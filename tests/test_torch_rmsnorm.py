"""The port's RMSNorm held to the JAX package's: the plain PyTorch
version (what a CPU tensor runs) against `rms_norm_ref` and against the
Pallas kernel in interpret mode, over the reference's shape sweep, at
1e-5 in f32 and 2e-2 in bf16 (the reference kernel test's tolerances).
The CUDA kernel is held to the plain version on the card (`-m cuda`;
skipped without one).

Inputs are made with numpy and cast to bf16 by both frameworks, which
round to nearest even alike (checked bit for bit). The JAX package is
imported inside the parity tests only, so the CUDA tests run on a
machine that has no JAX."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.rmsnorm import kernel as tkernel
from repro_torch.kernels.rmsnorm import ops as tops
from repro_torch.kernels.rmsnorm.ref import rms_norm_ref

SHAPES = [(4, 128), (3, 7, 256), (1, 512), (300, 64)]
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    scale = (rng.standard_normal(shape[-1:]) * 0.1 + 1.0).astype(np.float32)
    return x, scale


def _f32(t) -> np.ndarray:
    return np.asarray(t, dtype=np.float32) if not isinstance(
        t, torch.Tensor) else t.float().numpy()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_and_pallas(shape, dtype):
    import jax.numpy as jnp
    from repro.kernels.rmsnorm.kernel import rms_norm_pallas
    from repro.kernels.rmsnorm.ref import rms_norm_ref as jax_ref
    from repro_torch.models.convert import params_from_numpy
    x, scale = _inputs(shape, sum(shape))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, js = jnp.asarray(x, jdt), jnp.asarray(scale, jdt)
    tx = torch.from_numpy(x).to(tdt)
    ts = torch.from_numpy(scale).to(tdt)
    # both frameworks hold the same input bits
    back = params_from_numpy({"x": np.asarray(jx)}, device="cpu")["x"]
    assert torch.equal(back.view(torch.int16 if dtype == "bfloat16"
                                 else torch.int32),
                       tx.view(torch.int16 if dtype == "bfloat16"
                               else torch.int32))
    got = rms_norm_ref(tx, ts)
    assert got.dtype == tdt and got.shape == tx.shape
    assert torch.equal(tops.rms_norm_op(tx, ts), got)   # CPU -> plain
    tol = TOL[tdt]
    np.testing.assert_allclose(_f32(got), _f32(jax_ref(jx, js)),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(
        _f32(got), _f32(rms_norm_pallas(jx, js, interpret=True)),
        atol=tol, rtol=tol)


def test_eps_and_f32_scale_with_bf16_input():
    import jax.numpy as jnp
    from repro.kernels.rmsnorm.ref import rms_norm_ref as jax_ref
    x, scale = _inputs((5, 96), 3)
    x *= 1e-3                                    # eps matters here
    got = rms_norm_ref(torch.from_numpy(x).to(torch.bfloat16),
                       torch.from_numpy(scale), eps=1e-5)
    want = jax_ref(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale),
                   eps=1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-2, rtol=2e-2)


def test_dispatch_refuses_what_it_cannot_run():
    x = torch.ones(2, 8)
    with pytest.raises(TypeError):
        tops.rms_norm_op(x.numpy(), torch.ones(8))
    # a meta tensor (the dry-run's trace) takes the plain version: shapes
    # only, no kernel
    y = tops.rms_norm_op(torch.empty(2, 8, dtype=torch.bfloat16,
                                     device="meta"),
                         torch.ones(8, device="meta"))
    assert (y.device.type, y.shape, y.dtype) == \
        ("meta", (2, 8), torch.bfloat16)
    with pytest.raises(ValueError):              # the kernel needs CUDA
        tkernel.rms_norm_cuda(x, torch.ones(8))


def test_import_builds_nothing():
    assert tkernel._lib is None or torch.cuda.is_available()


# ---- the layout planner (host side, no card needed) --------------------

L = tkernel.Layout
PLANS = [
    # (d, bytes per element, 16-byte aligned) -> layout
    ((64, 2, True), L("tile", 1, 8, 1, 16, 128)),      # 4 rows per warp
    ((128, 2, True), L("tile", 1, 16, 1, 8, 128)),     # q_norm / k_norm
    ((64, 4, True), L("tile", 1, 16, 1, 8, 128)),
    ((128, 4, True), L("tile", 1, 32, 1, 4, 128)),     # 512 B: one warp
    ((100, 4, True), L("tile", 1, 32, 1, 4, 128)),     # 25 of 32 lanes
    ((896, 2, True), L("tile", 4, 32, 1, 4, 128)),     # masked tail
    ((1024, 2, True), L("tile", 4, 32, 1, 4, 128)),    # train ln
    ((2048, 2, True), L("tile", 8, 32, 1, 4, 128)),    # serving ln
    ((2048, 4, True), L("tile", 8, 32, 2, 1, 64)),
    ((5120, 2, True), L("tile", 7, 32, 3, 1, 96)),     # 640 of 672 slots
    ((8192, 2, True), L("tile", 8, 32, 4, 1, 128)),
    ((8192, 4, True), L("tile", 8, 32, 8, 1, 256)),
    ((16384, 2, True), L("tile", 8, 32, 8, 1, 256)),   # the widest tile
    ((16384, 4, True), L("loop", 0, 32, 8, 1, 256)),   # beyond the tile
    ((20000, 2, True), L("loop", 0, 32, 8, 1, 256)),
    ((100, 2, True), L("scalar", 0, 32, 4, 1, 128)),   # 200 B rows
    ((12, 2, True), L("scalar", 0, 32, 1, 1, 32)),
    ((64, 2, False), L("scalar", 0, 32, 2, 1, 64)),    # unaligned view
    ((4096, 2, False), L("scalar", 0, 32, 8, 1, 256)),
    # (d, bytes, aligned, rows, SMs): rows too few to give each of 132
    # SMs a block spread over more warps, at one vector a lane if they can
    ((2048, 2, True, 16, 132), L("tile", 1, 32, 8, 1, 256)),    # decode
    ((2048, 2, True, 32768, 132), L("tile", 8, 32, 1, 4, 128)),  # prefill
    ((1024, 2, True, 4096, 132), L("tile", 4, 32, 1, 4, 128)),   # train
    ((1024, 2, True, 300, 132), L("tile", 1, 32, 4, 1, 128)),
    ((2048, 4, True, 16, 132), L("tile", 2, 32, 8, 1, 256)),
    ((8192, 2, True, 16, 132), L("tile", 4, 32, 8, 1, 256)),
    ((5120, 2, True, 200, 132), L("tile", 7, 32, 3, 1, 96)),
    ((128, 2, True, 16, 132), L("tile", 1, 16, 1, 8, 128)),     # packed
    ((100, 2, True, 1, 132), L("scalar", 0, 32, 4, 1, 128)),
]


@pytest.mark.parametrize("args,want", PLANS,
                         ids=["d{}x{}{}{}".format(
                             a[0], a[1], "" if a[2] else "u",
                             f"r{a[3]}" if len(a) > 3 else "")
                             for a, _ in PLANS])
def test_plan_picks_the_layout_by_width(args, want):
    assert tkernel.plan(*args) == want


@pytest.mark.parametrize("elem", [2, 4])
def test_plan_tiles_cover_each_row_once(elem):
    """Every 16-byte vector of a row lands in exactly one (thread, slot)
    of its layout (slot k of thread t holds vector t + k * threads per
    row, as the kernel indexes it), no slot column is wholly empty, and
    each block is whole rows of whole warps within the kernel's
    limits."""
    widths = list(range(16 // elem, 20000, 16 // elem))[::7] + [896, 5120]
    for d, rows in [(d, r) for d in widths for r in (1, 16, 100000)]:
        lay = tkernel.plan(d, elem, True, rows, 132)
        if lay.kind != "tile":
            assert d * elem > 32 * 16 * tkernel.MAX_VEC * tkernel.MAX_WARPS
            continue
        nvec = d * elem // 16
        tpr = lay.lanes * lay.warps
        assert lay.threads == lay.rpb * tpr <= 256
        assert lay.threads % 32 == 0 and 1 <= lay.vec <= tkernel.MAX_VEC
        assert lay.lanes == 32 or (lay.warps == 1 and 32 % lay.lanes == 0)
        assert lay.warps == 1 or lay.rpb == 1
        slots = np.arange(tpr)[:, None] + np.arange(lay.vec)[None] * tpr
        used = np.sort(slots[slots < nvec])
        np.testing.assert_array_equal(used, np.arange(nvec))
        assert (lay.vec - 1) * tpr < nvec          # last slot column used


# ---- on the card -----------------------------------------------------------

CARD_SHAPES = SHAPES + [(16, 1, 2048), (16, 1, 16, 128), (16, 1, 8, 128),
                        (2, 2048, 2048), (2, 2048, 16, 128), (3, 5, 100),
                        (7, 1000),
                        # every layout of `plan`: d_model 896 to 8192, a
                        # row beyond the register tile, rows of 24 bytes
                        # (scalar in bf16), and more row groups than the
                        # persistent grid holds
                        (5, 896), (4096, 1024), (3, 5120), (2, 8192),
                        (3, 20000), (4, 7, 12), (3, 64), (33000, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(cuda_device, dtype):
    before = tkernel.launches
    calls = 0
    for shape in CARD_SHAPES:
        x, scale = _inputs(shape, sum(shape))
        tx = torch.from_numpy(x).to(cuda_device, dtype)
        for ts in (torch.from_numpy(scale).to(cuda_device, dtype),
                   torch.from_numpy(scale).to(cuda_device)):
            got = tops.rms_norm_op(tx, ts, 1e-6)
            want = rms_norm_ref(tx, ts, 1e-6)
            torch.cuda.synchronize()
            assert got.dtype == dtype and got.shape == tx.shape
            tol = TOL[dtype]
            torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                       rtol=tol)
            calls += 1
    # a view whose rows are not 16-byte aligned takes the scalar path
    base = torch.randn(9, 65, device=cuda_device).to(dtype)
    view = base[:, 1:]
    got = tops.rms_norm_op(view, torch.ones(64, device=cuda_device))
    torch.testing.assert_close(got.float(), rms_norm_ref(
        view, torch.ones(64, device=cuda_device)).float(),
        atol=TOL[dtype], rtol=TOL[dtype])
    assert tkernel.launches - before == calls + 1
