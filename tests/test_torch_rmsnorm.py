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
    with pytest.raises(ValueError):
        tops.rms_norm_op(torch.empty(2, 8, device="meta"), torch.ones(8))
    with pytest.raises(ValueError):              # the kernel needs CUDA
        tkernel.rms_norm_cuda(x, torch.ones(8))


def test_import_builds_nothing():
    assert tkernel._lib is None or torch.cuda.is_available()


# ---- on the card -----------------------------------------------------------

CARD_SHAPES = SHAPES + [(16, 1, 2048), (16, 1, 16, 128), (16, 1, 8, 128),
                        (2, 2048, 2048), (2, 2048, 16, 128), (3, 5, 100),
                        (7, 1000)]


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
