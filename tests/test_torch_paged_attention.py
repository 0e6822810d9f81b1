"""The port's paged decode attention held to the JAX package's: the plain
PyTorch version (what a CPU tensor runs) against
`paged_decode_attention_ref` and against the Pallas kernel in interpret
mode, over the reference's shape sweep with random page permutations and
ragged lengths, at 2e-5 in f32 and 3e-2 in bf16 (the reference kernel
test's tolerances), plus page-permutation invariance. The CUDA kernels
are held to the plain version on the card (`-m cuda`; skipped without
one), at those sweeps and at Qwen3-1.7B's decode shape.

The JAX package is imported inside the parity tests only, so the CUDA
tests run on a machine that has no JAX. The host-side split and wave
rule and the head groups are tested on the CPU."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import kernel as tkernel
from repro_torch.kernels.paged_attention import ops as tops
from repro_torch.kernels.paged_attention.ref import paged_decode_attention_ref

SWEEP = [(1, 2, 4, 1, 1, 8), (2, 4, 8, 2, 2, 16), (3, 5, 8, 2, 3, 16),
         (2, 8, 16, 4, 1, 32)]
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(seed, B, P, ps, K, G, hd, lens=None):
    """numpy inputs: q (B,H,hd), pools (B,P,ps,K,hd), a random page
    permutation per sequence and ragged lengths in [1, P*ps]."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, K * G, hd)).astype(np.float32)
    kp = rng.standard_normal((B, P, ps, K, hd)).astype(np.float32)
    vp = rng.standard_normal((B, P, ps, K, hd)).astype(np.float32)
    tbl = np.stack([rng.permutation(P) for _ in range(B)]).astype(np.int32)
    if lens is None:
        lens = rng.integers(1, P * ps + 1, B)
    return q, kp, vp, tbl, np.asarray(lens, dtype=np.int32)


def _torch(args, dtype, device="cpu"):
    q, kp, vp, tbl, lens = (torch.from_numpy(a) for a in args)
    return (q.to(device, dtype), kp.to(device, dtype), vp.to(device, dtype),
            tbl.to(device), lens.to(device))


def _jax(args, dtype):
    import jax.numpy as jnp
    q, kp, vp, tbl, lens = args
    return (jnp.asarray(q, dtype), jnp.asarray(kp, dtype),
            jnp.asarray(vp, dtype), jnp.asarray(tbl), jnp.asarray(lens))


def _check_against_reference(args, dtype):
    import jax.numpy as jnp
    from repro.kernels.paged_attention.kernel import \
        paged_decode_attention_pallas
    from repro.kernels.paged_attention.ref import \
        paged_decode_attention_ref as jax_ref
    tdt = getattr(torch, dtype)
    targs, jargs = _torch(args, tdt), _jax(args, getattr(jnp, dtype))
    got = paged_decode_attention_ref(*targs)
    assert got.dtype == torch.float32
    dispatched = tops.paged_decode_attention(*targs)     # CPU -> plain
    assert dispatched.dtype == tdt
    assert torch.equal(dispatched, got.to(tdt))
    tol = TOL[tdt]
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jax_ref(*jargs), dtype=np.float32), atol=tol, rtol=tol)
    np.testing.assert_allclose(
        dispatched.float().numpy(),
        np.asarray(paged_decode_attention_pallas(*jargs, interpret=True),
                   dtype=np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,P,ps,K,G,hd", SWEEP)
def test_plain_matches_reference_f32(B, P, ps, K, G, hd):
    _check_against_reference(_case(B * 100 + P, B, P, ps, K, G, hd),
                             "float32")


def test_plain_matches_reference_bf16():
    _check_against_reference(_case(7, 2, 4, 8, 2, 2, 16), "bfloat16")


def test_plain_matches_reference_full_and_single_token_lengths():
    B, P, ps = 3, 4, 8
    _check_against_reference(_case(9, B, P, ps, 2, 2, 16,
                                   lens=[1, P * ps, 13]), "float32")


def test_permutation_invariance():
    """Physical page placement must not affect the result — the SMS
    compaction guarantee."""
    q, kp, vp, tbl, lens = _case(11, 2, 6, 4, 2, 2, 16)
    out1 = tops.paged_decode_attention(*_torch((q, kp, vp, tbl, lens),
                                               torch.float32))
    perm = np.random.default_rng(5).permutation(6)
    inv = np.argsort(perm).astype(np.int32)
    out2 = tops.paged_decode_attention(*_torch(
        (q, kp[:, perm], vp[:, perm], inv[tbl], lens), torch.float32))
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_dispatch_refuses_what_it_cannot_run():
    args = _torch(_case(1, 1, 2, 4, 1, 1, 8), torch.float32)
    with pytest.raises(TypeError):
        tops.paged_decode_attention(args[0].numpy(), *args[1:])
    with pytest.raises(ValueError):
        tops.paged_decode_attention(args[0].to("meta"), *args[1:])
    with pytest.raises(ValueError):              # the kernel needs CUDA
        tkernel.paged_decode_attention_cuda(*args)


def test_split_pages_fills_the_card():
    # Qwen3-1.7B decode: 16 sequences x 8 kv heads, 34 pages of 64, at
    # the two occupancies the kernel can reach at hd 128 (bf16: 2 blocks
    # per SM; f32: 1)
    for occ in (1, 2, 3):
        splits, pps = tkernel.split_pages(16, 8, 2, 34, 132, occ)
        assert 16 * 8 * splits <= occ * 132           # one wave
        assert 16 * 8 * (splits + 1) > occ * 132      # the fullest one
        assert (splits - 1) * pps < 34 <= splits * pps
    assert tkernel.split_pages(16, 8, 2, 34, 132, 2) == (2, 17)
    assert tkernel.split_pages(1, 1, 1, 3, 132, 2) == (3, 1)
    assert tkernel.split_pages(64, 8, 8, 10, 132, 2) == (1, 10)


WAVES = [
    # (B, K, G, P, sms, blocks per SM) -> (splits, pages per split)
    ((16, 8, 2, 34, 132, 2), (2, 17)),
    ((16, 8, 2, 34, 132, 1), (1, 34)),     # pairs alone fill the wave
    ((4, 2, 8, 40, 132, 2), (20, 2)),      # 33 runs would leave empties
    ((1, 1, 1, 3, 132, 4), (3, 1)),        # never more splits than pages
    ((2, 2, 12, 9, 132, 1), (9, 1)),       # G 12: two head groups
    ((200, 8, 2, 34, 132, 2), (1, 34)),    # more pairs than a wave
    ((3, 5, 3, 7, 100, 0), (4, 2)),        # occupancy 0 counts as 1
]


@pytest.mark.parametrize("args,want", WAVES,
                         ids=["x".join(map(str, a)) for a, _ in WAVES])
def test_split_pages_wave_rule(args, want):
    B, K, G, P, sms, occ = args
    splits, pps = tkernel.split_pages(*args)
    assert (splits, pps) == want
    blocks = B * K * -(-G // tkernel.head_group(G)) * splits
    assert splits == 1 or blocks <= sms * max(1, occ)
    assert (splits - 1) * pps < P <= splits * pps     # no empty split


@pytest.mark.parametrize("G,want", [(1, 1), (2, 2), (3, 4), (4, 4),
                                    (5, 8), (8, 8), (12, 8), (16, 8)])
def test_head_group_is_the_templated_width(G, want):
    assert tkernel.head_group(G) == want


def test_import_builds_nothing():
    assert tkernel._lib is None or torch.cuda.is_available()


# ---- on the card -----------------------------------------------------------

CARD_CASES = SWEEP + [
    (16, 34, 64, 8, 2, 128),       # Qwen3-1.7B decode at 16 slots
    (2, 7, 16, 2, 4, 64), (2, 5, 8, 1, 5, 32), (1, 9, 32, 2, 8, 128),
    (4, 3, 64, 16, 1, 64),
    # the new designs' cases: G = 1 and 8 at hd 128, page sizes 16 and
    # 128, G = 12 (two head groups), hd 64 and 8
    (3, 6, 64, 4, 1, 128), (2, 12, 16, 2, 8, 128), (2, 5, 128, 2, 2, 128),
    (2, 4, 16, 1, 12, 64), (2, 3, 128, 2, 2, 64), (2, 4, 8, 2, 2, 8),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(cuda_device, dtype):
    before = tkernel.launches
    calls = 0
    for i, (B, P, ps, K, G, hd) in enumerate(CARD_CASES):
        occ = tkernel._blocks_per_sm(cuda_device, hd, G,
                                     tkernel.DTYPES[dtype], P)
        splits, pps = tkernel.split_pages(B, K, G, P,
                                          _build.sm_count(cuda_device), occ)
        page_end = max(1, P // 2) * ps           # ends on a page boundary
        split_end = min(P, pps) * ps             # ends where a split ends
        for lens in (None, [1] * B, [P * ps] * B, [page_end] * B,
                     [split_end] * B, [split_end + 1] * B):
            args = _torch(_case(i, B, P, ps, K, G, hd, lens), dtype,
                          cuda_device)
            got = tops.paged_decode_attention(*args)
            want = paged_decode_attention_ref(*args)
            torch.cuda.synchronize()
            assert got.dtype == dtype and got.shape == args[0].shape
            assert torch.isfinite(got.float()).all()
            torch.testing.assert_close(got.float(), want, atol=TOL[dtype],
                                       rtol=TOL[dtype])
            calls += 1
    assert tkernel.launches - before == calls
