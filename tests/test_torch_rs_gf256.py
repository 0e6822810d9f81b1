"""The port's GF(256) arithmetic and Reed-Solomon kernel wrappers held to
the JAX package's: tables, Cauchy and inverse matrices, and the plain
PyTorch products — the codec's and the xtime ladder's — bit-identical
(tolerance 0) to `gf_matmul_np` and to the Pallas kernels in interpret
mode; the `backend=` dispatch of `gf256_matmul`. The CUDA kernels are
held to their plain versions and to each other on the card (`-m cuda`;
skipped without one).

The JAX package is imported inside the parity tests only, so the CUDA
case runs on a machine that has no JAX."""
from itertools import combinations

import numpy as np
import pytest
import torch

from repro_torch.kernels.rs_gf256 import kernel as tkernel
from repro_torch.kernels.rs_gf256 import ops as tops
from repro_torch.kernels.rs_gf256 import ref as tref


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return torch.device("cuda")


def _operands(m, k, L, seed):
    rng = np.random.default_rng(seed)
    G = rng.integers(0, 256, (m, k), dtype=np.uint8)
    X = rng.integers(0, 256, (k, L), dtype=np.uint8)
    return G, X


@pytest.mark.parametrize("m,k", [(2, 10), (4, 4), (1, 2), (6, 12)])
@pytest.mark.parametrize("L", [1, 100, 1024, 2125])
def test_plain_matches_reference_and_pallas(m, k, L):
    from repro.kernels.rs_gf256.kernel import gf256_matmul_bitsliced
    from repro.kernels.rs_gf256.ref import gf_matmul_np
    G, X = _operands(m, k, L, m * 1000 + k * 10 + L)
    want = gf_matmul_np(G, X)
    pallas = np.asarray(gf256_matmul_bitsliced(G, X, interpret=True))
    plain = tref.gf256_matmul_ref(G, torch.from_numpy(X)).numpy()
    # a CPU tensor dispatches to the plain version
    dispatched = tops.gf256_matmul(G, torch.from_numpy(X)).numpy()
    assert np.array_equal(pallas, want)
    assert np.array_equal(plain, want)
    assert np.array_equal(dispatched, want)


def test_plain_takes_column_slice_views():
    from repro.kernels.rs_gf256.ref import gf_matmul_np
    G, X = _operands(3, 5, 203, 7)
    Xt = torch.from_numpy(X)
    for off, L in [(1, 101), (3, 37), (5, 198)]:
        view = Xt[:, off:off + L]
        assert not view.is_contiguous()
        assert np.array_equal(tref.gf256_matmul_ref(G, view).numpy(),
                              gf_matmul_np(G, X[:, off:off + L]))


def test_tables_and_matrices_equal_reference():
    from repro.kernels.rs_gf256 import ref as jref
    assert np.array_equal(tref.EXP_TABLE, jref.EXP_TABLE)
    assert np.array_equal(tref.LOG_TABLE, jref.LOG_TABLE)
    assert np.array_equal(tref.GF_MUL_TABLE, jref.GF_MUL_TABLE)
    rng = np.random.default_rng(3)
    a, b = (rng.integers(0, 256, 500).astype(np.uint8) for _ in range(2))
    assert np.array_equal(tref.gf_mul_np(a, b), jref.gf_mul_np(a, b))
    nz = a[a != 0]
    assert np.array_equal(tref.gf_inv_np(nz), jref.gf_inv_np(nz))
    G = rng.integers(0, 256, (5, 7), dtype=np.uint8)
    X = rng.integers(0, 256, (7, 333), dtype=np.uint8)
    assert np.array_equal(tref.gf_coeff_planes(G), jref.gf_coeff_planes(G))
    assert np.array_equal(tref.gf_matmul_table(G, X),
                          jref.gf_matmul_np(G, X))
    for k, p in [(10, 2), (4, 2), (3, 2), (12, 4)]:
        C = tref.cauchy_parity_matrix(k, p)
        assert np.array_equal(C, jref.cauchy_parity_matrix(k, p))
        gen = np.concatenate([np.eye(k, dtype=np.uint8), C], 0)
        for rows in list(combinations(range(k + p), k))[:12]:
            assert np.array_equal(tref.gf_inv_matrix_np(gen[list(rows)]),
                                  jref.gf_inv_matrix_np(gen[list(rows)]))


def test_cauchy_rows_mds_property():
    """Every k x k submatrix of [I; C] is invertible (any k of the k+p
    chunks reconstruct)."""
    k, p = 4, 2
    G = np.concatenate([np.eye(k, dtype=np.uint8),
                        tref.cauchy_parity_matrix(k, p)], 0)
    for rows in combinations(range(k + p), k):
        inv = tref.gf_inv_matrix_np(G[list(rows)])
        assert np.array_equal(tref.gf_matmul_np(inv, G[list(rows)]),
                              np.eye(k, dtype=np.uint8))


def test_expand_planes_are_byte_replicated_bitplanes():
    G, _ = _operands(3, 4, 1, 11)
    planes = tkernel.expand_planes(G, "cpu")
    assert planes.shape == (3, 4, 8) and planes.dtype == torch.int32
    words = planes.numpy().view(np.uint32)
    base = tref.gf_coeff_planes(G).astype(np.uint32)
    assert np.array_equal(words, base * np.uint32(0x01010101))


def test_planes_cache_keys_on_matrix_bytes():
    G, _ = _operands(3, 4, 1, 12)
    first = tkernel.planes_for(G, "cpu")
    assert tkernel.planes_for(G.copy(), "cpu") is first
    assert tkernel.planes_for(torch.from_numpy(G), "cpu") is first
    assert torch.equal(first, tkernel.expand_planes(G, "cpu"))
    H = G.copy()
    H[0, 0] ^= 1
    assert not torch.equal(tkernel.planes_for(H, "cpu"), first)
    assert tkernel.planes_for(G.reshape(4, 3), "cpu") is not first


def test_dispatch_refuses_what_it_cannot_run():
    G, X = _operands(2, 3, 10, 0)
    with pytest.raises(TypeError):
        tops.gf256_matmul(G, X)                  # numpy: not a tensor
    with pytest.raises(ValueError):
        tops.gf256_matmul(G, torch.empty((3, 10), dtype=torch.uint8,
                                         device="meta"))
    with pytest.raises(ValueError):              # the kernel needs CUDA
        tkernel.gf256_matmul_cuda(G, torch.from_numpy(X))


def test_import_builds_nothing():
    # the CPU tests import the kernel module on machines without nvcc:
    # nothing is compiled or loaded until a CUDA tensor reaches it
    assert not tkernel._libs or torch.cuda.is_available()


LADDER_SWEEP = [(2, 10), (4, 4), (1, 2), (6, 12), (10, 10)]


def _pallas_ladder(G, X):
    """The Pallas ladder in interpret mode, called one 1024-byte tile of
    columns at a time — the tiles its grid walks, and independent — so
    every L reuses one compiled (m, k) kernel (interpret mode compiles
    anew for each grid length, ~15 s apiece at m = k = 10)."""
    from repro.kernels.rs_gf256.kernel import (TILE,
                                               gf256_matmul_pallas_ladder)
    return np.concatenate([
        np.asarray(gf256_matmul_pallas_ladder(G, X[:, c:c + TILE],
                                              interpret=True))
        for c in range(0, X.shape[1], TILE)], axis=1)


@pytest.mark.parametrize("m,k", LADDER_SWEEP)
@pytest.mark.parametrize("L", [1, 100, 1024, 2125])
def test_plain_ladder_matches_reference_and_pallas_ladder(m, k, L):
    from repro.kernels.rs_gf256.ref import gf_matmul_np
    G, X = _operands(m, k, L, m * 1000 + k * 10 + L + 1)
    want = gf_matmul_np(G, X)
    pallas = _pallas_ladder(G, X)
    plain = tref.gf256_matmul_ladder_ref(G, torch.from_numpy(X))
    assert plain.dtype == torch.uint8
    # on a CPU tensor backend="ladder" runs the plain ladder
    dispatched = tops.gf256_matmul(G, torch.from_numpy(X),
                                   backend="ladder").numpy()
    assert np.array_equal(pallas, want)
    assert np.array_equal(plain.numpy(), want)
    assert np.array_equal(dispatched, want)


def test_plain_ladder_takes_views_and_tensor_coefficients():
    from repro.kernels.rs_gf256.ref import gf_matmul_np
    G, X = _operands(5, 6, 301, 21)
    Xt = torch.from_numpy(X)
    for off, L in [(1, 101), (3, 37), (0, 301)]:
        view = Xt[:, off:off + L]
        got = tref.gf256_matmul_ladder_ref(torch.from_numpy(G), view)
        assert np.array_equal(got.numpy(), gf_matmul_np(G, X[:, off:off + L]))
    with pytest.raises(ValueError):
        tref.gf256_matmul_ladder_ref(G, Xt[:5])


def test_backend_dispatch_mirrors_reference_names():
    from repro.kernels.rs_gf256.ref import gf_matmul_np
    G, X = _operands(3, 4, 77, 13)
    want = gf_matmul_np(G, X)
    Xt = torch.from_numpy(X)
    for backend in ("auto", "bitsliced", "ladder", "ref"):
        assert np.array_equal(
            tops.gf256_matmul(G, Xt, backend=backend).numpy(), want), backend
    # "pallas" is "bitsliced" here; "interpret" has no counterpart
    for backend in ("interpret", "pallas", "numpy", ""):
        with pytest.raises(ValueError, match="backend"):
            tops.gf256_matmul(G, Xt, backend=backend)
    with pytest.raises(TypeError):
        tops.gf256_matmul(G, X, backend="ladder")     # numpy: not a tensor
    with pytest.raises(ValueError):                  # the kernel needs CUDA
        tkernel.gf256_matmul_ladder_cuda(G, Xt)


def test_operand_cache_keeps_planes_and_coefficients_apart():
    G, _ = _operands(2, 3, 1, 14)
    planes, coeffs = tkernel.planes_for(G, "cpu"), tkernel.coeffs_for(G, "cpu")
    assert tkernel.coeffs_for(G.copy(), "cpu") is coeffs
    assert coeffs.dtype == torch.int32 and coeffs.shape == (2, 3)
    assert np.array_equal(coeffs.numpy(), G.astype(np.int32))
    assert planes.shape == (2, 3, 8)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    rng = np.random.default_rng(5)
    before = tkernel.launches
    calls = 0
    for m, k in [(2, 10), (10, 10), (1, 2), (6, 12), (17, 20)]:
        for L in [1, 3, 5, 17, 1023, 4099, 65539]:
            G = rng.integers(0, 256, (m, k), dtype=np.uint8)
            base = torch.from_numpy(
                rng.integers(0, 256, (k, L + 5), dtype=np.uint8)
            ).to(cuda_device)
            for off in (0, 1, 3):                # strided column slices
                X = base[:, off:off + L]
                got = tops.gf256_matmul(G, X)
                want = tref.gf256_matmul_ref(G, X)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (m, k, L, off)
                calls += 1
    assert tkernel.launches - before == calls


@pytest.mark.cuda
def test_ladder_kernel_matches_plain_and_bitsliced_on_card(cuda_device):
    rng = np.random.default_rng(6)
    before = tkernel.ladder_launches
    calls = 0
    for m, k in LADDER_SWEEP + [(17, 20)]:
        for L in [1, 3, 100, 1024, 2125, 65539]:
            G = rng.integers(0, 256, (m, k), dtype=np.uint8)
            base = torch.from_numpy(
                rng.integers(0, 256, (k, L + 5), dtype=np.uint8)
            ).to(cuda_device)
            for off in (0, 1, 3):                # strided column slices
                X = base[:, off:off + L]
                got = tops.gf256_matmul(G, X, backend="ladder")
                want = tref.gf256_matmul_ladder_ref(G, X)
                bitsliced = tops.gf256_matmul(G, X, backend="bitsliced")
                torch.cuda.synchronize()
                assert torch.equal(got, want), (m, k, L, off)
                assert torch.equal(got, bitsliced), (m, k, L, off)
                calls += 1
    assert tkernel.ladder_launches - before == calls
