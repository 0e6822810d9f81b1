"""The port's GF(256) arithmetic and Reed-Solomon kernel wrappers held to
the JAX package's: tables, Cauchy and inverse matrices, and the plain
PyTorch products — the codec's and the xtime ladder's — bit-identical
(tolerance 0) to `gf_matmul_np` and to the Pallas kernels in interpret
mode; the `backend=` dispatch of `gf256_matmul`; numpy emulations of
the kernels' word arithmetic (the codec's byte permutes, the ladder's
packed xtimes, the funnel-shift realignment) and of the gathered
decode's framed stores; the plain gathered decode against the staged
product. The CUDA kernels are held to their plain versions and to each
other on the card (`-m cuda`; skipped without one), the gathered one
also through the codec and a degraded GET of a CUDA store.

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


def test_planes_cache_keys_on_matrix_bytes():
    G, _ = _operands(3, 4, 1, 12)
    first = tkernel.plan_for(G, "cpu")
    assert tkernel.plan_for(G.copy(), "cpu") is first
    assert tkernel.plan_for(torch.from_numpy(G), "cpu") is first
    assert torch.equal(first.general, tkernel.expand_plan(G, "cpu").general)
    H = G.copy()
    H[0, 0] ^= 1
    assert not torch.equal(tkernel.plan_for(H, "cpu").general, first.general)
    assert tkernel.plan_for(G.reshape(4, 3), "cpu") is not first


def _codec_matrices():
    """(label, k, G, lost) of the store's real decode matrices: RS(10+2)
    and RS(4+2), one and two data chunks lost (the first, the last, two
    apart), plus their encodes."""
    from repro_torch.core.ec import ECConfig, RSCodec
    out = []
    for k, p in [(10, 2), (4, 2)]:
        codec = RSCodec(ECConfig(k, p), device="cpu")
        for lost in [(0,), (k - 1,), (0, 1), (1, k - 1)]:
            idx = tuple(i for i in range(k + p) if i not in lost)[:k]
            out.append((f"RS({k}+{p}) lost {lost}", k,
                        codec._decode_matrix(idx), lost))
        out.append((f"RS({k}+{p}) encode", k, codec._parity, None))
    return out


CODEC_MATRICES = _codec_matrices()


@pytest.mark.parametrize("case", range(len(CODEC_MATRICES)))
def test_row_plan_of_the_store_matrices(case):
    label, k, G, lost = CODEC_MATRICES[case]
    plan = tkernel.row_plan(G)
    m = G.shape[0]
    assert sorted(plan.zero + plan.dense + tuple(i for i, _ in plan.unit)) \
        == list(range(m)), label
    if lost is None:                      # the Cauchy rows: all dense
        assert plan.dense == tuple(range(m)) and not plan.unit
    else:
        # every surviving data chunk is a copy of its survivor, the lost
        # ones are GF products: never more dense rows than chunks lost
        assert plan.dense == lost, label
        survivors = [i for i in range(k + 2) if i not in lost][:k]
        assert plan.unit == tuple((i, survivors.index(i)) for i in range(k)
                                  if i not in lost), label
    assert not plan.zero
    assert tkernel.route(plan, m, k) == "small"


def test_row_plan_identity_zero_and_coefficient_one_rows():
    eye = np.eye(5, dtype=np.uint8)
    assert tkernel.row_plan(eye) == tkernel.RowPlan(
        (), tuple((i, i) for i in range(5)), ())
    G = np.array([[0, 0, 0], [0, 1, 0], [0, 7, 0], [1, 1, 0], [0, 0, 0],
                  [1, 0, 3]], np.uint8)
    plan = tkernel.row_plan(G)
    # a lone coefficient other than 1 is a product, two 1s are a sum
    assert plan == tkernel.RowPlan((0, 4), ((1, 1),), (2, 3, 5))
    assert str(plan) == "3 dense, 1 unit, 2 zero rows"
    assert np.array_equal(tkernel.coeff_kinds(G[5]), [1, 0, 2])
    assert tkernel.route(plan, 6, 3) == "general"       # k not 4 or 10
    assert tkernel.route(tkernel.row_plan(np.full((3, 10), 9, np.uint8)),
                         3, 10) == "general"            # 3 dense rows
    assert tkernel.route(tkernel.row_plan(np.eye(17, 10, dtype=np.uint8)),
                         17, 10) == "general"           # m past 16


def _plan_ref(G, X: torch.Tensor) -> torch.Tensor:
    """A plain executor of the row plan: zeros, copies of the unit rows'
    inputs, `gf256_matmul_ref` on the dense rows."""
    plan = tkernel.row_plan(G)
    out = torch.empty((G.shape[0], X.shape[1]), dtype=torch.uint8)
    for i in plan.zero:
        out[i] = 0
    for i, j in plan.unit:
        out[i] = X[j]
    if plan.dense:
        out[list(plan.dense)] = tref.gf256_matmul_ref(G[list(plan.dense)], X)
    return out


@pytest.mark.parametrize("case", range(len(CODEC_MATRICES) + 3))
def test_plan_executor_matches_gf_matmul_np(case):
    rng = np.random.default_rng(40 + case)
    if case < len(CODEC_MATRICES):
        G = CODEC_MATRICES[case][2]
    else:                                 # identity, zero rows, dense
        G = [np.eye(6, dtype=np.uint8),
             np.array([[0, 0, 0, 0], [0, 0, 1, 0], [5, 0, 1, 1]], np.uint8),
             rng.integers(0, 256, (7, 9), dtype=np.uint8)][
                 case - len(CODEC_MATRICES)]
    X = rng.integers(0, 256, (G.shape[1], 203), dtype=np.uint8)
    assert np.array_equal(_plan_ref(G, torch.from_numpy(X)).numpy(),
                          tref.gf_matmul_np(G, X))


def _prmt(a, b, sel):
    """numpy `prmt.b32` (CUDA's byte permute, with the sign-replicate bit
    of each selector nibble): result byte n is byte (nibble n & 7) of the
    8 bytes {b, a}, or that byte's top bit replicated if nibble n & 8."""
    a, b, sel = np.broadcast_arrays(*(np.asarray(v, np.uint64)
                                      for v in (a, b, sel)))
    pool = a | (b << np.uint64(32))
    out = np.zeros(a.shape, np.uint64)
    for n in range(4):
        nib = (sel >> np.uint64(4 * n)) & np.uint64(15)
        byte = (pool >> ((nib & np.uint64(7)) * np.uint64(8))) & \
            np.uint64(255)
        byte = np.where(nib & np.uint64(8),
                        np.where(byte & np.uint64(128), 255, 0), byte)
        out |= byte.astype(np.uint64) << np.uint64(8 * n)
    return out.astype(np.uint32)


def _table_mul_words(tables, x):
    """The kernel's `selectors` and `mul` on uint32 words x, in numpy."""
    x = np.asarray(x, np.uint32)
    xs = _prmt(x, 0, 0x3120)
    sels = []
    for shift, mask in ((0, 0x07070707), (3, 0x07070707), (6, 0x03030303)):
        t = (xs >> np.uint32(shift)) & np.uint32(mask)
        sels.append(t | (t >> np.uint32(12)))
    t = [tables[..., w] for w in range(5)]
    return (_prmt(t[0], t[1], sels[0]) ^ _prmt(t[2], t[3], sels[1])
            ^ _prmt(t[4], t[4], sels[2]))


def test_split_tables_give_every_product_by_byte_permute():
    coeffs = np.arange(256, dtype=np.uint8)[:, None]         # (256, 1)
    tables = tkernel.split_tables(coeffs)[:, 0]              # (256, 5)
    assert tables.shape == (256, 5) and tables.dtype == np.uint32
    xs = np.arange(256, dtype=np.uint8)
    for rot in range(4):                 # every x at every byte position
        words = np.roll(xs, rot).view("<u4")                 # (64,)
        got = _table_mul_words(tables[:, None, :], words[None, :])
        got = np.ascontiguousarray(got).view(np.uint8).reshape(256, 256)
        assert np.array_equal(got, tref.GF_MUL_TABLE[:, np.roll(xs, rot)])


def test_small_plan_words_follow_the_struct_layout():
    G = CODEC_MATRICES[2][2]                             # RS(10+2), 2 lost
    plan = tkernel.row_plan(G)
    w = tkernel.small_plan_words(G, plan)
    assert w.dtype == np.uint32 and w.size == tkernel.SMALL_PLAN_WORDS
    tab = w[:100].reshape(2, 10, 5)
    kinds, copies, zeros, dense_row = w[100:102], w[102:112], w[112], \
        w[113:115]
    assert list(dense_row) == list(plan.dense) == [0, 1]
    for d, i in enumerate(plan.dense):
        assert np.array_equal(tab[d], tkernel.split_tables(G[i:i + 1])[0])
        assert [(int(kinds[d]) >> (2 * j)) & 3 for j in range(10)] == \
            list(tkernel.coeff_kinds(G[i]))
    for i, j in plan.unit:
        assert copies[j] >> i & 1
    assert sum(bin(int(c)).count("1") for c in copies) == len(plan.unit)
    assert zeros == 0
    G4 = np.array([[0, 0, 0, 0], [0, 0, 1, 0], [3, 0, 0, 1]], np.uint8)
    w4 = tkernel.small_plan_words(G4, tkernel.row_plan(G4))
    assert w4[112] == 1 and w4[102 + 2] == 1 << 1 and w4[113] == 2
    assert np.array_equal(w4[:100].reshape(2, 10, 5)[0, :4],
                          tkernel.split_tables(G4[2:3])[0])
    assert not w4[:100].reshape(2, 10, 5)[0, 4:].any()


def test_general_operand_packs_tables_and_kinds():
    G, _ = _operands(3, 7, 1, 15)
    G[0, 0], G[1, 1] = 0, 1
    op = tkernel.general_operand(G)
    assert op.shape == (3, 7, 8) and op.dtype == np.uint32
    assert np.array_equal(op[..., :5], tkernel.split_tables(G))
    assert np.array_equal(op[..., 5], tkernel.coeff_kinds(G))
    assert not op[..., 6:].any()
    small = tkernel.expand_plan(np.full((3, 10), 9, np.uint8), "cpu")
    assert small.route == "general" and small.small is None
    assert torch.equal(small.general, torch.from_numpy(
        tkernel.general_operand(np.full((3, 10), 9, np.uint8))
        .view(np.int32)))


@pytest.mark.parametrize("L,sms,want", [
    (1, 132, (32, 1)),
    (104_858, 132, (32, 205)),           # a 1 MB object's chunk
    (734_004, 132, (128, 359)),          # a KV page's
    (2_097_153, 132, (128, 1025)),       # a checkpoint fragment's
    (10_485_761, 132, (128, 5121)),      # a 100 MB object's
    (16 * 2 * 132 * 128 - 16, 132, (128, 264)),
    (16 * 2 * 132 * 96, 132, (96, 264)),
])
def test_launch_shape_spreads_small_products(L, sms, want):
    threads, blocks = tkernel.launch_shape(L, sms)
    assert (threads, blocks) == want
    chunks = -(-L // 16)
    assert threads % 32 == 0 and threads <= tkernel.THREADS
    assert threads * blocks >= chunks            # one chunk a thread
    assert threads * (blocks - 1) < chunks       # and no idle block


@pytest.mark.parametrize("L,sms,want", [
    (1, 132, (32, 1)),
    (3_160_001, 132, (256, 772)),        # the mean GET's chunk
    (10_485_761, 132, (256, 2561)),      # a 100 MB object's
])
def test_gathered_launch_takes_blocks_of_256(L, sms, want):
    """The gathered decode's grid: one chunk a thread, blocks of up to
    GATHER_THREADS, since its partial stores fall at a block's ends."""
    threads, blocks = tkernel.launch_shape(L, sms, tkernel.GATHER_THREADS)
    assert (threads, blocks) == want
    assert threads * blocks >= -(-L // 16) > threads * (blocks - 1)


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
    plan, coeffs = tkernel.plan_for(G, "cpu"), tkernel.coeffs_for(G, "cpu")
    assert tkernel.coeffs_for(G.copy(), "cpu") is coeffs
    assert coeffs.dtype == torch.int32 and coeffs.shape == (2, 3)
    assert np.array_equal(coeffs.numpy(), G.astype(np.int32))
    assert plan.route == "general" and plan.general.shape == (2, 3, 8)


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


def _xtime4(a):
    """The ladder kernel's `xtime4` on uint32 words, in numpy: the
    sign-replicating byte permute marks each byte whose bit 7 is set, the
    bytes shift left within their byte, 0x1D goes in where bit 7 was."""
    a = np.asarray(a, np.uint32)
    msb = _prmt(a, 0, 0xBA98)
    return ((a & np.uint32(0x7F7F7F7F)) << np.uint32(1)) ^ \
        (msb & np.uint32(0x1D1D1D1D))


def _ladder_words(coeffs, x, mask_bits):
    """The ladder kernel's work for one coefficient and input row on
    uint32 words x: the bits in pairs, x * 2^(2p + 1) from x * 2^(2p) by
    `_xtime4`, both taken in one acc ^ t1 ^ t2, each take a mask
    x & -bit for bits below `mask_bits`, else a product x * bit."""
    c = np.asarray(coeffs, np.uint32)
    a = np.asarray(x, np.uint32)
    acc = np.zeros(np.broadcast_shapes(c.shape, a.shape), np.uint32)
    for p in range(4):
        a1 = _xtime4(a)
        takes = []
        for b, m in ((2 * p, a), (2 * p + 1, a1)):
            bit = (c >> np.uint32(b)) & np.uint32(1)
            takes.append(m & (np.uint32(0) - bit) if b < mask_bits
                         else m * bit)
        acc = acc ^ takes[0] ^ takes[1]
        if p < 3:
            a = _xtime4(a1)
    return acc


@pytest.mark.parametrize("mask_bits", [0, 2])
def test_swar_xtime_ladder_gives_every_product(mask_bits):
    xs = np.arange(256, dtype=np.uint8)
    coeffs = np.arange(256, dtype=np.uint32)[:, None]          # (256, 1)
    for rot in range(4):                 # every x at every byte position
        words = np.roll(xs, rot).view("<u4")                    # (64,)
        got = _ladder_words(coeffs, words[None, :], mask_bits)
        got = np.ascontiguousarray(got).view(np.uint8).reshape(256, 256)
        assert np.array_equal(got, tref.GF_MUL_TABLE[:, np.roll(xs, rot)])
    # one xtime of every byte: times 2 in the field
    got = _xtime4(xs.view("<u4")).view(np.uint8)
    assert np.array_equal(got, tref.GF_MUL_TABLE[2, xs])


def _load_chunk(blocks, shift, c, L):
    """The kernels' `load_chunk` in numpy: chunk c of a row starting
    `shift` bytes into 16-byte block 0 of `blocks` ((n, 4) uint32), from
    the two aligned blocks that cover it by funnel shifts; the second is
    read only if it holds a byte of the row."""
    lo = blocks[c]
    if shift == 0:
        return lo
    hi = blocks[c + 1] if 16 * c + 16 - shift < L else np.zeros(4, np.uint32)
    return _realign(lo, hi, shift)


def _realign(lo, hi, shift):
    """The kernels' `realign` in numpy: the 16 bytes that start `shift`
    bytes into the 32 bytes lo, hi ((4,) uint32 each), by funnel shifts."""
    w = np.concatenate([lo, hi]).astype(np.uint64)
    r = np.uint64((shift & 3) * 8)
    q = shift >> 2

    def fsr(n):                          # __funnelshift_r(w[n], w[n+1], r)
        return ((w[n] | (w[n + 1] << np.uint64(32))) >> r) & \
            np.uint64(0xFFFFFFFF)
    return np.array([fsr(q + n) for n in range(4)], np.uint32)


@pytest.mark.parametrize("L", [1, 15, 16, 17, 63, 64, 65])
def test_funnel_shift_realignment_rebuilds_every_offset(L):
    rng = np.random.default_rng(L)
    for off in range(16):
        n = -(-(off + L) // 16) * 16                 # the blocks it touches
        buf = rng.integers(0, 256, n, dtype=np.uint8)
        blocks = buf.view("<u4").reshape(-1, 4)
        row = buf[off:off + L]
        for c in range(-(-L // 16)):
            got = _load_chunk(blocks, off, c, L).view(np.uint8)
            want = row[16 * c:16 * c + 16]
            assert np.array_equal(got[:want.size], want), (off, c)


@pytest.mark.cuda
def test_ladder_kernel_matches_plain_and_bitsliced_on_card(cuda_device):
    """The ladder kernel against the plain ladder and the codec's kernel:
    input column offsets 0-15 (rows at every alignment), lengths around
    the 16-byte chunk, the output on the 16-byte pitch."""
    rng = np.random.default_rng(6)
    before = tkernel.ladder_launches
    calls = 0
    for m, k in LADDER_SWEEP + [(17, 20)]:
        for L in [1, 3, 15, 16, 17, 63, 64, 65, 100, 1024, 2125, 65539]:
            G = rng.integers(0, 256, (m, k), dtype=np.uint8)
            base = torch.from_numpy(
                rng.integers(0, 256, (k, L + 16), dtype=np.uint8)
            ).to(cuda_device)
            for off in range(16):                # strided column slices
                X = base[:, off:off + L]
                got = tops.gf256_matmul(G, X, backend="ladder")
                want = tref.gf256_matmul_ladder_ref(G, X)
                bitsliced = tops.gf256_matmul(G, X, backend="bitsliced")
                torch.cuda.synchronize()
                assert torch.equal(got, want), (m, k, L, off)
                assert torch.equal(got, bitsliced), (m, k, L, off)
                assert got.data_ptr() % 16 == 0 and got.stride(0) % 16 == 0
                calls += 1
    assert tkernel.ladder_launches - before == calls


SWEEP_L = [1, 3, 15, 16, 17, 4097, 104_858]


def _sweep_matrices(rng):
    """The store's matrices, identity, zero rows, coefficient-1 rows and
    dense (m,k) up to (16,16): both kernels of the codec path."""
    mats = [G for _, _, G, _ in CODEC_MATRICES]
    mats += [np.eye(10, dtype=np.uint8), np.eye(4, dtype=np.uint8),
             np.array([[0] * 10, [1] + [0] * 9, [0, 1] * 5], np.uint8)]
    for m, k in [(16, 16), (3, 10), (2, 4), (5, 7), (1, 1), (12, 10)]:
        G = rng.integers(0, 256, (m, k), dtype=np.uint8)
        G[0, 0] = 1
        mats.append(G)
    return mats


@pytest.mark.cuda
def test_kernel_sweeps_plans_offsets_and_lengths_on_card(cuda_device):
    """Every route and plan against the plain version: input column
    offsets 0-15 (rows at every alignment), the result at output column
    offsets 0-15 equal to the product of the offset input, and lengths
    around the 16-byte chunk and the small main-path products."""
    rng = np.random.default_rng(9)
    before = tkernel.launches
    calls = 0
    for G in _sweep_matrices(rng):
        m, k = G.shape
        for L in SWEEP_L:
            base = torch.from_numpy(
                rng.integers(0, 256, (k, L + 16), dtype=np.uint8)
            ).to(cuda_device)
            for off in range(16):
                X = base[:, off:off + L]
                got = tops.gf256_matmul(G, X)
                want = tref.gf256_matmul_ref(G, X)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (G.shape, L, off)
                assert got.data_ptr() % 16 == 0 and got.stride(0) % 16 == 0
                calls += 1
                if L == 4097:
                    for o in range(16):      # the output at offset o
                        part = tops.gf256_matmul(G, X[:, o:])
                        torch.cuda.synchronize()
                        assert torch.equal(part, got[:, o:]), (G.shape, o)
                        calls += 1
    assert tkernel.launches - before == calls


# ---- the gathered, framed decode -----------------------------------------

def _decode_matrices(k, p, lost_counts=(1, 2)):
    """Every decode matrix of RS(k+p) with 1 or 2 chunks lost that is not
    the identity (a data chunk among the lost): (lost, G)."""
    from repro_torch.core.ec import ECConfig, RSCodec
    codec = RSCodec(ECConfig(k, p), device="cpu")
    out = []
    for n in lost_counts:
        for lost in combinations(range(k + p), n):
            idx = tuple(i for i in range(k + p) if i not in lost)[:k]
            if idx != tuple(range(k)):
                out.append((lost, codec._decode_matrix(idx)))
    return out


GATHER_MATRICES = [(k, lost, G) for k, p in [(10, 2), (4, 2)]
                   for lost, G in _decode_matrices(k, p)]
GATHER_L = [1, 3, 15, 16, 17, 4097, 1_048_577]


def _gather_case(G, L, n, rng, device, offsets=None):
    """n fragments for G: each fragment's k chunks at byte offsets 0-15
    of their own storage (`offsets[j]`, else drawn), and framed outputs
    of k * L bytes at every output alignment in turn, inside buffers
    filled with a sentinel. Returns (chunks, outs, buffers, spans)."""
    m, k = G.shape
    chunks, outs, bufs, spans = [], [], [], []
    for f in range(n):
        rows = []
        for j in range(k):
            off = int(rng.integers(0, 16)) if offsets is None else offsets[j]
            base = torch.from_numpy(
                rng.integers(0, 256, off + L, dtype=np.uint8)).to(device)
            rows.append(base[off:])
        o = f % 16
        buf = torch.full((o + m * L + 32,), 0xA5, dtype=torch.uint8,
                         device=device)
        chunks.append(rows)
        outs.append(buf[o:o + m * L])
        bufs.append(buf)
        spans.append((o, o + m * L))
    return chunks, outs, bufs, spans


@pytest.mark.parametrize("L", GATHER_L)
def test_plain_gather_equals_staged_product_for_every_survivor_set(L):
    """The plain gathered decode against the staged path it replaces (a
    stacked survivor buffer, `gf256_matmul_ref`, rows copied into the
    framed buffer) and against the JAX package's `gf_matmul_np`: every
    RS(10+2) and RS(4+2) survivor set with 1 or 2 chunks lost, chunks
    at byte offsets 0-15 of their storage, batches of 1 (and of 4 for
    every eighth set)."""
    from repro.kernels.rs_gf256.ref import gf_matmul_np
    rng = np.random.default_rng(L)
    mats = GATHER_MATRICES if L < 1_000_000 else \
        [GATHER_MATRICES[0], GATHER_MATRICES[12]]   # RS(10+2), 1 and 2 lost
    for i, (k, lost, G) in enumerate(mats):
        for n in ((1, 4) if L < 5000 and i % 8 == 0 else (1,)):
            chunks, outs, bufs, spans = _gather_case(G, L, n, rng, "cpu")
            tref.gf256_gather_framed_ref(G, chunks, outs)
            for rows, out, buf, (a, b) in zip(chunks, outs, bufs, spans):
                X = torch.stack(list(rows))
                staged = tref.gf256_matmul_ref(G, X)
                assert torch.equal(out.view(k, L), staged), (k, lost, L)
                if L < 5000:
                    assert np.array_equal(out.view(k, L).numpy(),
                                          gf_matmul_np(G, X.numpy()))
                assert bool((buf[:a] == 0xA5).all()) and \
                    bool((buf[b:] == 0xA5).all()), (k, lost, L)


def test_plain_gather_takes_more_fragments_than_one_launch():
    """A batch past one launch's table (`GATHER_FRAGS`) through the
    dispatch: every fragment its own length and offsets."""
    rng = np.random.default_rng(77)
    k, lost, G = GATHER_MATRICES[0]
    n = tkernel.GATHER_FRAGS + 9
    chunks, outs = [], []
    for f in range(n):
        L = int(rng.integers(1, 300))
        c, o, _, _ = _gather_case(G, L, 1, rng, "cpu")
        chunks += c
        outs += o
    tops.gf256_gather_framed(G, chunks, outs)
    for rows, out in zip(chunks, outs):
        L = rows[0].numel()
        want = tref.gf_matmul_np(G, torch.stack(list(rows)).numpy())
        assert np.array_equal(out.view(k, L).numpy(), want)


def test_gather_refuses_what_it_cannot_run():
    k, lost, G = GATHER_MATRICES[0]
    rows = [torch.zeros(8, dtype=torch.uint8) for _ in range(k)]
    out = torch.zeros(k * 8, dtype=torch.uint8)
    assert tops.gathers(G) and not tops.gathers(np.eye(3, dtype=np.uint8))
    assert not tops.gathers(np.full((3, 10), 9, np.uint8))  # 3 dense rows
    with pytest.raises(ValueError):                # one chunk too short
        tops.gf256_gather_framed(G, [rows[:-1] + [rows[0][:7]]], [out])
    with pytest.raises(ValueError):                # output not k * L
        tops.gf256_gather_framed(G, [rows], [out[:-1]])
    with pytest.raises(ValueError):                # fragments != outputs
        tops.gf256_gather_framed(G, [rows, rows], [out])
    with pytest.raises(ValueError):                # a CUDA-less kernel call
        tkernel.gf256_gather_framed_cuda(G, [rows], [out])
    tops.gf256_gather_framed(G, [], [])            # nothing to do


def test_gather_tables_hold_pointers_and_lengths():
    """The launch's tables: k pointers a fragment in order, the outputs,
    the lengths; a strided, wrong-type or wrong-device tensor raises."""
    k, lost, G = GATHER_MATRICES[0]
    base = torch.zeros(4096, dtype=torch.uint8)
    chunks = [[base[f * 400 + 3 * j:f * 400 + 3 * j + 5] for j in range(k)]
              for f in range(3)]
    outs = [base[2000 + 64 * f:2000 + 64 * f + 5 * k] for f in range(3)]
    ins, out_ptrs, lens = tkernel.gather_tables(chunks, outs, k, k,
                                                torch.device("cpu"))
    assert list(ins) == [t.data_ptr() for rows in chunks for t in rows]
    assert list(out_ptrs) == [t.data_ptr() for t in outs]
    assert list(lens) == [5, 5, 5]
    for bad in (base[:10:2], base[:5].view(torch.int8), base[:10].view(2, 5)):
        with pytest.raises(ValueError):
            tkernel.gather_tables([[bad] * k], [outs[0]], k, k,
                                  torch.device("cpu"))


def _store_bytes(mem, count, at, w, lo, hi):
    """Bytes [lo, hi) of the 16 bytes w stored at `at` + lo on."""
    mem[at + lo:at + hi] = w[lo:hi]
    count[at + lo:at + hi] += 1


def _gather_stores(base, rows, L, threads):
    """The kernel's stores for one fragment, in numpy: `rows` the (m, L)
    output, written framed at byte `base` of a buffer; every thread as
    `gf256_small_gather` and `store_framed` run it, a block of `threads`
    holding consecutive chunks, lane 0 of each warp after the first given
    chunk c - 1 by the warp before. Returns (memory, stores per byte)."""
    m = rows.shape[0]
    nchunks = -(-L // 16)
    size = base + m * L + 64
    mem = np.full(size, 0xA5, np.uint8)
    count = np.zeros(size, np.int64)
    padded = np.full((m, 16 * nchunks + 16), 0xEE, np.uint8)
    padded[:, :L] = rows

    def words(b):
        return np.ascontiguousarray(b).view("<u4")

    def realign(lo, hi, shift):
        return _realign(words(lo), words(hi), shift).view(np.uint8)

    for r in range(m):
        row = base + r * L
        for c in range(nchunks):
            t = c % threads
            first_of_block = t == 0
            owns_tail = t == threads - 1 or 16 * c + 16 >= L
            v = padded[r, 16 * c:16 * c + 16]
            prev = v if first_of_block else padded[r, 16 * c - 16:16 * c]
            at = row + 16 * c
            s = at % 16
            blk = at - s
            assert blk % 16 == 0
            w = v if s == 0 else realign(prev, v, 16 - s)
            n = min(16, L - 16 * c)
            lo = s if first_of_block else 0
            hi = min(16, s + n)
            tail = n - 16 + s if owns_tail and n > 16 - s else 0
            if lo == 0 and hi == 16:             # one aligned 16-byte store
                _store_bytes(mem, count, blk, w, 0, 16)
            else:                                # a byte a lane
                _store_bytes(mem, count, blk, w, lo, hi)
            if tail:
                tv = v if s == 0 else realign(v, v, 16 - s)
                _store_bytes(mem, count, blk + 16, tv, 0, tail)
    return mem, count


@pytest.mark.parametrize("L", list(range(1, 34)) + [255, 511, 512, 513, 527,
                                                    1000, 1537, 4097])
def test_framed_stores_write_every_byte_once(L):
    """`store_framed`'s plan in numpy, for output rows at every alignment
    (the codec's framed buffer begins at 12 mod 16) and blocks of 32, 64
    and 256 threads: the framed bytes come out right, each stored by
    exactly one store (an aligned 16-byte block, or a piece's byte), and
    no byte outside them is touched,
    whatever the row length (rows shorter than a block, rows over several
    blocks, a block cut short by the row's end)."""
    rng = np.random.default_rng(L)
    m = 10 if L in (17, 513, 4097) else 3
    rows = rng.integers(0, 256, (m, L), dtype=np.uint8)
    for threads in (32, 64, 256):
        for base in range(16, 32):
            mem, count = _gather_stores(base, rows, L, threads)
            span = slice(base, base + m * L)
            assert np.array_equal(mem[span], rows.reshape(-1)), (L, base)
            assert (count[span] == 1).all(), (L, threads, base)
            assert not count[:base].any() and not count[base + m * L:].any()


@pytest.mark.cuda
def test_gather_kernel_matches_plain_on_card(cuda_device):
    """The gathered kernel against the plain version bit for bit: every
    RS(10+2) and RS(4+2) survivor set with 1 or 2 chunks lost, the
    lengths around a 16-byte chunk and past a warp, chunks at byte
    offsets 0-15 of their storage, outputs at every alignment with the
    bytes around them untouched, batches of 1 (and, for every eighth set,
    of 4 and past one launch's table); ceil(n / GATHER_FRAGS) launches a
    call."""
    rng = np.random.default_rng(12)
    before, before_mm = tkernel.gather_launches, tkernel.launches
    launches = 0
    for L in GATHER_L:
        mats = GATHER_MATRICES if L < 1_000_000 else \
            [GATHER_MATRICES[0], GATHER_MATRICES[12]]
        for i, (k, lost, G) in enumerate(mats):
            ns = (1,) if i % 8 else (1, 4, tkernel.GATHER_FRAGS + 3) \
                if L <= 17 else (1, 4) if L < 5000 else (1,)
            for n in ns:
                chunks, outs, bufs, spans = _gather_case(G, L, n, rng,
                                                         cuda_device)
                want = [b.clone() for b in bufs]
                wouts = [w[a:b] for w, (a, b) in zip(want, spans)]
                tops.gf256_gather_framed(G, chunks, outs)
                tref.gf256_gather_framed_ref(G, chunks, wouts)
                torch.cuda.synchronize()
                for got, w in zip(bufs, want):
                    assert torch.equal(got, w), (k, lost, L, n)
                launches += -(-n // tkernel.GATHER_FRAGS)
    assert tkernel.gather_launches - before == launches
    assert tkernel.launches == before_mm


@pytest.mark.cuda
@pytest.mark.parametrize("lost", [(0,), (0, 1)])
def test_gather_kernel_at_the_store_layout_on_card(cuda_device, lost):
    """A 100 MB object's fragment (L 10,485,761) decoded into the codec's
    framed buffer from the encode's chunks: the same bytes as the plain
    version, and the object read back."""
    from repro_torch.core import ec
    codec = ec.RSCodec(ec.ECConfig(10, 2), device=cuda_device)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(3)
    payload = torch.randint(0, 256, (100 * 2 ** 20,), dtype=torch.uint8,
                            device=cuda_device, generator=gen)
    chunks = codec.encode_many([payload], as_arrays=True)[0]
    idx = tuple(i for i in range(12) if i not in lost)[:10]
    G = codec._decode_matrix(idx)
    L = chunks[0].numel()
    assert L == 10_485_761
    rows = [chunks[i] for i in idx]
    got = ec._framed(10 * L, cuda_device)
    want = ec._framed(10 * L, cuda_device)
    before = tkernel.gather_launches
    tops.gf256_gather_framed(G, [rows], [got])
    tref.gf256_gather_framed_ref(G, [rows], [want])
    torch.cuda.synchronize()
    assert tkernel.gather_launches == before + 1
    assert got.data_ptr() % 16 == 12
    assert torch.equal(got, want)
    assert torch.equal(codec.decode_many([{i: chunks[i] for i in idx}],
                                         as_arrays=True)[0], payload)


@pytest.mark.cuda
def test_degraded_decode_is_one_gather_launch_per_group_on_card(cuda_device):
    """A CUDA codec's decode: one gathered launch per survivor group
    (fragments of several lengths in one launch), `launches` unchanged and
    nothing staged; the identity path launches nothing; a matrix off the
    small route (RS(3+2)) stages and is counted."""
    from repro_torch.core import ec
    rng = np.random.default_rng(4)
    codec = ec.RSCodec(ec.ECConfig(10, 2), device=cuda_device)
    payloads = [rng.bytes(n) for n in (1, 17, 4097, 1_000_003, 33)]
    enc = codec.encode_many(payloads, as_arrays=True)
    one = [{i: c for i, c in enumerate(cs) if i != 0} for cs in enc]
    two = [{i: c for i, c in enumerate(cs) if i not in (3, 7)} for cs in enc]
    ident = [{i: c for i, c in enumerate(cs) if i < 10} for cs in enc]
    g0, m0 = tkernel.gather_launches, tkernel.launches
    got = codec.decode_many(one + two + ident)
    assert got == payloads * 3
    assert tkernel.gather_launches - g0 == 2 and tkernel.launches == m0
    assert codec.staged_decodes == 0
    small = ec.RSCodec(ec.ECConfig(3, 2), device=cuda_device)
    cs = small.encode(b"staged" * 99)
    m0 = tkernel.launches
    assert small.decode({i: cs[i] for i in (1, 2, 4)}) == b"staged" * 99
    assert small.staged_decodes == 1 and tkernel.launches == m0 + 1


@pytest.mark.cuda
def test_degraded_get_on_cuda_store_gathers_on_card(cuda_device, tmp_path):
    """A degraded `get_many_arrays` on a CUDA store: the objects' bytes
    through the gathered decode, `staged_decodes` 0 in `get_pipeline`."""
    from repro_torch.core import InfiniStore, StoreConfig
    st = InfiniStore(StoreConfig(enable_recovery=False,
                                 spill_dir=str(tmp_path / "spill")))
    try:
        gen = torch.Generator(device=cuda_device)
        gen.manual_seed(5)
        objs = {f"o{i}": torch.randint(0, 256, (n,), dtype=torch.uint8,
                                       device=cuda_device, generator=gen)
                for i, n in enumerate((3_000_001, 20_000_000, 17))}
        st.put_many(objs)
        assert st.flush_writeback(timeout=120.0)
        st.inject_failure(st.chunk_map["o1|1/f0#0"])
        g0 = tkernel.gather_launches
        got = st.get_many_arrays(list(objs))
        for key, want in objs.items():
            assert torch.equal(got[key], want), key
        assert tkernel.gather_launches > g0
        assert st.snapshot_metadata()["get_pipeline"]["staged_decodes"] == 0
    finally:
        st.close()
