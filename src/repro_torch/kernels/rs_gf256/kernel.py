"""Hopper CUDA kernels: GF(256) matrix multiply (RS coding).

Computes OUT = G ∘ X over GF(2^8): OUT[i, :] = XOR_j gfmul(G[i,j], X[j, :]).
Three kernels, each described at the top of its source:

- `gf256_matmul_cuda` (`csrc/gf256_matmul.cu`), the codec's kernel;
  replaces the JAX package's `_rs_bitsliced_kernel`: a row plan of G
  (`row_plan`: zero, unit and dense rows) and split product tables
  looked up by byte permutes (`split_tables`), one 16-byte column chunk
  of every input row per thread (`launch_shape`);
- `gf256_gather_framed_cuda` (the same source, `gf256_small_gather`),
  the codec's degraded decode on the small route: each fragment's
  survivor chunks read where they lie and its rows written straight
  into its framed buffer, up to `GATHER_FRAGS` fragments a launch, the
  plan and the pointers by value; it replaces no TPU kernel (the JAX
  package stacks and unframes in host arrays);
- `gf256_matmul_ladder_cuda` (`csrc/gf256_ladder.cu`), the xtime-ladder
  A/B baseline; replaces `_rs_ladder_kernel`: every product formed at
  run time by xtimes of four packed bytes per 32-bit word, the running
  multiples shared by the output rows, each take a warp-uniform mask or
  0/1 product, one 16-byte column chunk of every input row per thread
  (`launch_shape`).

Each source is compiled with `nvcc` for `sm_90a` into a shared library
with a plain C entry point (built at first use by `kernels/_build.py`
under `build/repro_torch/`, keyed by a hash of the source) and called
through `ctypes` on PyTorch's current stream. Importing this module builds
nothing; a failed build raises — there is no fallback to the plain
version. `launches`, `gather_launches` and `ladder_launches` count each
kernel's launches in this process.

Each kernel's coefficient operand — the codec kernel's plan (by value in
the launch for the store's shapes, else a device table), the ladder's
int32 coefficients — is made host-side once per matrix and kept in a
small LRU keyed on G's bytes, so a caller passes only G.
"""
from __future__ import annotations

import ctypes
import threading
from collections import OrderedDict
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build, require_plain
from repro_torch.kernels.rs_gf256.ref import GF_MUL_TABLE

SOURCE = Path(__file__).resolve().parent / "csrc" / "gf256_matmul.cu"
LADDER_SOURCE = SOURCE.with_name("gf256_ladder.cu")
MAX_DIM = 255                    # m, k bound (RS over GF(256): k+p <= 256)

OPERAND_CACHE_SIZE = 128         # matrices whose operands are kept
# the store's shapes, which `gf256_small` takes (the .cu's kSmall*)
SMALL_K = (4, 10)
SMALL_MAX_M = 16
SMALL_MAX_DENSE = 2
SMALL_PLAN_WORDS = 115           # sizeof(SmallPlan) / 4
THREADS = 128                    # threads per block, at most
MAX_BLOCKS = 2 ** 31 - 1         # grid cap; threads stride beyond it
GATHER_FRAGS = 32                # fragments per gathered launch (.cu's
                                 # kGatherFrags)
GATHER_THREADS = 256             # threads per gathered block, at most

launches = 0                     # codec kernel launches
gather_launches = 0              # gathered, framed decode launches
ladder_launches = 0              # ladder kernel launches
_lock = threading.Lock()         # guards the libraries, counts, the cache
_libs: dict = {}                 # source -> loaded library
_operand_cache: "OrderedDict[tuple, object]" = OrderedDict()
_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
# entry point -> argtypes
_ARGTYPES = {
    # (small plan, coef, X, ldx, out, ldo, m, k, dense, L, threads,
    # blocks, stream)
    "gf256_matmul_planned": [_P, _P, _P, _LL, _P, _LL, _I, _I, _I, _LL, _I,
                             _I, _P],
    # (coefficients, X, ldx, out, ldo, m, k, L, threads, blocks, stream)
    "gf256_matmul_ladder": [_P, _P, _LL, _P, _LL, _I, _I, _LL, _I, _I, _P],
    # (small plan, inputs, outputs, lengths, n, k, dense, threads, blocks,
    # stream)
    "gf256_gather_planned": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}


def _entry(source: Path, name: str):
    """The C entry point `name` of `source`'s library, built and loaded
    at first use (every entry point of `_ARGTYPES` it has typed then)."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(_build.build(source)))
            for entry, argtypes in _ARGTYPES.items():
                if hasattr(lib, entry):
                    getattr(lib, entry).argtypes = argtypes
                    getattr(lib, entry).restype = ctypes.c_int
            _libs[source] = lib
        return getattr(lib, name)


@dataclass(frozen=True)
class RowPlan:
    """G's output rows by what they cost: `zero` rows (all coefficients
    0), `unit` rows as (output row, input row) pairs (one coefficient, 1:
    a copy) and `dense` rows (a GF(256) product, its zero coefficients
    dropped and its coefficients 1 done as plain XORs)."""
    zero: Tuple[int, ...]
    unit: Tuple[Tuple[int, int], ...]
    dense: Tuple[int, ...]

    def __str__(self) -> str:
        return (f"{len(self.dense)} dense, {len(self.unit)} unit, "
                f"{len(self.zero)} zero rows")


def row_plan(G) -> RowPlan:
    """Sort the rows of (m,k) uint8 G into zero, unit and dense rows."""
    G = np.asarray(G, np.uint8)
    zero, unit, dense = [], [], []
    for i, row in enumerate(G):
        nz = np.flatnonzero(row)
        if nz.size == 0:
            zero.append(i)
        elif nz.size == 1 and row[nz[0]] == 1:
            unit.append((i, int(nz[0])))
        else:
            dense.append(i)
    return RowPlan(tuple(zero), tuple(unit), tuple(dense))


def route(plan: RowPlan, m: int, k: int) -> str:
    """"small" (`gf256_small`: the store's shapes, the plan by value in
    the launch) or "general" (`gf256_general`: tables in shared
    memory)."""
    if k in SMALL_K and m <= SMALL_MAX_M and \
            len(plan.dense) <= SMALL_MAX_DENSE:
        return "small"
    return "general"


def coeff_kinds(G) -> np.ndarray:
    """(m,k) uint8 -> (m,k) uint32: 0 where the coefficient is 0, 1 where
    it is 1 (a plain XOR), 2 where it takes a table product."""
    G = np.asarray(G, np.uint8)
    return np.where(G < 2, G, 2).astype(np.uint32)


def _pack(rows: np.ndarray) -> np.ndarray:
    """(..., 4) bytes -> (...) little-endian uint32 words."""
    return np.ascontiguousarray(rows, np.uint8).view("<u4")[..., 0]


def split_tables(G) -> np.ndarray:
    """(m,k) uint8 -> (m,k,5) uint32: the split product tables of each
    coefficient c, words T0 lo, T0 hi, T1 lo, T1 hi, T2 with
    T0[i] = c*i (i < 8), T1[i] = c*(i << 3) (i < 8), T2[i] = c*(i << 6)
    (i < 4), byte i of a table at byte i % 4 of its word i // 4. Then
    c*x = T0[x & 7] ^ T1[(x >> 3) & 7] ^ T2[x >> 6]: each lookup is one
    byte permute of the table's words."""
    G = np.asarray(G, np.uint8)
    rows = GF_MUL_TABLE[G]                          # (m, k, 256): c*x
    t0 = rows[..., 0:8]
    t1 = rows[..., 0:64:8]
    t2 = rows[..., 0:256:64]
    return np.stack([_pack(t0[..., :4]), _pack(t0[..., 4:]),
                     _pack(t1[..., :4]), _pack(t1[..., 4:]), _pack(t2)],
                    axis=-1).astype(np.uint32)


def small_plan_words(G, plan: RowPlan) -> np.ndarray:
    """The `SmallPlan` parameter of `gf256_small`, word for word: the
    dense rows' tables (2 x 10 x 5), their coefficient kinds (2 bits per
    input row), per input row the mask of output rows copying it, the
    mask of zero rows, and the dense rows' output rows."""
    G = np.asarray(G, np.uint8)
    tab = np.zeros((SMALL_MAX_DENSE, 10, 5), np.uint32)
    kinds = np.zeros(SMALL_MAX_DENSE, np.uint32)
    dense_row = np.zeros(SMALL_MAX_DENSE, np.uint32)
    for d, i in enumerate(plan.dense):
        tab[d, :G.shape[1]] = split_tables(G[i:i + 1])[0]
        kinds[d] = sum(int(kd) << (2 * j)
                       for j, kd in enumerate(coeff_kinds(G[i])))
        dense_row[d] = i
    copies = np.zeros(10, np.uint32)
    for i, j in plan.unit:
        copies[j] |= np.uint32(1 << i)
    zeros = np.uint32(sum(1 << i for i in plan.zero))
    words = np.concatenate([tab.ravel(), kinds, copies, [zeros],
                            dense_row]).astype(np.uint32)
    assert words.size == SMALL_PLAN_WORDS
    return words


def general_operand(G) -> np.ndarray:
    """(m,k) uint8 -> (m,k,8) uint32, the `gf256_general` operand: each
    coefficient's `split_tables` words, its `coeff_kinds` kind, two
    zero words (32 bytes: two aligned 16-byte loads)."""
    m, k = np.shape(G)
    out = np.zeros((m, k, 8), np.uint32)
    out[..., :5] = split_tables(G)
    out[..., 5] = coeff_kinds(G)
    return out


@dataclass(frozen=True)
class Operand:
    """The codec kernel's operand for one G: its row plan and route, and
    the `small_plan_words` (host memory, copied into the launch) or the
    `general_operand` on the device."""
    plan: RowPlan
    route: str
    small: Optional[np.ndarray]
    general: Optional[torch.Tensor]


def expand_plan(G, device) -> Operand:
    """G's `Operand` for a launch on `device`."""
    plan = row_plan(G)
    m, k = np.shape(G)
    if route(plan, m, k) == "small":
        return Operand(plan, "small", small_plan_words(G, plan), None)
    coef = torch.from_numpy(general_operand(G).view(np.int32)).to(device)
    return Operand(plan, "general", None, coef)


def launch_shape(L: int, sms: int, most: int = THREADS
                 ) -> Tuple[int, int]:
    """(threads, blocks) over the ceil(L/16) column chunks, one chunk a
    thread: `most` threads a block where the chunks give every SM two
    such blocks, fewer (a multiple of 32) where they do not, so a small
    product still spreads over the card. (Measured on an H100 at a 100 MB
    object's chunk: one chunk a thread beat grids capped at 4-16 blocks
    per SM with the threads striding, and 128 threads beat 256 at the
    decode and the dense product; the gathered decode takes 256, since
    its partial stores fall at a block's ends.)"""
    chunks = -(-L // 16)
    threads = most
    if chunks < 2 * sms * most:
        threads = max(32, 32 * -(-chunks // (2 * sms * 32)))
    return threads, max(1, min(-(-chunks // threads), MAX_BLOCKS))


def expand_coeffs(G, device) -> torch.Tensor:
    """(m,k) uint8 coefficients -> (m,k) int32 on `device` (the ladder
    kernel's coefficient operand)."""
    return torch.from_numpy(np.asarray(G, np.int32)).to(device)


def _cached(G, device, expand) -> torch.Tensor:
    """`expand(G, device)` from an LRU keyed on the expansion, G's shape
    and bytes: each matrix crosses host-to-device once, not once per
    call."""
    if isinstance(G, torch.Tensor):
        G = G.cpu().numpy()
    G = np.ascontiguousarray(G, dtype=np.uint8)
    key = (expand.__name__, G.shape, G.tobytes(), str(torch.device(device)))
    with _lock:
        hit = _operand_cache.get(key)
        if hit is not None:
            _operand_cache.move_to_end(key)
            return hit
    operand = expand(G, device)
    with _lock:
        _operand_cache[key] = operand
        if len(_operand_cache) > OPERAND_CACHE_SIZE:
            _operand_cache.popitem(last=False)
    return operand


def plan_for(G, device) -> Operand:
    """G's `expand_plan` for `device`, cached (`_cached`)."""
    return _cached(G, device, expand_plan)


def coeffs_for(G, device) -> torch.Tensor:
    """G's `expand_coeffs` on `device`, cached (`_cached`)."""
    return _cached(G, device, expand_coeffs)


def gf256_matmul_cuda(G, X: torch.Tensor) -> torch.Tensor:
    """Launch the codec kernel: G (m,k) uint8 (numpy or tensor), X (k,L)
    uint8 CUDA tensor with unit column stride (any row stride, any
    alignment). Returns a (m,L) uint8 view of an output whose rows are
    16-byte aligned (their pad columns hold whatever the last chunk
    computed)."""
    global launches
    m, k, L = _check("gf256_matmul_planned", G, X)
    op = plan_for(G, X.device)
    out = _output(m, L, X.device)
    if L == 0:
        return out
    threads, blocks = launch_shape(L, _build.sm_count(X.device))
    fn = _entry(SOURCE, "gf256_matmul_planned")
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        small = None if op.small is None else op.small.ctypes.data
        coef = None if op.general is None else op.general.data_ptr()
        rc = fn(small, coef, X.data_ptr(), X.stride(0), out.data_ptr(),
                out.stride(0), m, k, len(op.plan.dense), L, threads, blocks,
                stream)
    _raise_on("gf256_matmul_planned", rc)
    with _lock:
        launches += 1
    return out


def gather_tables(chunks, outs, m: int, k: int, device
                  ) -> Tuple[ctypes.Array, ctypes.Array, ctypes.Array]:
    """The `gf256_gather_planned` tables of one launch: each fragment's k
    survivor pointers (fragment after fragment), its output pointer and
    its chunk length L. Raises on a tensor that is not a flat contiguous
    uint8 tensor on `device`, on a fragment whose chunks differ in
    length or number, and on an output that is not m * L bytes."""
    n = len(chunks)
    ins = (ctypes.c_void_p * (n * k))()
    out_ptrs = (ctypes.c_void_p * n)()
    lens = (ctypes.c_longlong * n)()
    for f, (rows, out) in enumerate(zip(chunks, outs)):
        if len(rows) != k:
            raise ValueError(f"fragment {f} has {len(rows)} chunks, G "
                             f"takes {k}")
        L = _flat_u8(rows[0], device).numel()
        for j, row in enumerate(rows):
            if _flat_u8(row, device).numel() != L:
                raise ValueError(f"fragment {f}: chunk {j} holds "
                                 f"{row.numel()} bytes, chunk 0 {L}")
            ins[f * k + j] = row.data_ptr()
        if _flat_u8(out, device).numel() != m * L:
            raise ValueError(f"fragment {f}: output of {out.numel()} "
                             f"bytes for {m} rows of {L}")
        out_ptrs[f] = out.data_ptr()
        lens[f] = L
    return ins, out_ptrs, lens


def _flat_u8(t, device) -> torch.Tensor:
    """`t` if it is a plain flat contiguous uint8 tensor on `device`."""
    if type(t) is not torch.Tensor or t.dtype != torch.uint8 or \
            t.dim() != 1 or t.device != device or not t.is_contiguous():
        raise ValueError(f"need flat contiguous uint8 tensors on {device}, "
                         f"got {type(t).__name__} "
                         f"{getattr(t, 'dtype', None)} "
                         f"{tuple(getattr(t, 'shape', ()))} on "
                         f"{getattr(t, 'device', None)}")
    return t


def gf256_gather_framed_cuda(G, chunks, outs) -> None:
    """Launch the gathered, framed decode (`gf256_small_gather`): for
    each fragment f, the product of G ((m, k) uint8 on the small route,
    `route`) and its k survivor chunks `chunks[f]` (flat uint8 CUDA
    tensors of one length L, any alignment, read where they lie) written
    into `outs[f]` (flat uint8, m * L bytes, any alignment) row after
    row: output row i at byte i * L. ceil(n / GATHER_FRAGS) launches for
    n fragments."""
    global gather_launches
    if len(chunks) != len(outs):
        raise ValueError(f"{len(chunks)} fragments, {len(outs)} outputs")
    if not outs:
        return
    device = outs[0].device
    if device.type != "cuda":
        raise ValueError("gf256_gather_framed_cuda needs CUDA tensors")
    m, k = np.shape(G)
    op = plan_for(G, device)
    if op.route != "small":
        raise ValueError(f"G ({m}, {k}) with {op.plan} is not on the "
                         f"small route: gf256_matmul_cuda takes it")
    fn = _entry(SOURCE, "gf256_gather_planned")
    sms = _build.sm_count(device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for start in range(0, len(outs), GATHER_FRAGS):
            part = slice(start, start + GATHER_FRAGS)
            ins, out_ptrs, lens = gather_tables(chunks[part], outs[part],
                                                m, k, device)
            threads, blocks = launch_shape(max(lens), sms, GATHER_THREADS)
            rc = fn(op.small.ctypes.data, ins, out_ptrs, lens, len(lens),
                    k, len(op.plan.dense), threads, blocks, stream)
            _raise_on("gf256_gather_planned", rc)
            with _lock:
                gather_launches += 1


def gf256_matmul_ladder_cuda(G, X: torch.Tensor) -> torch.Tensor:
    """Launch the xtime-ladder kernel on the same operands as
    `gf256_matmul_cuda`, with the same result and output layout."""
    global ladder_launches
    m, k, L = _check("gf256_matmul_ladder", G, X)
    coeffs = coeffs_for(G, X.device)
    out = _output(m, L, X.device)
    if L == 0:
        return out
    threads, blocks = launch_shape(L, _build.sm_count(X.device))
    fn = _entry(LADDER_SOURCE, "gf256_matmul_ladder")
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = fn(coeffs.data_ptr(), X.data_ptr(), X.stride(0),
                out.data_ptr(), out.stride(0), m, k, L, threads, blocks,
                stream)
    _raise_on("gf256_matmul_ladder", rc)
    with _lock:
        ladder_launches += 1
    return out


def _check(name: str, G, X: torch.Tensor) -> Tuple[int, int, int]:
    """Raise on operands the kernels do not take; returns (m, k, L)."""
    require_plain(name, G, X)
    if not isinstance(X, torch.Tensor) or X.device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA tensor")
    if X.dtype != torch.uint8 or X.dim() != 2:
        raise ValueError(f"X must be 2-D uint8, got {X.dtype} "
                         f"{tuple(X.shape)}")
    k, L = X.shape
    if L > 1 and X.stride(1) != 1:
        raise ValueError("X needs unit column stride (row slices of a "
                         "stacked buffer are fine; a transposed view "
                         "is not)")
    m, kg = np.shape(G)
    if kg != k or not (0 < m <= MAX_DIM and 0 < k <= MAX_DIM):
        raise ValueError(f"G is ({m}, {kg}) for X with {k} rows: need "
                         f"matching k and m, k in 1..{MAX_DIM}")
    return m, k, L


def _output(m: int, L: int, device) -> torch.Tensor:
    """(m, L) view of an uninitialised buffer whose rows are 16-byte
    aligned, their pitch L rounded up to 16."""
    pitch = -(-L // 16) * 16
    return torch.empty((m, pitch), dtype=torch.uint8, device=device)[:, :L]


def _raise_on(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
