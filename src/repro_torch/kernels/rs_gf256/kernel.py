"""Hopper CUDA kernels: GF(256) matrix multiply (RS coding).

Computes OUT = G ∘ X over GF(2^8): OUT[i, :] = XOR_j gfmul(G[i,j], X[j, :]).
Two kernels, each described at the top of its source:

- `gf256_matmul_cuda` (`csrc/gf256_matmul.cu`), bit-sliced, the codec's
  kernel; replaces the JAX package's `_rs_bitsliced_kernel`;
- `gf256_matmul_ladder_cuda` (`csrc/gf256_ladder.cu`), the xtime-ladder
  A/B baseline; replaces `_rs_ladder_kernel`.

Each source is compiled with `nvcc` for `sm_90a` into a shared library
with a plain C entry point (built at first use by `kernels/_build.py`
under `build/repro_torch/`, keyed by a hash of the source) and called
through `ctypes` on PyTorch's current stream. Importing this module builds
nothing; a failed build raises — there is no fallback to the plain
version. `launches` and `ladder_launches` count each kernel's launches
in this process.

The coefficient operand lives on the device — the bit-sliced kernel's
bit-planes, the ladder's int32 coefficients — made host-side once per
matrix and kept in a small LRU keyed on G's bytes, so a caller passes
only G.
"""
from __future__ import annotations

import ctypes
import threading
from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rs_gf256.ref import gf_coeff_planes

SOURCE = Path(__file__).resolve().parent / "csrc" / "gf256_matmul.cu"
LADDER_SOURCE = SOURCE.with_name("gf256_ladder.cu")
MAX_DIM = 255                    # m, k bound (RS over GF(256): k+p <= 256)

_LOW_BITS = 0x01010101           # replicates a plane byte into a word
PLANES_CACHE_SIZE = 128          # matrices whose device operands are kept

launches = 0                     # bit-sliced kernel launches
ladder_launches = 0              # ladder kernel launches
_lock = threading.Lock()         # guards the libraries, counts, the cache
_libs: dict = {}                 # source -> loaded library
_operand_cache: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
# both entry points: (planes or coefficients, X, ldx, out, ldo, m, k, L,
# stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_void_p]


def _entry(source: Path, name: str):
    """The C entry point `name` of `source`'s library, built and loaded
    at first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(_build.build(source)))
            fn = getattr(lib, name)
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
            _libs[source] = lib
        return getattr(lib, name)


def expand_planes(G, device) -> torch.Tensor:
    """(m,k) uint8 coefficients -> (m,k,8) int32 bit-planes on `device`,
    each plane byte replicated into all four bytes of its word (the
    kernel's coefficient operand)."""
    planes = gf_coeff_planes(G).astype(np.uint32)
    planes *= np.uint32(_LOW_BITS)
    return torch.from_numpy(planes.view(np.int32)).to(device)


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
        if len(_operand_cache) > PLANES_CACHE_SIZE:
            _operand_cache.popitem(last=False)
    return operand


def planes_for(G, device) -> torch.Tensor:
    """G's `expand_planes` on `device`, cached (`_cached`)."""
    return _cached(G, device, expand_planes)


def coeffs_for(G, device) -> torch.Tensor:
    """G's `expand_coeffs` on `device`, cached (`_cached`)."""
    return _cached(G, device, expand_coeffs)


def gf256_matmul_cuda(G, X: torch.Tensor) -> torch.Tensor:
    """Launch the bit-sliced kernel: G (m,k) uint8 (numpy or tensor), X
    (k,L) uint8 CUDA tensor with unit column stride (any row stride, any
    alignment). Returns a (m,L) uint8 view of an output whose rows are
    16-byte aligned."""
    global launches
    out, launched = _launch(SOURCE, "gf256_matmul_bitsliced", planes_for,
                            G, X)
    with _lock:
        launches += launched
    return out


def gf256_matmul_ladder_cuda(G, X: torch.Tensor) -> torch.Tensor:
    """Launch the xtime-ladder kernel on the same operands as
    `gf256_matmul_cuda`, with the same result."""
    global ladder_launches
    out, launched = _launch(LADDER_SOURCE, "gf256_matmul_ladder",
                            coeffs_for, G, X)
    with _lock:
        ladder_launches += launched
    return out


def _launch(source: Path, name: str, operand, G,
            X: torch.Tensor):
    """Check the operands, allocate the output and launch `name` of
    `source` on X's current stream; raises on a refused launch. Returns
    the output and whether a kernel was launched (not for L = 0)."""
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
    coeffs = operand(G, X.device)
    pitch = -(-L // 16) * 16
    out = torch.empty((m, pitch), dtype=torch.uint8, device=X.device)[:, :L]
    if L == 0:
        return out, False
    fn = _entry(source, name)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = fn(coeffs.data_ptr(), X.data_ptr(), X.stride(0),
                out.data_ptr(), out.stride(0), m, k, L, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    return out, True
