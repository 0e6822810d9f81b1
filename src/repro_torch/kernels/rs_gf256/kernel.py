"""Hopper CUDA kernel: bit-sliced GF(256) matrix multiply (RS coding).

Computes OUT = G ∘ X over GF(2^8): OUT[i, :] = XOR_j gfmul(G[i,j], X[j, :]).
Replaces the JAX package's `_rs_bitsliced_kernel`; the arithmetic and
the design are described at the top of `csrc/gf256_matmul.cu`.

The source is compiled with `nvcc` for `sm_90a` into a shared library
with a plain C entry point (built at first use by `kernels/_build.py`
under `build/repro_torch/`, keyed by a hash of the source) and called
through `ctypes` on PyTorch's current stream. Importing this module builds
nothing; a failed build raises — there is no fallback to the plain
version. `launches` counts the kernel launches this process made.

The kernel's coefficient operand is G's bit-planes on the device; they
are expanded host-side once per matrix and kept in a small LRU keyed on
G's bytes, so a caller passes only G.
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
MAX_DIM = 255                    # m, k bound (RS over GF(256): k+p <= 256)

_LOW_BITS = 0x01010101           # replicates a plane byte into a word
PLANES_CACHE_SIZE = 128          # matrices whose device planes are kept

launches = 0                     # kernel launches made by this process
_lock = threading.Lock()         # guards the library, `launches`, the cache
_lib = None
_planes_cache: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()


def build() -> Path:
    """Compile the kernel's shared library if this source's build is
    missing (`kernels/_build.py`); returns its path."""
    return _build.build(SOURCE)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.gf256_matmul_bitsliced
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                           ctypes.c_longlong, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def expand_planes(G, device) -> torch.Tensor:
    """(m,k) uint8 coefficients -> (m,k,8) int32 bit-planes on `device`,
    each plane byte replicated into all four bytes of its word (the
    kernel's coefficient operand)."""
    planes = gf_coeff_planes(G).astype(np.uint32)
    planes *= np.uint32(_LOW_BITS)
    return torch.from_numpy(planes.view(np.int32)).to(device)


def planes_for(G, device) -> torch.Tensor:
    """G's `expand_planes` on `device`, from an LRU keyed on G's shape and
    bytes: each matrix crosses host-to-device once, not once per call."""
    if isinstance(G, torch.Tensor):
        G = G.cpu().numpy()
    G = np.ascontiguousarray(G, dtype=np.uint8)
    key = (G.shape, G.tobytes(), str(torch.device(device)))
    with _lock:
        hit = _planes_cache.get(key)
        if hit is not None:
            _planes_cache.move_to_end(key)
            return hit
    planes = expand_planes(G, device)
    with _lock:
        _planes_cache[key] = planes
        if len(_planes_cache) > PLANES_CACHE_SIZE:
            _planes_cache.popitem(last=False)
    return planes


def gf256_matmul_cuda(G, X: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: G (m,k) uint8 (numpy or tensor), X (k,L) uint8
    CUDA tensor with unit column stride (any row stride, any alignment).
    Returns a (m,L) uint8 view of an output whose rows are 16-byte
    aligned."""
    global launches
    if not isinstance(X, torch.Tensor) or X.device.type != "cuda":
        raise ValueError("gf256_matmul_cuda needs a CUDA tensor")
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
    planes = planes_for(G, X.device)
    pitch = -(-L // 16) * 16
    out = torch.empty((m, pitch), dtype=torch.uint8, device=X.device)[:, :L]
    if L == 0:
        return out
    lib = _load()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = lib.gf256_matmul_bitsliced(
            planes.data_ptr(), X.data_ptr(), X.stride(0), out.data_ptr(),
            out.stride(0), m, k, L, stream)
    if rc != 0:
        raise RuntimeError(f"gf256_matmul_bitsliced launch failed: CUDA "
                           f"error {rc}")
    with _lock:
        launches += 1
    return out
