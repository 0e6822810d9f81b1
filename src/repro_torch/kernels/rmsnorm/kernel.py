"""Hopper CUDA kernel: fused RMSNorm over the last dimension.

Replaces the JAX package's `rmsnorm/kernel.py::_kernel`; the design and
its bound are described at the top of `csrc/rmsnorm.cu`.

The source is compiled with `nvcc` for `sm_90a` into a shared library
with a plain C entry point (built at first use by `kernels/_build.py`
under `build/repro_torch/`, keyed by a hash of the source) and called
through `ctypes` on PyTorch's current stream. Importing this module
builds nothing; a failed build or launch raises — there is no fallback
to the plain version. `launches` counts the kernel launches this process
made.
"""
from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from pathlib import Path

import torch

from repro_torch.kernels import _build, require_plain

SOURCE = Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # the kernel's type codes

MAX_VEC = 8          # 16-byte vectors one lane holds in registers
MAX_WARPS = 8        # warps that share one row of the register tile
PACK_BYTES = 256     # rows up to this width share a warp
BLOCK = 128          # threads per block of the packed and one-warp layouts
LOOP_THREADS = 256   # threads per row of the loop kernels, at most

launches = 0                     # kernel launches made by this process
_lock = threading.Lock()         # guards the library and `launches`
_lib = None


@dataclass(frozen=True)
class Layout:
    """How the kernel lays a (rows, d) input on the card (the C entry
    point's `kind`, `vec`, `lanes`, `warps`, `rpb`, `threads`)."""
    kind: str       # "tile" (register tile), "loop" (16-byte), "scalar"
    vec: int        # 16-byte vectors per lane (tile), else 0
    lanes: int      # lanes per row: < 32 packs 32 // lanes rows in a warp
    warps: int      # warps per row
    rpb: int        # rows per block
    threads: int    # threads per block

    @property
    def code(self) -> int:
        return {"tile": 0, "loop": 1, "scalar": 2}[self.kind]


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def plan(d: int, elem: int, aligned: bool = True, rows: int = 0,
         sms: int = 0) -> Layout:
    """The layout for `rows` rows of `d` elements of `elem` bytes on a
    card of `sms` SMs.

    16-byte access (`aligned`, and a row a multiple of 16 bytes) takes
    the register tile while a row fits in MAX_WARPS warps x MAX_VEC
    vectors a lane: rows of at most PACK_BYTES share a warp, rows of at
    most 32 x MAX_VEC vectors take one warp, wider rows the fewest warps
    that hold them; anything else loops over the row. When the blocks
    would leave SMs idle (the decode step's 16 rows), a row wider than
    PACK_BYTES is spread over as many warps as take it at one vector a
    lane, up to MAX_WARPS, so its loads and sums are split over more
    threads."""
    row_bytes = d * elem
    if not aligned or row_bytes % 16:
        threads = min(LOOP_THREADS, max(32, _pow2_at_least(d)))
        return Layout("scalar", 0, 32, threads // 32, 1, threads)
    nvec = row_bytes // 16
    if row_bytes <= PACK_BYTES:
        lanes = _pow2_at_least(nvec)
        return Layout("tile", 1, lanes, 1, BLOCK // lanes, BLOCK)
    if nvec > 32 * MAX_VEC * MAX_WARPS:
        return Layout("loop", 0, 32, LOOP_THREADS // 32, 1, LOOP_THREADS)
    warps = -(-nvec // (32 * MAX_VEC))
    blocks = -(-rows // (BLOCK // 32)) if warps == 1 else rows
    if blocks < sms:                # SMs left idle: one vector a lane
        warps = max(warps, min(MAX_WARPS, -(-nvec // 32)))
    if warps == 1:
        return Layout("tile", -(-nvec // 32), 32, 1, BLOCK // 32, BLOCK)
    return Layout("tile", -(-nvec // (32 * warps)), 32, warps, 1,
                  32 * warps)


def build() -> Path:
    """Compile the kernel's shared library if this source's build is
    missing; returns its path."""
    return _build.build(SOURCE)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.rmsnorm_forward
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_float] + [ctypes.c_int] * 8 + [
                               ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def rms_norm_cuda(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Launch the kernel: x (..., d) float32 or bfloat16 CUDA tensor,
    scale (d,) float32 or bfloat16 on the same card. Returns a new
    tensor of x's shape and dtype."""
    global launches
    require_plain("rms_norm_cuda", x, scale)
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError("rms_norm_cuda needs a CUDA tensor")
    if x.dtype not in DTYPES or scale.dtype not in DTYPES:
        raise ValueError(f"RMSNorm kernel takes float32 or bfloat16, got "
                         f"x {x.dtype}, scale {scale.dtype}")
    if x.dim() == 0 or scale.shape != x.shape[-1:]:
        raise ValueError(f"scale {tuple(scale.shape)} does not match the "
                         f"last dim of x {tuple(x.shape)}")
    if scale.device != x.device:
        raise ValueError(f"scale is on {scale.device}, x on {x.device}")
    x = x.contiguous()
    scale = scale.contiguous()
    out = torch.empty_like(x)
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    if rows == 0 or d == 0:
        return out
    lay = plan(d, x.element_size(),
               all(t.data_ptr() % 16 == 0 for t in (x, scale, out)), rows,
               _build.sm_count(x.device))
    lib = _load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.rmsnorm_forward(x.data_ptr(), scale.data_ptr(),
                                 out.data_ptr(), rows, d, float(eps),
                                 DTYPES[x.dtype], DTYPES[scale.dtype],
                                 lay.code, lay.vec, lay.lanes, lay.warps,
                                 lay.rpb, lay.threads, stream)
    if rc != 0:
        raise RuntimeError(f"rmsnorm_forward launch failed: CUDA error {rc}")
    with _lock:
        launches += 1
    return out
