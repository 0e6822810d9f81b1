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
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # the kernel's type codes

launches = 0                     # kernel launches made by this process
_lock = threading.Lock()         # guards the library and `launches`
_lib = None


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
                           ctypes.c_float, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def rms_norm_cuda(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Launch the kernel: x (..., d) float32 or bfloat16 CUDA tensor,
    scale (d,) float32 or bfloat16 on the same card. Returns a new
    tensor of x's shape and dtype."""
    global launches
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
    vec = int(d * x.element_size() % 16 == 0
              and all(t.data_ptr() % 16 == 0 for t in (x, scale, out)))
    lib = _load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.rmsnorm_forward(x.data_ptr(), scale.data_ptr(),
                                 out.data_ptr(), rows, d, float(eps),
                                 DTYPES[x.dtype], DTYPES[scale.dtype], vec,
                                 stream)
    if rc != 0:
        raise RuntimeError(f"rmsnorm_forward launch failed: CUDA error {rc}")
    with _lock:
        launches += 1
    return out
