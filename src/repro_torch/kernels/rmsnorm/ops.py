"""Public op: RMSNorm, dispatched on the input tensor's device.

A CUDA tensor launches the hand-written Hopper kernel (`kernel.py`); a
CPU tensor takes the plain PyTorch version (`ref.py`). Any other input
raises — a CUDA tensor never silently falls back to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.kernel import rms_norm_cuda
from repro_torch.kernels.rmsnorm.ref import rms_norm_ref


def rms_norm_op(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2, -1) + eps) * scale, in x's dtype."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"x must be a torch.Tensor, got {type(x).__name__}")
    if x.device.type == "cuda":
        return rms_norm_cuda(x, scale, eps)
    if x.device.type == "cpu":
        return rms_norm_ref(x, scale, eps)
    raise ValueError(f"no RMSNorm for device {x.device}")
