"""Plain PyTorch RMSNorm: the kernel's reference, and what a CPU tensor
runs. Same arithmetic as the JAX package's `rms_norm_ref`: f32 mean of
squares, rsqrt, scale, cast back to x's dtype."""
from __future__ import annotations

import torch


def rms_norm_ref(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
