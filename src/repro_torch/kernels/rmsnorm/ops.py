"""Public op: RMSNorm, dispatched on the input tensor's device.

A CUDA tensor runs the hand-written Hopper kernel (`kernel.py`) through
`RMSNormFunction`, which gives it a gradient; a CPU tensor takes the
plain PyTorch version (`ref.py`), which autograd differentiates. Any
other input raises — a CUDA tensor never silently falls back to the
plain version. A DTensor raises too: the model layer
(`models/layers.py:rms_norm`) calls this op on each rank's local
tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import require_plain
from repro_torch.kernels.rmsnorm.kernel import rms_norm_cuda
from repro_torch.kernels.rmsnorm.ref import rms_norm_ref


def rms_norm_backward(x: torch.Tensor, scale: torch.Tensor, eps: float,
                      dy: torch.Tensor, need_dx: bool = True,
                      need_dscale: bool = True):
    """Gradients of RMSNorm, plain PyTorch in f32 (the JAX package
    differentiates plain jnp and has no backward kernel):

        rstd = rsqrt(mean(x^2, -1) + eps),  xhat = x * rstd
        gs = dy * scale
        dx = rstd * (gs - xhat * mean(gs * xhat, -1))
        dscale = sum over rows of dy * xhat

    each cast to its input's dtype (None where not needed)."""
    xf = x.float()
    rstd = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    xhat = xf * rstd
    g = dy.float()
    dx = dscale = None
    if need_dx:
        gs = g * scale.float()
        dx = (rstd * (gs - xhat * (gs * xhat).mean(dim=-1, keepdim=True))
              ).to(x.dtype)
    if need_dscale:
        dscale = (g * xhat).reshape(-1, x.shape[-1]).sum(0).to(scale.dtype)
    return dx, dscale


class RMSNormFunction(torch.autograd.Function):
    """The RMSNorm kernel as an autograd node: the forward launches the
    kernel and saves x and scale; the backward is `rms_norm_backward`.
    With no gradient needed it saves nothing."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            ctx.save_for_backward(x, scale)
            ctx.eps = eps
        return rms_norm_cuda(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rms_norm_backward(x, scale, ctx.eps, dy,
                                       ctx.needs_input_grad[0],
                                       ctx.needs_input_grad[1])
        return dx, dscale, None


def rms_norm_op(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2, -1) + eps) * scale, in x's dtype."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"x must be a torch.Tensor, got {type(x).__name__}")
    if x.device.type == "meta":
        return rms_norm_ref(x, scale, eps)
    require_plain("rms_norm_op", x, scale)
    if x.device.type == "cuda":
        return RMSNormFunction.apply(x, scale, eps)
    if x.device.type == "cpu":
        return rms_norm_ref(x, scale, eps)
    raise ValueError(f"no RMSNorm for device {x.device}")
