"""Fused RMSNorm: Hopper CUDA kernel + plain PyTorch version."""
from repro_torch.kernels.rmsnorm.ops import rms_norm_op  # noqa: F401
from repro_torch.kernels.rmsnorm.ref import rms_norm_ref  # noqa: F401
