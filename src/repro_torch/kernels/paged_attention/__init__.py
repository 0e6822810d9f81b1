"""Paged decode attention: Hopper CUDA kernels + plain PyTorch version."""
from repro_torch.kernels.paged_attention.ops import \
    paged_decode_attention  # noqa: F401
from repro_torch.kernels.paged_attention.ref import \
    paged_decode_attention_ref  # noqa: F401
