"""Public op: paged decode attention, dispatched on q's device.

A CUDA tensor launches the hand-written Hopper kernels (`kernel.py`); a
CPU tensor takes the plain PyTorch version (`ref.py`). Any other input
raises — a CUDA tensor never silently falls back to the plain version.
A DTensor raises too: the model layer (`models/transformer.py:
_paged_kernel`) calls this op on each rank's local shards.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import require_plain
from repro_torch.kernels.paged_attention.kernel import \
    paged_decode_attention_cuda
from repro_torch.kernels.paged_attention.ref import paged_decode_attention_ref


def paged_decode_attention(q, k_pool, v_pool, block_table, lens):
    """Decode attention over an SMS-paged KV pool.

    q: (B, H, hd); pools: (B, P, ps, K, hd); block_table: (B, P) int32;
    lens: (B,) int32. Returns (B, H, hd) in q.dtype."""
    if not isinstance(q, torch.Tensor):
        raise TypeError(f"q must be a torch.Tensor, got {type(q).__name__}")
    require_plain("paged_decode_attention", q, k_pool, v_pool, block_table,
                  lens)
    if q.device.type == "cuda":
        return paged_decode_attention_cuda(q, k_pool, v_pool, block_table,
                                           lens)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, block_table,
                                          lens).to(q.dtype)
    raise ValueError(f"no paged decode attention for device {q.device}")
