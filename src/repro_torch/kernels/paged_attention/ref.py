"""Plain PyTorch paged decode attention: the kernel's reference, and what
a CPU tensor runs.

Gathers the paged pool into logical order (a full copy of the cache,
which the kernel avoids) and runs masked decode attention in f32, as the
JAX package's `paged_decode_attention_ref` does.
"""
from __future__ import annotations

import math

import torch


def paged_decode_attention_ref(q, k_pool, v_pool, block_table, lens):
    """q: (B, H, hd); k_pool/v_pool: (B, P, ps, K, hd); block_table: (B, P)
    int32 logical->physical; lens: (B,) int32 number of valid tokens.
    Returns (B, H, hd) f32."""
    B, H, hd = q.shape
    _, P, ps, K, hd2 = k_pool.shape
    assert hd == hd2 and H % K == 0
    rows = torch.arange(B, device=q.device)[:, None]
    idx = block_table.long()
    k = k_pool[rows, idx].reshape(B, P * ps, K, hd)
    v = v_pool[rows, idx].reshape(B, P * ps, K, hd)
    G = H // K
    qk = q.reshape(B, K, G, hd).float()
    s = torch.einsum("bkgd,btkd->bkgt", qk, k.float()) * (1.0 / math.sqrt(hd))
    pos = torch.arange(P * ps, device=q.device)
    mask = pos[None, :] < lens.to(q.device)[:, None]          # (B, T)
    s = torch.where(mask[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    return out.reshape(B, H, hd)
