"""Mixture-of-experts FFN with sort-based capacity dispatch, on torch
tensors.

The JAX package's `models/moe.py`: tokens pick top-k experts; (token,
expert) pairs are sorted by expert id and packed into a static
(E, C, d) dispatch buffer per sequence (capacity
C = ceil(S*k/E * capacity_factor)); overflow pairs are dropped (their
residual path passes through unchanged, as in Switch/GShard).
`moe_ffn_dense` is the O(E)-FLOPs oracle the property tests use.

What differs is PyTorch idiom, never which pairs are kept:
`dispatch_indices` takes any leading batch dims (the reference vmaps it
over sequences) and sorts with `torch.argsort(stable=True)` and a
batched `torch.searchsorted`; JAX's out-of-bounds `.at[].set(mode=
"drop")` becomes a scatter into one extra slot that is then cut off; the
combine is `index_put_(accumulate=True)`, which sums the duplicate
indices (a token's k pairs, the pad row's many empty slots).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.models.layers import activate


def router_probs(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                 xf: torch.Tensor):
    """xf: (T, d) -> (probs (T,E) f32, gate_vals (T,k), expert_ids (T,k))."""
    m = cfg.moe
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, m.top_k, dim=-1)
    if m.renorm_topk:
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_vals, expert_ids


def aux_load_balance(probs: torch.Tensor, expert_ids: torch.Tensor,
                     num_experts: int) -> torch.Tensor:
    """Switch-style load-balance loss: E * sum_e f_e * P_e."""
    T, k = expert_ids.shape
    counts = torch.bincount(expert_ids.reshape(-1),
                            minlength=num_experts).float()
    f = counts / (T * k)
    P = probs.mean(dim=0)
    return num_experts * torch.sum(f * P)


def capacity(cfg: ModelConfig, group_tokens: int) -> int:
    """Per-group expert capacity (groups = sequences; see moe_ffn)."""
    m = cfg.moe
    c = int(-(-group_tokens * m.top_k * m.capacity_factor // m.num_experts))
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def dispatch_indices(expert_ids: torch.Tensor, gate_vals: torch.Tensor,
                     num_experts: int, cap: int):
    """Sort (token, expert) pairs by expert and pack into (E*C,) slots.

    expert_ids, gate_vals: (..., T, k), each leading index a dispatch
    group of its own. Returns (disp, gate_slot), each (..., E*C):
    disp[(e*C + c)] = token index (or T if the slot is empty / token
    dropped), gate_slot = the matching gate weight.
    """
    *lead, T, k = expert_ids.shape
    n, slots = T * k, num_experts * cap
    flat_e = expert_ids.reshape(-1, n)                       # (G, T*k)
    sort_idx = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, -1, sort_idx)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_in_e = torch.arange(n, device=flat_e.device) - first
    # a dropped pair goes to slot E*C, one past the end, cut off below
    slot = torch.where(pos_in_e < cap, sorted_e * cap + pos_in_e, slots)
    token_of = sort_idx // k
    G = flat_e.shape[0]
    disp = torch.full((G, slots + 1), T, dtype=torch.int32,
                      device=flat_e.device)
    disp.scatter_(-1, slot, token_of.to(torch.int32))
    gate_flat = torch.gather(gate_vals.reshape(-1, n).float(), -1, sort_idx)
    gate_slot = torch.zeros((G, slots + 1), dtype=torch.float32,
                            device=flat_e.device)
    gate_slot.scatter_(-1, slot, gate_flat)
    return (disp[:, :slots].reshape(*lead, slots),
            gate_slot[:, :slots].reshape(*lead, slots))


def moe_ffn(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B,S,d), aux_loss scalar).

    GShard-style GROUP-LOCAL dispatch: each sequence is a dispatch group
    with its own capacity C = ceil(S*k*cf/E)."""
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.num_experts, m.top_k
    probs, gate_vals, expert_ids = router_probs(cfg, p, x.reshape(B * S, d))
    aux = aux_load_balance(probs, expert_ids, E)
    cap = capacity(cfg, S)
    disp, gate_slot = dispatch_indices(expert_ids.reshape(B, S, k),
                                       gate_vals.reshape(B, S, k), E, cap)
    idx = disp.long()                                        # (B, E*C)
    xpad = torch.cat([x, x.new_zeros((B, 1, d))], dim=1)
    xd = torch.gather(xpad, 1, idx[..., None].expand(B, E * cap, d))
    xd = constrain(xd.reshape(B, E, cap, d),
                   ("batch", "experts", None, None))        # (B, E, C, d)
    h = activate(torch.einsum("becd,edf->becf", xd, p["we_gate"]), cfg.act)
    h = h * torch.einsum("becd,edf->becf", xd, p["we_up"])
    y = torch.einsum("becf,efd->becd", h, p["we_down"])     # (B, E, C, d)
    y = y.float() * gate_slot.reshape(B, E, cap, 1)
    out = torch.zeros((B, S + 1, d), dtype=torch.float32, device=x.device)
    rows = torch.arange(B, device=x.device)[:, None].expand(B, E * cap)
    out.index_put_((rows, idx), y.reshape(B, E * cap, d), accumulate=True)
    return constrain(out[:, :S].to(x.dtype), ("batch", None, None)), aux


def moe_ffn_dense(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                  x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(E) oracle: every expert computed for every token, combined with
    the same top-k gates. No capacity, no drops — the tests compare
    `moe_ffn` against this wherever no token exceeds capacity."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    probs, gate_vals, expert_ids = router_probs(cfg, p, xf)
    aux = aux_load_balance(probs, expert_ids, m.num_experts)
    h = activate(torch.einsum("td,edf->etf", xf, p["we_gate"]), cfg.act)
    h = h * torch.einsum("td,edf->etf", xf, p["we_up"])
    y = torch.einsum("etf,efd->etd", h, p["we_down"])       # (E, T, d)
    w = torch.zeros((T, m.num_experts), dtype=torch.float32,
                    device=x.device)
    w.scatter_add_(1, expert_ids, gate_vals.float())
    out = torch.einsum("etd,te->td", y.float(), w)
    return out.reshape(B, S, d).to(x.dtype), aux
