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

import functools
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import (Partial, Replicate, Shard,
                                              constrain, is_dtensor,
                                              on_locals)
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
    if is_dtensor(expert_ids):
        counts = _counts_local(expert_ids, num_experts)
    else:
        counts = torch.bincount(expert_ids.reshape(-1),
                                minlength=num_experts).float()
    f = counts / (T * k)
    P = probs.mean(dim=0)
    return num_experts * torch.sum(f * P)


def _counts_local(expert_ids, num_experts: int):
    """Pairs per expert of a DTensor's ids: each rank counts its own
    tokens (the reference's scatter-add form; a count has no DTensor
    strategy), a partial sum over the dims that split them."""
    pl = tuple(expert_ids.placements)

    def count(ids):
        flat = ids.reshape(-1).long()
        return torch.zeros(num_experts, dtype=torch.float32,
                           device=ids.device).index_add_(
            0, flat, torch.ones(flat.shape, dtype=torch.float32,
                                device=ids.device))

    return on_locals(count, (expert_ids,), (pl,), tuple(
        Partial() if isinstance(p, Shard) else Replicate() for p in pl))


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
    if is_dtensor(expert_ids):
        # each rank's own groups (sequences, split over the batch)
        pl = tuple(p if p == Shard(0) else Replicate()
                   for p in expert_ids.placements)
        return on_locals(functools.partial(
            dispatch_indices, num_experts=num_experts, cap=cap),
            (expert_ids, gate_vals), (pl, pl), (pl, pl))
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
    if is_dtensor(x):
        return constrain(_experts_local(cfg, p, x, disp, gate_slot, cap),
                         ("batch", None, None)), aux
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


_EXPERT_AXES = {"we_gate": ("experts", "embed", "expert_ff"),
                "we_up": ("experts", "embed", "expert_ff"),
                "we_down": ("experts", "expert_ff", "embed")}


def _experts_local(cfg: ModelConfig, p, x, disp, gate_slot, cap: int):
    """`moe_ffn`'s experts and combine on DTensors, each rank on its own
    rows and its own experts (or expert_ff columns), as the reference's
    `("experts", ...)` layouts split them: the expert weights gathered
    over the dims that split their d, and where the rules split the
    experts (or expert_ff) over a dim on which a weight is whole (60
    experts over 16 ranks), each rank takes its zero-padded part of it
    (`sharding.rank_split`: 4 of 64). The result is a partial sum over
    the dims that split the experts or expert_ff."""
    m = cfg.moe
    E = m.num_experts
    dm = x.device_mesh
    n = dm.ndim
    R, P = Replicate(), Partial()
    rows = tuple(Shard(0) if pl == Shard(0) else R for pl in x.placements)
    names = sorted(_EXPERT_AXES)
    w_pl, w_grad, cuts = [], [], {k: [] for k in names}
    split = [False] * n
    e_range = (E, 0)
    for k in names:
        w, axes = p[k], _EXPERT_AXES[k]
        want = sharding.wanted(axes, dm)
        keep, grad = [], []
        for i, pl in enumerate(w.placements):
            wd = want[i].dim if isinstance(want[i], Shard) else None
            if isinstance(pl, Shard) and axes[pl.dim] != "embed":
                keep.append(pl)
                grad.append(pl)
                split[i] = True
                if pl.dim == 0:
                    e_range = sharding.rank_split(E, dm, i)
                continue
            keep.append(R)
            grad.append(P if rows[i] != R else R)
            if pl == R and wd is not None and axes[wd] != "embed":
                cuts[k].append((wd,) + sharding.rank_split(
                    w.shape[wd], dm, i))
                grad[-1] = P
                split[i] = True
                if wd == 0:
                    e_range = sharding.rank_split(E, dm, i)
        w_pl.append(tuple(keep))
        w_grad.append(tuple(grad))
    per, e0 = e_range

    def experts(xl, dl, gl, *ws):
        ws = dict(zip(names, ws))
        for k in names:
            for dim, cnt, start in cuts[k]:
                ws[k] = sharding.take_padded(ws[k], dim, start, cnt)
        B, S, d = xl.shape
        idx = sharding.take_padded(dl.reshape(B, E, cap), 1, e0,
                                   per).reshape(B, per * cap).long()
        gs = sharding.take_padded(gl.reshape(B, E, cap), 1, e0, per)
        xpad = torch.cat([xl, xl.new_zeros((B, 1, d))], dim=1)
        xd = torch.gather(xpad, 1, idx[..., None].expand(B, per * cap, d))
        xd = xd.reshape(B, per, cap, d)
        h = activate(torch.einsum("becd,edf->becf", xd, ws["we_gate"]),
                     cfg.act)
        h = h * torch.einsum("becd,edf->becf", xd, ws["we_up"])
        y = torch.einsum("becf,efd->becd", h, ws["we_down"])
        y = y.float() * gs.reshape(B, per, cap, 1)
        out = torch.zeros((B, S + 1, d), dtype=torch.float32,
                          device=xl.device)
        rws = torch.arange(B, device=xl.device)[:, None].expand(B, per * cap)
        out.index_put_((rws, idx), y.reshape(B, per * cap, d),
                       accumulate=True)
        return out[:, :S].to(xl.dtype)

    part = tuple(P if split[i] else rows[i] for i in range(n))
    return on_locals(
        experts, (x, disp, gate_slot) + tuple(p[k] for k in names),
        (rows, rows, rows) + tuple(w_pl), part,
        in_grad_placements=(part, rows, part) + tuple(w_grad))


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
