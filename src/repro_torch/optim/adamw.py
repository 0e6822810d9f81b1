"""AdamW with f32 master weights, over a flat dict of parameters.

The JAX package's `optim/adamw.py` on torch tensors: the same state
(`mu`, `nu`, `master`, each a dict keyed like the parameters, and a 0-d
int32 `count`), the same warmup schedule, global-norm clipping and bias
corrections, in the same order of f32 operations. Every quantity stays
a tensor on the parameters' device, so an update makes no host sync.
The update is functional, as the reference's: it returns new tensors
and leaves its inputs as they were (a caller may still hold them, e.g.
a checkpoint of the previous step). `opt_logical_axes` gives the
state's logical axes for the sharding rules.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def _count(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def adamw_init(params: Params) -> Dict:
    """Zero moments and an f32 copy of every parameter (its own storage,
    even where the parameter is already f32), on the parameters'
    device; for DTensor parameters, DTensors laid out as they are (each
    rank allocates only its shards). The count is a plain 0-d tensor."""
    device = next(iter(params.values())).device
    return {
        "mu": {k: torch.zeros_like(p, dtype=torch.float32)
               for k, p in params.items()},
        "nu": {k: torch.zeros_like(p, dtype=torch.float32)
               for k, p in params.items()},
        "master": {k: p.detach().to(torch.float32, copy=True)
                   for k, p in params.items()},
        "count": _count(device),
    }


def abstract_opt_state(abstract_params: Params) -> Dict:
    """The state's shapes and dtypes on the meta device (no memory)."""
    def f32(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")
    return {
        "mu": {k: f32(p) for k, p in abstract_params.items()},
        "nu": {k: f32(p) for k, p in abstract_params.items()},
        "master": {k: f32(p) for k, p in abstract_params.items()},
        "count": _count("meta"),
    }


def opt_logical_axes(param_axes: Dict[str, Tuple]) -> Dict:
    """The state's logical axes: each moment and the master weights
    sharded as their parameter, the count replicated."""
    return {"mu": dict(param_axes), "nu": dict(param_axes),
            "master": dict(param_axes), "count": ()}


def _schedule(cfg: AdamWConfig, count: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(count.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def adamw_update(cfg: AdamWConfig, grads: Params, state: Dict,
                 params: Params) -> Tuple[Params, Dict, Dict]:
    """One AdamW step: returns (new params in their own dtypes, new
    state, {"grad_norm", "lr"} as 0-d device tensors)."""
    names = sorted(grads)                  # the reference's leaf order
    g32 = {k: grads[k].float() for k in names}
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g32[k])) for k in names))
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    count = state["count"] + 1
    lr = _schedule(cfg, count)
    b1c = 1.0 - cfg.b1 ** count.float()
    b2c = 1.0 - cfg.b2 ** count.float()
    mu, nu, master = {}, {}, {}
    for k in names:
        g = g32[k] * scale
        mu[k] = cfg.b1 * state["mu"][k] + (1 - cfg.b1) * g
        nu[k] = cfg.b2 * state["nu"][k] + (1 - cfg.b2) * torch.square(g)
        mhat = mu[k] / b1c
        nhat = nu[k] / b2c
        step = mhat / (torch.sqrt(nhat) + cfg.eps) \
            + cfg.weight_decay * state["master"][k]
        master[k] = state["master"][k] - lr * step
    new_params = {k: master[k].to(params[k].dtype) for k in params}
    new_state = {"mu": mu, "nu": nu, "master": master, "count": count}
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
