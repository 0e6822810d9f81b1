"""The train step: gradient accumulation over microbatches + AdamW.

The JAX package's `launch/steps.py::make_train_step` on torch tensors.
The sharded and compressed steps and the serve steps wait for the
distributed part of the port.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.registry import Model
from repro_torch.optim import adamw


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics).

    batch tensors have a leading num_microbatches dim. Each microbatch's
    gradients are taken with `torch.autograd.grad` and summed in f32 (a
    Python loop where the reference scans), so activation memory stays
    one microbatch deep; the sum is divided by n before the AdamW update.
    Metrics are 0-d device tensors: a step makes no host sync.
    """
    def train_step(params: Dict[str, torch.Tensor], opt_state, batch):
        names = sorted(params)
        leaves = [params[k].detach().requires_grad_(True) for k in names]
        live = dict(zip(names, leaves))
        n = next(iter(batch.values())).shape[0]
        g_sum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves]
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
        for i in range(n):
            loss, _ = model.loss_fn(live, {k: v[i] for k, v in batch.items()})
            grads = torch.autograd.grad(loss, leaves)
            for acc, g in zip(g_sum, grads):
                acc.add_(g.float())
            loss_sum = loss_sum + loss.detach()
        grads = {k: g / n for k, g in zip(names, g_sum)}
        new_params, new_opt, om = adamw.adamw_update(opt_cfg, grads,
                                                     opt_state, params)
        return new_params, new_opt, {"loss": loss_sum / n, **om}

    return train_step
