"""Cross-pod gradient compression with error feedback.

The JAX package's `optim/compression.py` on torch. Across pods the
gradient mean crosses the slow link, so each pod exchanges its gradients
as int8 with one f32 scale per leaf, and carries the quantization
residual into the next step (error feedback: Seide et al. 2014,
Karimireddy et al. 2019), so compression error does not accumulate.

Mechanics: each process of the pod group holds its pod's gradients (the
train step computes them over the pod's part of the batch); every leaf
is quantized, the int8 payloads and the scales are all-gathered over
the group, and each rank reduces the gathered tensors locally in the
reference's order, so the mean is bit-identical on every rank. The
intra-pod reductions stay full precision.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import is_dtensor

Tree = Dict[str, torch.Tensor]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale); both
    `round`s round half to even, as `jnp.round` does."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_decompress(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Round-trip quantization; returns (xhat, residual)."""
    q, s = quantize_int8(x)
    xhat = dequantize(q, s)
    return xhat, x - xhat


def all_gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's `x` over `group`, in rank order. A DTensor (the
    dry-run's per-pod region, on the mesh without the pod axis) gathers
    its local shard: the ranks of a pod group hold the same shard of
    their own pods' tensors."""
    if is_dtensor(x):
        from torch.distributed.tensor import DTensor
        return [DTensor.from_local(part, x.device_mesh, x.placements,
                                   run_check=False, shape=x.shape,
                                   stride=x.stride())
                for part in all_gather(x.to_local(), group)]
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x, group=group)
    return out


def psum_compressed(grads: Tree, group, errors: Tree) -> Tuple[Tree, Tree]:
    """Error-feedback compressed mean over the ranks of `group` (each
    holding its pod's gradients). Exchanges the int8 payloads and one
    f32 scale per leaf by `all_gather`; the mean is
    sum_i s_i * q_i / n, reduced by every rank in the same order.
    Returns (mean_grads, new_errors), keyed like `grads`."""
    n = dist.get_world_size(group)
    mean, new_err = {}, {}
    for k in sorted(grads):                 # the reference's leaf order
        g = grads[k].to(torch.float32) + errors[k]        # error feedback
        q, s = quantize_int8(g)
        new_err[k] = g - dequantize(q, s)
        qs = all_gather(q, group)                         # (n, ...) int8
        ss = all_gather(s.reshape(1), group)              # (n,) f32
        mean[k] = combine(ss, qs) / n
    return mean, new_err


def combine(ss: List[torch.Tensor], qs: List[torch.Tensor]) -> torch.Tensor:
    """sum_i s_i * q_i in f32: the reference's `tensordot` over the
    gathered axis. DTensors (every pod's copy of one shard) combine their
    local tensors, which line up element for element."""
    if is_dtensor(qs[0]):
        from torch.distributed.tensor import DTensor
        q = qs[0]
        return DTensor.from_local(
            combine([x.to_local() for x in ss], [x.to_local() for x in qs]),
            q.device_mesh, q.placements, run_check=False, shape=q.shape,
            stride=q.stride())
    return torch.tensordot(torch.cat(ss), torch.stack(qs).to(torch.float32),
                           dims=([0], [0]))


def dcn_bytes_per_step(params, *, compressed: bool) -> int:
    """Analytic per-step cross-pod traffic: f32 gradients, or int8 and one
    f32 scale per leaf. `params` is a dict tree of tensors (meta ones
    included)."""
    from repro_torch.distributed.sharding import tree_leaves
    leaves = tree_leaves(params)
    total = sum(int(p.numel()) for p in leaves)
    return total + 4 * len(leaves) if compressed else 4 * total
