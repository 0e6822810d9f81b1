"""DTensor's collectives between processes that share one card.

Two ranks on one card cannot form an NCCL world (NCCL refuses two ranks
on one device), so the port's multi-rank runs on one card use a gloo
world. Gloo is no transport for their tensors: it moves a CUDA tensor
through host memory over loopback TCP (0.52-0.56 GB/s from the other
rank), and torch's functional all-gather, which DTensor redistributes
through, kills the process on a CUDA tensor (a segmentation fault; both
on an NVIDIA H100 80GB HBM3, torch 2.11, CUDA 12.8:
`scripts/gloo_cuda_collectives.py`).

`install()` registers kernels of the functional collectives DTensor
calls, for one dispatch key ("CUDA"), that exchange through buffers
every rank of the op's group maps: each rank's staging buffer on the
card, opened in the others through CUDA IPC (for CPU tensors, a file
in /dev/shm, which the CPU tests use). A collective copies this rank's
input into its own buffer, synchronises the device, meets the group at
a gloo barrier, reads the peers' buffers device to device, synchronises
and meets them again before any buffer is reused. Sums run in rank
order, so every rank computes the same bits. Each kernel returns the
finished result, so the later `wait_tensor` has nothing to wait for.
`moved` counts the calls, the bytes of their results and the host's
seconds inside them; `release()` drops this process's buffers (before
its group goes).
"""
from __future__ import annotations

import functools
import os
import time
import uuid
from typing import Dict, List

import torch
import torch.distributed as dist

_LIBS = {}
_EXCHANGES: Dict[tuple, "_Exchange"] = {}
moved = {"calls": 0, "bytes": 0, "seconds": 0.0}

_OPS = ("sum", "avg", "product", "min", "max")


def _group(group_name):
    if isinstance(group_name, dist.ProcessGroup):
        return group_name
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(group_name)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mapped(nbytes: int, device: torch.device, group) -> List[torch.Tensor]:
    """A new buffer of `nbytes` for this rank and every rank's, this
    rank's at its place: on the card, the peers' opened through their
    IPC handles; on the CPU, files in /dev/shm (removed once every rank
    has them open)."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    if device.type == "cuda":
        from torch.multiprocessing.reductions import reduce_tensor
        own = torch.empty(nbytes, dtype=torch.uint8, device=device)
        every = [None] * n
        dist.all_gather_object(every, reduce_tensor(own), group=group)
        return [own if r == me else fn(*args)
                for r, (fn, args) in enumerate(every)]
    token = [uuid.uuid4().hex if me == 0 else None]
    dist.broadcast_object_list(token, src=dist.get_global_rank(group, 0),
                               group=group)
    paths = [f"/dev/shm/istore-torch-exchange-{token[0]}-{r}"
             for r in range(n)]
    own = torch.from_file(paths[me], shared=True, size=nbytes,
                          dtype=torch.uint8)
    dist.barrier(group=group)
    bufs = [own if r == me else torch.from_file(
        p, shared=True, size=nbytes, dtype=torch.uint8)
        for r, p in enumerate(paths)]
    dist.barrier(group=group)
    os.unlink(paths[me])
    return bufs


class _Exchange:
    """The staging buffers of one process group's ranks on one device
    type, each mapped into every rank, grown as collectives need (every
    rank of a group calls the same collectives on the same sizes, so
    every rank grows at the same call)."""

    def __init__(self, group, device: torch.device):
        self.group, self.device = group, device
        self.me = dist.get_rank(group)
        self.cap, self.bufs = 0, []

    def stage(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Write x into this rank's buffer and meet the group: every
        rank's x, as views of the mapped buffers."""
        nbytes = x.numel() * x.element_size()
        if nbytes > self.cap:
            self.bufs = []                # the peers' old buffers first
            self.cap = max(nbytes, 2 * self.cap, 1 << 20)
            self.bufs = _mapped(self.cap, self.device, self.group)
        flat = x.contiguous().reshape(-1).view(torch.uint8)
        self.bufs[self.me][:nbytes].copy_(flat)
        _sync(self.device)
        dist.barrier(group=self.group)
        return [b[:nbytes].view(x.dtype).view(x.shape) for b in self.bufs]

    def done(self) -> None:
        """Every rank has read what it needs: the buffers may be reused."""
        _sync(self.device)
        dist.barrier(group=self.group)


def _exchange(group, device: torch.device) -> _Exchange:
    key = (group.group_name, device.type)
    if key not in _EXCHANGES:
        _EXCHANGES[key] = _Exchange(group, device)
    return _EXCHANGES[key]


def release() -> None:
    """Drop this process's exchanges: the peers' buffers, then its own."""
    for ex in _EXCHANGES.values():
        ex.bufs = []
    _EXCHANGES.clear()


def _counted(fn):
    @functools.wraps(fn)
    def call(*args):
        t = time.perf_counter()
        out = fn(*args)
        moved["seconds"] += time.perf_counter() - t
        moved["calls"] += 1
        moved["bytes"] += out.numel() * out.element_size()
        return out
    return call


def _reduced(parts: List[torch.Tensor], reduce_op: str) -> torch.Tensor:
    """The parts combined in rank order, in their dtype."""
    if reduce_op not in _OPS:
        raise ValueError(f"no reduction {reduce_op!r}")
    out = parts[0].clone()
    for p in parts[1:]:
        if reduce_op in ("sum", "avg"):
            out.add_(p)
        elif reduce_op == "product":
            out.mul_(p)
        elif reduce_op == "min":
            torch.minimum(out, p, out=out)
        else:
            torch.maximum(out, p, out=out)
    return out.div_(len(parts)) if reduce_op == "avg" else out


@_counted
def all_gather_into_tensor(input, group_size: int, group_name):
    """The inputs of the group's ranks concatenated along dim 0."""
    ex = _exchange(_group(group_name), input.device)
    out = torch.cat(ex.stage(input), dim=0)
    ex.done()
    return out


@_counted
def reduce_scatter_tensor(input, reduce_op: str, group_size: int,
                          group_name):
    """This rank's 1/group_size of dim 0 of the ranks' reduced inputs."""
    ex = _exchange(_group(group_name), input.device)
    rows = input.shape[0] // group_size
    out = _reduced([x[ex.me * rows:(ex.me + 1) * rows]
                    for x in ex.stage(input)], reduce_op)
    ex.done()
    return out


@_counted
def all_reduce(input, reduce_op: str, group_name):
    ex = _exchange(_group(group_name), input.device)
    out = _reduced(ex.stage(input), reduce_op)
    ex.done()
    return out


def all_to_all_single(input, output_split_sizes: List[int],
                      input_split_sizes: List[int], group_name):
    """Rank r's output: part r of every rank's input (split along dim 0
    by the ranks' `input_split_sizes`), in rank order, through an
    all-gather of the inputs, each padded to the longest."""
    group = _group(group_name)
    n, me = dist.get_world_size(group), dist.get_rank(group)
    every = [None] * n
    dist.all_gather_object(every, list(input_split_sizes), group=group)
    width = max(sum(s) for s in every)
    pad = input.new_zeros((width,) + input.shape[1:])
    pad[:input.shape[0]] = input
    gathered = all_gather_into_tensor(pad, n, group)
    parts = []
    for r in range(n):
        start = r * width + sum(every[r][:me])
        parts.append(gathered[start:start + every[r][me]])
    return torch.cat(parts)


def _coalesced(op, inputs, *args):
    return [op(t, *args) for t in inputs]


def install(dispatch_key: str = "CUDA") -> None:
    """Route the functional collectives of tensors under `dispatch_key`
    through the shared buffers, for the rest of the process (any group
    whose ranks can map each other's buffers: one card, one host).
    Idempotent."""
    if dispatch_key in _LIBS:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    kernels = {
        "all_gather_into_tensor": all_gather_into_tensor,
        "reduce_scatter_tensor": reduce_scatter_tensor,
        "all_reduce": all_reduce,
        "all_to_all_single": all_to_all_single,
        "all_gather_into_tensor_coalesced": functools.partial(
            _coalesced, all_gather_into_tensor),
        "reduce_scatter_tensor_coalesced": functools.partial(
            _coalesced, reduce_scatter_tensor),
        "all_reduce_coalesced": functools.partial(_coalesced, all_reduce),
    }
    for name, fn in kernels.items():
        lib.impl(name, fn, dispatch_key)
    _LIBS[dispatch_key] = lib
