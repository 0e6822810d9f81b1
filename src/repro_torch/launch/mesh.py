"""Meshes: named axes over the ranks of a `torch.distributed` world.

The JAX package's `launch/mesh.py` on torch. A `Mesh` holds the axis
sizes by name (`shape`), the axis names in order (`axis_names`) and,
where one was built, the torch `DeviceMesh` over the current process
group; `distributed/sharding.py` reads only `shape` and `axis_names`,
so a shape-only mesh (`Mesh({"data": 16, "model": 16})`) is enough for
the sharding rules. One rank is one process on one device: the
reference's `compat_make_mesh` / `compat_shard_map` shims across JAX
versions have no counterpart (a per-axis region is ordinary code that
passes the axis's process group to its collectives, `Mesh.group`).

Building a mesh never touches a device or a process group at import.
The dry-run's production meshes live on a fake world (`init_fake_world`:
256 or 512 ranks in one process, torch's `fake` backend), whose
`DeviceMesh` is a `cpu` mesh: the reference's 512 placeholder CPU
devices. `HW` is the H100's roofline model.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.payload import require_device


class Mesh:
    """Axis sizes by name, in order, and the `DeviceMesh` when built."""

    def __init__(self, shape: Dict[str, int], device_mesh=None):
        self.shape: Dict[str, int] = dict(shape)
        self.axis_names: Tuple[str, ...] = tuple(shape)
        self.device_mesh = device_mesh

    def group(self, axis: str):
        """The process group of this rank along `axis`."""
        if self.device_mesh is None:
            raise ValueError("a shape-only mesh has no process groups")
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        dims = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        return f"Mesh({dims})"


def _device_mesh(shape: Dict[str, int], device: str) -> Mesh:
    """A `Mesh` whose `DeviceMesh` spans the current world. Where no
    process group is initialised and the mesh has one rank, this starts
    a world of one (NCCL on the card, gloo on the CPU) on an in-memory
    store; a larger mesh needs the caller's process group."""
    dev = require_device(device)
    n = math.prod(shape.values())
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(f"a mesh of {n} ranks needs a process group "
                               f"of {n}: call torch.distributed."
                               f"init_process_group first")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_world_size() != n:
        raise RuntimeError(f"mesh {shape} has {n} ranks, the process group "
                           f"{dist.get_world_size()}")
    if dev.type == "cuda":        # this process's card, not a guess by rank
        torch.cuda.set_device(dev if dev.index is not None
                              else torch.cuda.current_device())
        if dist.get_backend() == "gloo":
            # ranks sharing a card: DTensor's collectives through buffers
            # they share (gloo's TCP is slow, its all-gather fails here)
            from repro_torch.distributed import shared_card
            shared_card.install("CUDA")
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(dev.type, tuple(shape.values()),
                          mesh_dim_names=tuple(shape))
    return Mesh(shape, dm)


def init_fake_world(ranks: int) -> None:
    """Make this process rank 0 of a world of `ranks` ranks on torch's
    `fake` backend, whose collectives move nothing and return at once: a
    `DeviceMesh` over it (on "cpu") has every process group of the real
    mesh, for tracing on meta tensors. A process has one default group,
    so a fake world needs a process of its own."""
    # importing the module registers the backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=ranks)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "cuda") -> Mesh:
    """The reference's (16, 16) ("data", "model") mesh, or (2, 16, 16)
    with "pod": needs a world of 256 or 512 ranks (the dry-run's fake
    world, with `device="cpu"`)."""
    shape = {"pod": 2, "data": 16, "model": 16} if multi_pod \
        else {"data": 16, "model": 16}
    need = math.prod(shape.values())
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != need:
        raise RuntimeError(f"the production mesh needs {need} ranks, the "
                           f"world has {have}")
    return _device_mesh(shape, device)


def make_test_mesh(data: int = 1, model: int = 1, *, pod: int = 0,
                   device: str = "cuda") -> Mesh:
    """A small mesh ("data", "model"), or ("pod", "data", "model") with
    `pod`, over the current world (on the card unless `device` says
    otherwise)."""
    shape: Dict[str, int] = {"pod": pod} if pod else {}
    shape.update(data=data, model=model)
    return _device_mesh(shape, device)


# NVIDIA H100 SXM5 80 GB model used by the roofline analysis (per card).
# The keys are the reference's (its TPU v5e model); every number here is
# the H100's.
HW = {
    # FLOP/s, dense bf16 (no sparsity): NVIDIA H100 SXM5 datasheet
    "peak_flops_bf16": 989e12,
    # B/s, HBM3: the same datasheet
    "hbm_bw": 3.35e12,
    # B/s per direction, NVLink 4 (the datasheet's 900 GB/s is both
    # directions); on 8-card nodes a 16-rank axis also crosses nodes
    "ici_bw": 450e9,
    # B/s per card across nodes: one 400 Gb/s NDR port per GPU
    # (assumption, as the reference's own figure is)
    "dcn_bw": 50e9,
    # bytes: the card's own `total_memory` (torch.cuda), as
    # chip_smoke.py phase 14 prints it: an NVIDIA H100 80GB HBM3 at 700 W
    "hbm_bytes": 85_017_493_504,
}
