"""Logical-axis sharding rules (t5x-style), specialized per architecture.

The JAX package's `distributed/sharding.py` on torch. Model code
annotates every param/cache leaf with logical axis names ("embed",
"heads", "vocab", ...). `make_rules(cfg, mesh)` maps those to mesh
axes, rule for rule as the reference:

  * embed        -> data   (FSDP/ZeRO: params, grads, optimizer state)
  * vocab/ff/heads/lru -> model  (tensor parallel)
  * kv_heads     -> model only when num_kv_heads % tp == 0, else the kv
                    heads are replicated and head_dim is sharded instead
                    (or, with flash_decode, the KV sequence)
  * experts      -> model for "expert" sharding (EP), expert_ff for "ffn"
  * batch        -> (pod, data) on the multi-pod mesh

A `PartitionSpec` has one entry per tensor dim (None, a mesh axis name,
or a tuple of names); `NamedSharding(mesh, spec).placements` turns it
into DTensor placements, one per mesh dim. `place` builds DTensors from
whole tensors by these shardings, `local` takes their local tensors
back where every sharded axis is this process's own (size 1, or a
per-axis region such as the compressed step's pod), and `lay_out` and
`full` lay out or gather the results of a step run on the DTensors
themselves, over axes of several ranks. Beside such a manual axis,
`per_pod` views a DTensor over the mesh without it and `from_pod` lays
the region's results out on the full mesh again.
Trees are the port's: nested dicts (and tuples) whose leaves are
tensors, or logical-axis tuples.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Dict, Iterator, Optional, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig

Axis = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), a mesh axis name, or
    a tuple of names (the dim split over those axes, the first major).
    As in JAX, a one-name tuple is kept as the name and an empty one as
    None. Equal to a tuple of the same entries."""

    def __new__(cls, *parts: Axis):
        def norm(p):
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                return None if not p else p[0] if len(p) == 1 else p
            return p
        return super().__new__(cls, (norm(p) for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _names(entry: Axis) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class NamedSharding:
    """A `PartitionSpec` on a mesh (anything with `shape` and
    `axis_names`)."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    @property
    def placements(self):
        """One DTensor placement per mesh dim (see `_placements`)."""
        return _placements(self.spec, self.mesh.axis_names)


def _placements(spec: PartitionSpec, axis_names: Tuple[str, ...]):
    """One DTensor placement per mesh dim, in mesh order: `Shard(i)`
    where the dim's name appears in entry i of `spec`, else
    `Replicate()`. Raises where a name is not a mesh axis, where a mesh
    axis appears twice, or where a tuple entry lists axes out of mesh
    order (a DTensor splits a dim over its mesh dims major-first)."""
    order = {name: i for i, name in enumerate(axis_names)}
    where: Dict[str, int] = {}
    for dim, entry in enumerate(spec):
        names = _names(entry)
        for name in names:
            if name not in order:
                raise ValueError(f"{spec}: axis {name!r} is not in "
                                 f"mesh {tuple(axis_names)}")
            if name in where:
                raise ValueError(f"{spec}: mesh axis {name!r} "
                                 f"shards dims {where[name]} and {dim}")
            where[name] = dim
        if [order[n] for n in names] != sorted(order[n] for n in names):
            raise ValueError(f"{spec}: entry {entry} is not in mesh "
                             f"order {tuple(axis_names)}")
    return tuple(Shard(where[name]) if name in where else Replicate()
                 for name in axis_names)


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def tp_size(mesh) -> int:
    return mesh.shape.get("model", 1)


def make_rules(cfg: ModelConfig, mesh, *,
               flash_decode: bool = False) -> Dict[str, Axis]:
    """flash_decode: for GQA archs with K < TP, shard the KV cache over
    the SEQUENCE/pages dim instead of head_dim (flash-decoding style)."""
    tp = tp_size(mesh)
    kv_even = cfg.num_kv_heads % tp == 0
    rules: Dict[str, Axis] = {
        "batch": dp_axes(mesh),
        "vocab": "model",
        "embed": "data" if "data" in mesh.axis_names else None,
        "ff": "model",
        "heads": "model",
        "heads_d": "model",          # rwkv fused (H*hs) output dim
        "kv_heads": "model" if kv_even else None,
        "head_dim": (None if kv_even or flash_decode else "model"),
        "kv_seq": ("model" if flash_decode and not kv_even else None),
        "lru": "model",
        "lru_blocks": None,          # block-diag gate blocks stay replicated
        "layers": None,
        "experts": None,
        "expert_ff": None,
    }
    if cfg.moe is not None:
        if cfg.moe.expert_sharding == "expert":
            rules["experts"] = "model"
        else:
            rules["expert_ff"] = "model"
    return rules


def spec_for(axes: Tuple, rules: Dict[str, Axis],
             shape: Optional[Tuple[int, ...]] = None,
             mesh=None) -> PartitionSpec:
    """Logical axes -> PartitionSpec. If `shape` (+mesh) is given, mesh
    axes that do not evenly divide the dim are dropped (replicated):
    argument shardings must divide evenly; intermediates may stay
    uneven."""
    parts = []
    for i, ax in enumerate(axes):
        r = None if ax is None else rules.get(ax, None)
        if r is not None and shape is not None and mesh is not None:
            total = 1
            for nm in _names(r):
                total *= mesh.shape.get(nm, 1)
            if total == 0 or shape[i] % total != 0:
                r = None
        parts.append(r)
    return PartitionSpec(*parts)


def sharding_for(axes: Tuple, mesh, rules: Dict[str, Axis],
                 shape: Optional[Tuple[int, ...]] = None) -> NamedSharding:
    return NamedSharding(mesh, spec_for(axes, rules, shape, mesh))


# --------------------------------------------------------------------------
# Trees
# --------------------------------------------------------------------------

def _axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, str) for a in x)


def tree_leaves(tree: Any, is_leaf: Callable[[Any], bool] = None) -> list:
    """Leaves in the reference's order: dict keys sorted, then tuples and
    lists in order."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_leaves(t, is_leaf)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Callable[[Any], bool] = None) -> Any:
    """`fn` over the leaves of `tree` and the matching leaves of `rest`,
    rebuilt in `tree`'s structure."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        for r in rest:
            if not isinstance(r, dict) or set(r) != set(tree):
                raise ValueError(f"tree keys {sorted(tree)} do not match "
                                 f"{sorted(r) if isinstance(r, dict) else r}")
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in tree}
    if isinstance(tree, (tuple, list)):
        for r in rest:
            if len(r) != len(tree):
                raise ValueError(f"tree of {len(tree)} does not match one "
                                 f"of {len(r)}")
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_shardings(axes_tree: Any, mesh, rules: Dict[str, Axis],
                   shapes_tree: Any = None):
    """Map a tree of logical-axis tuples to NamedShardings. When
    `shapes_tree` (a matching tree of tensors, meta ones included) is
    given, non-dividing mesh axes are dropped per leaf."""
    if shapes_tree is None:
        return tree_map(lambda axes: sharding_for(axes, mesh, rules),
                        axes_tree, is_leaf=_axes_leaf)
    flat_axes = tree_leaves(axes_tree, _axes_leaf)
    flat_shapes = tree_leaves(shapes_tree)
    if len(flat_axes) != len(flat_shapes):
        raise ValueError(
            f"axes tree ({len(flat_axes)} leaves) does not match shapes "
            f"tree ({len(flat_shapes)} leaves)")
    return tree_map(lambda a, s: sharding_for(a, mesh, rules, tuple(s.shape)),
                    axes_tree, shapes_tree, is_leaf=_axes_leaf)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


# --------------------------------------------------------------------------
# Placing tensors on a mesh
# --------------------------------------------------------------------------

def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def _place_one(x, sharding: NamedSharding):
    """This rank's shard of the whole tensor `x`, as a DTensor: no
    communication (every rank holds the same `x`). A shard smaller than
    `x` is a copy, so this rank holds only its part once `x` goes."""
    mesh = sharding.mesh
    dm = mesh.device_mesh
    if dm is None:
        raise ValueError(f"{mesh!r} has no DeviceMesh to place tensors on")
    placements = sharding.placements
    coord = dm.get_coordinate()
    local = x
    for m, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = dm.size(m)
            if local.shape[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of {tuple(x.shape)} does not "
                                 f"divide over {n} ranks of "
                                 f"{mesh.axis_names[m]!r}")
            local = local.chunk(n, dim=pl.dim)[coord[m]]
    if local.numel() < x.numel():
        local = local.clone()
    return DTensor.from_local(local, dm, placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def place(tree: Any, shardings: Any) -> Any:
    """Whole tensors -> DTensors by `shardings` (a matching tree of
    NamedShardings). Every rank passes the same whole tensors and keeps
    its own shard of each: the leaf itself where the shard is whole, else
    a copy of its part."""
    return tree_map(_place_one, tree, shardings)


def lay_out(tree: Any, shardings: Any) -> Any:
    """Results of a step on DTensors, laid out by `shardings`: a DTensor
    redistributed to its sharding's placements (partial sums reduced,
    shards gathered or cut by collectives), a plain tensor (the same on
    every rank) `place`d."""
    def one(x, sharding: NamedSharding):
        if not is_dtensor(x):
            return _place_one(x, sharding)
        return _redistributed(x, sharding.placements)
    return tree_map(one, tree, shardings)


def full(tree: Any) -> Any:
    """The whole tensor of every DTensor leaf (`full_tensor()`: every rank
    takes part in the gathers); plain tensors pass as they are."""
    return tree_map(lambda x: x.full_tensor() if is_dtensor(x) else x, tree)


def per_pod(x, manual: Tuple[str, ...]):
    """A DTensor over the full mesh -> the same local tensor as a DTensor
    over the mesh without the `manual` axes: the per-pod region's view,
    as the reference's `shard_map(axis_names=manual)` gives its body
    (this process's shard over a manual axis is its own whole tensor;
    the other axes stay DTensor axes). Plain tensors pass as they
    are."""
    if not is_dtensor(x):
        return x
    dm = x.device_mesh
    names = dm.mesh_dim_names
    keep = tuple(n for n in names if n not in manual)
    shape = list(x.shape)
    for m, pl in enumerate(x.placements):
        if names[m] in manual and isinstance(pl, Shard):
            shape[pl.dim] //= dm.size(m)
    placements = [pl for m, pl in enumerate(x.placements)
                  if names[m] not in manual]
    return DTensor.from_local(x.to_local(), dm[keep], placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def pod_laid_out(x, sharding: NamedSharding, manual: Tuple[str, ...]):
    """A result of the per-pod region (a DTensor over the mesh without the
    `manual` axes, `per_pod`) redistributed there to `sharding`'s
    placements with the manual axes' entries dropped."""
    if not is_dtensor(x):
        return x
    dm = x.device_mesh
    spec = PartitionSpec(*(tuple(a for a in _names(e) if a not in manual)
                           for e in sharding.spec))
    return _redistributed(x, _placements(spec, dm.mesh_dim_names))


def from_pod(x, sharding: NamedSharding, manual: Tuple[str, ...]):
    """The inverse of `per_pod`: a result of the per-pod region laid out
    by `sharding` on the full mesh, this process's local tensor kept as
    its shard (`pod_laid_out` first, then no communication: a tensor
    replicated over a manual axis is the same on every pod, one split
    over it is each pod's own part). A plain result is `place`d."""
    if not is_dtensor(x):
        return _place_one(x, sharding)
    x = pod_laid_out(x, sharding, manual)
    dm = sharding.mesh.device_mesh
    shape = list(x.shape)
    for m, pl in enumerate(sharding.placements):
        if dm.mesh_dim_names[m] in manual and isinstance(pl, Shard):
            shape[pl.dim] *= dm.size(m)
    return DTensor.from_local(x.to_local(), dm, sharding.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def local(tree: Any, manual: Tuple[str, ...] = ()) -> Any:
    """The local tensor of every DTensor leaf (plain tensors pass as they
    are). Raises where a leaf is sharded over a mesh dim larger than one
    that is not `manual`: this process holds only its shard there, which
    is not the whole tensor (a step over such dims runs on the DTensors,
    or beside manual axes on their per-pod view, `per_pod`: see
    `steps.build_cell`'s fn). `manual` names axes whose shards are this
    process's own data, as the reference's `shard_map(axis_names=...)`
    region does."""

    def one(x):
        if not is_dtensor(x):
            return x
        dm = x.device_mesh
        for m, pl in enumerate(x.placements):
            name = dm.mesh_dim_names[m]
            if isinstance(pl, Shard) and dm.size(m) > 1 \
                    and name not in manual:
                raise ValueError(
                    f"a leaf of shape {tuple(x.shape)} is sharded over mesh "
                    f"axis {name!r} of size {dm.size(m)}: only size-1 axes "
                    f"(or manual ones, {manual}) execute here")
        return x.to_local()

    return tree_map(one, tree)


# --------------------------------------------------------------------------
# Activation sharding constraints
# --------------------------------------------------------------------------
# Model code pins activation shardings via `constrain(x, logical_axes)`;
# the rules are installed process-globally, for the duration of a cell's
# `fn` (`installed_rules`), and `constrain` returns x unchanged when no
# rules are installed or x is a plain tensor. DTensors reach model code
# where a cell's arguments are split over a mesh axis of several ranks
# (its `fn` runs the step on them) and in the dry-run
# (`launch/dryrun.py`, meta DTensors); on a mesh of one rank a cell
# computes on plain tensors (`local`). Every kernel refuses a DTensor:
# the model layer calls it on each rank's local tensors through the
# helpers below (`on_shards`, `on_locals`; `zeros` for new state).

_RULES: Optional[Dict[str, Axis]] = None


def set_global_rules(rules: Optional[Dict[str, Axis]]) -> None:
    global _RULES
    _RULES = rules


def get_global_rules() -> Optional[Dict[str, Axis]]:
    return _RULES


@contextlib.contextmanager
def installed_rules(rules: Optional[Dict[str, Axis]]) -> Iterator[None]:
    """`rules` installed for the body of the `with`, the outer ones (or
    none) back after it, on an exception too."""
    outer = _RULES
    set_global_rules(rules)
    try:
        yield
    finally:
        set_global_rules(outer)


def zeros(shape: Tuple[int, ...], dtype, like, axes: Tuple):
    """torch.zeros(shape) on `like`'s device; where `like` is a DTensor
    under installed rules, a DTensor laid out by the logical `axes` on
    its mesh, each rank holding only its own zero shard."""
    if _RULES is None or not is_dtensor(like):
        return torch.zeros(shape, dtype=dtype, device=like.device)
    dm = like.device_mesh
    names = dm.mesh_dim_names
    placements = _placements(spec_for(axes, _RULES, shape, _MeshShape(dm)),
                             names)
    local_shape = list(shape)
    for m, pl in enumerate(placements):
        if isinstance(pl, Shard):
            local_shape[pl.dim] = -(-local_shape[pl.dim] // dm.size(m))
    loc = torch.zeros(local_shape, dtype=dtype,
                      device=like.to_local().device)
    return DTensor.from_local(loc, dm, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def zeros_tree(tree: Any, like, axes: Any) -> Any:
    """`zeros` for each leaf of `tree` (tensors, meta ones included: their
    shapes and dtypes), laid out by the matching logical axes of `axes`:
    a model's initial state beside a DTensor input `like`."""
    return tree_map(lambda t, ax: zeros(tuple(t.shape), t.dtype, like, ax),
                    tree, axes)


def contiguous_stride(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of `shape`."""
    stride, n = [], 1
    for size in reversed(shape):
        stride.append(n)
        n *= max(size, 1)
    return tuple(reversed(stride))


class _MeshShape:
    """A shape-only mesh (what `spec_for` reads) for a DeviceMesh."""

    def __init__(self, dm):
        self.axis_names = tuple(dm.mesh_dim_names)
        self.shape = {n: dm.size(i) for i, n in enumerate(self.axis_names)}


def constrain(x, axes: Tuple):
    """x, or for a DTensor under installed rules, x redistributed to the
    placements of `spec_for(axes, rules, x.shape)` on its own mesh. A
    mesh axis that does not divide its dim is dropped here: a DTensor's
    uneven shards do not survive its reshapes. The reference's GSPMD
    pads such a dim instead, ceil(n / size) per rank; the models pad it
    themselves where it splits their work (attention heads, RWKV6's
    heads, MoE experts): the shard-local code takes each rank's
    zero-padded part (`rank_split`, `take_padded`, with the layout
    `wanted` by the axes), and the padding is cut off where the heads
    or experts are summed out. In the backward a partial gradient is
    reduced here (DTensor's own backward would carry the partial sums
    on, and the next op gather its weights for them)."""
    if _RULES is None or not is_dtensor(x):
        return x
    dm = x.device_mesh
    placements = _placements(
        spec_for(axes, _RULES, tuple(x.shape), _MeshShape(dm)),
        dm.mesh_dim_names)
    return _Constrain.apply(x, placements)


def wanted(axes: Tuple, dm):
    """The placements on DeviceMesh `dm` of a tensor laid out by the
    logical `axes` under the installed rules, a mesh axis kept where it
    does not divide its dim (GSPMD's padded layout; see `constrain`)."""
    return _placements(spec_for(axes, _RULES or {}), dm.mesh_dim_names)


def rank_split(n: int, dm, m: int) -> Tuple[int, int]:
    """A dim of `n` split over mesh dim `m` of `dm` as GSPMD splits it:
    (ceil(n / size) per rank, this rank's first index). The last ranks'
    parts run past `n` where the size does not divide it."""
    per = -(-n // dm.size(m))
    return per, dm.get_local_rank(m) * per


def take_padded(t: torch.Tensor, dim: int, start: int,
                count: int) -> torch.Tensor:
    """t[start:start + count] along `dim`, zeros past t's end: one
    rank's part of a dim that GSPMD pads."""
    n = t.shape[dim]
    lo = min(start, n)
    part = t.narrow(dim, lo, max(0, min(count, n - lo)))
    short = count - part.shape[dim]
    if short:
        part = torch.cat([part, part.new_zeros(
            part.shape[:dim] + (short,) + part.shape[dim + 1:])], dim=dim)
    return part


def _redistributed(x, placements):
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, placements)


class _Constrain(torch.autograd.Function):
    """Redistribute; the gradient goes back to the input's layout with
    partial sums reduced (DTensor's own backward keeps a partial
    gradient partial)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.back = tuple(Replicate() if p.is_partial() else p
                         for p in x.placements)
        return _redistributed(x, placements)

    @staticmethod
    def backward(ctx, grad):
        return _redistributed(grad, ctx.back), None


def _call(fn: Callable, *xs):
    return fn(*xs)


# How `on_shards` calls its function on the local tensors: `_call`, or
# what a tracer puts here for the length of its trace (the dry-run's
# analyzer replays repeated calls).
local_call: Callable = _call


def on_shards(fn: Callable, *xs):
    """fn(*xs); for DTensors laid out alike, fn over each rank's local
    tensors (through `local_call`), the result laid out as they are. For
    work that each shard completes on its own (attention over its batch
    rows and heads), so eager code runs on plain local tensors instead
    of one DTensor dispatch per op."""
    if not is_dtensor(xs[0]):
        return fn(*xs)
    placements = xs[0].placements
    if any(p.is_partial() for p in placements):
        raise ValueError(f"on_shards takes no partial sums: {placements}")
    return on_locals(functools.partial(local_call, fn), xs,
                     (placements,) * len(xs), placements)


def on_locals(fn: Callable, xs: Tuple, in_placements: Tuple,
              out_placements, in_grad_placements: Optional[Tuple] = None):
    """fn over the local tensors of the DTensors `xs`, each first laid out
    by its entry of `in_placements` (None for an argument that is not a
    DTensor); the result a DTensor laid out by `out_placements`, and an
    input's gradient by its entry of `in_grad_placements` where given
    (`local_map`); a tuple of such layouts for a function of several
    results. The caller's placements must make each rank's shards a
    whole problem of their own."""
    from torch.distributed.tensor.experimental import local_map
    kw = {} if in_grad_placements is None else \
        {"in_grad_placements": in_grad_placements}

    def on_local(*local_xs):
        return fn(*(_ContiguousGrad.apply(x) if isinstance(x, torch.Tensor)
                    and x.requires_grad else x for x in local_xs))

    several = bool(out_placements) and isinstance(out_placements[0],
                                                  (tuple, list))
    return local_map(on_local, out_placements=tuple(out_placements)
                     if several else list(out_placements),
                     in_placements=in_placements,
                     redistribute_inputs=True, **kw)(*xs)


class _ContiguousGrad(torch.autograd.Function):
    """Identity; its gradient made contiguous. A local gradient leaves
    `local_map` as a DTensor with contiguous global strides, which its
    later views assume of the local tensor too."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()
