"""Per-rank analyzer for the roofline pass: the traced aten ops of one rank.

The JAX package's `analysis/hlo.py` walks a compiled program's optimized
HLO text. PyTorch has no HLO: `analyze(fn, *args)` runs `fn` eagerly
under a dispatch mode that sees every aten op THIS rank executes on its
own tensors, and reports the reference's `HloAnalysis`. A DTensor op is
let through (`NotImplemented`), so DTensor dispatch runs its sharding
propagation and hands the mode the local op on the local tensors;
the fake tensors that propagation computes on pass uncounted. So every
count is per rank, on local shapes, as the reference's per-device
numbers are:

  * dot/convolution FLOPs: 2 x out x contract (the reference's
    `_dot_flops`), by `torch.utils.flop_counter`'s formulas;
  * bytes accessed, by the reference's rules mapped to aten ops: views
    and reshapes are free (`_FREE`, its `_SKIP_BYTES`); slices, gathers
    and indexing count twice their result (`_SLICES`, its dynamic-slice
    / gather / slice); an in-place window write counts twice its update
    (`_UPDATES`, its scatter / dynamic-update-slice); anything else
    counts its inputs plus its outputs. These are unfused, eager bytes:
    what the port runs, more than XLA's fused count;
  * collectives by op (DTensor's redistributions and the model's own
    `torch.distributed` calls), with the reference's ring model and an
    ICI/DCN split by `pod_stride`; the group's ranks come from its
    process group;
  * `peak_bytes`: the largest sum, over the ops in eager order, of the
    bytes of the storages alive after the op. A storage is counted from
    the op that first returns a tensor on it (the arguments' from the
    start) until it is freed, whoever holds it (autograd's saved tensors
    included).

Python loops unroll in the trace: every trip is counted as it runs and
`while_trips` stays empty, since there is no loop to infer a count for.
Meta tensors, and DTensors whose local tensors are meta, trace at any
size without memory.

The trace also keeps a log of what it counted (`HloAnalysis.log`, the
text that `python -m repro_torch.launch.dryrun --save-hlo` saves): each
counted op once per signature (its aten name, the shape, stride and
dtype of every tensor in and out, its other arguments, a collective's
group ranks) with the number of times it ran, memo hits and replayed
calls included. One rule, `_Counter._count`, turns a signature into its
counts, in the trace and over a saved log alike: `analyze_hlo(text)`
re-runs the rules on meta tensors of the logged layouts and gives the
trace's flops, bytes, transcendentals and collectives without tracing
again (the reference's names; `parse_hlo` reads the log,
`bf16_upcast_f32_bytes` sums its bf16 -> f32 conversions).
"""
from __future__ import annotations

import functools
import importlib
import json
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils.flop_counter import flop_registry

# aten collective -> the reference's HLO opcode; functional collectives
# (DTensor's) and the c10d ops that `torch.distributed` calls run
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "collective-broadcast", "broadcast_": "collective-broadcast",
}

# free: views that keep every element, the splits into views (a piece
# is charged where an op reads it), allocations, iota, the waits on
# collectives (the reference skips bitcast / reshape / broadcast /
# constant / iota / parameter and every *-done)
_FREE = {
    "view", "_unsafe_view", "reshape", "expand", "expand_as", "permute",
    "transpose", "t", "unsqueeze", "squeeze", "flatten", "unflatten",
    "alias", "detach", "lift_fresh", "view_as", "view_as_real",
    "view_as_complex", "_reshape_alias", "split", "split_with_sizes",
    "chunk", "unbind", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "arange",
    "wait_tensor", "_wrap_tensor_autograd",
}
# reads of a window: twice the result
_SLICES = {
    "slice", "select", "narrow", "index", "index_select", "gather",
    "embedding",
    "take_along_dim", "diagonal", "as_strided",
}
# in-place window writes: twice the update, by its argument position
_UPDATES = {"index_put_": 2, "_index_put_impl_": 2, "index_copy_": 3,
            "scatter_": 3, "index_add_": 3, "copy_": 1}

_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "tanh",
                   "sigmoid", "rsqrt", "sqrt", "sin", "cos", "erf", "pow",
                   "_softmax", "_log_softmax", "silu", "gelu"}


@dataclass
class CollectiveStat:
    opcode: str
    count: float = 0.0
    result_bytes: float = 0.0      # sum of result sizes x multiplier
    ring_bytes: float = 0.0        # per-device ring traffic x multiplier
    dcn: bool = False
    group_size: int = 1


@dataclass
class HloAnalysis:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collectives: List[CollectiveStat] = field(default_factory=list)
    while_trips: List[int] = field(default_factory=list)
    transcendentals: float = 0.0
    peak_bytes: int = 0
    bytes_by_op: Dict[str, float] = field(default_factory=dict)
    result: Any = field(default=None, repr=False)   # what `fn` returned
    log: str = field(default="", repr=False)        # the counted ops' log

    @property
    def collective_result_bytes(self) -> float:
        return sum(c.result_bytes for c in self.collectives)

    def ring_bytes(self, dcn: Optional[bool] = None) -> float:
        return sum(c.ring_bytes for c in self.collectives
                   if dcn is None or c.dcn == dcn)

    def summary(self) -> Dict[str, float]:
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "collective_bytes": self.collective_result_bytes,
            "ici_ring_bytes": self.ring_bytes(dcn=False),
            "dcn_ring_bytes": self.ring_bytes(dcn=True),
            "num_collectives": float(sum(c.count for c in self.collectives)),
        }


def _collective_stat(opcode: str, rb: int, ranks: Sequence[int],
                     mult: float, pod_stride: int) -> CollectiveStat:
    """The reference's ring model, over a group of `ranks` (global rank
    ids) and `rb` result bytes: all-gather's is the gathered size,
    reduce-scatter's the scattered one."""
    ids = list(ranks)
    dcn = bool(ids) and (max(ids) - min(ids)) >= pod_stride
    g = max(len(ids), 1)
    if opcode == "all-reduce":
        ring = 2.0 * rb * (g - 1) / g
    elif opcode == "all-gather":
        ring = rb * (g - 1) / g          # rb is the gathered size
    elif opcode == "reduce-scatter":
        ring = rb * (g - 1)              # rb is the scattered size
    elif opcode in ("all-to-all", "ragged-all-to-all"):
        ring = rb * (g - 1) / g
    else:                                # collective-permute / broadcast
        ring = rb
    return CollectiveStat(opcode=opcode, count=mult, result_bytes=rb * mult,
                          ring_bytes=ring * mult, dcn=dcn, group_size=g)


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of an op's arguments or results (nested lists, tuples
    and dicts)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _group_ranks(args) -> List[int]:
    """The global ranks of the collective's group: a functional
    collective names it (its last string argument), a c10d op passes
    the ProcessGroup."""
    import torch.distributed as dist
    from torch._C._distributed_c10d import ProcessGroup
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in reversed(args):
        if isinstance(a, str):
            return dist.get_process_group_ranks(_resolve_process_group(a))
        if isinstance(a, torch.ScriptObject) and \
                a._type().qualified_name().endswith(".ProcessGroup"):
            return dist.get_process_group_ranks(ProcessGroup.unbox(a))
    raise ValueError("a collective without a process group")


def _in_gloo_alltoall() -> bool:
    """True inside DTensor's all-to-all on a cpu mesh, which it runs as an
    all-gather and a chunk (gloo has no all-to-all). The fake world's
    mesh is a cpu mesh standing for the cards' NCCL mesh, so the analyzer
    counts the all-to-all that NCCL runs."""
    f = sys._getframe(2)
    for _ in range(16):
        if f is None:
            return False
        if f.f_code.co_name == "shard_dim_alltoall":
            return True
        f = f.f_back
    return False


def _collective_result(name: str, args, out) -> Any:
    """The tensors a collective produces: its return value, or for the
    in-place c10d ops (names ending "_") their first argument, the
    output list (all-gather, all-to-all, reduce-scatter) or the reduced
    tensors."""
    return args[0] if name.endswith("_") else out


class _Storages:
    """Live storages of the trace: bytes by storage, freed ones found by
    a weak reference each, swept whenever the live sum would set a new
    peak (so the peak is exact and the sweeps few)."""

    def __init__(self):
        self.refs: Dict[int, tuple] = {}
        self.live = 0
        self.peak = 0

    def add(self, tensors) -> None:
        for t in tensors:
            if type(t) is not torch.Tensor and \
                    type(t) is not torch.nn.Parameter:
                continue
            s = t.untyped_storage()
            key = s._cdata
            if key in self.refs:
                continue
            nb = s.nbytes()
            self.refs[key] = (StorageWeakRef(s), nb)
            self.live += nb
        if self.live > self.peak:
            self.sweep()
            self.peak = max(self.peak, self.live)

    def sweep(self) -> None:
        dead = [k for k, (r, _) in self.refs.items() if r.expired()]
        for k in dead:
            self.live -= self.refs.pop(k)[1]


def _key(x):
    """What an op's result depends on, hashable: the shapes, strides and
    dtypes of its tensors, and its other arguments (a sequence or dict by
    its items, NaN as "nan"; a process group, a work handle or another
    unhashable object by its type's name). The memo's key and the log's
    signature."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_key(y) for y in x)
    if isinstance(x, dict):
        return tuple((k, _key(v)) for k, v in x.items())
    if isinstance(x, float) and x != x:
        return "nan"
    if isinstance(x, torch.ScriptObject) or type(x).__hash__ is None:
        return type(x).__name__
    return x


def _memoizable(func) -> bool:
    """An aten op whose results are new tensors: no view, no in-place."""
    schema = func._schema
    return (func.namespace == "aten" and not schema.is_mutable
            and all(r.alias_info is None for r in schema.returns))


# ---- the log: counted ops by signature --------------------------------

LOG_TITLE = ("# repro_torch.analysis.hlo log: one counted aten op signature "
             "a line, n = the times it ran")


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _enc(x):
    """An op's argument or result as JSON: a tensor as its layout
    {"$t": [shape, stride, dtype]}, a dtype, device, memory format or
    layout tagged, another object as its type's name."""
    if isinstance(x, torch.Tensor):
        return {"$t": [list(x.shape), list(x.stride()),
                       _dtype_name(x.dtype)]}
    if isinstance(x, (list, tuple)):
        return [_enc(y) for y in x]
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, torch.dtype):
        return {"$dtype": _dtype_name(x)}
    if isinstance(x, torch.device):
        return {"$device": str(x)}
    if isinstance(x, (torch.memory_format, torch.layout)):
        return {"$torch": str(x).removeprefix("torch.")}
    return {"$object": type(x).__name__}


def _dec(x):
    """`_enc`'s inverse, a tensor as an empty meta tensor of its layout
    (another object as None)."""
    if isinstance(x, list):
        return [_dec(y) for y in x]
    if isinstance(x, dict):
        if "$t" in x:
            shape, stride, dtype = x["$t"]
            return torch.empty_strided(shape, stride,
                                       dtype=getattr(torch, dtype),
                                       device="meta")
        if "$dtype" in x:
            return getattr(torch, x["$dtype"])
        if "$device" in x:
            return torch.device(x["$device"])
        if "$torch" in x:
            return getattr(torch, x["$torch"])
        return None
    return x


def _op(name: str):
    """The op overload a log line names ("aten.mm.default")."""
    ns, packet, overload = name.split(".")
    if ns != "aten":               # registers the collectives' ops
        importlib.import_module("torch.distributed._functional_collectives")
    return getattr(getattr(getattr(torch.ops, ns), packet), overload)


@dataclass
class LoggedOp:
    """One line of the log: an op signature and the times it ran."""
    n: int
    op: str                        # "aten.mm.default"
    args: list                     # `_enc`'s form
    kwargs: dict
    out: Any
    ranks: Optional[List[int]]     # a collective's group, else None


class _Counter(TorchDispatchMode):
    """Counts each op this rank runs on plain tensors. An op on meta
    tensors that makes new tensors runs its meta kernel once per
    signature (shapes, strides, dtypes, arguments): later calls get
    empty meta tensors of the remembered layout and the remembered
    counts (the meta kernels are Python, and the trace repeats each
    signature thousands of times). Every count is also logged by
    signature (`log`), memo hits and replayed calls as the times they
    stand for."""

    def __init__(self, res: HloAnalysis, pod_stride: int):
        super().__init__()
        self.res, self.pod_stride = res, pod_stride
        self.storages = _Storages()
        self.memo: Dict[Any, tuple] = {}
        self.memoizable: Dict[Any, bool] = {}
        self.calls: Dict[Any, tuple] = {}
        self.log: Dict[Any, list] = {}     # signature -> [times, line]
        self.memo_hits = self.replays = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if DTensor in types:
            return NotImplemented      # DTensor dispatch: local ops follow
        plain = (torch.Tensor, torch.nn.Parameter)
        if any(t not in plain for t in types):
            return func(*args, **kwargs)   # sharding propagation's fakes
        key = self._memo_key(func, args, kwargs)
        hit = self.memo.get(key) if key is not None else None
        if hit is not None:
            layouts, seq, counts, sig = hit
            outs = [torch.empty_strided(shape, stride, dtype=dtype,
                                        device="meta")
                    for shape, stride, dtype in layouts]
            self._add(*counts)
            self.log[sig][0] += 1
            self.memo_hits += 1
            self.storages.add(outs)
            return tuple(outs) if seq else outs[0]
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(type(t) not in plain for t in outs):
            return out                 # sharding propagation's fakes
        if _in_gloo_alltoall():
            self._gloo_alltoall(func, args, outs)
            return out
        ranks = _group_ranks(args) \
            if func.overloadpacket.__name__ in _COLLECTIVE_OPS else None
        counts, coll = self._count(func, args, kwargs, out, ranks,
                                   self.pod_stride)
        sig = self._log(func, args, kwargs, out, ranks, key)
        self._add(*counts)
        if coll is not None:
            self.res.collectives.append(coll)
        self.storages.add(outs)
        seq = isinstance(out, (tuple, list))
        if key is not None and outs and (not seq or len(outs) == len(out)):
            self.memo[key] = ([(tuple(t.shape), t.stride(), t.dtype)
                               for t in outs], seq, counts, sig)
        return out

    def _gloo_alltoall(self, func, args, outs) -> None:
        """An op of DTensor's all-gather-and-chunk stand-in for an
        all-to-all: its all-gather counts, and is logged, as the
        all-to-all NCCL runs (this rank's shard in, a tensor of its
        layout out), its copy of the kept chunk as the result, the rest
        as nothing."""
        name = func.overloadpacket.__name__
        if name == "all_gather_into_tensor":
            a2a = torch.ops._c10d_functional.all_to_all_single.default
            a2a_args = (args[0], [], [], args[-1])
            out = torch.empty_like(args[0], device="meta")
            ranks = _group_ranks(args)
            counts, coll = self._count(a2a, a2a_args, {}, out, ranks,
                                       self.pod_stride)
            self._log(a2a, a2a_args, {}, out, ranks)
            self._add(*counts)
            self.res.collectives.append(coll)
        elif name == "clone":
            self.storages.add(outs)

    def _memo_key(self, func, args, kwargs):
        ok = self.memoizable.get(func)
        if ok is None:
            ok = self.memoizable[func] = _memoizable(func)
        tensors = _tensors((args, kwargs))
        if not ok or not tensors or any(t.device.type != "meta"
                                        for t in tensors):
            return None
        return (func, _key(args), _key(kwargs))

    def _log(self, func, args, kwargs, out, ranks, memo_key=None):
        """Log one run of an op: the first of its signature adds a line
        (its arguments' and results' layouts, no tensor kept), later
        ones its count. A memoizable meta op's memo key is its signature
        (its results' layouts follow from it). Returns the signature."""
        sig = memo_key if memo_key is not None else (
            func, _key(args), _key(kwargs), _key(out),
            None if ranks is None else tuple(ranks))
        entry = self.log.get(sig)
        if entry is None:
            self.log[sig] = [1, (str(func), _enc(args),
                                 {k: _enc(v) for k, v in kwargs.items()},
                                 _enc(out), ranks)]
        else:
            entry[0] += 1
        return sig

    def log_text(self) -> str:
        """The log as text: a title, a JSON line of totals (ops run,
        signatures, memo hits, replayed calls), then one JSON line per
        signature."""
        lines = [LOG_TITLE, "# " + json.dumps({
            "ops": sum(n for n, _ in self.log.values()),
            "signatures": len(self.log), "memo_hits": self.memo_hits,
            "replays": self.replays})]
        for n, (op, args, kwargs, out, ranks) in self.log.values():
            lines.append(json.dumps(
                {"n": n, "op": op, "args": args, "kwargs": kwargs,
                 "out": out, "ranks": ranks}, separators=(",", ":")))
        return "\n".join(lines) + "\n"

    def _add(self, name, flops, nbytes, transcendentals) -> None:
        res = self.res
        res.flops += flops
        if nbytes:
            res.bytes_accessed += nbytes
            res.bytes_by_op[name] = res.bytes_by_op.get(name, 0) + nbytes
        res.transcendentals += transcendentals

    @staticmethod
    def _count(func, args, kwargs, out, ranks, pod_stride: int):
        """The rules: (name, flops, bytes, transcendentals) of one op on
        these arguments and results, and its `CollectiveStat` over the
        global `ranks` of its group (None for an op that is not a
        collective). Reads only layouts, arguments and ranks, so a
        logged signature's meta tensors give the trace's counts."""
        name = func.overloadpacket.__name__
        packet = func.overloadpacket
        flops = 0
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
        nbytes = 0
        coll = None
        if name in _COLLECTIVE_OPS:
            result = _collective_result(name, args, out)
            coll = _collective_stat(_COLLECTIVE_OPS[name], _nbytes(result),
                                    ranks, 1.0, pod_stride)
            nbytes = _nbytes(result) + _nbytes(
                [a for a in args if a is not result])
        elif name in _SLICES:
            nbytes = 2 * _nbytes(out)
        elif name in _UPDATES:
            nbytes = 2 * _nbytes(args[_UPDATES[name]])
        elif name not in _FREE:
            nbytes = _nbytes((args, kwargs)) + _nbytes(out)
        trans = sum(t.numel() for t in _tensors(out)) \
            if name in _TRANSCENDENTAL else 0
        return (name, flops, nbytes, trans), coll

    def call(self, fn, args):
        """fn(*args), or the replay of an earlier call of the same `fn`
        on arguments of the same layout (see `replayed`)."""
        key = (_fn_key(fn), _key(args))
        hit = self.calls.get(key)
        st, res = self.storages, self.res
        st.sweep()
        if hit is not None:
            layouts, seq, (flops, nbytes, by_op, trans, colls, peak), \
                logged = hit
            res.flops += flops
            res.bytes_accessed += nbytes
            for name, b in by_op.items():
                res.bytes_by_op[name] = res.bytes_by_op.get(name, 0) + b
            res.transcendentals += trans
            res.collectives.extend(colls)
            for sig, n in logged:
                self.log[sig][0] += n
            self.replays += 1
            st.peak = max(st.peak, st.live + peak)
            outs = [torch.empty_strided(shape, stride, dtype=dtype,
                                        device="meta")
                    for shape, stride, dtype in layouts]
            st.add(outs)
            return tuple(outs) if seq else outs[0]
        before = (res.flops, res.bytes_accessed, dict(res.bytes_by_op),
                  res.transcendentals, len(res.collectives),
                  {sig: e[0] for sig, e in self.log.items()})
        entry, outer_peak = st.live, st.peak
        st.peak = entry
        out = fn(*args)
        outs = _tensors(out)
        st.sweep()
        peak, st.peak = st.peak - entry, max(outer_peak, st.peak)
        by_op = {k: v - before[2].get(k, 0)
                 for k, v in res.bytes_by_op.items()
                 if v != before[2].get(k, 0)}
        logged = [(sig, e[0] - before[5].get(sig, 0))
                  for sig, e in self.log.items()
                  if e[0] != before[5].get(sig, 0)]
        seq = isinstance(out, (tuple, list))
        self.calls[key] = (
            [(tuple(t.shape), t.stride(), t.dtype) for t in outs], seq,
            (res.flops - before[0], res.bytes_accessed - before[1], by_op,
             res.transcendentals - before[3],
             res.collectives[before[4]:], peak), logged)
        return out


def _fn_key(fn):
    if isinstance(fn, functools.partial):
        return (fn.func, fn.args, tuple(sorted(fn.keywords.items())))
    return fn


def replayed(fn, *args):
    """fn(*args). Under `analyze`, for meta tensors that record no
    gradient, a call of the same `fn` on arguments of the same layout as
    an earlier call replays that call's counts (flops, bytes, collectives
    and its rise of the live bytes over their level at the call) and
    returns fresh meta tensors of its results' layout. For a function of
    its arguments' shapes alone that a trace calls once a layer (the
    attention's block loops): every call is still counted, once
    traced."""
    modes = [m for m in _get_current_dispatch_mode_stack()
             if isinstance(m, _Counter)]
    tensors = _tensors(args)
    if not modes or any(t.device.type != "meta" or t.requires_grad
                        for t in tensors) or torch.is_grad_enabled() \
            and any(t.requires_grad for t in tensors):
        return fn(*args)
    return modes[-1].call(fn, args)


def _local_tensors(tree) -> List[torch.Tensor]:
    from torch.distributed.tensor import DTensor
    return [x._local_tensor if isinstance(x, DTensor) else x
            for x in _tensors(tree)]


def analyze(fn, *args, pod_stride: int = 256) -> HloAnalysis:
    """Run `fn(*args)` and count this rank's work (see the module's
    docstring); the analysis holds `fn`'s return value as `result` and
    the log of the counted ops as `log`.
    For the trace, `sharding.local_call` is `replayed`, so repeated
    `sharding.on_shards` calls replay their first.
    `pod_stride` is the rank distance at which a group spans pods: a
    collective whose group spans it is DCN."""
    from repro_torch.distributed import sharding
    res = HloAnalysis()
    counter = _Counter(res, pod_stride)
    counter.storages.add(_local_tensors(args))
    outer, sharding.local_call = sharding.local_call, replayed
    try:
        with counter:
            res.result = fn(*args)
    finally:
        sharding.local_call = outer
    res.peak_bytes = counter.storages.peak
    res.log = counter.log_text()
    return res


# ---- a saved log, re-analyzed: the reference's names -------------------

def parse_hlo(text: str) -> List[LoggedOp]:
    """The op signatures of a saved log (`HloAnalysis.log`), with the
    times each ran."""
    return [LoggedOp(**json.loads(line)) for line in text.splitlines()
            if line and not line.startswith("#")]


def log_totals(text: str) -> Dict[str, int]:
    """A saved log's totals: ops run, signatures, memo hits and
    replayed calls."""
    lines = text.splitlines()
    assert lines and lines[0] == LOG_TITLE, "not an analysis log"
    return json.loads(lines[1][2:])


def analyze_hlo(text: str, *, pod_stride: int = 256) -> HloAnalysis:
    """flops, bytes_accessed, bytes_by_op, transcendentals and
    collectives of a saved log, by `_Counter._count` on meta tensors of
    each signature's layouts times the times it ran: the live trace's
    counts under the rules as they are now, without tracing. Memory
    (`peak_bytes`), `while_trips` and `result` are the trace's alone."""
    res = HloAnalysis()
    for e in parse_hlo(text):
        (name, flops, nbytes, trans), coll = _Counter._count(
            _op(e.op), _dec(e.args), {k: _dec(v) for k, v in
                                      e.kwargs.items()},
            _dec(e.out), e.ranks, pod_stride)
        res.flops += flops * e.n
        if nbytes:
            res.bytes_accessed += nbytes * e.n
            res.bytes_by_op[name] = res.bytes_by_op.get(name, 0) \
                + nbytes * e.n
        res.transcendentals += trans * e.n
        if coll is not None:
            coll.count *= e.n
            coll.result_bytes *= e.n
            coll.ring_bytes *= e.n
            res.collectives.append(coll)
    return res


# a conversion and the position of the tensor it converts
_CONVERSIONS = {"_to_copy": 0, "copy_": 1, "copy": 1}


def bf16_upcast_f32_bytes(text: str, min_bytes: int = 128 * 2**20) -> int:
    """The bytes of the DISTINCT f32 shapes of at least `min_bytes` that
    a logged conversion (`_to_copy`, `copy_`) produced from a bf16
    tensor, one buffer per shape (the reference's count over its HLO's
    `convert`s). The dry-run records it as `f32_upcast_bytes`."""
    shapes: Dict[tuple, int] = {}
    for e in parse_hlo(text):
        ns, packet, _ = e.op.split(".")
        pos = _CONVERSIONS.get(packet)
        if ns != "aten" or pos is None or len(e.args) <= pos:
            continue
        src = e.args[pos]
        if not (isinstance(src, dict) and "$t" in src
                and src["$t"][2] == "bfloat16"):
            continue
        for t in _tensors(_dec(e.out)):
            nbytes = t.numel() * t.element_size()
            if t.dtype == torch.float32 and nbytes >= min_bytes:
                shapes[tuple(t.shape)] = nbytes
    return int(sum(shapes.values()))
