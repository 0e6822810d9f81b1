"""Lightweight per-op tracing: spans, ambient context, propagation.

A *span* is one timed stage of one operation: `trace_id` names the
whole operation (stable across threads, processes, and transport
epochs), `span_id` names this stage, `parent_id` stitches it under the
stage that caused it. Trace context is ambient — a thread-local
`(trace_id, span_id)` pair — so instrumentation never threads explicit
arguments through call chains:

- same thread: a nested `span()` reads the ambient pair and parents
  itself automatically;
- executor hop (client daemon, GET I/O pool, writeback writer, leader
  pool): the submitter captures `current()` and the task re-installs it
  with `use()` (see `ObsPlane.bind_current`);
- process hop: the parent attaches the pair to the RPC payload
  (`host._ShardProxy._rpc`) and the worker adopts it around dispatch,
  so worker-side spans carry the parent's `trace_id` across both the
  pipe and the TCP transport — including across reconnect epochs (the
  pair is plain data; a retransmitted frame carries the same trace).

Span ids are `<pid-hex>.<counter>` so ids never collide across worker
processes; trace ids are 64-bit random hex. Finished spans land in a
bounded ring (newest win) — collection is `ObsPlane`'s job.

Clock: a span's `start_ns` is `time.time_ns()` at open and its `end_ns`
that plus the `perf_counter` duration at close — Unix nanoseconds, the
clock `torch.profiler` stamps its host and device events with, so a
span can be laid over a profiler trace. Beside the ring, the tracer
keeps a *timeline* per site: the (start_ns, end_ns) of the site's last
`TIMELINE_CAPACITY` finished spans in two preallocated int64 arrays.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from array import array
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

# spans a site's timeline keeps: a 51 s window at 1,000 GETs a second
TIMELINE_CAPACITY = 1 << 17

# ambient trace context: (trace_id, span_id) of the innermost open span
_tls = threading.local()

# this process's id, read once and again in a forked child: `os.getpid`
# is a system call, which costs microseconds on some hosts, and
# every span needs it twice
_pid = os.getpid()


def _read_pid() -> None:
    global _pid
    _pid = os.getpid()


os.register_at_fork(after_in_child=_read_pid)


def current() -> Optional[Tuple[str, str]]:
    """The ambient (trace_id, span_id) pair, or None outside any span."""
    return getattr(_tls, "ctx", None)


class use:
    """Install a (trace_id, span_id) pair as the ambient context for a
    region — the adoption half of every propagation hop."""
    __slots__ = ("_ctx", "_prev")

    def __init__(self, ctx: Optional[Tuple[str, str]]):
        self._ctx = tuple(ctx) if ctx is not None else None

    def __enter__(self):
        self._prev = getattr(_tls, "ctx", None)
        _tls.ctx = self._ctx
        return self._ctx

    def __exit__(self, *exc) -> bool:
        _tls.ctx = self._prev
        return False


class Span:
    """One finished (or in-flight) timed stage."""
    __slots__ = ("trace_id", "span_id", "parent_id", "site", "t0",
                 "dur_s", "start_ns", "end_ns", "tags", "pid", "tid",
                 "epoch")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str], site: str,
                 tags: Optional[Dict] = None,
                 epoch: Optional[int] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.site = site
        self.start_ns = time.time_ns()
        self.t0 = time.perf_counter()
        self.dur_s: Optional[float] = None
        self.end_ns: Optional[int] = None
        self.tags = tags or {}
        self.pid = _pid
        self.tid = threading.get_ident()
        self.epoch = epoch

    def to_dict(self) -> Dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "site": self.site,
                "dur_us": None if self.dur_s is None
                else round(self.dur_s * 1e6, 1),
                "start_ns": self.start_ns, "end_ns": self.end_ns,
                "pid": self.pid, "tid": self.tid, "epoch": self.epoch,
                "tags": dict(self.tags)}


class _SpanHandle:
    """Context manager for one span: opens it as a child of the ambient
    context, installs itself as the ambient context for the body, and
    reports the finished span back to the plane on exit."""
    __slots__ = ("_tracer", "_plane", "_site", "_tags", "_span", "_prev")

    def __init__(self, tracer: "Tracer", plane, site: str, tags: Dict):
        self._tracer = tracer
        self._plane = plane
        self._site = site
        self._tags = tags

    def __enter__(self) -> Span:
        parent = getattr(_tls, "ctx", None)
        if parent is None:
            trace_id = os.urandom(8).hex()
            parent_id = None
        else:
            trace_id, parent_id = parent
        span_id = f"{_pid:x}.{next(self._tracer._ids)}"
        self._span = Span(trace_id, span_id, parent_id, self._site,
                          self._tags, epoch=self._plane.epoch)
        self._prev = parent
        _tls.ctx = (trace_id, span_id)
        return self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        _tls.ctx = self._prev
        span = self._span
        span.dur_s = time.perf_counter() - span.t0
        span.end_ns = span.start_ns + round(span.dur_s * 1e9)
        if exc_type is not None:
            span.tags["error"] = exc_type.__name__
        self._plane._finish_span(span)
        return False


class _Noop:
    """Shared no-op context manager: what `span()` hands out when the
    plane is disabled, so disabled sites cost one branch and no
    allocation."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


NOOP_CM = _Noop()


class _Timeline:
    """(start_ns, end_ns) of one site's last `capacity` finished spans,
    in two int64 arrays made once. A slot is one GIL-atomic `next()` of
    an `itertools.count`, so appends from any thread take no lock; a
    read taken while spans finish may miss the newest."""
    __slots__ = ("_starts", "_ends", "_cap", "_slot")

    def __init__(self, capacity: int):
        self._starts = array("q", bytes(8 * capacity))
        self._ends = array("q", bytes(8 * capacity))
        self._cap = capacity
        self._slot = itertools.count(0)

    def add(self, start_ns: int, end_ns: int) -> None:
        i = next(self._slot) % self._cap
        self._starts[i] = start_ns
        self._ends[i] = end_ns

    def intervals(self) -> np.ndarray:
        """(n, 2) int64, oldest first (in the order the spans finished)."""
        n, cap = self._slot.__reduce__()[1][0], self._cap
        order = np.arange(n - min(n, cap), n) % cap
        return np.stack([np.frombuffer(self._starts, np.int64)[order],
                         np.frombuffer(self._ends, np.int64)[order]], axis=1)


class Tracer:
    """Bounded ring of finished spans, and each site's timeline. Appends
    are a single GIL-atomic `deque.append` (maxlen evicts the oldest)
    and one timeline slot, so recording takes no lock — the same
    multi-writer discipline as `AtomicCounter`."""

    def __init__(self, capacity: int = 4096):
        self._ring: deque = deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._timelines: Dict[str, _Timeline] = {}

    def start(self, plane, site: str, tags: Dict) -> _SpanHandle:
        return _SpanHandle(self, plane, site, tags)

    def add(self, span: Span) -> None:
        self._ring.append(span)
        tl = self._timelines.get(span.site)
        if tl is None:
            # made on the site's first span; setdefault keeps one winner
            # if two threads race here
            tl = self._timelines.setdefault(
                span.site, _Timeline(TIMELINE_CAPACITY))
        tl.add(span.start_ns, span.end_ns)

    def timeline(self, site: str) -> np.ndarray:
        tl = self._timelines.get(site)
        if tl is None:
            return np.zeros((0, 2), dtype=np.int64)
        return tl.intervals()

    def snapshot(self) -> List[Dict]:
        return [s.to_dict() for s in list(self._ring)]
