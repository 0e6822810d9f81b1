"""`ObsPlane` — the unified observability plane one store (or one
worker process) records into: tracing + latency histograms + flight
recorder behind a single handle.

Cost discipline (mirrors `repro_torch.core.faults.FaultPlan`): the plane is
OFF by default — `StoreConfig.obs` is None and every instrumentation
site is guarded by one `obs is not None` check. An attached-but-
disabled plane (`enabled=False`) costs one early-returning method call
per site, and its methods read no clock (`tests/test_torch_obs_timeline.py`
holds them to that). Only an enabled plane allocates spans and touches
buckets.

Timelines: an enabled plane also keeps, per span site, the
(start_ns, end_ns) of its last `TIMELINE_CAPACITY` spans on the Unix
clock that `torch.profiler` stamps its events with (`timeline(site)`),
so a traced run can say what the store was doing in each stretch the
device sat idle. Like the rings, a timeline is per process.

Process model: the plane pickles into worker processes with the
`StoreConfig` that carries it (like `FaultPlan`, each process gets an
INDEPENDENT copy — fresh rings, fresh buckets, its own mmap flight file
bound under that worker's spill directory). The parent re-assembles the
global view by RPC-ing each worker's `snapshot()` and merging with
`merge_metric_snapshots` — histograms sum bucket-wise, spans stitch by
`trace_id`, flight events concatenate.

`ISTORE_METRICS_DUMP=<path>` registers an atexit hook that dumps the
merged Prometheus text of every live plane in the process.
"""
from __future__ import annotations

import atexit
import os
import weakref
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from repro_torch.obs import trace as _trace
from repro_torch.obs.metrics import (LatencyHistogram, merge_counts, summarize,
                               to_prometheus)
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.sites import HISTOGRAM_SITES, METRIC_SITES
from repro_torch.obs.trace import NOOP_CM, Tracer

_PLANES: "weakref.WeakSet[ObsPlane]" = weakref.WeakSet()
_ATEXIT_INSTALLED = [False]


def _atexit_dump(path: str) -> None:
    planes = [p for p in list(_PLANES) if p.enabled]
    if not planes:
        return
    merged = merge_metric_snapshots([p.snapshot() for p in planes])
    try:
        with open(path, "w") as f:
            f.write(to_prometheus(merged))
    except OSError:
        pass                                  # best-effort exit hook


def _register_plane(plane: "ObsPlane") -> None:
    _PLANES.add(plane)
    path = os.environ.get("ISTORE_METRICS_DUMP")
    if path and not _ATEXIT_INSTALLED[0]:
        _ATEXIT_INSTALLED[0] = True
        atexit.register(_atexit_dump, path)


class ObsPlane:
    """One process's observability plane; see the module docstring."""

    def __init__(self, *, enabled: bool = True, name: str = "",
                 span_capacity: int = 4096,
                 event_capacity: int = 256):
        self.enabled = enabled
        self.name = name
        self.epoch: Optional[int] = None
        self._span_capacity = span_capacity
        self._event_capacity = event_capacity
        self._tracer = Tracer(span_capacity)
        self._hists: Dict[str, LatencyHistogram] = {
            site: LatencyHistogram() for site in sorted(HISTOGRAM_SITES)}
        self._recorder = FlightRecorder(event_capacity)
        # forensics loaded from dead workers' flight files; leaf lock.
        # (Constructor-time import: repro_torch.core layers import repro_torch.obs,
        # so a module-level core import here would be circular.)
        from repro_torch.core.locks import make_lock
        self._flock = make_lock("plane.ObsPlane._flock")
        self._forensics: List[Dict] = []
        _register_plane(self)

    # ---- site API (every call below takes a literal registered in
    # ---- obs.METRIC_SITES; the metric_site lint rule enforces it) ----

    def span(self, site: str, **tags):
        """Context manager opening one span as a child of the ambient
        context. Disabled plane: a shared no-op CM, no allocation."""
        if not self.enabled:
            return NOOP_CM
        return self._tracer.start(self, site, tags)

    def record(self, site: str, value_us: float) -> None:
        """One lock-free histogram sample (microseconds)."""
        if self.enabled:
            self._hists[site].record(value_us)

    def event(self, site: str, **fields) -> None:
        """One flight-recorder event (ring + mmap mirror)."""
        if self.enabled:
            if self.epoch is not None:
                fields.setdefault("epoch", self.epoch)
            self._recorder.event(site, **fields)

    # ---- context propagation ---------------------------------------------

    def ctx(self) -> Optional[Tuple[str, str]]:
        """The ambient (trace_id, span_id) pair to attach to an RPC or
        executor hop; None when disabled or outside any span."""
        if not self.enabled:
            return None
        return _trace.current()

    def adopt(self, ctx: Optional[Tuple[str, str]]):
        """Install a propagated context pair for a region (worker-side
        dispatch, executor task bodies)."""
        return _trace.use(ctx)

    def bind_current(self, fn: Callable) -> Callable:
        """Close `fn` over the ambient context so an executor hop keeps
        the trace: the returned callable re-installs the submitter's
        context. Returns `fn` unchanged when there is nothing to carry."""
        ctx = self.ctx()
        if ctx is None:
            return fn

        def _traced(*a, **kw):
            with _trace.use(ctx):
                return fn(*a, **kw)

        return _traced

    # ---- lifecycle --------------------------------------------------------

    def bind_flight(self, path: str) -> bool:
        """Attach the mmap flight mirror (first bind wins — one file
        per crash domain/process)."""
        if not self.enabled:
            return False
        return self._recorder.bind(path)

    @property
    def flight_path(self) -> Optional[str]:
        return self._recorder.path

    def set_epoch(self, epoch: int) -> None:
        """Adopt a (new) connection epoch: subsequent spans and events
        are tagged with it, so post-reconnect activity is attributable
        to its epoch."""
        self.epoch = epoch

    def close(self) -> None:
        self._recorder.close()

    def _finish_span(self, span) -> None:
        self._tracer.add(span)
        # mirror to the flight file so a SIGKILL'd worker's spans are
        # recoverable (tagged with their epoch) instead of lost; the
        # clock fields stay out, or the record outgrows its slot
        if self._recorder.path is not None:
            d = span.to_dict()
            for k in ("start_ns", "end_ns", "tid"):
                del d[k]
            d["kind"] = "span"
            self._recorder.mirror(d)

    # ---- timelines ----------------------------------------------------------

    def timeline(self, site: str):
        """(start_ns, end_ns) of the site's last `TIMELINE_CAPACITY`
        (2^17) finished spans in this process, oldest first: an (n, 2)
        int64 array, empty for a site with no span."""
        return self._tracer.timeline(site)

    # ---- forensics --------------------------------------------------------

    def add_forensics(self, source: str, records: List[Dict],
                      **tags) -> None:
        """Attach records recovered from a dead process's flight file;
        they surface under `snapshot()["forensics"]`, tagged dead=True
        plus whatever the caller knows (shard id, last epoch)."""
        with self._flock:
            self._forensics.append(
                {"source": source, "dead": True, **tags,
                 "records": list(records)})

    # ---- export -----------------------------------------------------------

    def snapshot(self) -> Dict:
        hists = {site: {"buckets": h.snapshot()}
                 for site, h in self._hists.items()}
        for site, d in hists.items():
            d.update(summarize(d["buckets"]))
        with self._flock:
            forensics = [dict(f) for f in self._forensics]
        return {"enabled": self.enabled, "name": self.name,
                "pid": os.getpid(), "epoch": self.epoch,
                "sites": sorted(METRIC_SITES),
                "histograms": hists,
                "spans": self._tracer.snapshot(),
                "events": self._recorder.snapshot(),
                "forensics": forensics,
                "flight_path": self._recorder.path}

    # ---- pickling (into worker processes) ---------------------------------

    def __getstate__(self) -> Dict:
        return {"enabled": self.enabled, "name": self.name,
                "span_capacity": self._span_capacity,
                "event_capacity": self._event_capacity}

    def __setstate__(self, state: Dict) -> None:
        self.__init__(enabled=state["enabled"], name=state["name"],
                      span_capacity=state["span_capacity"],
                      event_capacity=state["event_capacity"])


def merge_metric_snapshots(snaps: Iterable[Dict]) -> Dict:
    """Merge plane snapshots (parent + per-worker) into one store-wide
    view: histograms sum bucket-wise (then re-summarized), spans /
    events / forensics concatenate. Input dicts are not mutated."""
    snaps = [s for s in snaps if s]
    out: Dict = {"enabled": any(s.get("enabled") for s in snaps),
                 "pid": os.getpid(),
                 "sites": sorted(METRIC_SITES),
                 "histograms": {}, "spans": [], "events": [],
                 "forensics": []}
    all_sites: set = set()
    for s in snaps:
        all_sites.update(s.get("histograms", {}))
    for site in sorted(all_sites):
        counts = merge_counts(
            [s["histograms"][site]["buckets"] for s in snaps
             if site in s.get("histograms", {})])
        out["histograms"][site] = {"buckets": counts, **summarize(counts)}
    for s in snaps:
        out["spans"].extend(s.get("spans", ()))
        for ev in s.get("events", ()):
            ev = dict(ev)
            if s.get("name"):
                ev.setdefault("source", s["name"])
            out["events"].append(ev)
        out["forensics"].extend(s.get("forensics", ()))
    counters: Dict[str, float] = {}
    for s in snaps:
        for k, v in (s.get("counters") or {}).items():
            counters[k] = counters.get(k, 0) + v
    if counters:
        out["counters"] = counters
    return out
