"""The port's spans on the profiler's clock: every span carries its
start and end in Unix nanoseconds, an enabled plane keeps a bounded
timeline of each site's spans, and the store's daemon records its queue
wait and its host time per GET batch; a disabled plane and a store with
no plane read no clock and record nothing."""
import os
import statistics
import threading
import time

import numpy as np
import torch

from repro_torch.core import Clock, InfiniStore, StoreConfig
from repro_torch.core.ec import ECConfig
from repro_torch.core.gc_window import GCConfig
from repro_torch.obs import NOOP_CM, ObsPlane, trace

MB = 1024 * 1024


def _store(plane, **kw):
    cfg = StoreConfig(ec=ECConfig(k=4, p=2), function_capacity=8 * MB,
                      fragment_bytes=1 * MB, gc=GCConfig(gc_interval=1e9),
                      num_recovery_functions=4, enable_recovery=False,
                      obs=plane, device="cpu", **kw)
    return InfiniStore(cfg, clock=Clock(), seed=0)


def _degraded(st, keys, nbytes=300_000):
    """PUT `keys`, drain the writeback, and reclaim the function holding
    chunk #0 of the first: its GETs sweep the slabs and decode."""
    rng = np.random.default_rng(0)
    for k in keys:
        st.put(k, rng.bytes(nbytes))
    assert st.flush_writeback(timeout=60.0)
    m = st.mt.load(keys[0])
    st.inject_failure(st.chunk_map[f"{keys[0]}|{m.ver}/f0#0"])


def _count(plane, site):
    return plane.snapshot()["histograms"][site]["count"]


def test_spans_export_start_and_end_that_agree_with_dur():
    plane = ObsPlane(name="t")
    before = time.time_ns()
    with plane.span("get.decode", fragments=1) as span:
        time.sleep(0.002)
    after = time.time_ns()
    (d,) = plane.snapshot()["spans"]
    assert d["start_ns"] == span.start_ns and d["end_ns"] == span.end_ns
    assert before <= d["start_ns"] < d["end_ns"] <= after + 1_000_000
    assert d["end_ns"] - d["start_ns"] == round(span.dur_s * 1e9)
    assert abs((d["end_ns"] - d["start_ns"]) / 1e3 - d["dur_us"]) <= 0.1
    assert d["dur_us"] >= 2000 and d["tid"] == threading.get_ident()


def test_plane_clock_agrees_with_the_profilers():
    """A plane span opened around a `record_function` range holds the
    range as `torch.profiler` stamps it, each end within 50 us."""
    plane = ObsPlane(name="t")
    probes = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(21):
            with plane.span("get.decode", probe=i) as span:
                with torch.profiler.record_function(f"probe{i}"):
                    torch.ones(64).sum()
            probes.append(span)
    ranges = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("probe")}
    lead, tail = [], []
    for i, span in enumerate(probes):
        s, e = ranges[f"probe{i}"]
        lead.append((s - span.start_ns) / 1e3)
        tail.append((span.end_ns - e) / 1e3)
    # each range lies inside its span, up to the clocks' noise
    assert min(lead) > -50 and min(tail) > -50, (lead, tail)
    # and its ends lie within 50 us of the span's
    assert statistics.median(lead) < 50 and statistics.median(tail) < 50, \
        (lead, tail)


def test_timeline_is_oldest_first_and_bounded(monkeypatch):
    monkeypatch.setattr(trace, "TIMELINE_CAPACITY", 8)
    plane = ObsPlane(name="t")
    assert plane.timeline("get.decode").shape == (0, 2)
    for i in range(20):
        with plane.span("get.decode", i=i):
            pass
    with plane.span("daemon.get_many"):
        pass
    tl = plane.timeline("get.decode")
    assert tl.shape == (8, 2) and tl.dtype == np.int64
    spans = [s for s in plane.snapshot()["spans"]
             if s["site"] == "get.decode"]
    assert [s["tags"]["i"] for s in spans[-8:]] == list(range(12, 20))
    assert tl.tolist() == [[s["start_ns"], s["end_ns"]] for s in spans[-8:]]
    assert (np.diff(tl[:, 0]) >= 0).all() and (tl[:, 1] >= tl[:, 0]).all()
    assert len(plane.timeline("daemon.get_many")) == 1


def test_span_ids_carry_a_forked_childs_pid():
    plane = ObsPlane(name="t")
    with plane.span("get.decode") as span:
        pass
    assert span.pid == os.getpid()
    r, w = os.pipe()
    child = os.fork()
    if child == 0:
        try:
            with plane.span("get.decode") as span:
                pass
            os.write(w, f"{span.pid} {span.span_id}".encode())
        finally:
            os._exit(0)
    os.close(w)
    try:
        pid, span_id = os.read(r, 256).decode().split()
    finally:
        os.close(r)
        os.waitpid(child, 0)
    assert int(pid) == child and span_id.startswith(f"{child:x}.")


class _Clocks:
    """Counts calls of `time.perf_counter` and `time.time_ns` made on the
    threads named, while patched in."""

    def __init__(self, monkeypatch, threads):
        self.threads, self.calls = threads, 0
        for name in ("perf_counter", "time_ns"):
            monkeypatch.setattr(time, name, self._counting(getattr(time,
                                                                   name)))

    def _counting(self, real):
        def f():
            if threading.get_ident() in self.threads:
                self.calls += 1
            return real()
        return f


def test_disabled_plane_reads_no_clock_and_records_nothing(monkeypatch):
    """A disabled plane's methods read no clock, and neither does a
    store's GET path with it, degraded and not, on the caller's thread
    or the daemon's."""
    plane = ObsPlane(enabled=False, name="off")
    st = _store(plane)
    try:
        _degraded(st, ["a", "b"])
        st.get_many_arrays(["a"])                   # the daemon is up
        clocks = _Clocks(monkeypatch,
                         {threading.get_ident(), st._daemon_ident})
        assert plane.span("daemon.get_many") is NOOP_CM
        plane.record("daemon.get_us", 5.0)
        assert clocks.calls == 0
        out = st.get_many_arrays(["a", "b"])
        st.get_many_arrays_async(["b"]).result()
        calls = clocks.calls
        monkeypatch.undo()
        assert out["a"].numel() == out["b"].numel() == 300_000
        assert st.stats.decode_batches >= 2
    finally:
        monkeypatch.undo()
        st.close()
    assert calls == 0
    snap = plane.snapshot()
    assert snap["spans"] == []
    assert sum(h["count"] for h in snap["histograms"].values()) == 0
    for site in ("daemon.get_many", "get.decode"):
        assert plane.timeline(site).shape == (0, 2)


def test_no_plane_get_path_reads_no_clock(monkeypatch):
    """With `obs=None` a GET, degraded and not, takes no clock reading on
    the caller's thread or the daemon's; an enabled plane takes them."""
    for plane in (None, ObsPlane(name="on")):
        st = _store(plane)
        try:
            _degraded(st, ["a", "b"])
            st.get_many_arrays(["a"])               # the daemon is up
            clocks = _Clocks(monkeypatch,
                             {threading.get_ident(), st._daemon_ident})
            out = st.get_many_arrays(["a", "b"])
            st.get_many_arrays_async(["b"]).result()
            calls = clocks.calls
            monkeypatch.undo()
            assert out["a"].numel() == out["b"].numel() == 300_000
        finally:
            monkeypatch.undo()
            st.close()
        if plane is None:
            assert calls == 0
        else:
            assert calls > 0


def test_daemon_records_queue_wait_per_task_and_get_us_per_batch():
    plane = ObsPlane(name="t")
    st = _store(plane)
    try:
        _degraded(st, ["a", "b", "c"])
        wait0 = _count(plane, "daemon.queue_wait_us")
        get0 = _count(plane, "daemon.get_us")
        futs = [st.get_many_arrays_async([k]) for k in ("a", "b", "c")]
        futs.append(st.get_many_arrays_async(["a", "b"]))
        assert all(f.result() for f in futs)
        assert _count(plane, "daemon.queue_wait_us") - wait0 == 4
        assert _count(plane, "daemon.get_us") - get0 == 4
        # a task that GETs from the daemon thread itself: the inner GET
        # runs inline, so one queue wait and one more GET batch
        inner = st._submit(lambda: st.get_many_arrays(["c"])).result()
        assert inner["c"].numel() == 300_000
        assert _count(plane, "daemon.queue_wait_us") - wait0 == 5
        assert _count(plane, "daemon.get_us") - get0 == 5
        # the histogram's samples are the daemon.get_many spans' lengths
        spans = [s for s in plane.snapshot()["spans"]
                 if s["site"] == "daemon.get_many"]
        assert len(plane.timeline("daemon.get_many")) == len(spans)
    finally:
        st.close()


def test_decode_nests_under_daemon_get_many_on_the_daemon_thread():
    """The two spans the idle metrics read: each `get.decode` of a GET
    batch lies inside its `daemon.get_many`, on the daemon's thread and
    in the caller's trace."""
    plane = ObsPlane(name="t")
    st = _store(plane)
    try:
        _degraded(st, ["a", "b"])
        with plane.span("client.get_many", n=2):
            out = st.get_many_arrays_async(["a", "b"]).result()
    finally:
        st.close()
    rng = np.random.default_rng(0)
    for k in ("a", "b"):
        assert bytes(out[k].numpy()) == rng.bytes(300_000)
    spans = plane.snapshot()["spans"]
    (root,) = [s for s in spans if s["site"] == "client.get_many"]
    trace = [s for s in spans if s["trace_id"] == root["trace_id"]]
    (get,) = [s for s in trace if s["site"] == "daemon.get_many"]
    assert get["parent_id"] == root["span_id"]
    decodes = [s for s in trace if s["site"] == "get.decode"]
    assert decodes
    for child in decodes:
        assert child["parent_id"] == get["span_id"]
        assert child["tid"] == get["tid"] != root["tid"]
        assert get["start_ns"] <= child["start_ns"] <= child["end_ns"] \
            <= get["end_ns"]
    assert {s["site"] for s in trace} == {"client.get_many",
                                          "daemon.get_many", "get.decode"}
