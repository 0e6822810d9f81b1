"""Recovery on the observability plane: a store whose reclaimed functions
are read back records one `recovery.session` span and one
`recovery.session_us` sample per recovery (local and parallel alike),
exports the chunks and bytes restored with its counters, and records
nothing with recovery off or with no plane."""
import numpy as np
import pytest

from repro_torch.core import Clock, InfiniStore, StoreConfig
from repro_torch.core.ec import ECConfig
from repro_torch.core.gc_window import GCConfig
from repro_torch.obs import ObsPlane

MB = 1024 * 1024


def _store(plane, *, recovery=True, groups=4):
    cfg = StoreConfig(ec=ECConfig(k=4, p=2), function_capacity=8 * MB,
                      fragment_bytes=1 * MB, gc=GCConfig(gc_interval=1e9),
                      num_recovery_functions=groups,
                      enable_recovery=recovery, obs=plane, device="cpu")
    return InfiniStore(cfg, clock=Clock(), seed=0)


def _fill(st, n):
    rng = np.random.default_rng(1)
    keys = [f"k{i}" for i in range(n)]
    want = {k: rng.bytes(20_000) for k in keys}
    for k, v in want.items():
        st.put(k, v)
    assert st.flush_writeback(timeout=60.0)
    return want


def _reclaim_and_read(st, want, slots):
    """Reclaim the function holding chunk #slot of the first key, for
    each slot in turn, and read every key after each."""
    k0 = next(iter(want))
    m = st.mt.load(k0)
    for idx in slots:
        st.inject_failure(st.chunk_map[f"{k0}|{m.ver}/f0#{idx}"])
        for k, v in want.items():
            assert st.get(k) == v


def _count(plane, site):
    return plane.snapshot()["histograms"][site]["count"]


@pytest.mark.parametrize("kind,keys", [("local", 3), ("parallel", 12)])
def test_one_span_and_one_sample_per_recovery(kind, keys):
    plane = ObsPlane(name="t")
    st = _store(plane)
    try:
        want = _fill(st, keys)
        _reclaim_and_read(st, want, [0, 1, 2])
        stats = st.recovery.stats
        done = stats.local_recoveries + stats.parallel_recoveries
        assert done == 3
        assert getattr(stats, f"{kind}_recoveries") == 3
        rows = plane.timeline("recovery.session")
        assert len(rows) == 3 and (rows[:, 1] > rows[:, 0]).all()
        assert _count(plane, "recovery.session_us") == 3
        spans = [s for s in plane.snapshot()["spans"]
                 if s["site"] == "recovery.session"]
        assert len(spans) == 3
        # each session runs inside the GET that found its function cold
        gets = {s["span_id"] for s in plane.snapshot()["spans"]
                if s["site"] == "daemon.get_many"}
        assert all(s["parent_id"] in gets for s in spans)
        counters = st.snapshot_metrics()["counters"]
        assert counters["recovery_chunks"] == stats.chunks_recovered > 0
        assert counters["recovery_bytes"] == stats.bytes_recovered > 0
        assert counters[f"recovery_{kind}"] == 3
    finally:
        st.close()


def test_nothing_is_entered_with_recovery_off(monkeypatch):
    plane = ObsPlane(name="t")
    st = _store(plane, recovery=False)
    entered = []
    monkeypatch.setattr(InfiniStore, "_recover",
                        lambda self, fid: entered.append(fid))
    try:
        want = _fill(st, 12)
        _reclaim_and_read(st, want, [0])
        assert entered == []
        assert len(plane.timeline("recovery.session")) == 0
        assert _count(plane, "recovery.session_us") == 0
        assert st.snapshot_metrics()["counters"]["recovery_chunks"] == 0
        # the reads went through the plane all the same
        assert _count(plane, "daemon.get_us") > 0
    finally:
        st.close()


@pytest.mark.parametrize("kind", ["none", "disabled"])
def test_nothing_is_recorded_without_an_enabled_plane(kind):
    plane = None if kind == "none" else ObsPlane(name="off", enabled=False)
    st = _store(plane)
    try:
        want = _fill(st, 12)
        _reclaim_and_read(st, want, [0, 1])
        snap = st.snapshot_metrics()
        assert st.recovery.stats.parallel_recoveries == 2
        assert snap["counters"]["recovery_parallel"] == 2
        if plane is None:
            assert snap["histograms"] == {} and snap["spans"] == []
        else:
            assert len(plane.timeline("recovery.session")) == 0
            assert _count(plane, "recovery.session_us") == 0
            assert snap["spans"] == []
    finally:
        st.close()
