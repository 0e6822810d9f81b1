"""The readers of the store daemon's stages on the CPU: the two
histogram medians, and the device idle that lies inside the plane's
`daemon.get_many` and `get.decode` spans, over a synthetic trace whose
gaps are known; each reads None where it has nothing to read."""
import types

import numpy as np
import pytest

from chipbench import harness, tracing
from chipbench.metrics import _timeline
from chipbench.tests.test_chipbench_harness import ALL, small_run

CELL = "store.ycsb-c.degraded"
IDLE = ("device.idle_in_get_pct.store", "device.idle_in_decode_pct.store")
HISTS = ("daemon.queue_wait_us", "daemon.get_us")


class Plane:
    """The plane's timelines, in Unix ns, for the readers."""

    def __init__(self, get=(), decode=()):
        self.sites = {"daemon.get_many": get, "get.decode": decode}

    def timeline(self, site):
        rows = self.sites.get(site, [])
        return np.array(rows, dtype=np.int64).reshape(-1, 2)


def trace(busy_us, lo, hi):
    """A read Trace: device intervals `busy_us`, the host active over
    [lo, hi] us, the window as long as that."""
    t = tracing.Trace()
    t.device = [("gf256_small", s, e) for s, e in busy_us]
    t.host = [(lo, hi, "client")]
    t.window_s = (hi - lo) * 1e-6
    return t


def run_of(profile, plane, obs_delta=None):
    return types.SimpleNamespace(profile=profile, log={"obs": plane},
                                 obs_delta=obs_delta or {})


def read(name, run):
    return harness.metric_reader(name).read(run)


def ns(*intervals_us):
    return [(int(s * 1e3), int(e * 1e3)) for s, e in intervals_us]


T0 = 1.7e12                                    # a Unix instant, in us


def test_idle_inside_a_span_is_exact():
    # busy [0,10] [20,30] [50,60]: gaps (10,20) and (30,50), window 60 us
    prof = trace([(T0, T0 + 10), (T0 + 20, T0 + 30), (T0 + 50, T0 + 60)],
                 T0, T0 + 60)
    plane = Plane(get=ns((T0 + 15, T0 + 40)),
                  decode=ns((T0 + 32, T0 + 35)))
    run = run_of(prof, plane)
    assert read(IDLE[0], run) == pytest.approx(100 * 15 / 60, abs=1e-6)
    assert read(IDLE[1], run) == pytest.approx(100 * 3 / 60, abs=1e-6)
    assert read("device.idle_pct.store", run) == pytest.approx(
        100 * 30 / 60, abs=1e-6)


def test_gaps_outside_every_span_count_nothing():
    prof = trace([(T0, T0 + 10), (T0 + 20, T0 + 30)], T0, T0 + 40)
    # spans over busy stretches only, and before and after the trace
    plane = Plane(get=ns((T0 - 50, T0 - 5), (T0, T0 + 10),
                         (T0 + 20, T0 + 30), (T0 + 45, T0 + 90)),
                  decode=ns((T0 + 2, T0 + 8)))
    run = run_of(prof, plane)
    assert read(IDLE[0], run) == 0.0 and read(IDLE[1], run) == 0.0


def test_overlapping_spans_count_each_idle_instant_once():
    prof = trace([(T0, T0 + 10), (T0 + 30, T0 + 40)], T0, T0 + 40)
    plane = Plane(get=ns((T0 + 12, T0 + 20), (T0 + 15, T0 + 25),
                         (T0 + 14, T0 + 16)))
    assert read(IDLE[0], run_of(prof, plane)) == pytest.approx(
        100 * 13 / 40, abs=1e-6)


@pytest.mark.parametrize("seed", range(5))
def test_decode_idle_within_get_idle_within_all_idle(seed):
    rng = np.random.default_rng(seed)
    edges = np.sort(rng.uniform(0, 10_000, 400)) + T0
    busy = list(zip(edges[0::2], edges[1::2]))
    prof = trace(busy, T0, T0 + 10_000)
    # GET spans tile most of the window; each holds a decode span
    cuts = np.sort(rng.uniform(0, 10_000, 60)) + T0
    gets = [(s + 5, e - 5) for s, e in zip(cuts[0::2], cuts[1::2])]
    decodes = [(s + (e - s) * 0.2, s + (e - s) * 0.7) for s, e in gets]
    run = run_of(prof, Plane(get=ns(*gets), decode=ns(*decodes)))
    dec, get = read(IDLE[1], run), read(IDLE[0], run)
    idle = read("device.idle_pct.store", run)
    assert 0 < dec <= get <= idle
    # the sum equals a brute-force count on a 0.25 us grid
    grid = np.arange(T0, T0 + 10_000, 0.25) + 0.125
    idle_at = np.ones(len(grid), bool)
    for s, e in busy:
        idle_at[(grid >= s) & (grid < e)] = False
    in_get = np.zeros(len(grid), bool)
    for s, e in gets:
        in_get[(grid >= s) & (grid < e)] = True
    want = 100 * (idle_at & in_get).sum() * 0.25 / 10_000
    assert get == pytest.approx(want, abs=0.05)


def test_readers_read_none_without_a_profile_or_a_plane():
    prof = trace([(T0, T0 + 10), (T0 + 20, T0 + 30)], T0, T0 + 40)
    plane = Plane(get=ns((T0, T0 + 40)), decode=ns((T0, T0 + 40)))
    for name in IDLE:
        assert read(name, run_of(None, plane)) is None
        assert read(name, run_of(prof, None)) is None
        # a plane without timelines, as an earlier commit's
        assert read(name, run_of(prof, object())) is None
        # a plane with no span of the site
        assert read(name, run_of(prof, Plane())) is None
        # a trace that saw no device operation
        assert read(name, run_of(trace([], T0, T0 + 40), plane)) is None
        assert read(name, run_of(prof, plane)) is not None
    for name in HISTS:
        assert read(name, run_of(None, None)) is None
        counts = [0] * 96
        assert read(name, run_of(None, None, {name: counts})) is None
        counts[40] = 3
        assert read(name, run_of(None, None, {name: counts})) == \
            pytest.approx(2 ** (39.5 / 4), rel=1e-9)


def test_merged_and_overlap_helpers():
    assert _timeline.merged([(5, 6), (1, 3), (2, 4)]) == [(1, 4), (5, 6)]
    assert _timeline.overlap([(0, 2), (3, 10)], [(1, 4), (5, 6)]) == 3


def test_traced_small_run_reads_the_daemon_histograms():
    """A traced run at a small size on the CPU: the store's plane records
    the daemon's stages and the histogram readers read them; the idle
    readers find no device operation there and read nothing."""
    run = small_run(CELL)
    run.trace = True
    res = harness.execute(run)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    for name in HISTS:
        assert got[name]["value"] > 0
    for name in IDLE:
        assert name not in got
    names = {m["name"] for m in harness.metrics_of(ALL, CELL, "per_layer")}
    assert set(HISTS) | set(IDLE) <= names
