"""The `store.ycsb-c.reclaim` cell on the CPU at a small size: a sound run
reads `correct` with parallel recoveries in its window; a recovery that
restores a wrong byte, a recovery that restores nothing, and a store
with no redundancy each read incorrect; the reclaim schedule and the
request cycle are the same work for every seed; the recovery readers
read what the window recorded, and nothing without it."""
import math
import time
import types

import numpy as np
import pytest
import torch

from chipbench import control, harness
from chipbench.drivers import store_reads, store_reclaim
from chipbench.metrics import _counts
from chipbench.tests.test_chipbench_harness import ALL, BENCH, patched

CELL = "store.ycsb-c.reclaim"
PER_LAYER = ("recovery.session_us", "recovery.gb_s",
             "device.idle_in_recovery_pct.store", "get.p95_ms.reclaim")


def small_run(seed=2 ** 31 + 13, trace=False):
    """The cell at a small size: 40 objects, so that every function's
    insertion log lists more chunks than the recovery group has
    functions (parallel recovery), and a reclaim every 0.1 s of a 1 s
    window."""
    cfg = harness.load_json(harness.HERE / "configs/store-rs10p2.json")
    cfg.update(function_capacity_bytes=8 << 20, fragment_bytes=1 << 20)
    mix = harness.load_json(harness.HERE / "traffic/ycsb-c.reclaim.json")
    mix.update(objects=40, size_min_bytes=10_000, size_max_bytes=200_000,
               cycle_requests=400, warm_requests=24, check_extra=20,
               reclaim_first_s=0.05, reclaim_every_s=0.1)
    return harness.Run(ALL, CELL, seed, 1.0, trace, torch.device("cpu"),
                       config=cfg, mix=mix)


def _checks(res):
    return {n: v for n, v, _ in res["checks"]}


def test_cell_is_in_the_benchmark_with_its_metrics():
    entry = harness.cell_entry(BENCH, CELL)
    assert entry == {**entry, "config": "store-rs10p2",
                     "traffic": "ycsb-c.reclaim", "chips": 1}
    conf = next(c for c in BENCH["configs"] if c["name"] == "store-rs10p2")
    assert conf["reduced"] == []
    names = {m["name"] for m in harness.metrics_of(BENCH, CELL, "per_layer")}
    assert names == set(PER_LAYER)
    e2e = {m["name"] for m in harness.metrics_of(BENCH, CELL, "end_to_end")}
    assert e2e == {"get_gb_s", "setup_s"}
    cfg = harness.load_json(harness.HERE / "configs/store-rs10p2.json")
    assert cfg["enable_recovery"] and not cfg["spill_journal"]


def test_sound_run_is_correct_with_parallel_recoveries():
    run = small_run()
    res = harness.execute(run)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"get_gb_s", "setup_s"}
    notes = run.log["notes"]
    assert notes["reclaims_in_window"] >= 5
    assert notes["parallel_recoveries_in_window"] >= 1
    assert notes["bytes_restored_in_window"] > 0
    assert notes["functions_per_slot"] == [1] * 10


def _flip_a_byte(real):
    """Every chunk a recovery downloads comes back with one byte flipped
    (a copy: COS keeps the true bytes)."""
    def f(self, keys):
        out = {}
        for key, v in real(self, keys).items():
            v = v.clone()
            v[len(v) // 2] ^= 1
            out[key] = v
        return out
    return f


def _restore_nothing(real):
    def f(self, fid):
        return None
    return f


@pytest.mark.parametrize("fault", ["flip", "nothing"])
def test_faulty_recovery_reads_incorrect(fault):
    from repro_torch.core.recovery import RecoveryManager
    from repro_torch.core.store import InfiniStore
    target = {"flip": (RecoveryManager, "_download", _flip_a_byte),
              "nothing": (InfiniStore, "_recover", _restore_nothing)}[fault]
    with patched(*target):
        res = harness.execute(small_run())
    checks = _checks(res)
    assert not res["correct"], res["checks"]
    if fault == "flip":
        assert checks["get_mismatch"] > 0 and checks["restored_mismatch"] > 0
    else:
        # its GETs still decode right from parity and COS: only the
        # check of the restored functions sees it
        assert checks["unrestored"] > 0
        assert checks["get_mismatch"] == 0 and checks["get_missing"] == 0


def test_no_redundancy_control_reads_restored_mismatch():
    run = small_run()
    drv = run.driver()
    with control.no_redundancy():
        drv.setup(run)
    drv.warm(run)
    run.t0 = time.perf_counter()
    run.t1 = run.t0 + run.seconds
    drv.window(run)
    checks = dict((n, v) for n, v, _ in drv.check(run))
    assert checks["restored_mismatch"] > 0


def test_schedule_and_cycle_are_the_same_work_for_every_seed():
    mix = harness.load_json(harness.HERE / "traffic/ycsb-c.reclaim.json")
    cfg = harness.load_json(harness.HERE / "configs/store-rs10p2.json")
    k = cfg["ec"]["k"]
    plan = store_reclaim.schedule(mix, BENCH["run_seconds"], k)
    # one reclaim a second from 0.5 s, data slots 0..9 in turn
    assert len(plan) == BENCH["run_seconds"]
    assert [s for _, s in plan] == [i % k for i in range(len(plan))]
    assert np.allclose([t for t, _ in plan],
                       0.5 + np.arange(len(plan)) * 1.0)
    assert plan == store_reclaim.schedule(mix, BENCH["run_seconds"], k)
    sizes = store_reads.object_sizes(mix)
    assert len(sizes) == 256 and sum(sizes) <= cfg["dataset_bytes"]
    logs = np.diff(np.log(sorted(sizes)))
    assert np.allclose(logs, math.log(10) / 256, rtol=1e-3)
    # a data slot's chunks fit one function's storage partition
    from repro_torch.core.sms import hardcap
    slot = sum(_counts.rs_chunk_len(s, k) for s in sizes)
    assert 0.9e9 < slot < hardcap(cfg["function_capacity_bytes"])
    counts = store_reads.zipf_counts(mix)
    a = store_reads.request_cycle(mix, 2 ** 31 + 5)
    b = store_reads.request_cycle(mix, 2 ** 31 + 6)
    assert not np.array_equal(a, b)
    assert np.array_equal(np.bincount(a, minlength=256), counts)
    assert np.array_equal(np.sort(a), np.sort(b))
    sample = store_reads.checked(mix, 7)
    assert len(sample) == 512 and set(a[sorted(
        store_reads.checked(mix, 2 ** 31 + 5))]) == set(range(256))


class Plane:
    def __init__(self, rows):
        self.rows = rows

    def timeline(self, site):
        rows = self.rows.get(site, [])
        return np.array(rows, dtype=np.int64).reshape(-1, 2)


def test_recovery_readers_read_the_window_and_none_without_it():
    T = 1_700_000_000 * 10 ** 9
    plane = Plane({"recovery.session": [(T - 50, T - 10),        # before
                                        (T + 100, T + 400),
                                        (T + 1_000, T + 1_700),
                                        (T + 5_000, T + 9_000)]})  # after
    counts = [0] * 96
    counts[40] = 2
    run = types.SimpleNamespace(
        profile=None, obs_delta={"recovery.session_us": counts},
        log={"obs": plane, "window_ns": (T, T + 2_000),
             "window_counts": {"recovery_bytes": 2_000}})
    read = {n: harness.metric_reader(n).read for n in PER_LAYER}
    # 2,000 bytes over 1,000 ns of spans
    assert read["recovery.gb_s"](run) == pytest.approx(2.0)
    assert read["recovery.session_us"](run) == pytest.approx(
        2 ** (39.5 / 4), rel=1e-9)
    assert read["device.idle_in_recovery_pct.store"](run) is None
    # an earlier commit: no counter, no span site, no histogram
    bare = types.SimpleNamespace(
        profile=None, obs_delta={},
        log={"obs": Plane({}), "window_ns": (T, T + 2_000),
             "window_counts": {"sms_chunk_misses": 0}})
    for name in ("recovery.gb_s", "recovery.session_us",
                 "device.idle_in_recovery_pct.store"):
        assert read[name](bare) is None
    none = types.SimpleNamespace(profile=None, obs_delta={}, log={})
    assert read["recovery.gb_s"](none) is None


def test_traced_small_run_reads_the_recovery_metrics():
    """Traced on the CPU: the histogram and the span readers read the
    window's recoveries; the device reader finds no device operation."""
    run = small_run(trace=True)
    res = harness.execute(run)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert got["recovery.session_us"]["value"] > 0
    assert got["recovery.gb_s"]["value"] > 0
    assert got["get.p95_ms.reclaim"]["value"] > 0
    assert "device.idle_in_recovery_pct.store" not in got
    notes = run.log["notes"]
    assert 0 < notes["recovery_span_s"] <= notes["get_span_s"]


@pytest.mark.cuda
def test_small_reclaim_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    run = small_run(trace=True)
    run.device = torch.device("cuda", 0)
    res = harness.execute(run)
    assert res["correct"], res["checks"]
    assert res["busy_s"] > 0
    assert res["metrics"]["device.idle_in_recovery_pct.store"]["value"] >= 0

