"""Read-only traffic against one InfiniStore with parallel recovery on,
while the FaaS provider reclaims its functions on a schedule.

Set-up, the closed loop of GETs and its digests are `store_reads`'s: the
same objects, sizes, request cycle and check sample for a seed. What
this module adds:

- warm-up reclaims the function(s) holding each data slot 0..k-1 in
  turn, and GETs one object after each, so that every slot's function
  is detected and restored once before the window (the recovery pool,
  the allocator and first calls fall outside it);
- in the window a reclaimer thread reclaims the function(s) holding
  data slot 0, 1, ..., k-1, 0, ... at `reclaim_first_s` and then every
  `reclaim_every_s` on the host clock. The next GET that invokes a
  reclaimed function finds it cold, and the store restores it from COS
  through the pending map before that GET reads it;
- the check, after one more GET of every object: every reclaimed
  function is alive and holds every chunk its insertion log's manifest
  lists (`unrestored`), and every chunk of every slot that the slabs
  hold for the parity-sample objects equals the NumPy reference's
  encode (`restored_mismatch`), beside `store_reads`'s `get_missing`
  and `get_mismatch` over the warm-up's, the window's sample and the
  last pass's GETs.

The schedule is the same for every seed: it depends on the mix and the
window's length alone.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Tuple

import numpy as np

from chipbench.drivers import store_reads
from chipbench.drivers.store_reads import _judge, chunk_keys, get_p95_ms
from chipbench.reference import gf256_rs


def schedule(mix: dict, seconds: float, k: int) -> List[Tuple[float, int]]:
    """(seconds after the window opens, data slot) of every reclaim that
    a window of `seconds` holds, in order."""
    out = []
    t = mix["reclaim_first_s"]
    while t < seconds:
        out.append((t, len(out) % k))
        t = mix["reclaim_first_s"] + len(out) * mix["reclaim_every_s"]
    return out


def slot_functions(store, keys, k: int) -> List[List[int]]:
    """The functions that hold each data slot's chunks of the objects."""
    return [sorted({store.chunk_map[ck] for key in keys
                    for ck in chunk_keys(store, key, idx)})
            for idx in range(k)]


def setup(run) -> None:
    store_reads.setup(run)
    lg = run.log
    lg["slots"] = slot_functions(lg["store"], lg["keys"],
                                 run.config["ec"]["k"])
    lg["reclaimed"] = set()


def _reclaim(run, slot: int) -> None:
    store = run.log["store"]
    for fid in run.log["slots"][slot]:
        store.inject_failure(fid)
        run.log["reclaimed"].add(fid)


def _counters(store) -> Dict[str, int]:
    return dict(store.snapshot_metrics()["counters"])


def warm(run) -> None:
    """Each data slot's function reclaimed and restored once, each
    restore by one GET (judged with the warm-up's), then `store_reads`'s
    warm-up."""
    lg = run.log
    store, keys = lg["store"], lg["keys"]
    done = _judge(run, lg.setdefault("warm_recs", []))
    for slot in range(len(lg["slots"])):
        _reclaim(run, slot)
        r = slot % len(keys)
        t = time.perf_counter()
        done(r, r, t, t, store.get_many_arrays([keys[r]])[keys[r]])
    store_reads.warm(run)
    lg["counters_before"] = _counters(store)


def window(run) -> None:
    lg = run.log
    plan = schedule(run.mix, run.seconds, len(lg["slots"]))
    stop = threading.Event()
    reclaims: List[Tuple[float, int]] = []

    def reclaimer():
        for at, slot in plan:
            if stop.wait(max(0.0, run.t0 + at - time.perf_counter())):
                return
            _reclaim(run, slot)
            reclaims.append((time.perf_counter() - run.t0, slot))

    ns0 = time.time_ns()
    th = threading.Thread(target=reclaimer, name="chipbench-reclaimer",
                          daemon=True)
    th.start()
    try:
        store_reads.window(run)
    finally:
        stop.set()
        th.join()
    lg["window_ns"] = (ns0, time.time_ns())
    lg["window_to"] = len(lg["digests"].ranks)
    lg["reclaims"] = reclaims
    before, after = lg["counters_before"], _counters(lg["store"])
    lg["window_counts"] = {c: after[c] - before[c] for c in after
                           if c in before}


def window_spans(run, site: str) -> List[Tuple[int, int]]:
    """(start_ns, end_ns) of the plane's `site` spans that ended inside
    the window (with the GETs still out at its end); none without a
    plane or a timeline, as at an earlier commit."""
    timeline = getattr(run.log.get("obs"), "timeline", None)
    bounds = run.log.get("window_ns")
    if timeline is None or bounds is None:
        return []
    lo, hi = bounds
    return [(s, e) for s, e in timeline(site).tolist() if lo <= e <= hi]


def recovery_gb_s(run):
    """Bytes the store restored in the window over the summed length of
    the window's `recovery.session` spans, in GB/s (10^9)."""
    nbytes = run.log.get("window_counts", {}).get("recovery_bytes")
    spans = window_spans(run, "recovery.session")
    if not nbytes or not spans:
        return None
    return nbytes / (sum(e - s for s, e in spans) * 1e-9) / 1e9


def _span_s(run, site: str):
    spans = window_spans(run, site)
    return sum(e - s for s, e in spans) * 1e-9 if spans else None


def _notes(run) -> dict:
    """What the window did beyond its GETs (not checked): reclaims,
    recoveries and the bytes they restored (None where the program
    exports no recovery counters), the chunks the sweeps missed (read
    from parity or COS instead: GETs that raced a reclaim), and, traced,
    the daemon's time in recoveries and in GETs, and the card's busy
    time inside the recoveries."""
    lg = run.log
    wc = lg.get("window_counts", {})
    out = {"reclaims_in_window": len(lg["reclaims"]),
           "functions_per_slot": [len(f) for f in lg["slots"]],
           "recoveries_in_window": (wc["recovery_local"]
                                    + wc["recovery_parallel"]
                                    if "recovery_local" in wc else None),
           "parallel_recoveries_in_window": wc.get("recovery_parallel"),
           "bytes_restored_in_window": wc.get("recovery_bytes"),
           "chunks_restored_in_window": wc.get("recovery_chunks"),
           "chunks_missed_in_window": wc.get("sms_chunk_misses"),
           "recovery_span_s": _span_s(run, "recovery.session"),
           "get_span_s": _span_s(run, "daemon.get_many")}
    p = run.profile
    spans = window_spans(run, "recovery.session")
    if p is not None and p.device and spans:
        from chipbench.metrics._timeline import merged, overlap
        out["device_busy_in_recovery_s"] = overlap(
            p.busy_intervals(),
            merged((s / 1e3, e / 1e3) for s, e in spans)) * 1e-6
    return out


def check(run) -> list:
    lg = run.log
    store, keys = lg["store"], lg["keys"]
    k, p = run.config["ec"]["k"], run.config["ec"]["p"]
    fb = run.config["fragment_bytes"]
    # one GET of every object: each reclaimed function is invoked again
    final: list = []
    done = _judge(run, final)
    for r, key in enumerate(keys):
        t = time.perf_counter()
        done(r, r, t, t, store.get_many_arrays([key])[key])
    unrestored = 0
    for fid in sorted(lg["reclaimed"]):
        slab = store.sms.get(fid)
        held = set(slab.keys())
        if not slab.alive or any(ck not in held
                                 for ck in store.logs[fid].manifest()):
            unrestored += 1
    stored = []
    for r in lg["parity_objects"]:
        for idx in range(k + p):
            for fi, ck in enumerate(chunk_keys(store, keys[r], idx)):
                val = store.sms.get(store.chunk_map[ck]).load(ck)
                stored.append((r, fi, idx, None if val is None
                               else val.cpu().numpy()))
    notes = _notes(run)
    store.close()
    lg["store"] = None
    del store
    recs = lg["recs"]
    missing = sum(not rec[3] for rec in recs + lg["warm_recs"] + final)
    table = lg["digests"]
    bad = table.values() != lg["want"][table.ranks]
    restored_bad = 0
    enc = {}
    for r, fi, idx, val in stored:
        if (r, fi) not in enc:
            data = lg["parity_objects"][r][fi * fb:(fi + 1) * fb]
            enc[r, fi] = gf256_rs.encode(data, k, p)
        if val is None or not np.array_equal(val, enc[r, fi][idx]):
            restored_bad += 1
    w0, w1 = lg["window_from"], lg["window_to"]
    run.failed = sum(not rec[3] for rec in recs) + int(bad[w0:w1].sum())
    lg["notes"] = {"gets_compared": len(bad),
                   "window_gets_compared": w1 - w0,
                   "restored_chunks_compared": len(stored),
                   "get_p95_ms": get_p95_ms(run), **notes}
    return [("get_missing", missing, 0),
            ("get_mismatch", int(bad.sum()), 0),
            ("restored_mismatch", restored_bad, 0),
            ("unrestored", unrestored, 0)]
