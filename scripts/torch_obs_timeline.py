#!/usr/bin/env python
"""Checks of the store plane's timelines (`ObsPlane.timeline`) on the
card, and what the plane costs there.

    python3 scripts/torch_obs_timeline.py [--device cuda] clock [--probes 20]
    python3 scripts/torch_obs_timeline.py [--device cuda] span-cost \
        [--spans 200000]

`clock`: one 100 MB object at the geometry of the benchmark's store
configuration (RS(10+2), 200 MB fragments, recovery off), the function
holding its chunk #0 reclaimed. Under `chipbench.tracing.Trace`, the
store's daemon thread runs `--probes` tasks, each a plane span around
one degraded GET of the object between two short spin kernels, and
`torch.cuda.synchronize()`. Each span must hold its GET's `gf256`
kernel as the trace reads it. The margins (kernel start - span start,
span end - kernel end, in us) are printed, for the kernel and for the
spin kernels; those of the spin kernels are a launch and a
synchronise's return, so they bound the device clock's offset from the
plane's (`offset_us_range`). The exit code is 1 if a margin falls below
-50 us (the device clock off the plane's by more than that).

`span-cost`: host time of one span opened and closed on an enabled
plane (ring, timeline; a root span and a nested one; nested with the
flight file bound, as in a store with a spill directory), of one
histogram sample, and of a span site of a disabled plane and of a store
with no plane, in us; beside them the system calls a span makes.

Run from the root of a checkout on a machine with a card; the kernels
build into `build/` on first use. `--device cpu` rehearses the paths on
the host (no device interval there: `clock` fails).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

OBJECT_BYTES = 100 * 1024 * 1024
OFF_LIMIT_US = 50.0
PAUSE_S = 0.02
MARK_CYCLES = 200_000             # ~0.1 ms of spinning at the card's clock


def card(dev) -> dict:
    if dev.type != "cuda":
        return {"kind": dev.type, "torch": torch.__version__}
    from chipbench.harness import card_limit
    return {"kind": torch.cuda.get_device_name(0),
            "power_limit": card_limit(), "torch": torch.__version__}


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def clock(dev, probes: int) -> int:
    from chipbench import harness, tracing
    from chipbench.drivers import store_reads
    from repro_torch.core.store import InfiniStore
    cfg = harness.load_json(
        harness.HERE / "configs" / "store-rs10p2-parity.json")
    scfg = store_reads.store_config(
        types.SimpleNamespace(config=cfg, trace=True, device=dev))
    store = InfiniStore(scfg, seed=1)
    obs, key = scfg.obs, "probe"
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    data = torch.randint(0, 256, (OBJECT_BYTES,), dtype=torch.uint8,
                         device=dev, generator=gen)
    store.put_many([(key, data)])
    assert store.flush_writeback(timeout=600.0)
    for ck in store_reads.chunk_keys(store, key, 0):
        store.inject_failure(store.chunk_map[ck])
    for _ in range(3):                                 # build and warm
        assert torch.equal(store.get_many_arrays([key])[key], data)
    sync(dev)

    def mark():
        # a spin kernel right after the span opens and right before it
        # closes: the device's first and last operation in the span, so
        # each margin is a launch or a synchronise's return
        if dev.type == "cuda":
            torch.cuda._sleep(MARK_CYCLES)

    def probe(i):
        with obs.span("client.get_many", probe=i) as span:
            mark()
            out = store._get_many_impl([key], as_arrays=True)
            mark()
            sync(dev)
        return span, out[key]

    spans = []
    with tracing.Trace() as trace:
        for i in range(probes):
            span, out = store._submit(lambda i=i: probe(i)).result()
            spans.append(span)
            time.sleep(PAUSE_S)       # each probe's device work stands alone
    assert torch.equal(out, data)
    store.close()
    near = PAUSE_S * 1e6 / 2
    lead, tail, mark_lead, mark_tail, found, names = [], [], [], [], [], set()
    # the CUDA runtime's calls as the profiler stamps them on the host:
    # the plane's clock against the profiler's host clock, and that
    # against the device's
    host = {k: [] for k in ("to_launch", "launch_to_kernel", "kernel_to_sync",
                            "sync_to_end")}
    for span in spans:
        s0, s1 = span.start_ns / 1e3, span.end_ns / 1e3
        ops = [(n, s, e) for n, s, e in trace.device
               if e > s0 - near and s < s1 + near]
        gf = [(s, e) for n, s, e in ops if "gf256" in n]
        names.update(tracing.short_name(n) for n, _, _ in ops)
        found.append(len(gf))
        if gf:
            lead.append(gf[0][0] - s0)
            tail.append(s1 - max(e for _, e in gf))
            mark_lead.append(min(s for _, s, _ in ops) - s0)
            mark_tail.append(s1 - max(e for _, _, e in ops))
        calls = [(s, e) for s, e, n in trace.host
                 if n.startswith("cuda") and s0 - near < s < s1 + near]
        if ops and calls:
            host["to_launch"].append(calls[0][0] - s0)
            host["launch_to_kernel"].append(
                min(s for _, s, _ in ops) - calls[0][0])
            last = max(e for _, e in calls)
            host["kernel_to_sync"].append(last - max(e for _, _, e in ops))
            host["sync_to_end"].append(s1 - last)
    ok = all(found) and min(mark_lead + mark_tail) >= -OFF_LIMIT_US

    def med(x):
        return statistics.median(x) if x else None
    line = {"check": "clock", "ok": ok, "probes": probes,
            "gf256_per_probe": found, "device_ops": sorted(names),
            "lead_us": lead, "tail_us": tail,
            "lead_us_min": min(lead, default=None),
            "lead_us_median": med(lead),
            "tail_us_min": min(tail, default=None),
            "tail_us_median": med(tail),
            "mark_lead_us_min": min(mark_lead, default=None),
            "mark_lead_us_median": med(mark_lead),
            "mark_tail_us_min": min(mark_tail, default=None),
            "mark_tail_us_median": med(mark_tail),
            # the device clock's offset from the plane's lies in here
            "offset_us_range": [-min(mark_tail, default=0.0),
                                min(mark_lead, default=0.0)],
            "runtime_calls_us": {k: {"min": min(v, default=None),
                                     "median": med(v)}
                                 for k, v in host.items()},
            "span_us_median": med([s.dur_s * 1e6 for s in spans]),
            "device": card(dev)}
    print(json.dumps(line))
    return 0 if ok else 1


def span_cost(dev, n: int) -> int:
    import os
    import threading
    import tempfile
    from repro_torch.obs import NOOP_CM, ObsPlane
    on, off = ObsPlane(name="on"), ObsPlane(enabled=False, name="off")
    none = None
    # a store with a spill directory mirrors every span to its flight file
    flight = ObsPlane(name="flight")
    tmp = tempfile.TemporaryDirectory(prefix="obs-flight-")
    flight.bind_flight(os.path.join(tmp.name, "flight.bin"))

    def per_call_us(body) -> float:
        best = float("inf")
        for _ in range(5):
            t = time.perf_counter()
            body()
            best = min(best, (time.perf_counter() - t) / n * 1e6)
        return best

    def spans(plane):
        def body():
            for _ in range(n):
                with plane.span("get.decode", fragments=1):
                    pass
        return body

    def nested(plane=on):
        def body():
            with plane.span("daemon.get_many", n=1):
                spans(plane)()
        return body

    def spans_none():
        for _ in range(n):
            with (none.span("get.decode", fragments=1)
                  if none is not None else NOOP_CM):
                pass

    def calls(fn, *a):
        def body():
            for _ in range(n):
                fn(*a)
        return body

    t_root, t_nested, t_none = (per_call_us(spans(on)),
                                per_call_us(nested()),
                                per_call_us(spans_none))
    line = {"check": "span_cost", "calls": n,
            "span_root_us": t_root, "span_nested_us": t_nested,
            "span_nested_flight_us": per_call_us(nested(flight)),
            "span_disabled_us": per_call_us(spans(off)),
            "span_no_plane_us": t_none,
            "record_enabled_us": per_call_us(calls(on.record,
                                                   "daemon.get_us", 1500.0)),
            "time_ns_us": per_call_us(calls(time.time_ns)),
            "perf_counter_us": per_call_us(calls(time.perf_counter)),
            "getpid_us": per_call_us(calls(os.getpid)),
            "urandom8_us": per_call_us(calls(os.urandom, 8)),
            "get_ident_us": per_call_us(calls(threading.get_ident)),
            "timeline_rows": len(on.timeline("get.decode")),
            "device": card(dev)}
    flight.close()
    tmp.cleanup()
    print(json.dumps(line))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    sub = ap.add_subparsers(dest="what", required=True)
    c = sub.add_parser("clock")
    c.add_argument("--probes", type=int, default=20)
    s = sub.add_parser("span-cost")
    s.add_argument("--spans", type=int, default=200_000)
    a = ap.parse_args(argv)
    dev = torch.device(a.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("CUDA is not available: pass --device cpu")
        dev = torch.device("cuda", 0)
    if a.what == "clock":
        return clock(dev, a.probes)
    return span_cost(dev, a.spans)


if __name__ == "__main__":
    sys.exit(main())
