"""The benchmark's core: resolve a cell of `BENCHMARK.json` to its
files by name, run it, and print the result line.

A cell names a configuration (`configs/<config>.json`) and a traffic mix
(`traffic/<traffic>.json`); the mix names its driver
(`drivers/<driver>.py`), which builds the system under test from the
configuration, offers the mix's load, and compares what it produced with
the plain reference. Every metric is a reader of its own,
`metrics/<name>.py`, with one function `read(run)` that returns a number
or None where it finds nothing to read. Adding a configuration, a mix, a
metric or a cell is adding files and entries; no file here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level modules the process that prints a result may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Run:
    """What one run of one cell knows: its entry, configuration, mix,
    arguments, the driver's log of the window, and (traced) the profile
    and the program's observability plane."""

    def __init__(self, bench: dict, name: str, seed: int, seconds: float,
                 trace: bool, device, config: Optional[dict] = None,
                 mix: Optional[dict] = None):
        self.bench = bench
        self.name = name
        self.cell = cell_entry(bench, name)
        self.config = config if config is not None else load_json(
            HERE / "configs" / f"{self.cell['config']}.json")
        self.mix = mix if mix is not None else load_json(
            HERE / "traffic" / f"{self.cell['traffic']}.json")
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.t_start = time.perf_counter()
        self.t0 = self.t1 = 0.0          # the measured window (host clock)
        self.log: Dict = {}              # the driver's record of the window
        self.attempted = 0
        self.failed = 0
        self.memory_peak = 0
        self.profile = None              # tracing.Trace of a traced run
        self.obs_delta: Dict[str, List[int]] = {}

    def tracing(self) -> bool:
        """True while the profiler records."""
        return self.profile is not None and self.profile.active

    def end_trace(self) -> None:
        """Stop the profiler before the window closes (a driver whose
        window records more events than a run can read in its time)."""
        if self.tracing():
            self.profile.__exit__(None, None, None)

    def driver(self):
        return importlib.import_module(f"chipbench.drivers.{self.mix['driver']}")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def with_held(bench: dict) -> dict:
    """`bench` with the cells of `held.json` added: cells whose files stay
    here but that BENCHMARK.json does not list, for the CPU tests and the
    controls. A held metric named like one of `bench`'s adds its cells to
    that metric's `workloads`."""
    held = load_json(HERE / "held.json")
    out = dict(bench)
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        entries = [dict(e) for e in bench[kind]]
        have = {e["name"]: e for e in entries}
        for e in held[kind]:
            if e["name"] in have:
                mine = have[e["name"]]
                mine["workloads"] = mine["workloads"] + e["workloads"]
            else:
                entries.append(e)
        out[kind] = entries
    return out


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, name: str, kind: str) -> List[dict]:
    """The `end_to_end` or `per_layer` metrics that cell `name` reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or name in m["workloads"]]


def metric_reader(name: str):
    """`metrics/<name>.py`, loaded by path (a name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"chipbench.metrics._{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole: `repro_torch` is not `repro`."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def card_limit() -> str:
    """The card's power limit as `nvidia-smi` reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def execute(run: Run) -> dict:
    """Set up, warm, measure, check: the result's fields (no device
    look: the caller has made it)."""
    import torch

    from chipbench import tracing
    drv = run.driver()
    drv.setup(run)
    drv.warm(run)
    cuda = run.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    obs = run.log.get("obs")
    before = _hists(obs)
    trace = tracing.Trace() if run.trace else None
    run.profile = trace
    if trace is not None:
        trace.__enter__()
    run.t0 = time.perf_counter()
    run.t1 = run.t0 + run.seconds
    try:
        drv.window(run)
    finally:
        run.end_trace()
    run.obs_delta = {k: [b - a for a, b in zip(before.get(k, [0] * len(v)),
                                              v)]
                     for k, v in _hists(obs).items()}
    if cuda:
        torch.cuda.synchronize()
        run.memory_peak = torch.cuda.max_memory_allocated()
    kind = "per_layer" if run.trace else "end_to_end"
    metrics = {}
    for m in metrics_of(run.bench, run.name, kind):
        value = metric_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = drv.check(run)
    out = {"correct": all(v <= lim for _, v, lim in checks),
           "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "checks": checks}
    if trace is not None:
        out["busy_s"] = trace.busy_s()
        out["window_s"] = trace.window_s
        out["breakdown"] = trace.breakdown()
        out["trace_read_s"] = trace.read_s
    return out


def _hists(obs) -> Dict[str, List[int]]:
    if obs is None:
        return {}
    return {site: h["buckets"]
            for site, h in obs.snapshot()["histograms"].items()}


def main(args, t_start: float) -> int:
    import torch
    bench = load_benchmark()
    entry = cell_entry(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"chipbench: cell {args.workload} needs {entry['chips']} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f": no result", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    run = Run(bench, args.workload, args.seed, args.seconds, args.trace, dev)
    run.t_start = t_start
    res = execute(run)
    bad = forbidden_modules()
    if bad:
        print(f"chipbench: the run loaded forbidden modules {bad}: no "
              f"result", file=sys.stderr)
        return 3
    metrics = res["metrics"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": entry["chips"], "memory_peak_bytes": run.memory_peak,
              "power_limit": card_limit()}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": device}
    if run.trace:
        device["busy_s"] = res["busy_s"]
        device["window_s"] = res["window_s"]
        device["trace_read_s"] = res["trace_read_s"]
        line["breakdown"] = res["breakdown"]
    line["checks"] = {n: {"value": v, "limit": lim}
                      for n, v, lim in res["checks"]}
    for n, v in run.log.get("notes", {}).items():
        print(f"note {n}: {v!r}", file=sys.stderr)
    for n, v, lim in res["checks"]:
        print(f"check {n}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    sys.stdout.flush()
    return 0
