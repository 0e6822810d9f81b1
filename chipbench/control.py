"""The controls of `correct`: the readings that a sound run must stay
below, and the limits are set between. Not run by the benchmark's own
runs; run on the card at each cell's own size:

    python3 chipbench/control.py --workload serve.moe.chat \
        --seeds S1 ... S12 --control-seeds S1 S2 S3 [--seconds 1]
    python3 chipbench/control.py --workload store.ycsb-c.degraded \
        --control-seeds S1 S2 S3 [--seconds 3]

Serving: one process runs the cell's window (at least one whole batch)
for each seed, and prints the program's `served_logit_gap_mean` (the
lower reading); for the control seeds it also runs the benchmark's
check with the reference computed with fp8 operands (the precision
below the configuration's bf16) in the program's place: at every served
position of the same requests, the token the fp8 reference puts first
is judged (the upper reading, and `control_correct`, which has to be
false).

Store: the control is the reference encode of RS(10+0), a store with
no redundancy (parity rows of zeros) put in the program's place for the
set-up PUTs: it breaks the configuration's guarantee that an acked
object reads back with up to 2 of its 12 chunks lost. The run is then
checked as the benchmark checks it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


@contextlib.contextmanager
def no_redundancy():
    """The codec's parity product replaced by RS(10+0)'s: rows of zeros."""
    import torch
    from repro_torch.core import ec
    real = ec.gf256_matmul

    def zeros(G, X):
        return torch.zeros((len(G), X.shape[1]), dtype=torch.uint8,
                           device=X.device)

    ec.gf256_matmul = zeros
    try:
        yield
    finally:
        ec.gf256_matmul = real


def correct(checks) -> bool:
    return all(v <= lim for _, v, lim in checks)


def serve_readings(run, control: bool) -> dict:
    """Run the window, then the check as the benchmark makes it; for a
    control seed, the check again with the fp8 reference's tokens in the
    program's place."""
    drv = run.driver()
    drv.setup(run)
    drv.warm(run)
    run.t0 = time.perf_counter()
    run.t1 = run.t0 + run.seconds
    drv.window(run)
    out = {"seed": run.seed, "batches": len(run.log["batches"])}
    checks = drv.check(run)
    out["served_logit_gap_mean"] = checks[0][1]
    out["served_logit_gap_max"] = run.log["gap_max"]
    out["positions_off"] = int((run.log["gaps"] > 0).sum())
    out["prefill_pairs_dropped_pct"] = \
        run.log["notes"]["prefill_pairs_dropped_pct"]
    out["correct"] = correct(checks)
    if control:
        checks = drv.check(run, control="fp8")
        out["control_logit_gap_mean"] = checks[0][1]
        out["control_logit_gap_max"] = run.log["gap_max"]
        out["control_positions_off"] = int((run.log["gaps"] > 0).sum())
        out["control_correct"] = correct(checks)
    return out


def main(argv=None) -> int:
    import torch

    from chipbench import harness
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=1.0)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    bench = harness.with_held(harness.load_benchmark())
    dev = torch.device("cuda", 0)
    seeds = list(dict.fromkeys(a.control_seeds + a.seeds))
    for seed in seeds:
        run = harness.Run(bench, a.workload, seed, a.seconds, False, dev)
        t = time.perf_counter()
        if run.mix["driver"] == "serve_batches":
            rec = serve_readings(run, seed in a.control_seeds)
        else:
            drv = run.driver()
            with no_redundancy():
                drv.setup(run)
            drv.warm(run)
            run.t0 = time.perf_counter()
            run.t1 = run.t0 + run.seconds
            drv.window(run)
            rec = {"seed": seed, "control": "RS(10+0)",
                   "checks": drv.check(run)}
            rec["correct"] = correct(rec["checks"])
        rec["wall_s"] = time.perf_counter() - t
        rec["card"] = torch.cuda.get_device_name(0) + ", " + \
            harness.card_limit()
        print(json.dumps(rec), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
