"""How far the port's writeback thread is behind the quickstart's PUTs.

    PYTHONPATH=src python scripts/torch_writeback_race.py [--device cpu]
        [--trials 20]

`examples/torch_quickstart.py` GETs its key right after its two PUTs,
with no barrier: the GET reads the slabs if the store's writer has
persisted the chunks by then, the persistent buffer if not (then its
recovery count and its bill differ). Each trial builds the quickstart's
store on `--device` (the card by default), makes its two PUTs (500,000
and 300,000 random bytes, seed 0) and reads the writer's queue depth
when the second PUT returns, the milliseconds `flush_writeback` then
takes to drain it, and each PUT's milliseconds. Prints one JSON line:
the trials' numbers in lists and how many trials left the queue
nonempty.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.core import Clock, InfiniStore, StoreConfig  # noqa: E402
from repro_torch.core.ec import ECConfig  # noqa: E402
from repro_torch.core.gc_window import GCConfig  # noqa: E402

MB = 1024 * 1024


def trial(device: str) -> dict:
    store = InfiniStore(StoreConfig(
        ec=ECConfig(k=4, p=2), function_capacity=8 * MB,
        gc=GCConfig(gc_interval=10.0, active_intervals=2,
                    degraded_intervals=2), device=device), clock=Clock())
    rng = np.random.default_rng(0)
    v1, v2 = rng.bytes(500_000), rng.bytes(300_000)
    t0 = time.perf_counter()
    store.put("model/embedding", v1)
    t1 = time.perf_counter()
    store.put("model/embedding", v2)
    t2 = time.perf_counter()
    depth = store.writeback.depth
    assert store.flush_writeback(timeout=60.0)
    t3 = time.perf_counter()
    store.close()
    return {"depth": depth, "drain_ms": (t3 - t2) * 1e3,
            "put1_ms": (t1 - t0) * 1e3, "put2_ms": (t2 - t1) * 1e3}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trials", type=int, default=20)
    args = ap.parse_args(argv)
    runs = [trial(args.device) for _ in range(args.trials)]
    print(json.dumps({"device": args.device, "trials": args.trials,
                      "behind": sum(r["depth"] > 0 for r in runs),
                      **{k: [r[k] for r in runs] for k in runs[0]}}))


if __name__ == "__main__":
    main()
