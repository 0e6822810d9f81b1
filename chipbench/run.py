"""Run one cell of the benchmark of the PyTorch/CUDA port (`repro_torch`)
and print its result as one JSON line.

    python3 chipbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell
asks for; without them it exits non-zero and prints no result. The
program's kernels build into `build/` inside the checkout on the first
run and are loaded from there afterwards.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


if __name__ == "__main__":
    from chipbench import harness
    sys.exit(harness.main(parse(), T_START))
