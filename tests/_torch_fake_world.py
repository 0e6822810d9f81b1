"""A fake world of its own for the dry-run's CPU tests: one process is
one world (a process has one default group, and other CPU tests start a
gloo world of one), so each scenario runs here in a subprocess.

    python tests/_torch_fake_world.py SCENARIO

SCENARIO "one": reduced f32 cells on a 1 x 1 mesh over a fake world of
one, the records of `dryrun.record_cell` for train, prefill and decode
of each arch in `ARCHS`.
SCENARIO "four": the same cells on a 4 x 4 mesh (16 ranks).
SCENARIO "pods": the compressed train cell on (pod=2, data=2, model=2)
(8 ranks), with its pod all-gather's bytes by the placements.

Prints one JSON object, {"<arch> <kind>": record}, as the last line.
`run(*scenarios)` runs them, at once, and returns what each printed.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ("qwen3-1.7b", "qwen1.5-0.5b")
SEQ, BATCH = 128, 8


def shape_of(kind: str):
    from repro_torch.configs import ShapeConfig
    return ShapeConfig(f"test_{kind}", seq_len=SEQ, global_batch=BATCH,
                       kind=kind)


def config(arch: str):
    from repro_torch.configs import get_config, reduced
    return dataclasses.replace(reduced(get_config(arch)), dtype="float32")


def run(*scenarios: str, timeout: float = 240) -> dict:
    """Run the scenarios, each in a process of its own, all at once:
    {scenario: its printed object}."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = {s: subprocess.Popen([sys.executable, __file__, s], env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for s in scenarios}
    out = {}
    for s, p in procs.items():
        stdout, stderr = p.communicate(timeout=timeout)
        assert p.returncode == 0, stdout[-3000:] + stderr[-3000:]
        out[s] = json.loads(stdout.strip().splitlines()[-1])
    return out


def main(scenario: str) -> None:
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import init_fake_world, make_test_mesh
    out = {}
    if scenario in ("one", "four"):
        n = 1 if scenario == "one" else 4
        init_fake_world(n * n)
        mesh = make_test_mesh(n, n, device="cpu")
        for arch in ARCHS:
            for kind in ("train", "prefill", "decode"):
                out[f"{arch} {kind}"] = dryrun.record_cell(
                    config(arch), shape_of(kind), mesh, pod_stride=10**9)
    elif scenario == "pods":
        from repro_torch.launch.steps import build_cell
        init_fake_world(8)
        mesh = make_test_mesh(2, 2, pod=2, device="cpu")
        cfg, shape = config("qwen1.5-0.5b"), shape_of("train")
        rec = dryrun.record_cell(cfg, shape, mesh, pod_stride=4,
                                 grad_compress=True)
        rec["want_pod_gather_bytes"] = dryrun.pod_gather_bytes(
            build_cell(cfg, shape, mesh, grad_compress=True))
        out["qwen1.5-0.5b train"] = rec
    else:
        raise SystemExit(f"unknown scenario {scenario!r}")
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1])
