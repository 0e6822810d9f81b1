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
SCENARIOS "flags-one", "flags-four": the cells of `FLAG_CELLS` (the
dry-run's options other than the defaults) on 1 x 1 and on 4 x 4.
SCENARIO "heads": train and prefill of Qwen3-14B's head layout (40 heads,
8 kv heads) at small widths on (data=1, model=16), and of the same model
with 48 heads (`heads_configs`).
SCENARIO "logs": the cells of `LOG_CELLS` (one of each family) traced on a
2 x 2 mesh, each with its analysis and log of counted ops (`traced`).
SCENARIO "logs-pods": the compressed train cell on (pod=2, data=2,
model=2), pod_stride 4, traced with its log.
SCENARIO "logs-rule": Qwen3-1.7B's reduced f32 train cell on 1 x 1
traced, then traced again with "mul" among the analyzer's free ops
(`hlo._FREE`); and its bf16 train cell traced with the conversions from
bf16 to f32 recorded at the analyzer's dispatch (`upcasts`: shape ->
bytes).

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
ARCHS = ("qwen3-1.7b", "qwen1.5-0.5b", "qwen3-14b", "qwen2-moe-a2.7b",
         "granite-moe-1b-a400m", "rwkv6-3b", "recurrentgemma-2b",
         "musicgen-large")
SEQ, BATCH = 128, 8


def shape_of(kind: str):
    from repro_torch.configs import ShapeConfig
    return ShapeConfig(f"test_{kind}", seq_len=SEQ, global_batch=BATCH,
                       kind=kind)


def config(arch: str):
    from repro_torch.configs import get_config, reduced
    return dataclasses.replace(reduced(get_config(arch)), dtype="float32")


# (arch, kind, build_cell options): every option of the dry-run's CLI
# other than its defaults
FLAG_CELLS = [("qwen3-1.7b", "decode", {"kv_layout": "contiguous"}),
              ("musicgen-large", "decode", {"kv_layout": "contiguous"}),
              ("qwen3-1.7b", "decode", {"flash_decode": True}),
              ("qwen3-14b", "decode", {"flash_decode": True}),
              ("qwen3-1.7b", "train", {"attn_impl": "tri"}),
              ("rwkv6-3b", "train", {"wkv_impl": "scan"})]


# (arch, kind): a cell of each family for the saved logs' tests
LOG_CELLS = [("qwen3-1.7b", "prefill"), ("qwen3-1.7b", "train"),
             ("internvl2-1b", "train"), ("musicgen-large", "prefill"),
             ("qwen2-moe-a2.7b", "train"), ("rwkv6-3b", "decode"),
             ("recurrentgemma-2b", "prefill")]


def traced(cfg, kind: str, mesh, *, pod_stride: int = 10**9,
           **cell_kw) -> dict:
    """The cell traced by the dry-run: the analysis's counts, the
    collectives by op and the log of counted ops."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import build_cell
    a = dryrun.trace_cell(build_cell(cfg, shape_of(kind), mesh, **cell_kw),
                          pod_stride=pod_stride)
    return {"flops": a.flops, "bytes_accessed": a.bytes_accessed,
            "transcendentals": a.transcendentals,
            "bytes_by_op": a.bytes_by_op, "summary": a.summary(),
            "collectives_by_op": dryrun.collectives_by_op(a.collectives),
            "log": a.log}


def flag_key(arch: str, kind: str, opts: dict) -> str:
    return " ".join([arch, kind] + [f"{k}={v}" for k, v in opts.items()])


def heads_configs():
    """Qwen3-14B reduced to 2 layers of d_model 640 with its 40 heads of
    16 and 8 kv heads, and the same with 48 heads."""
    from repro_torch.configs import get_config, reduced
    c40 = dataclasses.replace(reduced(get_config("qwen3-14b"), heads=40,
                                      kv_heads=8, d_model=640),
                              dtype="float32")
    return c40, dataclasses.replace(c40, num_heads=48)


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
    import torch
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
    elif scenario in ("flags-one", "flags-four"):
        n = 1 if scenario == "flags-one" else 4
        init_fake_world(n * n)
        mesh = make_test_mesh(n, n, device="cpu")
        for arch, kind, opts in FLAG_CELLS:
            out[flag_key(arch, kind, opts)] = dryrun.record_cell(
                config(arch), shape_of(kind), mesh, pod_stride=10**9,
                **opts)
    elif scenario == "heads":
        init_fake_world(16)
        mesh = make_test_mesh(1, 16, device="cpu")
        for cfg in heads_configs():
            for kind in ("train", "prefill"):
                out[f"{cfg.num_heads} {kind}"] = dryrun.record_cell(
                    cfg, shape_of(kind), mesh, pod_stride=10**9)
    elif scenario == "logs":
        init_fake_world(4)
        mesh = make_test_mesh(2, 2, device="cpu")
        for arch, kind in LOG_CELLS:
            out[f"{arch} {kind}"] = traced(config(arch), kind, mesh)
    elif scenario == "logs-pods":
        init_fake_world(8)
        mesh = make_test_mesh(2, 2, pod=2, device="cpu")
        out["qwen1.5-0.5b train"] = traced(config("qwen1.5-0.5b"), "train",
                                           mesh, pod_stride=4,
                                           grad_compress=True)
    elif scenario == "logs-rule":
        from repro_torch.analysis import hlo
        from repro_torch.configs import get_config, reduced
        init_fake_world(1)
        mesh = make_test_mesh(1, 1, device="cpu")
        out["rules"] = traced(config("qwen3-1.7b"), "train", mesh)
        hlo._FREE.add("mul")
        try:
            out["mul free"] = traced(config("qwen3-1.7b"), "train", mesh)
        finally:
            hlo._FREE.discard("mul")
        upcasts = {}
        dispatch = hlo._Counter.__torch_dispatch__

        def spy(self, func, types, args=(), kwargs=None):
            res = dispatch(self, func, types, args, kwargs)
            pos = {"_to_copy": 0, "copy_": 1}.get(
                func.overloadpacket.__name__)
            if pos is not None and type(res) is torch.Tensor \
                    and type(args[pos]) is torch.Tensor \
                    and args[pos].dtype == torch.bfloat16 \
                    and res.dtype == torch.float32:
                upcasts[str(tuple(res.shape))] = res.numel() * 4
            return res

        hlo._Counter.__torch_dispatch__ = spy
        try:
            out["bf16"] = traced(reduced(get_config("qwen3-1.7b")), "train",
                                 mesh)
        finally:
            hlo._Counter.__torch_dispatch__ = dispatch
        out["bf16"]["upcasts"] = upcasts
    else:
        raise SystemExit(f"unknown scenario {scenario!r}")
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1])
