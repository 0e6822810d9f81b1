"""The dry-run's saved logs and their re-analysis: `analyze_hlo` over a
cell's log of counted ops gives the live trace's flops, bytes,
transcendentals and collectives (one cell of each family on a 2 x 2
fake world, and the compressed step's DCN all-gather on pod x data x
model); a rule changed in `analysis/hlo.py` moves the trace and the
re-analysis alike; the bf16 -> f32 upcasts are the conversions the
trace dispatched; `scripts/torch_reanalyze.py` refreshes a `--save-hlo`
dry-run's records in place. The fake worlds run in subprocesses
(`tests/_torch_fake_world.py`)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_fake_world as fake_world
from repro_torch.analysis import hlo
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-9


@pytest.fixture(scope="module")
def logs():
    """The three log scenarios' traces, their processes run at once."""
    return fake_world.run("logs", "logs-pods", "logs-rule", timeout=600)


def _assert_reanalysis_equals(live: dict, log: str, pod_stride: int):
    got = hlo.analyze_hlo(log, pod_stride=pod_stride)
    for name in ("flops", "bytes_accessed", "transcendentals"):
        np.testing.assert_allclose(getattr(got, name), live[name],
                                   rtol=REL, err_msg=name)
    assert got.bytes_by_op.keys() == live["bytes_by_op"].keys()
    for name, b in live["bytes_by_op"].items():
        np.testing.assert_allclose(got.bytes_by_op[name], b, rtol=REL,
                                   err_msg=name)
    summary = got.summary()
    assert summary.keys() == live["summary"].keys()
    for name, v in live["summary"].items():
        np.testing.assert_allclose(summary[name], v, rtol=REL, err_msg=name)
    assert summary["num_collectives"] == live["summary"]["num_collectives"]
    by_op = dryrun.collectives_by_op(got.collectives)
    assert by_op.keys() == live["collectives_by_op"].keys()
    for op, d in live["collectives_by_op"].items():
        assert by_op[op]["count"] == d["count"], op
        for name in ("result_bytes", "ring_bytes"):
            np.testing.assert_allclose(by_op[op][name], d[name], rtol=REL,
                                       err_msg=f"{op} {name}")
    return got


@pytest.mark.parametrize("arch,kind", fake_world.LOG_CELLS)
def test_reanalysis_equals_the_trace(logs, arch, kind):
    live = logs["logs"][f"{arch} {kind}"]
    _assert_reanalysis_equals(live, live["log"], 10**9)
    assert live["summary"]["num_collectives"] > 0   # a 2 x 2 mesh's


def test_reanalysis_keeps_the_pod_gather_dcn(logs):
    live = logs["logs-pods"]["qwen1.5-0.5b train"]
    _assert_reanalysis_equals(live, live["log"], 4)
    dcn = live["collectives_by_op"]["all-gather_dcn"]
    assert dcn["count"] == 2 * 14           # q and scale of 14 leaves
    assert live["summary"]["dcn_ring_bytes"] > 0
    # at another pod stride the same log reads the gather as ICI
    ici = dryrun.collectives_by_op(
        hlo.analyze_hlo(live["log"], pod_stride=10**9).collectives)
    assert "all-gather_dcn" not in ici


def test_memo_hits_and_replays_count_in_the_log(logs):
    """A memo hit and a replayed call each raise a line's times: the
    times sum to the ops the trace ran, and fewer lines than ops."""
    totals = [hlo.log_totals(v["log"]) for v in logs["logs"].values()]
    assert all(t["memo_hits"] > 0 for t in totals)
    assert any(t["replays"] > 0 for t in totals)
    for v in logs["logs"].values():
        t = hlo.log_totals(v["log"])
        lines = hlo.parse_hlo(v["log"])
        assert len(lines) == t["signatures"] < t["ops"]
        assert sum(e.n for e in lines) == t["ops"]


def test_a_rule_change_moves_trace_and_reanalysis_alike(logs, monkeypatch):
    rules = logs["logs-rule"]["rules"]
    free = logs["logs-rule"]["mul free"]
    moved = rules["bytes_accessed"] - free["bytes_accessed"]
    assert moved > 0 and moved == rules["bytes_by_op"]["mul"]
    before = hlo.analyze_hlo(rules["log"], pod_stride=10**9)
    monkeypatch.setattr(hlo, "_FREE", hlo._FREE | {"mul"})
    after = _assert_reanalysis_equals(free, rules["log"], 10**9)
    np.testing.assert_allclose(before.bytes_accessed - after.bytes_accessed,
                               moved, rtol=REL)
    assert "mul" not in after.bytes_by_op


def test_bf16_upcasts_are_the_dispatched_conversions(logs):
    bf16 = logs["logs-rule"]["bf16"]
    want = bf16["upcasts"]
    assert want
    assert hlo.bf16_upcast_f32_bytes(bf16["log"], min_bytes=0) == \
        sum(want.values())
    big = max(want.values())
    assert hlo.bf16_upcast_f32_bytes(bf16["log"], min_bytes=big) == \
        sum(b for b in want.values() if b >= big)
    # an f32 cell converts nothing from bf16
    assert hlo.bf16_upcast_f32_bytes(logs["logs-rule"]["rules"]["log"],
                                     min_bytes=0) == 0


def test_bf16_upcast_bytes_counted_by_hand():
    """One buffer per distinct f32 shape converted from bf16: `.float()`
    twice at one shape, a window copied into an f32 buffer, a product
    converted; f32 -> bf16 and f32 -> f32 are not upcasts."""
    def f(x, w):
        a = x.float() + x.float()                      # (64, 32) once
        b = (x @ w).float()                            # (64, 16)
        buf = torch.empty(8, dtype=torch.float32, device="meta")
        buf.copy_(x[0, :8])                            # (8,)
        c = a.to(torch.bfloat16).float()               # (64, 32) again
        return a.sum() + b.sum() + buf.sum() + c.sum() + a.float().sum()

    x = torch.ones(64, 32, dtype=torch.bfloat16, device="meta")
    w = torch.ones(32, 16, dtype=torch.bfloat16, device="meta")
    log = hlo.analyze(f, x, w).log
    assert hlo.bf16_upcast_f32_bytes(log, min_bytes=0) == \
        4 * (64 * 32 + 64 * 16 + 8)
    assert hlo.bf16_upcast_f32_bytes(log, min_bytes=4 * 64 * 16) == \
        4 * (64 * 32 + 64 * 16)
    assert hlo.bf16_upcast_f32_bytes(log) == 0     # 128 MiB by default


def test_log_lines_round_trip_every_argument_kind():
    """Tensors by layout (strided views too), dtypes, devices, memory
    formats and scalars come back as the rules read them."""
    def f(x):
        y = x.t().contiguous(memory_format=torch.contiguous_format)
        z = torch.zeros(3, dtype=torch.float16, device="meta")
        return y.to(torch.float64).sum() + z.sum() + torch.full(
            (2,), float("inf"), device="meta").sum()

    live = hlo.analyze(f, torch.ones(4, 6, device="meta"))
    got = hlo.analyze_hlo(live.log)
    assert (got.flops, got.bytes_accessed, got.bytes_by_op) == \
        (live.flops, live.bytes_accessed, live.bytes_by_op)
    lines = {e.op: e for e in hlo.parse_hlo(live.log)}
    t = lines["aten.t.default"]
    assert t.out == {"$t": [[6, 4], [1, 6], "float32"]}
    assert hlo._dec(lines["aten.zeros.default"].kwargs["dtype"]) == \
        torch.float16


def _dry_run(tmp_path: Path, out: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-1.7b", "--shape", "decode_32k", "--mesh", "single",
         "--save-hlo", "--out", str(out)], env=env, cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    return rec


def _reanalyze(tmp_path: Path, path: Path) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "torch_reanalyze.py"),
         str(path)], env=env, cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    return res.stdout


def test_reanalyze_script_refreshes_a_saved_dry_run(tmp_path):
    """`--save-hlo` writes the cell's log under experiments/torch_hlo/ of
    the working directory; the script re-runs the rules over it and
    leaves the traced record's analysis as it was, after it was
    clobbered; records that failed or have no log stay as they are."""
    out = tmp_path / "dryrun.jsonl"
    rec = _dry_run(tmp_path, out)
    log = tmp_path / dryrun.HLO_DIR / "qwen3-1.7b_decode_32k_16x16.txt"
    assert rec["ok"] and log.exists()
    assert hlo.log_totals(log.read_text())["ops"] > 0
    assert rec["memory"]["f32_upcast_bytes"] == \
        hlo.bf16_upcast_f32_bytes(log.read_text())
    assert "tpu_corrected_bytes" not in rec["memory"]
    stale = dict(rec, analysis={k: 0.0 for k in rec["analysis"]},
                 collectives_by_op={},
                 memory=dict(rec["memory"], f32_upcast_bytes=-1))
    out.write_text(json.dumps(stale) + "\n")
    assert "re-analyzed 1/1 records" in _reanalyze(tmp_path, out)
    (new,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert new["memory"] == rec["memory"]
    for k, v in rec["analysis"].items():
        np.testing.assert_allclose(new["analysis"][k], v, rtol=REL)
    assert new["collectives_by_op"].keys() == rec["collectives_by_op"].keys()
    for op, d in rec["collectives_by_op"].items():
        assert new["collectives_by_op"][op]["count"] == d["count"]
        for k in ("result_bytes", "ring_bytes"):
            np.testing.assert_allclose(new["collectives_by_op"][op][k],
                                       d[k], rtol=REL)
    failed = {"arch": "qwen3-1.7b", "shape": "train_4k", "mesh": "16x16",
              "tag": "", "ok": False, "error": "E"}
    no_log = dict(stale, shape="prefill_32k")
    out.write_text("\n".join(json.dumps(r) for r in (stale, failed, no_log))
                   + "\n")
    assert "re-analyzed 1/3 records" in _reanalyze(tmp_path, out)
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert recs[1] == failed and recs[2] == no_log
