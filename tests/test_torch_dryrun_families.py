"""The dry-run's DTensor paths of the MoE, RWKV6, RG-LRU and audio
families and Qwen3-14B's padded heads, against the JAX package's.

At published widths on the reference's 16 x 16 mesh, where the reduced
configs would hide what does not divide (RWKV6's 40 heads, RG-LRU's 10
gate blocks, Qwen3-14B's 40 heads, Qwen1.5-MoE's 60 experts over 16
ranks): each cell through both packages' dry-run CLI, the port's `ok`
and its per-rank flops within 10% of the reference's compiled cell.
Then the pieces: Qwen3-14B's 40 heads over 16 ranks cost each rank what
48 even heads cost (3 padded heads, as GSPMD pads them), and
`layers.expand_kv` on DTensors with one kv head and with eight."""
import dataclasses
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_fake_world as fake_world

ROOT = Path(__file__).resolve().parents[1]
FLOPS_RTOL = 0.10
# (arch, shape, extra CLI flags)
CELLS = [(arch, "decode_32k", ()) for arch in (
    "rwkv6-3b", "recurrentgemma-2b", "qwen2-moe-a2.7b",
    "granite-moe-1b-a400m", "musicgen-large", "qwen3-14b")] + [
    ("rwkv6-3b", "long_500k", ()), ("recurrentgemma-2b", "long_500k", ()),
    ("qwen3-14b", "prefill_32k", ()),
    ("qwen2-moe-a2.7b", "decode_32k", ("--expert-sharding", "expert"))]


def _cli(package: str, arch: str, shape: str, extra, out: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", f"{package}.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "single", *extra, "--out", str(out)],
        env=env, cwd=out.parent, capture_output=True, text=True,
        timeout=300)
    lines = out.read_text().splitlines() if out.exists() else []
    assert len(lines) == 1, res.stdout[-2000:] + res.stderr[-2000:]
    return json.loads(lines[0])


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """{(package, cell index): record}, both packages' CLIs over every
    cell, five processes at a time."""
    tmp = tmp_path_factory.mktemp("dryrun_families")
    jobs = [(pkg, i) for i in range(len(CELLS))
            for pkg in ("repro_torch", "repro")]
    with ThreadPoolExecutor(5) as pool:
        recs = pool.map(lambda job: _cli(
            job[0], *CELLS[job[1]], tmp / f"{job[0]}_{job[1]}.jsonl"), jobs)
        return dict(zip(jobs, recs))


@pytest.mark.parametrize("i", range(len(CELLS)),
                         ids=[" ".join((a, s) + e) for a, s, e in CELLS])
def test_published_cell_flops_match_the_reference(records, i):
    port, ref = records[("repro_torch", i)], records[("repro", i)]
    assert ref["ok"], ref.get("error")
    assert port["ok"], port.get("traceback")
    assert (port["mesh"], port["chips"]) == (ref["mesh"], 256)
    np.testing.assert_allclose(port["analysis"]["flops"],
                               ref["analysis"]["flops"], rtol=FLOPS_RTOL)


@pytest.fixture(scope="module")
def flag_worlds():
    return fake_world.run("flags-one", "flags-four")


@pytest.mark.parametrize("arch,kind,opts", fake_world.FLAG_CELLS,
                         ids=[fake_world.flag_key(*c)
                              for c in fake_world.FLAG_CELLS])
def test_cli_options_trace_and_match_the_reference(flag_worlds, arch, kind,
                                                   opts):
    """The dry-run's other options (`--kv-layout contiguous`,
    `--flash-decode`, `--attn-impl tri`, `--wkv-impl scan`) at reduced
    f32 widths: ok on 4 x 4, and one rank's flops on 1 x 1 within 2% of
    the reference's compiled cell with the same options."""
    import jax
    from repro.analysis.hlo import analyze_hlo
    from repro.configs import get_config, reduced
    from repro.configs.base import ShapeConfig
    from repro.distributed import sharding
    from repro.launch.mesh import make_test_mesh
    from repro.launch.steps import build_cell
    key = fake_world.flag_key(arch, kind, opts)
    one, four = flag_worlds["flags-one"][key], flag_worlds["flags-four"][key]
    assert one["ok"], one.get("traceback")
    assert four["ok"], four.get("traceback")
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    shape = ShapeConfig(f"test_{kind}", seq_len=fake_world.SEQ,
                        global_batch=fake_world.BATCH, kind=kind)
    mesh = make_test_mesh(1, 1)
    try:
        cell = build_cell(cfg, shape, mesh, **opts)
        with jax.set_mesh(mesh):
            txt = jax.jit(cell["fn"], in_shardings=cell["in_shardings"],
                          out_shardings=cell["out_shardings"]).lower(
                *cell["args"]).compile().as_text()
    finally:
        sharding.set_global_rules(None)
    np.testing.assert_allclose(one["analysis"]["flops"],
                               analyze_hlo(txt).flops, rtol=0.02)


def test_forty_heads_cost_what_48_even_heads_cost():
    """Qwen3-14B's head layout (40 heads, 8 kv heads) at small widths on
    a (data 1, model 16) fake world: each rank's train and prefill flops
    equal those of the same model with 48 heads, 3 on every rank; the
    port used to run all 40 on each rank."""
    c40, c48 = fake_world.heads_configs()
    assert (c40.num_heads, c48.num_heads, c40.num_kv_heads) == (40, 48, 8)
    assert dataclasses.replace(c48, num_heads=40) == c40
    recs = fake_world.run("heads")["heads"]
    for kind in ("train", "prefill"):
        r40, r48 = recs[f"40 {kind}"], recs[f"48 {kind}"]
        assert r40["ok"], r40.get("traceback")
        assert r48["ok"], r48.get("traceback")
        assert r40["analysis"]["flops"] == r48["analysis"]["flops"], kind


@pytest.mark.parametrize("kv_heads,dim", [(1, 2), (8, 2), (1, 3)])
def test_expand_kv_repeats_each_shards_heads(kv_heads, dim):
    """On a 1 x 1 mesh (a gloo world of one), a DTensor's kv heads split
    over the model axis (as the rules split them there, one kv head
    included) or its head_dim expand as the plain tensor's do;
    `repeat_interleave` on the DTensor itself is a view DTensor refuses
    over a sharded dim."""
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import layers
    mesh = make_test_mesh(1, 1, device="cpu")
    k = torch.from_numpy(np.random.default_rng(kv_heads).standard_normal(
        (2, 5, kv_heads, 16)).astype(np.float32))
    dk = DTensor.from_local(k, mesh.device_mesh, (Shard(0), Shard(dim)),
                            run_check=False)
    out = layers.expand_kv(dk, 40)
    assert tuple(out.shape) == (2, 5, 40, 16)
    assert tuple(out.placements) == (Shard(0), Shard(dim))
    torch.testing.assert_close(out.to_local(),
                               torch.repeat_interleave(k, 40 // kv_heads,
                                                       dim=2))


def test_jobs_trace_each_cell_in_a_process_of_its_own(tmp_path):
    """`--jobs 2 --mesh both`: both meshes' cells at once, each record
    appended once, a `done:` line per mesh."""
    out = tmp_path / "dryrun.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "granite-moe-1b-a400m", "--shape", "decode_32k", "--mesh", "both",
         "--jobs", "2", "--out", str(out)], env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["mesh"], r["ok"]) for r in recs] == [("16x16", True),
                                                    ("2x16x16", True)]
    assert "done: 1 ok, 0 failed (16x16)" in res.stdout
    assert "done: 1 ok, 0 failed (2x16x16)" in res.stdout
    assert not list(tmp_path.glob("*.part"))
