"""The port's dry-run against the JAX package's: per-device argument and
output bytes byte for byte (the reference's own shardings on an abstract
mesh), one rank's flops against the reference's compiled cell, counts
that are per rank and not global, the compressed step's pod all-gather
classified DCN at the bytes the placements give, and one full-width cell
through the CLI. A fake world is one process's only default group, so
every test that needs one runs it in a subprocess
(`tests/_torch_fake_world.py`)."""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh, NamedSharding

import _torch_fake_world as fake_world
from repro.analysis.hlo import analyze_hlo
from repro.configs import ARCH_NAMES as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.configs import shapes_for as ref_shapes_for
from repro.configs.base import ShapeConfig as RefShapeConfig
from repro.configs.base import padded_vocab as ref_padded_vocab
from repro.distributed import sharding as ref_sharding
from repro.launch.mesh import make_test_mesh as ref_test_mesh
from repro.launch.steps import build_cell as ref_build_cell
from repro_torch.configs import ARCH_NAMES, get_config, shapes_for
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.steps import build_cell

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _cells():
    for arch in ARCH_NAMES:
        for shape in shapes_for(get_config(arch)):
            for mesh in MESHES:
                yield arch, shape.name, mesh


def _ref_bytes(leaves, shardings) -> int:
    leaves, shardings = jax.tree.leaves(leaves), jax.tree.leaves(
        shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(leaves) == len(shardings)
    return sum(math.prod(sh.shard_shape(tuple(x.shape))) * x.dtype.itemsize
               for x, sh in zip(leaves, shardings))


def _ref_outputs(cell, cfg, shape):
    """The reference step's outputs, by the shapes its out shardings were
    built for: the train state and three f32 metrics, or the last logits
    (or next tokens) and the cache."""
    import jax.numpy as jnp
    args, model = cell["args"], cell["model"]
    if shape.kind == "train":
        f32 = jax.ShapeDtypeStruct((), jnp.float32)
        return args[0], args[1], {"grad_norm": f32, "loss": f32, "lr": f32}
    B, C = shape.global_batch, cfg.frontend.num_codebooks
    audio = cfg.frontend.kind == "audio" and C > 1
    cache = model.abstract_cache(B, shape.seq_len)
    if shape.kind == "prefill":
        V = ref_padded_vocab(cfg.vocab_size)
        return jax.ShapeDtypeStruct((B, 1, C, V) if audio else (B, 1, V),
                                    jnp.dtype(cfg.dtype)), cache
    return jax.ShapeDtypeStruct((B, 1, C) if audio else (B, 1),
                                jnp.int32), cache


@pytest.mark.parametrize("arch,shape_name,mesh_name", list(_cells()))
def test_memory_equals_the_reference_shard_shapes(arch, shape_name,
                                                  mesh_name):
    """argument_bytes and output_bytes, per device, byte for byte against
    NamedSharding.shard_shape over the reference's own shardings."""
    axes = MESHES[mesh_name]
    shape = next(s for s in shapes_for(get_config(arch))
                 if s.name == shape_name)
    cell = build_cell(get_config(arch), shape, Mesh(axes))
    got = dryrun.memory_record(cell, dryrun.abstract_outputs(cell, shape),
                               peak_bytes=0)

    ref_cfg = ref_get_config(arch)
    ref_shape = next(s for s in ref_shapes_for(ref_cfg)
                     if s.name == shape_name)
    mesh = AbstractMesh(tuple(axes.values()), tuple(axes))
    try:
        ref = ref_build_cell(ref_cfg, ref_shape, mesh)
    finally:
        ref_sharding.set_global_rules(None)
    want_args = _ref_bytes(ref["args"], ref["in_shardings"])
    want_out = _ref_bytes(_ref_outputs(ref, ref_cfg, ref_shape),
                          ref["out_shardings"])
    assert (got["argument_bytes"], got["output_bytes"]) == \
        (want_args, want_out)
    if (arch, shape_name, mesh_name) == ("qwen3-14b", "decode_32k", "16x16"):
        # 361,984,000 of the parameters' 29,536,614,400 bytes per device
        params = cell["args"][0]
        assert dryrun.local_bytes(params, cell["in_shardings"][0]) \
            == 361_984_000
        assert sum(x.numel() * x.element_size()
                   for x in params.values()) == 29_536_614_400


def test_every_reference_arch_is_covered():
    assert tuple(ARCH_NAMES) == tuple(REF_ARCHS)


@pytest.fixture(scope="module")
def worlds():
    """The three fake worlds' records, their processes run at once."""
    return fake_world.run("one", "four", "pods")


@pytest.fixture(scope="module")
def one_rank(worlds):
    return worlds["one"]


@pytest.fixture(scope="module")
def four_by_four(worlds):
    return worlds["four"]


def _ref_cell_flops(arch: str, kind: str) -> float:
    """The reference's analyze_hlo over its compiled cell on its 1 x 1
    mesh, the test's reduced f32 config and shape."""
    cfg = dataclasses.replace(ref_reduced(ref_get_config(arch)),
                              dtype="float32")
    shape = RefShapeConfig(f"test_{kind}", seq_len=fake_world.SEQ,
                           global_batch=fake_world.BATCH, kind=kind)
    mesh = ref_test_mesh(1, 1)
    try:
        cell = ref_build_cell(cfg, shape, mesh)
        with jax.set_mesh(mesh):
            txt = jax.jit(cell["fn"], in_shardings=cell["in_shardings"],
                          out_shardings=cell["out_shardings"]).lower(
                *cell["args"]).compile().as_text()
    finally:
        ref_sharding.set_global_rules(None)
    return analyze_hlo(txt).flops


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", fake_world.ARCHS)
def test_one_rank_flops_equal_the_reference(one_rank, arch, kind):
    rec = one_rank[f"{arch} {kind}"]
    assert rec["ok"], rec.get("traceback")
    want = _ref_cell_flops(arch, kind)
    np.testing.assert_allclose(rec["analysis"]["flops"], want, rtol=0.02)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", fake_world.ARCHS)
def test_counts_are_per_rank_not_global(one_rank, four_by_four, arch,
                                        kind):
    """On a 4 x 4 world each rank counts its own share: 16 ranks' flops
    lie within 1x to 2x of one rank's whole cell (a global count would
    read 16x)."""
    one, four = one_rank[f"{arch} {kind}"], four_by_four[f"{arch} {kind}"]
    assert one["ok"] and four["ok"], four.get("traceback")
    ratio = 16 * four["analysis"]["flops"] / one["analysis"]["flops"]
    assert 1.0 <= ratio <= 2.0, ratio
    assert four["memory"]["argument_bytes"] < one["memory"]["argument_bytes"]
    assert four["collectives_by_op"] and not one["analysis"]["ici_ring_bytes"]


def test_compressed_pod_gather_is_dcn_at_the_placements_bytes(worlds):
    rec = worlds["pods"]["qwen1.5-0.5b train"]
    assert rec["ok"], rec.get("traceback")
    dcn = rec["collectives_by_op"]["all-gather_dcn"]
    assert dcn["result_bytes"] == rec["want_pod_gather_bytes"] \
        == rec["pod_gather_bytes"]
    assert dcn["count"] == 2 * 14          # q and scale of 14 leaves
    assert rec["analysis"]["dcn_ring_bytes"] > 0


def test_full_width_cell_through_the_cli(tmp_path):
    out = tmp_path / "dryrun.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-1.7b", "--shape", "decode_32k", "--mesh", "single",
         "--out", str(out)], env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert rec["ok"] and rec["mesh"] == "16x16" and rec["chips"] == 256
    assert rec["while_trips"] == []
    assert rec["param_count"] == 1_720_574_976
    cell = build_cell(get_config("qwen3-1.7b"),
                      next(s for s in shapes_for(get_config("qwen3-1.7b"))
                           if s.name == "decode_32k"),
                      Mesh(MESHES["16x16"]))
    assert rec["memory"]["argument_bytes"] == dryrun.local_bytes(
        cell["args"], cell["in_shardings"])
    assert 0 < rec["analysis"]["flops"] and \
        rec["analysis"]["num_collectives"] > 0


def test_roofline_terms_divide_by_the_h100_model():
    from repro_torch.launch.mesh import HW
    a = {"flops": 2 * 989e12, "bytes_accessed": 3.35e12,
         "ici_ring_bytes": 450e9, "dcn_ring_bytes": 100e9}
    assert dryrun.roofline_terms(a) == {"compute_s": 2.0, "memory_s": 1.0,
                                        "collective_s": 3.0}
    assert (HW["peak_flops_bf16"], HW["hbm_bw"], HW["ici_bw"],
            HW["dcn_bw"]) == (989e12, 3.35e12, 450e9, 50e9)
