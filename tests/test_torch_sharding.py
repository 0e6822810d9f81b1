"""The port's logical-axis sharding held to the JAX package's.

`make_rules` equals the reference's dict, key for key, for all ten
architectures on the production meshes' shapes (16 x 16 and 2 x 16 x
16, shape-only), in both `expert_sharding` modes and with and without
`flash_decode`; `spec_for` gives the reference's spec entry for entry
for every parameter and cache leaf at full shapes, with and without the
evenness fallback; `tree_shardings` keeps the reference's leaf-count
check. On real meshes: `NamedSharding.placements` on a one-rank CPU
mesh and on a two-rank (2, 1, 1) gloo mesh, where `place` keeps each
rank's shard, `full_tensor()` gives the whole back and `constrain`
redistributes a DTensor under installed rules; `constrain` returns a
plain tensor, and any tensor without rules, unchanged. Exact (no
tolerance: the rules and specs are names)."""
import dataclasses
import json

import numpy as np
import pytest
import torch

import _torch_pods
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.distributed import sharding as S
from repro_torch.distributed.sharding import NamedSharding, PartitionSpec as P
from repro_torch.launch.mesh import Mesh, make_test_mesh
from repro_torch.models import build_model

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


class FakeMesh:
    """Shape-only stand-in, as the reference's tests use."""
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def _configs(name, mode):
    """Both packages' config for `name`, with `expert_sharding` = `mode`
    on MoE models."""
    from repro.configs import get_config as jget_config
    j, t = jget_config(name), get_config(name)
    if t.moe is not None:
        j = dataclasses.replace(j, moe=dataclasses.replace(
            j.moe, expert_sharding=mode))
        t = dataclasses.replace(t, moe=dataclasses.replace(
            t.moe, expert_sharding=mode))
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("mode", ["expert", "ffn"])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_make_rules_equal_reference(name, mode, mesh_name):
    from repro.distributed.sharding import make_rules as jmake_rules
    mesh = FakeMesh(MESHES[mesh_name])
    j, t = _configs(name, mode)
    for flash in (False, True):
        assert S.make_rules(t, mesh, flash_decode=flash) == \
            jmake_rules(j, mesh, flash_decode=flash)


def _leaf_specs(pkg_spec_for, rules, axes, shapes, mesh):
    out = {}
    for k in sorted(axes):
        if isinstance(axes[k], dict):
            out.update({f"{k}/{kk}": v for kk, v in _leaf_specs(
                pkg_spec_for, rules, axes[k], shapes[k], mesh).items()})
        else:
            shape = tuple(shapes[k].shape)
            out[k] = (tuple(pkg_spec_for(axes[k], rules, shape, mesh)),
                      tuple(pkg_spec_for(axes[k], rules)))
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_spec_for_equal_reference_on_every_leaf(name, mesh_name):
    """Every parameter and cache (or state) leaf at full shapes: the spec
    with the evenness fallback (argument shardings) and without it."""
    from repro.distributed.sharding import make_rules as jmake_rules
    from repro.distributed.sharding import spec_for as jspec_for
    from repro.models import build_model as jbuild_model
    mesh = FakeMesh(MESHES[mesh_name])
    j, t = _configs(name, "expert")
    jm, tm = jbuild_model(j), build_model(t)
    B, S_len = 128, 32768                # decode_32k's cache
    for flash in (False, True):
        jr = jmake_rules(j, mesh, flash_decode=flash)
        tr = S.make_rules(t, mesh, flash_decode=flash)
        want = _leaf_specs(jspec_for, jr, jm.logical_axes(),
                           jm.abstract_params(), mesh)
        got = _leaf_specs(S.spec_for, tr, tm.logical_axes(),
                          tm.abstract_params(), mesh)
        assert got == want
        want = _leaf_specs(jspec_for, jr, jm.cache_logical_axes(S_len),
                           jm.abstract_cache(B, S_len), mesh)
        got = _leaf_specs(S.spec_for, tr, tm.cache_logical_axes(S_len),
                          tm.abstract_cache(B, S_len), mesh)
        assert got == want


def test_tree_shardings_keep_the_reference_leaf_count_check():
    cfg = get_config("qwen1.5-0.5b")
    mesh = Mesh(MESHES["16x16"])
    rules = S.make_rules(cfg, mesh)
    tm = build_model(cfg)
    sh = S.tree_shardings(tm.logical_axes(), mesh, rules,
                          tm.abstract_params())
    assert set(sh) == set(tm.abstract_params())
    assert sh["embed"].spec == P("model", "data")
    ap = dict(tm.abstract_params())
    ap.pop("embed")
    with pytest.raises(ValueError, match="does not match shapes"):
        S.tree_shardings(tm.logical_axes(), mesh, rules, ap)


def test_placements_on_a_one_rank_mesh():
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_test_mesh(1, 1, device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.device_mesh.mesh_dim_names == ("data", "model")
    assert NamedSharding(mesh, P("data", None)).placements == \
        (Shard(0), Replicate())
    assert NamedSharding(mesh, P(None, "model", "data")).placements == \
        (Shard(2), Shard(1))
    assert NamedSharding(mesh, P(("data", "model"))).placements == \
        (Shard(0), Shard(0))
    assert S.replicated(mesh).placements == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="shards dims"):
        NamedSharding(mesh, P("data", "data")).placements
    with pytest.raises(ValueError, match="not in mesh"):
        NamedSharding(mesh, P("pod")).placements
    with pytest.raises(ValueError, match="mesh order"):
        NamedSharding(mesh, P(("model", "data"))).placements


def test_placements_place_and_constrain_on_two_gloo_ranks(tmp_path):
    ranks = _torch_pods.run("mesh", tmp_path)
    x = torch.arange(2 * 6 * 4, dtype=torch.float32).reshape(2, 6, 4)
    for r, out in enumerate(ranks):
        info = json.loads(str(out["json"]))
        assert info["batch"] == ["S(1)", "S(1)", "R"]
        assert info["pod_model"] == ["S(0)", "R", "S(1)"]
        assert info["replicated"] == ["R", "R", "R"]
        assert info["constrained"] == ["S(1)", "S(1)", "R"]
        half = x.chunk(2, dim=1)[r].numpy()
        assert (out["batch/local"] == half).all()
        assert (out["pod_model/local"] == x[r:r + 1].numpy()).all()
        assert (out["replicated/local"] == x.numpy()).all()
        assert (out["constrained/local"] == half).all()
        for spec in ("batch", "pod_model", "replicated"):
            assert bool(out[f"{spec}/full_ok"]), spec


def test_constrain_passes_plain_tensors_and_needs_rules():
    x = torch.ones(2, 3)
    assert S.get_global_rules() is None
    assert S.constrain(x, ("batch", None)) is x
    S.set_global_rules({"batch": ("data",)})
    try:
        assert S.constrain(x, ("batch", None)) is x
    finally:
        S.set_global_rules(None)
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_test_mesh(1, 1, device="cpu")
    d = S.place(x, S.replicated(mesh))
    assert S.constrain(d, ("batch", None)) is d          # no rules
    S.set_global_rules({"batch": "data"})
    try:
        c = S.constrain(d, ("batch", None))
    finally:
        S.set_global_rules(None)
    assert c.placements == (Shard(0), Replicate())
    assert torch.equal(c.to_local(), x)


def test_kernels_refuse_dtensors():
    """A DTensor handed to a kernel's entry point raises (it is never
    computed on by the kernel or its plain version); the CUDA wrappers
    refuse it too."""
    from repro_torch.kernels.paged_attention.kernel import \
        paged_decode_attention_cuda
    from repro_torch.kernels.paged_attention.ops import \
        paged_decode_attention
    from repro_torch.kernels.rmsnorm.kernel import rms_norm_cuda
    from repro_torch.kernels.rmsnorm.ops import rms_norm_op
    from repro_torch.kernels.rs_gf256.kernel import gf256_matmul_cuda
    from repro_torch.kernels.rs_gf256.ops import gf256_matmul
    mesh = make_test_mesh(1, 1, device="cpu")

    def dt(t):
        return S.place(t, S.replicated(mesh))

    x, w = torch.randn(3, 8), torch.ones(8)
    for fn in (rms_norm_op, rms_norm_cuda):
        with pytest.raises(TypeError, match="plain tensors"):
            fn(dt(x), w)
    q, pool = torch.randn(1, 2, 8), torch.randn(1, 2, 4, 1, 8)
    table = torch.zeros(1, 2, dtype=torch.int32)
    lens = torch.ones(1, dtype=torch.int32)
    for fn in (paged_decode_attention, paged_decode_attention_cuda):
        with pytest.raises(TypeError, match="plain tensors"):
            fn(dt(q), pool, pool, table, lens)
    G = np.ones((2, 4), np.uint8)
    X = torch.zeros(4, 16, dtype=torch.uint8)
    for fn in (gf256_matmul, gf256_matmul_cuda):
        with pytest.raises(TypeError, match="plain tensors"):
            fn(G, dt(X))
    # plain CPU tensors still take the plain versions
    assert rms_norm_op(x, w).shape == x.shape


def test_installed_rules_restore_the_outer_ones():
    with S.installed_rules({"batch": "data"}):
        with pytest.raises(RuntimeError):
            with S.installed_rules({"batch": None}):
                assert S.get_global_rules() == {"batch": None}
                raise RuntimeError
        assert S.get_global_rules() == {"batch": "data"}
    assert S.get_global_rules() is None
