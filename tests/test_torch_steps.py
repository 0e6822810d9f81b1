"""The port's step builders, specs and abstract shapes held to the JAX
package's `launch/{steps,specs}.py`.

For every (arch x shape) of `shapes_for`: the input specs, their
logical axes and `num_microbatches` (dp 1, 16, 32); the models'
`logical_axes`, `cache_logical_axes` and `abstract_cache` (shapes and
dtypes, as meta tensors: nothing is allocated, `long_500k` included);
`adamw.opt_logical_axes` and the abstract train state. Then
`build_cell`'s train, prefill and decode cells on a 1 x 1 CPU mesh,
their arguments `place`d as DTensors, against the reference's cell fn
jitted on its `make_test_mesh(1, 1)` for reduced f32 configs with the
reference's weights: the train step's params, AdamW state and metrics
within 1e-5 (the train tests' tolerance), prefill logits and cache
within 1e-5, decode tokens equal. `local` raises on a leaf sharded over
a mesh axis of two ranks. The compressed step on two gloo CPU processes
(one pod each) against the reference's `make_train_step_compressed` on
a (2, 1, 1) mesh of two host devices (run in a subprocess): params, the
AdamW moments and master copy, and the loss within 1e-5 (after one step
mu is (1 - b1) times the exchanged mean, which the tolerance resolves:
half or twice the reference's mu fails it on every leaf); each pod's quantization error err = g + e - xhat
within 1e-4 of the leaf's largest |g + e| (it inherits the gradient's
absolute f32 rounding: the embedding's gradient, a scatter-add over
tokens plus the tied head's product, summed in another order, differs
by 2.6e-5 of its largest element here), or, for at most 1 element in
1000, one quantization step apart (g + e on a rounding boundary,
rounded the other way)."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_pods
from repro_torch.configs import ARCH_NAMES, ShapeConfig, get_config, reduced
from repro_torch.data.pipeline import make_batch
from repro_torch.distributed import sharding as S
from repro_torch.distributed.sharding import local, place
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.steps import build_cell
from repro_torch.models import build_model
from repro_torch.models.convert import (train_state_from_numpy,
                                        train_state_to_numpy)
from repro_torch.optim import adamw

TOL = dict(rtol=1e-5, atol=1e-5)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def no_rules_left():
    """The reference's `build_cell` installs process-global rules (the
    port's are installed only while a cell's fn runs): take them down
    after each test."""
    yield
    assert S.get_global_rules() is None
    from repro.distributed import sharding as JS
    JS.set_global_rules(None)


def _dtype_name(dt) -> str:
    return str(dt).split(".")[-1]


def _flat(tree, prefix=""):
    """{path: leaf} over nested dicts (tuples of logical axes are
    leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _shapes(tree):
    return {k: (tuple(v.shape), _dtype_name(v.dtype))
            for k, v in _flat(tree).items()}


def _meta(tree):
    return all(v.device.type == "meta" for v in _flat(tree).values())


def _cells():
    from repro.configs import get_config as jget_config
    from repro.configs import shapes_for as jshapes_for
    for name in ARCH_NAMES:
        for shape in jshapes_for(jget_config(name)):
            yield name, shape.name


@pytest.mark.parametrize("name,shape_name", list(_cells()))
def test_specs_axes_and_abstract_shapes_equal_reference(name, shape_name):
    from repro.configs import SHAPES_BY_NAME as JSHAPES
    from repro.configs import get_config as jget_config
    from repro.launch import specs as jspecs
    from repro.models import build_model as jbuild_model
    from repro.optim import adamw as jadamw
    from repro_torch.configs import SHAPES_BY_NAME
    j, t = jget_config(name), get_config(name)
    jshape, shape = JSHAPES[shape_name], SHAPES_BY_NAME[shape_name]
    for dp in (1, 16, 32):
        assert specs_lib.num_microbatches(t, shape, dp) == \
            jspecs.num_microbatches(j, jshape, dp)
    pairs = [(specs_lib.input_specs(t, shape),
              jspecs.input_specs(j, jshape)),
             (specs_lib.train_batch_specs(t, shape, dp=32),
              jspecs.train_batch_specs(j, jshape, dp=32)),
             (specs_lib.prefill_batch_specs(t, shape),
              jspecs.prefill_batch_specs(j, jshape)),
             (specs_lib.decode_batch_specs(t, shape),
              jspecs.decode_batch_specs(j, jshape))]
    for (tspec, taxes), (jspec, jaxes) in pairs:
        assert _meta(tspec)
        assert _shapes(tspec) == _shapes(jspec)
        assert taxes == jaxes
    tm, jm = build_model(t), jbuild_model(j)
    assert tm.logical_axes() == jm.logical_axes()
    assert _meta(tm.abstract_params())
    assert _shapes(tm.abstract_params()) == _shapes(jm.abstract_params())
    B, L = shape.global_batch, shape.seq_len
    assert tm.cache_logical_axes(L) == jm.cache_logical_axes(L)
    cache = tm.abstract_cache(B, L)
    assert _meta(cache)
    assert _shapes(cache) == _shapes(jm.abstract_cache(B, L))
    assert adamw.opt_logical_axes(tm.logical_axes()) == \
        jadamw.opt_logical_axes(jm.logical_axes())
    opt = adamw.abstract_opt_state(tm.abstract_params())
    assert _meta(opt)
    assert _shapes(opt) == _shapes(jadamw.abstract_opt_state(
        jm.abstract_params()))


def _cfgs(name):
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    j = dataclasses.replace(jreduced(jget_config(name)), dtype="float32")
    t = dataclasses.replace(reduced(get_config(name)), dtype="float32")
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _reference_cell(jcfg, shape, **kw):
    """The reference's cell on its 1 x 1 mesh, jitted with its
    shardings; returns (cell, jitted fn, mesh)."""
    import jax
    from repro.launch.mesh import make_test_mesh as jmake_test_mesh
    from repro.launch.steps import build_cell as jbuild_cell
    mesh = jmake_test_mesh(1, 1)
    cell = jbuild_cell(jcfg, shape, mesh, **kw)
    fn = jax.jit(cell["fn"], in_shardings=cell["in_shardings"],
                 out_shardings=cell["out_shardings"])
    return cell, fn, mesh


def _port_cell(tcfg, shape, **kw):
    cell = build_cell(tcfg, shape, make_test_mesh(1, 1, device="cpu"), **kw)
    assert all(v.device.type == "meta" for v in S.tree_leaves(cell["args"]))
    return cell


def test_build_cell_train_matches_reference():
    import jax
    from repro.data.pipeline import make_batch as jmake_batch
    from repro.optim import adamw as jadamw
    jcfg, tcfg = _cfgs("qwen1.5-0.5b")
    shape = ShapeConfig("t", seq_len=16, global_batch=4, kind="train")
    jcell, jfn, jmesh = _reference_cell(jcfg, shape)
    tcell = _port_cell(tcfg, shape)
    assert tcell["donate_argnums"] == jcell["donate_argnums"] == (0, 1)
    n = tcell["args"][2]["tokens"].shape[0]
    assert n == jcell["args"][2]["tokens"].shape[0]
    jp = jcell["model"].init_params(jax.random.PRNGKey(0))
    jstate = {"params": jp, "opt": jadamw.adamw_init(jp)}
    tstate = train_state_from_numpy(_numpy_tree(jstate), device="cpu")
    jb = jmake_batch(jcfg, shape, step=0, num_microbatches=n)
    tb = {k: torch.from_numpy(v) for k, v in make_batch(
        tcfg, shape, step=0, num_microbatches=n).items()}
    with jax.set_mesh(jmesh):
        jout = jfn(jstate["params"], jstate["opt"], jb)
    args = place((tstate["params"], tstate["opt"], tb), tcell["in_shardings"])
    tout = tcell["fn"](*args)
    assert type(tout[0]["embed"]).__name__ == "DTensor"
    tout = local(tout)
    for got, want in zip(tout, jout):
        got = train_state_to_numpy(got)
        want = _numpy_tree(want)
        for k, v in _flat(want).items():
            np.testing.assert_allclose(_flat(got)[k], v, err_msg=k, **TOL)


def test_build_cell_prefill_matches_reference():
    import jax
    jcfg, tcfg = _cfgs("qwen3-1.7b")
    shape = ShapeConfig("p", seq_len=16, global_batch=2, kind="prefill")
    jcell, jfn, jmesh = _reference_cell(jcfg, shape)
    tcell = _port_cell(tcfg, shape)
    jp = jcell["model"].init_params(jax.random.PRNGKey(0))
    tp = train_state_from_numpy(_numpy_tree(jp), device="cpu")
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    with jax.set_mesh(jmesh):
        jlg, jcache = jfn(jp, {"tokens": toks})
    tlg, tcache = local(tcell["fn"](*place(
        (tp, {"tokens": torch.from_numpy(toks)}), tcell["in_shardings"])))
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL)
    for k, v in _numpy_tree(jcache).items():
        np.testing.assert_allclose(train_state_to_numpy(tcache[k]), v,
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("name", ["qwen3-1.7b", "rwkv6-3b"])
def test_build_cell_decode_matches_reference(name):
    import jax
    jcfg, tcfg = _cfgs(name)
    prompt, steps = 12, 4
    shape = ShapeConfig("d", seq_len=prompt + steps, global_batch=2,
                        kind="decode")
    jcell, jfn, jmesh = _reference_cell(jcfg, shape)
    tcell = _port_cell(tcfg, shape)
    assert tcell["donate_argnums"] == jcell["donate_argnums"] == (2,)
    jm, tm = jcell["model"], tcell["model"]
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = train_state_from_numpy(_numpy_tree(jp), device="cpu")
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, prompt)).astype(np.int32)
    with jax.set_mesh(jmesh):           # its rules are installed
        jlg, jcache = jm.prefill(jp, {"tokens": toks},
                                 max_len=shape.seq_len)
    tlg, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                             max_len=shape.seq_len)
    assert _shapes(tcache) == _shapes(tcell["args"][2])
    jtok = np.asarray(jlg[:, -1].argmax(-1)).astype(np.int32)[:, None]
    ttok = tlg[:, -1].argmax(-1).to(torch.int32)[:, None]
    assert (ttok.numpy() == jtok).all()
    for _ in range(steps):
        with jax.set_mesh(jmesh):
            jtok, jcache = jfn(jp, {"token": jtok}, jcache)
        ttok, tcache = local(tcell["fn"](*place(
            (tp, {"token": ttok}, tcache), tcell["in_shardings"])))
        assert ttok.dtype == torch.int32
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


def test_cell_fn_installs_its_rules_for_the_call_only():
    from repro_torch.launch.steps import _on_mesh
    mesh = make_test_mesh(1, 1, device="cpu")
    rules, seen = S.make_rules(get_config("qwen3-1.7b"), mesh), []

    def step(x):
        seen.append(S.get_global_rules())
        return 2 * x

    fn = _on_mesh(step, S.replicated(mesh), rules)
    out = fn(place(torch.ones(3), S.replicated(mesh)))
    assert seen == [rules] and S.get_global_rules() is None
    assert torch.equal(local(out), torch.full((3,), 2.0))


def test_local_raises_beyond_size_one_axes(tmp_path):
    ranks = _torch_pods.run("mesh", tmp_path)
    x = torch.arange(2 * 6 * 4, dtype=torch.float32).reshape(2, 6, 4)
    for r, out in enumerate(ranks):
        msg = json.loads(str(out["json"]))["local_raises"]
        assert msg and "'pod' of size 2" in msg
        # with the pod axis manual, the rank's own shard
        assert (out["manual/local"] == x.chunk(2, dim=1)[r].numpy()).all()


REFERENCE_COMPRESSED = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import ShapeConfig, get_config, reduced
from repro.data.pipeline import make_batch
from repro.launch.mesh import make_test_mesh
from repro.launch.steps import build_cell
from repro.optim import adamw
src, dst = sys.argv[1:]
inp = np.load(src)
cfg = dataclasses.replace(reduced(get_config(str(inp["arch"]))),
                          dtype="float32")
shape = ShapeConfig("pods", seq_len=int(inp["seq_len"]),
                    global_batch=int(inp["batch"]), kind="train")
mesh = make_test_mesh(1, 1, pod=2)
cell = build_cell(cfg, shape, mesh, grad_compress=True)
params = {k[2:]: jnp.asarray(inp[k]) for k in inp.files if k[:2] == "p/"}
opt = adamw.adamw_init(params)
opt["err"] = {k: jnp.zeros(v.shape, jnp.float32) for k, v in params.items()}
n = cell["args"][2]["tokens"].shape[0]
batch = make_batch(cfg, shape, step=0, num_microbatches=n)
with jax.set_mesh(mesh):
    fn = jax.jit(cell["fn"], in_shardings=cell["in_shardings"],
                 out_shardings=cell["out_shardings"])
    new_p, new_o, m = fn(params, opt, batch)
pod_of = {d.id: i for i, d in enumerate(mesh.devices[:, 0, 0])}
trees = {"p": new_p, **{t: new_o[t] for t in ("mu", "nu", "master")}}
out = {f"{t}/{k}": np.asarray(v) for t, tree in trees.items()
       for k, v in tree.items()}
for k, v in new_o["err"].items():
    for sh in v.addressable_shards:        # each pod's own residual
        out[f"err{pod_of[sh.device.id]}/{k}"] = np.asarray(sh.data)
out["loss"] = np.asarray(m["loss"])
np.savez(dst, **out)
"""


def _err_close(got, want, amax, name):
    step = np.float32(max(amax, 1e-12)) / np.float32(127.0)
    atol = 1e-4 * amax
    d = np.abs(got.astype(np.float64) - want)
    flips = np.abs(d - step) <= atol
    assert ((d <= atol) | flips).all(), (name, float(d.max()), atol, step)
    assert (flips & (d > atol)).sum() <= max(1, got.size // 1000), name


def test_compressed_step_two_pods_matches_reference(tmp_path):
    import jax
    from repro.models import build_model as jbuild_model
    jcfg, _ = _cfgs("qwen1.5-0.5b")
    jp = jbuild_model(jcfg).init_params(jax.random.PRNGKey(0))
    np.savez(tmp_path / "in.npz", arch="qwen1.5-0.5b", seq_len=16, batch=4,
             **{f"p/{k}": np.asarray(v) for k, v in jp.items()})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    ref = subprocess.run([sys.executable, "-c", REFERENCE_COMPRESSED,
                          str(tmp_path / "in.npz"),
                          str(tmp_path / "ref.npz")],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert ref.returncode == 0, ref.stderr
    want = dict(np.load(tmp_path / "ref.npz"))
    ranks = _torch_pods.run("step", tmp_path)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
        for k in jp:
            # mu = (1 - b1) * the exchanged mean after one step
            for t in ("p", "mu", "nu", "master"):
                np.testing.assert_allclose(got[f"{t}/{k}"], want[f"{t}/{k}"],
                                           err_msg=f"{t}/{k}", **TOL)
            _err_close(got[f"err/{k}"], want[f"err{r}/{k}"],
                       float(got[f"amax/{k}"]), k)
    for k in jp:          # the tolerance sees the mean: half or twice it fail
        for f in (0.5, 2.0):
            assert not np.allclose(f * want[f"mu/{k}"], want[f"mu/{k}"],
                                   **TOL), (k, f)
    for k in jp:          # the pods agree on params, not on their errors
        np.testing.assert_array_equal(ranks[0][f"p/{k}"], ranks[1][f"p/{k}"])
    assert any(not np.array_equal(ranks[0][f"err/{k}"], ranks[1][f"err/{k}"])
               for k in jp)
