"""The compressed train step beside a split `data` axis: `build_cell(...,
grad_compress=True)`'s fn on the mesh (pod = 2, data = 2, model = 1),
four gloo CPU processes (`tests/_torch_pods.py`, mode "step" with
`data`), held to the JAX package's cell jitted on its
`make_test_mesh(2, 1, pod=2)` over four XLA host devices.

Each pod's batch and FSDP state are split over its two `data` ranks; the
step runs on the per-pod views (`sharding.per_pod`, the reference's
`shard_map` over the pod axis), `psum_compressed` over the pod group.
Held: the new params, AdamW moments and master copy, the loss and the
grad norm within 1e-5 (the train tests' tolerance); each pod's `err`
within one quantization step where a rounding flips (`_err_close`, as
the two-pod test holds it); params equal on both pods and on both data
ranks of each; the grad norm the global one (a pod's or a rank's own
would differ). `sharding.local` itself still raises on a leaf split over
a non-manual axis of two ranks (`test_torch_steps.py`)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import _torch_pods
from test_torch_steps import _cfgs, _err_close

TOL = dict(rtol=1e-5, atol=1e-5)
ROOT = Path(__file__).resolve().parents[1]
DATA, PODS = 2, 2

REFERENCE = """
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
mesh = make_test_mesh(int(inp["data"]), 1, pod=2)
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
for i, row in enumerate(mesh.devices[:, :, 0]):
    for d in row:
        pod_of[d.id] = i
trees = {"p": new_p, **{t: new_o[t] for t in ("mu", "nu", "master")}}
out = {f"{t}/{k}": np.asarray(v) for t, tree in trees.items()
       for k, v in tree.items()}
for k, v in new_o["err"].items():
    whole = [np.zeros(v.shape, np.float32) for _ in range(2)]
    for sh in v.addressable_shards:        # each pod's own residual
        whole[pod_of[sh.device.id]][sh.index] = np.asarray(sh.data)
    for i in range(2):
        out[f"err{i}/{k}"] = whole[i]
out["loss"] = np.asarray(m["loss"])
out["grad_norm"] = np.asarray(m["grad_norm"])
np.savez(dst, **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's four ranks and the reference's cell, started together,
    on reduced f32 Qwen1.5-0.5B (4 x 16 tokens, 2 per pod)."""
    import jax
    from repro.models import build_model as jbuild_model
    tmp = tmp_path_factory.mktemp("pods_data")
    jcfg, _ = _cfgs("qwen1.5-0.5b")
    jp = jbuild_model(jcfg).init_params(jax.random.PRNGKey(0))
    np.savez(tmp / "in.npz", arch="qwen1.5-0.5b", seq_len=16, batch=4,
             data=DATA, **{f"p/{k}": np.asarray(v) for k, v in jp.items()})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS=f"--xla_force_host_platform_device_count="
                         f"{DATA * PODS}")
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE,
                            str(tmp / "in.npz"), str(tmp / "ref.npz")],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        ranks = _torch_pods.run("step", tmp, world=DATA * PODS,
                                timeout=240)
        _, err = ref.communicate(timeout=240)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err
    return ranks, dict(np.load(tmp / "ref.npz")), sorted(jp)


def test_state_loss_and_grad_norm_match_reference(runs):
    ranks, want, names = runs
    for r, got in enumerate(ranks):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], err_msg=(r, k),
                                       **TOL)
        for k in names:
            for t in ("p", "mu", "nu", "master"):
                np.testing.assert_allclose(got[f"{t}/{k}"], want[f"{t}/{k}"],
                                           err_msg=(r, t, k), **TOL)


def test_each_pod_keeps_its_own_error(runs):
    """Rank r is pod r // 2 (the mesh is pod-major): its whole `err` is
    that pod's residual, the same on both of its data ranks; the two
    pods' differ."""
    ranks, want, names = runs
    for r, got in enumerate(ranks):
        pod = r // DATA
        for k in names:
            _err_close(got[f"err/{k}"], want[f"err{pod}/{k}"],
                       float(got[f"amax/{k}"]), k)
            np.testing.assert_array_equal(
                got[f"err/{k}"], ranks[pod * DATA][f"err/{k}"])
    assert any(not np.array_equal(ranks[0][f"err/{k}"],
                                  ranks[DATA][f"err/{k}"]) for k in names)


def test_params_equal_on_every_rank_and_norm_is_global(runs):
    """The pods agree on the new params bit for bit (their exchanged mean
    is reduced in one order); the grad norm is the same on every rank,
    the norm over both pods' data ranks, not one shard's."""
    ranks, want, names = runs
    for got in ranks[1:]:
        for k in names:
            np.testing.assert_array_equal(got[f"p/{k}"], ranks[0][f"p/{k}"])
        assert got["grad_norm"] == ranks[0]["grad_norm"]
    # mu = (1 - b1) * the clipped mean gradient: its norm over the whole
    # leaves is 0.1 * min(1, 1 / grad_norm) * grad_norm
    mu = np.sqrt(sum(float((ranks[0][f"mu/{k}"].astype(np.float64) ** 2)
                           .sum()) for k in names))
    gn = float(ranks[0]["grad_norm"])
    np.testing.assert_allclose(mu, 0.1 * min(1.0, 1.0 / gn) * gn, rtol=1e-5)
