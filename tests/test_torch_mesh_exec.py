"""`build_cell`'s cells executed over mesh axes larger than one rank,
held to the JAX package's cells on the same mesh.

On gloo worlds of two and four CPU processes (`tests/_torch_mesh_ranks.py`,
one rank per process), the port's train cell (reduced f32 Qwen1.5-0.5B,
4 x 16 tokens), prefill cell and decode cell (reduced f32 Qwen3-1.7B,
4 prompts of 16, 4 greedy steps) run their steps on DTensors: FSDP over
`data`, Megatron's column- and row-parallel projections over `model`,
the vocab-parallel lookup, the per-shard paged cache, RMSNorm on each
rank's rows. The reference's cells run jitted with their shardings on
its `make_test_mesh(data, model)` over as many XLA host devices, in a
subprocess. Held: the new params, AdamW moments and master copy, loss
and grad norm within 1e-5 (the train tests' tolerance), and within 1e-5
of the port's plain step on one rank; prefill logits and cache within
1e-5; the decode cell's greedy tokens equal on every rank; each rank
holds 1/n of every leaf its sharding splits over n ranks. Then
`layers.rms_norm`'s scale gradient on a rows-split mesh, and the paged
kernel's per-shard dispatch refusing a pool split over head_dim."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_mesh_ranks
from repro_torch.configs import ShapeConfig
from repro_torch.data.pipeline import make_batch
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.optim import adamw

TOL = dict(rtol=1e-5, atol=1e-5)
ROOT = Path(__file__).resolve().parents[1]
# (data, model, DTensor's collectives through `shared_card`'s buffers,
# the card's transport, here in its CPU form, instead of gloo's own)
MESHES = [(2, 1, False), (1, 2, False), (2, 2, False), (2, 2, True)]


def _mesh_id(mesh):
    return f"{mesh[0]}x{mesh[1]}" + ("-shared" if mesh[2] else "")
TRAIN, SERVE = "qwen1.5-0.5b", "qwen3-1.7b"
TRAIN_SEQ, TRAIN_BATCH, PROMPT, SLOTS, STEPS = 16, 4, 16, 4, 4

REFERENCE_CELLS = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import ShapeConfig, get_config, reduced
from repro.data.pipeline import make_batch
from repro.launch.mesh import make_test_mesh
from repro.launch.steps import build_cell
from repro.optim import adamw
src, dst = sys.argv[1:]
inp = np.load(src)
mesh = make_test_mesh(int(inp["data"]), int(inp["model"]))
assert mesh.devices.size == int(inp["data"]) * int(inp["model"])


def cfg(name):
    return dataclasses.replace(reduced(get_config(str(name))),
                               dtype="float32")


def jitted(cell):
    return jax.jit(cell["fn"], in_shardings=cell["in_shardings"],
                   out_shardings=cell["out_shardings"])


out = {}
c = cfg(inp["train_arch"])
shape = ShapeConfig("t", seq_len=int(inp["train_seq"]),
                    global_batch=int(inp["train_batch"]), kind="train")
cell = build_cell(c, shape, mesh)
params = {k[3:]: jnp.asarray(inp[k]) for k in inp.files if k[:3] == "tp/"}
opt = adamw.adamw_init(params)
n = cell["args"][2]["tokens"].shape[0]
batch = make_batch(c, shape, step=0, num_microbatches=n)
with jax.set_mesh(mesh):
    new_p, new_o, m = jitted(cell)(params, opt, batch)
trees = {"p": new_p, **{t: new_o[t] for t in ("mu", "nu", "master")}}
out.update({f"{t}/{k}": np.asarray(v) for t, tree in trees.items()
            for k, v in tree.items()})
out.update({f"m/{k}": np.asarray(v) for k, v in m.items()})
c = cfg(inp["serve_arch"])
sp = {k[3:]: jnp.asarray(inp[k]) for k in inp.files if k[:3] == "sp/"}
toks = inp["tokens"]
B, S = toks.shape
cell = build_cell(c, ShapeConfig("p", seq_len=S, global_batch=B,
                                 kind="prefill"), mesh)
with jax.set_mesh(mesh):
    logits, cache = jitted(cell)(sp, {"tokens": toks})
out["logits"] = np.asarray(logits)
out.update({f"cache/{k}": np.asarray(v) for k, v in cache.items()})
steps = int(inp["decode_steps"])
shape = ShapeConfig("d", seq_len=S + steps, global_batch=B, kind="decode")
cell = build_cell(c, shape, mesh)
with jax.set_mesh(mesh):
    fn = jitted(cell)
    lg, cache = cell["model"].prefill(sp, {"tokens": toks},
                                      max_len=shape.seq_len)
    tok = np.asarray(lg[:, -1].argmax(-1)).astype(np.int32)[:, None]
    cache = jax.device_put(cache, cell["in_shardings"][2])
    got = [tok]
    for _ in range(steps):
        tok, cache = fn(sp, {"token": tok}, cache)
        got.append(np.asarray(tok))
out["tokens"] = np.concatenate(got, axis=1)
np.savez(dst, **out)
"""


@pytest.fixture(scope="module")
def weights():
    """The reference's weights of both reduced configs and the prompts."""
    import jax
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models import build_model as jbuild_model
    import dataclasses

    def params(name):
        cfg = dataclasses.replace(jreduced(jget_config(name)),
                                  dtype="float32")
        p = jbuild_model(cfg).init_params(jax.random.PRNGKey(0))
        return {k: np.asarray(v) for k, v in p.items()}

    toks = np.random.default_rng(1).integers(
        0, 256, (SLOTS, PROMPT)).astype(np.int32)
    return {"tp": params(TRAIN), "sp": params(SERVE), "tokens": toks}


_RUNS = {}


def _run(mesh, weights, tmp_root):
    """The port's ranks and the reference's cells on `mesh`, once per
    module (both started together): (list of rank outputs, reference)."""
    if mesh in _RUNS:
        return _RUNS[mesh]
    d, m, shared = mesh
    tmp = tmp_root / f"mesh_{_mesh_id(mesh)}"
    tmp.mkdir(exist_ok=True)
    np.savez(tmp / "in.npz", data=d, model=m, shared=shared,
             train_arch=TRAIN,
             serve_arch=SERVE, train_seq=TRAIN_SEQ, train_batch=TRAIN_BATCH,
             decode_steps=STEPS, tokens=weights["tokens"],
             **{f"tp/{k}": v for k, v in weights["tp"].items()},
             **{f"sp/{k}": v for k, v in weights["sp"].items()})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={d * m}")
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE_CELLS,
                            str(tmp / "in.npz"), str(tmp / "ref.npz")],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        ranks = _torch_mesh_ranks.run("cells", tmp, d * m)
        _, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err
    _RUNS[mesh] = ranks, dict(np.load(tmp / "ref.npz"))
    return _RUNS[mesh]


@pytest.fixture(scope="module")
def tmp_root(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh_exec")


def _state_keys(tp):
    return [f"{t}/{k}" for t in ("p", "mu", "nu", "master") for k in tp]


@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
def test_train_cell_matches_reference(mesh, weights, tmp_root):
    ranks, want = _run(mesh, weights, tmp_root)
    for r, got in enumerate(ranks):
        for k in ("m/loss", "m/grad_norm", "m/lr"):
            np.testing.assert_allclose(got[k], want[k], err_msg=(r, k),
                                       **TOL)
        for k in _state_keys(weights["tp"]):
            np.testing.assert_allclose(got[k], want[k], err_msg=(r, k),
                                       **TOL)


@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
def test_train_cell_matches_plain_step(mesh, weights, tmp_root):
    """The same step on one rank, plain tensors, no mesh."""
    ranks, _ = _run(mesh, weights, tmp_root)
    cfg = _torch_mesh_ranks._cfg(TRAIN)
    shape = ShapeConfig("t", seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                        kind="train")
    params = {k: torch.from_numpy(v) for k, v in weights["tp"].items()}
    batch = {k: torch.from_numpy(v) for k, v in make_batch(
        cfg, shape, step=0, num_microbatches=1).items()}
    p, o, m = make_train_step(build_model(cfg), adamw.AdamWConfig())(
        params, adamw.adamw_init(params), batch)
    plain = {**{f"p/{k}": v for k, v in p.items()},
             **{f"{t}/{k}": v for t in ("mu", "nu", "master")
                for k, v in o[t].items()},
             **{f"m/{k}": v for k, v in m.items()}}
    for got in ranks:
        for k, v in plain.items():
            np.testing.assert_allclose(got[k], v.numpy(), err_msg=k, **TOL)


@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
def test_prefill_cell_matches_reference(mesh, weights, tmp_root):
    ranks, want = _run(mesh, weights, tmp_root)
    for got in ranks:
        np.testing.assert_allclose(got["logits"], want["logits"], **TOL)
        for k in ("k", "v", "block_table", "len"):
            np.testing.assert_allclose(got[f"cache/{k}"], want[f"cache/{k}"],
                                       err_msg=k, **TOL)


@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
def test_decode_cell_tokens_equal_reference(mesh, weights, tmp_root):
    ranks, want = _run(mesh, weights, tmp_root)
    assert want["tokens"].shape == (SLOTS, STEPS + 1)
    for got in ranks:
        np.testing.assert_array_equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
def test_plain_positions_are_the_same_on_every_rank(mesh, weights,
                                                    tmp_root):
    """`implicit_replication()` counts a plain tensor that meets a
    DTensor as replicated: right only if every rank holds the same one.
    RoPE's positions at every call of the three cells (plain in the
    train and prefill cells, DTensors in the decode cell) are equal on
    every rank."""
    import json
    ranks, _ = _run(mesh, weights, tmp_root)
    calls = [json.loads(str(got["positions"])) for got in ranks]
    assert all(c == calls[0] for c in calls)
    kinds = {is_dt for is_dt, _ in calls[0]}
    assert kinds == {False, True}, kinds


@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
def test_paged_dispatch_per_shard_matches_the_whole_call(mesh, tmp_path):
    """The decode cell's per-shard paged call (`_paged_kernel`, the
    kernel on the card, its plain version here) on Qwen3-1.7B's layouts
    (8 kv heads, 16 query heads, rows over `data`, kv heads over
    `model`) gives the whole call's output within 1e-6, and every rank's
    lens, made from the replicated length, hold that length."""
    d, m, shared = mesh
    rng = np.random.default_rng(5)
    B, P, ps, K, H, hd, pos = 4, 3, 8, 8, 16, 32, 17
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, P, ps, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, P, ps, K, hd)).astype(np.float32)
    table = np.stack([rng.permutation(P) for _ in range(B)]).astype(
        np.int32)
    np.savez(tmp_path / "in.npz", data=d, model=m, shared=shared, q=q,
             k=k, v=v, table=table, pos=pos)
    ranks = _torch_mesh_ranks.run("paged", tmp_path, d * m)
    from repro_torch.kernels.paged_attention.ops import \
        paged_decode_attention
    want = paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, k, v, table)),
        torch.full((B,), pos + 1, dtype=torch.int32)).numpy()
    for got in ranks:
        np.testing.assert_allclose(got["out"], want, rtol=1e-6, atol=1e-6)
        assert (got["lens"] == pos + 1).all()
        assert tuple(got["local_pool"]) == (B // d, P, ps, K // m, hd)


@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
def test_each_rank_holds_its_part_of_every_leaf(mesh, weights, tmp_root):
    """Local shapes: every dim the reference's rules split over mesh axes
    of n ranks in all is 1/n of the whole on every rank, every other dim
    whole; the embedding (vocab over model, d over data) as a witness."""
    from repro.distributed.sharding import make_rules as jmake_rules
    from repro.distributed.sharding import spec_for as jspec_for
    d, m, _ = mesh
    ranks, _ = _run(mesh, weights, tmp_root)
    shape_mesh = Mesh({"data": d, "model": m})
    for tag, arch, tree in (("train/params", TRAIN, weights["tp"]),
                            ("train/opt/mu", TRAIN, weights["tp"]),
                            ("serve/params", SERVE, weights["sp"])):
        cfg = _torch_mesh_ranks._cfg(arch)
        rules = jmake_rules(cfg, shape_mesh)
        axes = build_model(cfg).logical_axes()
        split = 0
        for k, whole in tree.items():
            spec = jspec_for(axes[k], rules, whole.shape, shape_mesh)
            want = tuple(
                n // np.prod([shape_mesh.shape[a] for a in
                              ((e,) if isinstance(e, str) else e)])
                if e else n for n, e in zip(whole.shape, spec))
            split += want != whole.shape
            for got in ranks:
                assert tuple(got[f"local/{tag}/{k}"]) == want, (tag, k)
        assert split, tag
    for got in ranks:
        assert tuple(got["local/train/params/embed"]) == (256 // m, 64 // d)


def test_rms_norm_scale_gradient_is_reduced_over_rows(tmp_path):
    """RMSNorm on x split over its rows (two ranks): y and dx laid out as
    x, the scale's gradient a partial sum over the rows' ranks (each
    rank's own part is not the gradient: half or less of it), reduced to
    the unsharded gradient within 1e-5 on every rank."""
    import json
    from repro_torch.models import layers
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 6, 32)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    dy = rng.standard_normal((4, 6, 32)).astype(np.float32)
    np.savez(tmp_path / "in.npz", data=2, model=1, x=x, scale=scale, dy=dy)
    ranks = _torch_mesh_ranks.run("norm", tmp_path, 2)
    tx = torch.from_numpy(x).requires_grad_(True)
    ts = torch.from_numpy(scale).requires_grad_(True)
    y = layers.rms_norm(tx, ts, 1e-6)
    dx, ds = torch.autograd.grad(y, (tx, ts), torch.from_numpy(dy))
    for r, got in enumerate(ranks):
        info = json.loads(str(got["json"]))
        assert info["y"] == ["Shard(0)", "Replicate"]
        assert info["dscale"] == ["Partial", "Replicate"]
        np.testing.assert_allclose(got["y_full"], y.detach().numpy(), **TOL)
        np.testing.assert_allclose(got["dx"], dx.numpy(), **TOL)
        np.testing.assert_allclose(got["dscale"], ds.numpy(), **TOL)
        # this rank's rows' part alone: what an unmarked gradient would be
        assert not np.allclose(got["dscale_local"], ds.numpy(), **TOL)
    np.testing.assert_allclose(ranks[0]["dscale_local"]
                               + ranks[1]["dscale_local"], ds.numpy(), **TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_shared_buffer_collectives_equal_gloos_own(tmp_path, world):
    """`shared_card`'s kernels of the functional collectives (the card's
    path for ranks sharing one card; here their CPU form, buffers in
    /dev/shm) against gloo's own on the same CPU tensors and a float64
    recomputation: gathers and the all-to-all bit for bit, sums within
    f32 rounding of the float64 sums (gloo and the rank-order sum add in
    other orders), every rank's all-reduce bit-identical, each call
    counted."""
    np.savez(tmp_path / "in.npz", data=world, model=1)
    ranks = _torch_mesh_ranks.run("collectives", tmp_path, world)
    xs = np.stack([got["x"] for got in ranks]).astype(np.float64)
    rows = xs.shape[1] // world
    for r, got in enumerate(ranks):
        for op in ("all_gather", "all_to_all", "all_reduce_max"):
            np.testing.assert_array_equal(got[f"shared/{op}"],
                                          got[f"native/{op}"], err_msg=op)
        mine = slice(r * rows, (r + 1) * rows)
        for op, want in (("reduce_scatter", xs.sum(0)[mine]),
                         ("reduce_scatter_avg", xs.mean(0)[mine]),
                         ("all_reduce", xs.sum(0))):
            for mode in ("shared", "native"):
                np.testing.assert_allclose(got[f"{mode}/{op}"], want,
                                           rtol=1e-6, atol=1e-6,
                                           err_msg=(mode, op))
        np.testing.assert_array_equal(got["shared/all_reduce"],
                                      ranks[0]["shared/all_reduce"])
        assert int(got["shared_calls"]) >= 6


def test_paged_dispatch_refuses_a_pool_split_over_head_dim():
    """The paged kernel's per-shard call needs whole head_dims and pages:
    a pool laid out over head_dim raises before any kernel is reached
    (the layout alone decides, here on a one-rank CPU mesh)."""
    from repro_torch.distributed.sharding import (NamedSharding,
                                                  PartitionSpec as P, place)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.transformer import _paged_kernel
    mesh = make_test_mesh(1, 1, device="cpu")
    B, Pn, ps, K, H, hd = 2, 3, 4, 2, 4, 8
    pool = place(torch.zeros(B, Pn, ps, K, hd),
                 NamedSharding(mesh, P("data", None, None, None, "model")))
    q = place(torch.zeros(B, H, hd), NamedSharding(mesh, P("data")))
    table = place(torch.zeros(B, Pn, dtype=torch.int32),
                  NamedSharding(mesh, P("data")))
    lens = place(torch.ones(B, dtype=torch.int32),
                 NamedSharding(mesh, P("data")))
    with pytest.raises(ValueError, match="head_dim"):
        _paged_kernel(q, pool, pool, table, lens)
    pages = place(torch.zeros(B, Pn, ps, K, hd),
                  NamedSharding(mesh, P(None, "model")))
    with pytest.raises(ValueError, match="pages"):
        _paged_kernel(q, pages, pages, table, lens)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
def test_decode_on_card_raises_on_a_pool_split_over_head_dim(cuda_device):
    """decode_step over a CUDA cache laid out over head_dim (a model axis
    larger than the kv heads' count divides) raises: the kernel has no
    per-shard call there, and there is no switch to the gathered path."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed.sharding import (NamedSharding,
                                                  PartitionSpec as P, place,
                                                  replicated)
    from repro_torch.launch.mesh import make_test_mesh
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication
    mesh = make_test_mesh(1, 1, device="cuda")
    try:
        cfg = reduced(get_config(SERVE))
        model = build_model(cfg)
        gen = torch.Generator(device=cuda_device)
        gen.manual_seed(0)
        params = model.init_params(gen)
        toks = torch.zeros((2, 8), dtype=torch.int32, device=cuda_device)
        _, cache = model.prefill(params, {"tokens": toks}, max_len=16)
        by_head_dim = NamedSharding(
            mesh, P(None, "data", None, None, None, "model"))
        c = {"k": place(cache["k"], by_head_dim),
             "v": place(cache["v"], by_head_dim),
             "block_table": place(cache["block_table"], replicated(mesh)),
             "len": place(cache["len"], replicated(mesh))}
        p = place(params, {k: replicated(mesh) for k in params})
        tok = place(toks[:, :1], replicated(mesh))
        with implicit_replication(), \
                pytest.raises(ValueError, match="head_dim"):
            model.decode_step(p, {"token": tok}, c)
    finally:
        dist.destroy_process_group()
