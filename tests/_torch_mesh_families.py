"""The MoE, RWKV6, RG-LRU and MusicGen cells over mesh axes larger than
one rank: the inputs, the reference's side and the runner shared by
`tests/test_torch_mesh_{moe,rwkv,rglru,musicgen}.py`.

    python tests/_torch_mesh_families.py IN.npz OUT.npz

runs the JAX package's `build_cell` train, prefill and decode cells of
IN.npz's config jitted with their shardings on its
`make_test_mesh(data, model)` (the caller sets
`XLA_FLAGS=--xla_force_host_platform_device_count=data*model`) and
writes what `tests/_torch_mesh_ranks.py`'s mode "family" writes for the
port: the new train state (`p/`, `mu/`, `nu/`, `master/<name>`), the
metrics (`m/<name>`), the prefill's last logits (`logits`) and cache
(`cache/<path>`), and the decode cell's greedy tokens (`tokens`, one
step per entry of the sequence axis); with a true `single` in IN.npz
also the train cell on a mesh of one device (`single/m/<name>`,
`single/p/<name>`, ...): the reference's own spread between meshes.

IN.npz: `arch`, the widths `layers`, `d_model`, `heads` and `experts`
(0: the reduced config's own), `dtype`, `data`, `model`, `cells` (the
cells to run, of "train,prefill,decode"), `train_seq`,
`train_batch`, `decode_steps`, the params `p/<name>`, the prompts
(`tokens` (B, S), or for an audio config `frames` (B, S, d) and the
decode steps' inputs `dec_frames` (steps, B, 1, d)).

`run(inp, tmp, timeout)` writes IN.npz, starts the reference and the
port's ranks together and returns (the ranks' outputs, the reference's).
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
TRAIN_SEQ, TRAIN_BATCH = 16, 4


def family_cfg(configs, inp):
    """IN.npz's config from a package's `configs` module: the reduced
    config at IN's widths (`experts` > 0 replaces the expert count)."""
    cfg = configs.reduced(configs.get_config(str(inp["arch"])),
                          layers=int(inp["layers"]),
                          d_model=int(inp["d_model"]),
                          heads=int(inp["heads"]))
    if int(inp["experts"]):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=int(inp["experts"])))
    return dataclasses.replace(cfg, dtype=str(inp["dtype"]))


def flat(tree, prefix: str) -> dict:
    """A nested dict of arrays -> {prefix/path: array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


def inputs(arch: str, *, data: int, model: int, layers: int = 2,
           d_model: int = 64, heads: int = 4, experts: int = 0,
           prompt: int = 16, slots: int = 4, steps: int = 4,
           dtype: str = "float32", seed: int = 0,
           cells: str = "train,prefill,decode",
           single: bool = False) -> dict:
    """IN.npz's entries: the port's params drawn from
    `torch.Generator(seed)` on the CPU, the prompts from numpy."""
    import torch
    from repro_torch import configs
    from repro_torch.models import build_model
    inp = dict(arch=arch, layers=layers, d_model=d_model, heads=heads,
               experts=experts, dtype=dtype, data=data, model=model,
               train_seq=TRAIN_SEQ, train_batch=TRAIN_BATCH,
               decode_steps=steps, cells=cells, single=single)
    cfg = family_cfg(configs, inp)
    gen = torch.Generator().manual_seed(seed)
    params = build_model(cfg).init_params(gen)
    inp.update({f"p/{k}": v.float().numpy() for k, v in params.items()})
    rng = np.random.default_rng(seed + 1)
    if cfg.frontend.kind == "audio":
        inp["frames"] = (0.02 * rng.standard_normal(
            (slots, prompt, cfg.d_model))).astype(np.float32)
        inp["dec_frames"] = (0.02 * rng.standard_normal(
            (steps, slots, 1, cfg.d_model))).astype(np.float32)
    else:
        inp["tokens"] = rng.integers(0, cfg.vocab_size,
                                     (slots, prompt)).astype(np.int32)
    return inp


def run(inp: dict, tmp: Path, timeout: float = 240):
    """The reference's cells and the port's ranks on IN's mesh, started
    together: (list of rank outputs, the reference's outputs)."""
    import _torch_mesh_ranks
    tmp.mkdir(parents=True, exist_ok=True)
    np.savez(tmp / "in.npz", **inp)
    (tmp / "init").unlink(missing_ok=True)     # a world's rendezvous file
    n = int(inp["data"]) * int(inp["model"])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={n}")
    ref = subprocess.Popen([sys.executable, __file__, str(tmp / "in.npz"),
                            str(tmp / "ref.npz")], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        ranks = _torch_mesh_ranks.run("family", tmp, n, timeout=timeout)
        _, err = ref.communicate(timeout=timeout)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err
    return ranks, dict(np.load(tmp / "ref.npz"))


TOL = dict(rtol=1e-5, atol=1e-5)
# a perturbation of every param by f32's unit roundoff, relative, is how
# far rounding alone moves the gradients (`rounding_floor`); a mesh's
# gradients lie within FLOOR_FACTOR of it, the reference's too
FLOOR_FACTOR = 4.0
FLOOR_DRAWS = 3


class Runs:
    """Each (name -> inputs) run of a test module once: `get(name)` starts
    the reference and the port's ranks on first use and keeps what they
    wrote."""

    def __init__(self, specs: dict, tmp_root: Path):
        self.specs, self.tmp_root, self.done = specs, tmp_root, {}

    def get(self, name: str):
        """(rank outputs, reference outputs, inputs) of run `name`."""
        if name not in self.done:
            inp = inputs(**self.specs[name])
            ranks, ref = run(inp, self.tmp_root / name)
            self.done[name] = ranks, ref, inp
        return self.done[name]


def state_names(inp) -> list:
    return sorted(k[2:] for k in inp if k[:2] == "p/")


def check_train(ranks, ref, inp, gn_tol: float) -> None:
    """The new params, AdamW moments and master copy and the loss within
    1e-5 of the reference's on every rank; the grad norm within `gn_tol`
    (absolute)."""
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["m/loss"], ref["m/loss"], **TOL)
        np.testing.assert_allclose(got["m/lr"], ref["m/lr"], **TOL)
        gap = abs(float(got["m/grad_norm"]) - float(ref["m/grad_norm"]))
        assert gap <= gn_tol, (r, float(got["m/grad_norm"]),
                               float(ref["m/grad_norm"]), gn_tol)
        for k in state_names(inp):
            for t in ("p", "mu", "nu", "master"):
                np.testing.assert_allclose(got[f"{t}/{k}"], ref[f"{t}/{k}"],
                                           err_msg=(r, t, k), **TOL)


def strict_gn_tol(ref) -> float:
    """The grad norm's tolerance of every family but RWKV6: 1e-5 absolute
    and relative, the train tests'."""
    return 1e-5 + 1e-5 * abs(float(ref["m/grad_norm"]))


def grad_norm_tol(refs) -> float:
    """RWKV6's grad norm tolerance, grounded in the reference's own spread:
    the larger of `strict_gn_tol` and the
    largest distance between the reference's grad norms of one config on
    its meshes (`refs`: the reference's outputs, one with `single/`, its
    one-device cell)."""
    gns = [float(r[f"{tag}m/grad_norm"]) for r in refs
           for tag in ("", "single/") if f"{tag}m/grad_norm" in r]
    return max(1e-5 + 1e-5 * max(gns), max(gns) - min(gns))


def mesh_grads(got, inp) -> dict:
    """A rank's gradients, recovered from its first AdamW moment:
    mu = (1 - b1) * min(1, clip / grad_norm) * g after one step."""
    from repro_torch.optim.adamw import AdamWConfig
    c = AdamWConfig()
    gn = float(got["m/grad_norm"])
    scale = min(1.0, c.grad_clip / max(gn, 1e-12))
    return {k: got[f"mu/{k}"].astype(np.float64) / ((1 - c.b1) * scale)
            for k in state_names(inp)}


def rounding_floor(inp) -> tuple:
    """The port's plain train step's gradients at IN's params and the
    rounding floor of each leaf: the largest distance of its gradient
    over FLOOR_DRAWS perturbations of every param by N(0, 1) times f32's
    unit roundoff (2^-24), relative. (plain gradients, floors)"""
    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.steps import _mean_grads
    from repro_torch.models import build_model
    cfg = family_cfg(configs, inp)
    model = build_model(cfg)
    params = {k: torch.from_numpy(np.asarray(inp[f"p/{k}"]))
              for k in state_names(inp)}
    shape = configs.ShapeConfig("t", seq_len=int(inp["train_seq"]),
                                global_batch=int(inp["train_batch"]),
                                kind="train")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(
        cfg, shape, step=0, num_microbatches=1).items()}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # beside the tests' rank processes
    try:
        g0, _ = _mean_grads(model, params, batch)
        floors = {k: 0.0 for k in g0}
        gen = torch.Generator().manual_seed(7)
        for _ in range(FLOOR_DRAWS):
            noisy = {k: v * (1 + 2.0 ** -24 * torch.randn(v.shape,
                                                          generator=gen))
                     for k, v in params.items()}
            g1, _ = _mean_grads(model, noisy, batch)
            for k in g0:
                floors[k] = max(floors[k], float((g1[k] - g0[k]).double()
                                                 .norm()))
    finally:
        torch.set_num_threads(threads)
    return {k: v.double().numpy() for k, v in g0.items()}, floors


def check_floor(got, inp, plain, floors) -> None:
    """Every leaf's gradient on the mesh within FLOOR_FACTOR of its
    rounding floor of the plain step's (and 1e-6 of its norm): a lost or
    doubled term would sit orders of magnitude past it."""
    for k, g in mesh_grads(got, inp).items():
        gap = float(np.linalg.norm(g - plain[k]))
        lim = FLOOR_FACTOR * floors[k] + 1e-6 * float(
            np.linalg.norm(plain[k]))
        assert gap <= lim, (k, gap, floors[k])


def check_prefill(ranks, ref) -> None:
    """The last logits and every cache leaf within 1e-5 of the leaf's
    largest magnitude (each is a dot product over d, whose rounding
    scales with the leaf's size, not with each small entry: the
    reference's own MoE caches on two meshes differ by 1.9e-5 on entries
    up to 16)."""
    for got in ranks:
        cache = [k for k in ref if k.startswith("cache/")]
        assert cache
        for k in ["logits"] + cache:
            want = ref[k].astype(np.float64)
            gap = float(np.abs(got[k] - want).max()) if want.size else 0.0
            assert gap <= 1e-5 * (1 + float(np.abs(want).max())), (k, gap)


def check_plain_tensors(ranks) -> list:
    """Every plain tensor that met a DTensor (counted replicated by
    `implicit_replication()`) was the same on every rank; returns the
    ops that took one."""
    import json
    calls = [json.loads(str(got["plain"])) for got in ranks]
    assert calls[0] and all(c == calls[0] for c in calls)
    return sorted({c[0] for c in calls[0]})


def check_padded(ranks, model: int) -> int:
    """Each rank's part of a dim that `model` ranks do not divide: GSPMD's
    ceil(n / model) from rank * that, zero-padded past the end on the last
    ranks. Returns the number of such calls on a rank."""
    import json
    padded = 0
    for r, got in enumerate(ranks):
        calls = [c for c in json.loads(str(got["padded"]))
                 if c[3] % model]
        for dim, start, count, n in calls:
            assert count == -(-n // model) and start == r * count, \
                (r, dim, start, count, n)
        padded = len(calls)
        assert padded
    assert any(start + count > n for dim, start, count, n in
               json.loads(str(ranks[-1]["padded"])))
    return padded


def check_local_shapes(ranks, inp, tag: str) -> int:
    """This rank's part of every placed param by the reference's rules:
    1/n of each dim they split over n ranks (`spec_for` on the leaf's
    shape), the rest whole. Returns the number of split leaves."""
    from repro import configs as jconfigs
    from repro.distributed.sharding import make_rules, spec_for
    from repro.models import build_model as jbuild_model
    from repro_torch.launch.mesh import Mesh
    cfg = family_cfg(jconfigs, inp)
    mesh = Mesh({"data": int(inp["data"]), "model": int(inp["model"])})
    rules = make_rules(cfg, mesh)
    axes = jbuild_model(cfg).logical_axes()
    split = 0
    for k in state_names(inp):
        whole = inp[f"p/{k}"].shape
        spec = spec_for(axes[k], rules, whole, mesh)
        want = tuple(
            n // int(np.prod([mesh.shape[a] for a in
                              ((e,) if isinstance(e, str) else e)]))
            if e else n for n, e in zip(whole, spec))
        split += want != whole
        for got in ranks:
            assert tuple(got[f"local/{tag}/{k}"]) == want, (tag, k)
    return split


def _reference(src: str, dst: str) -> None:
    import jax
    import jax.numpy as jnp
    from repro import configs
    from repro.data.pipeline import make_batch
    from repro.distributed import sharding
    from repro.launch.mesh import compat_make_mesh, make_test_mesh
    from repro.launch.steps import build_cell
    from repro.models import build_model
    from repro.optim import adamw
    inp = np.load(src)
    mesh = make_test_mesh(int(inp["data"]), int(inp["model"]))
    assert mesh.devices.size == int(inp["data"]) * int(inp["model"])
    cfg = family_cfg(configs, inp)
    audio = cfg.frontend.kind == "audio"
    cells = str(inp["cells"]).split(",")

    def jitted(cell):
        return jax.jit(cell["fn"], in_shardings=cell["in_shardings"],
                       out_shardings=cell["out_shardings"])

    out = {}
    params = {k[2:]: jnp.asarray(inp[k]) for k in inp.files
              if k[:2] == "p/"}
    shape = configs.ShapeConfig("t", seq_len=int(inp["train_seq"]),
                                global_batch=int(inp["train_batch"]),
                                kind="train")
    # the train cell on this mesh and, with `single`, on one device
    train_on = [("", mesh)] if "train" in cells else []
    if "single" in inp.files and bool(inp["single"]):
        train_on.append(("single/", compat_make_mesh((1, 1),
                                                     ("data", "model"))))
    for tag, on in train_on:
        cell = build_cell(cfg, shape, on)
        opt = adamw.adamw_init(params)
        n = next(iter(cell["args"][2].values())).shape[0]
        batch = make_batch(cfg, shape, step=0, num_microbatches=n)
        with jax.set_mesh(on):
            new_p, new_o, m = jitted(cell)(params, opt, batch)
        trees = {"p": new_p, **{t: new_o[t] for t in ("mu", "nu",
                                                      "master")}}
        out.update({f"{tag}{t}/{k}": np.asarray(v)
                    for t, tree in trees.items() for k, v in tree.items()})
        out.update({f"{tag}m/{k}": np.asarray(v) for k, v in m.items()})
    prompt = ({"frame_embeds": jnp.asarray(inp["frames"])} if audio
              else {"tokens": jnp.asarray(inp["tokens"])})
    B, S = next(iter(prompt.values())).shape[:2]
    if "prefill" in cells:
        cell = build_cell(cfg, configs.ShapeConfig(
            "p", seq_len=S, global_batch=B, kind="prefill"), mesh)
        with jax.set_mesh(mesh):
            logits, cache = jitted(cell)(params, prompt)
        out["logits"] = np.asarray(logits)
        out.update(flat(jax.tree.map(np.asarray, cache), "cache"))
    if "decode" in cells:
        steps = int(inp["decode_steps"])
        shape = configs.ShapeConfig("d", seq_len=S + steps, global_batch=B,
                                    kind="decode")
        # the plain prefill, eager and off the mesh (an eager constraint
        # must divide its dim), then the cell (its rules installed)
        sharding.set_global_rules(None)
        lg, cache = build_model(cfg).prefill(params, prompt,
                                             max_len=shape.seq_len)
        cell = build_cell(cfg, shape, mesh)
        with jax.set_mesh(mesh):
            fn = jitted(cell)
            tok = np.asarray(jnp.argmax(lg[:, -1], -1)).astype(
                np.int32)[:, None]
            cache = jax.device_put(cache, cell["in_shardings"][2])
            got = [tok]
            for i in range(steps):
                b = ({"frame_embed": jnp.asarray(inp["dec_frames"][i])}
                     if audio else {"token": tok})
                tok, cache = fn(params, b, cache)
                got.append(np.asarray(tok))
        out["tokens"] = np.stack(got, axis=1)
    sharding.set_global_rules(None)
    np.savez(dst, **out)


if __name__ == "__main__":
    _reference(*sys.argv[1:])
