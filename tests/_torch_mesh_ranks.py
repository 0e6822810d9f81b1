"""One rank of a gloo world on the CPU, for the tests that execute the
port's cells and `train(..., mesh=)` over mesh axes larger than one rank
(`tests/test_torch_mesh_exec.py`, `tests/test_torch_mesh_train.py`).

    python tests/_torch_mesh_ranks.py MODE RANK WORLD INIT_FILE IN.npz OUT.npz

Every rank sets `torch.set_num_threads(1)` and joins a gloo world over
INIT_FILE; the mesh is `make_test_mesh(data, model, device="cpu")` with
`data` and `model` from IN.npz (their product is WORLD). With a true
`shared` in IN.npz, DTensor's collectives go through
`repro_torch.distributed.shared_card`'s buffers (in /dev/shm), as they
do on the card, instead of gloo's own.

MODE "cells": `build_cell`'s train, prefill and decode cells for reduced
f32 configs (IN.npz: `train_arch`, `serve_arch`, the sizes, the weights
`tp/<name>` and `sp/<name>` and the prompts `tokens`), their arguments
`place`d by the cells' input shardings. Writes the whole new params,
AdamW moments and master copy (`p/`, `mu/`, `nu/`, `master/<name>`), the
metrics, the prefill's last logits (`logits`) and cache (`cache/<name>`),
the decode cell's tokens (`tokens`, one column per step), this rank's
local shapes of the placed arguments (`local/<tree>/<name>`) and, as
JSON, RoPE's positions at every call (`positions`).
MODE "family": `build_cell`'s train, prefill and decode cells of one
config of the MoE, RWKV6, RG-LRU or MusicGen families
(`tests/_torch_mesh_families.py`: IN.npz's entries, the outputs' names),
the arguments `place`d by the cells' input shardings, on the CPU or, with
`device` "cuda" in IN.npz, on the card (the ranks share it: the RMSNorm
and paged-attention kernels' launches are written, `launches`). Writes besides
this rank's local shapes of the placed arguments (`local/<tree>/<path>`),
as JSON under `plain`, every plain tensor that met a DTensor under
`implicit_replication()` (the op, shape, dtype and a digest of the
values: the same on every rank where it is right to count it
replicated), and as JSON under `padded` every `sharding.take_padded`
call (dim, start, count, the dim's size): each rank's part of a dim
GSPMD pads.
MODE "norm": `layers.rms_norm` on x (B, S, d) split over its rows (mesh
(WORLD, 1)), IN.npz's `x`, `scale` and `dy`: writes the scale gradient's
placements (json), this rank's local part of it before the reduction
(`dscale_local`) and the reduced gradient (`dscale`), and x's.
MODE "collectives": torch's functional collectives (all-gather,
reduce-scatter with sum and avg, all-reduce with sum and max, an uneven
all-to-all) on seeded tensors through gloo's own kernels, then through
`repro_torch.distributed.shared_card`'s installed for CPU tensors.
MODE "paged": `transformer._paged_kernel` (the decode cell's per-shard
call of the paged kernel; its plain version on CPU tensors) on DTensors
laid out as the decode cell lays out Qwen3-1.7B's pools, q and table
(IN.npz's `q`, `k`, `v`, `table`, `pos`), its lens made from a
replicated length: writes the whole output (`out`), the lens this rank
passed (`lens`) and its local pool shape.
MODE "train": `train(..., mesh=make_test_mesh(data, model))` for IN.npz's
`arch`, sizes, `steps` and `seed`, with rank 0 holding the checkpoint
store: `scenario` "straight" (writes `losses`, `grad_norms`), "save" (`ckpt` steps
with a checkpoint at the last, then rank 0 resumes to `steps` with
`train(..., mesh=None)` in this process: `losses`, `resumed`,
`restored_from`, and whether the restored state equals the saved whole
leaves, `same_state`) or "resume" (rank 0 trains `ckpt` steps alone with
`train()` and a checkpoint, then every rank resumes to `steps` on the
mesh: `losses`, `resumed`, `restored_from`) or "refused" (rank 1
passes a checkpointer: `refused`, the error's message).

`run(mode, tmp, world)` starts the ranks and returns what each wrote.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


SRC = Path(__file__).resolve().parents[1] / "src"


def run(mode: str, tmp: Path, world: int, timeout: float = 240):
    """Run `world` ranks of `mode` over files in `tmp` (IN: tmp/in.npz);
    returns each rank's outputs as a dict. Every rank is killed at
    `timeout` seconds."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, mode, str(r), str(world),
         str(tmp / "init"), str(tmp / "in.npz"), str(tmp / "out.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    errors = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            if p.returncode:
                errors.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not errors, "\n".join(errors)
    return [dict(np.load(tmp / f"out_r{r}.npz")) for r in range(world)]


def _split(npz, prefix):
    return {k[len(prefix):]: torch.from_numpy(npz[k]) for k in npz.files
            if k.startswith(prefix)}


def _cfg(name: str):
    from repro_torch.configs import get_config, reduced
    return dataclasses.replace(reduced(get_config(name)), dtype="float32")


def _local_shapes(tree, prefix: str) -> dict:
    from repro_torch.distributed.sharding import is_dtensor
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_local_shapes(v, f"{prefix}/{k}"))
        elif is_dtensor(v):
            out[f"local/{prefix}/{k}"] = np.array(v.to_local().shape)
    return out


def _cells(inp, mesh) -> dict:
    """The three cells; RoPE's positions recorded at every call (plain
    ones as they are, DTensors whole), for the check that every rank
    passes the same ones (`positions`, one row per call)."""
    from repro_torch.distributed.sharding import is_dtensor
    from repro_torch.models import layers
    rope, calls = layers.rope_for_seq, []

    def recording(x, positions, theta):
        p = positions.full_tensor() if is_dtensor(positions) else positions
        calls.append((is_dtensor(positions), p.reshape(-1)[:8].tolist()))
        return rope(x, positions, theta)

    layers.rope_for_seq = recording
    try:
        out = _cell_runs(inp, mesh)
    finally:
        layers.rope_for_seq = rope
    out["positions"] = np.array(json.dumps(calls))
    return out


def _cell_runs(inp, mesh) -> dict:
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.distributed.sharding import full, place
    from repro_torch.launch.steps import build_cell
    from repro_torch.optim import adamw
    out = {}
    # ---- train -----------------------------------------------------
    cfg = _cfg(str(inp["train_arch"]))
    shape = ShapeConfig("t", seq_len=int(inp["train_seq"]),
                        global_batch=int(inp["train_batch"]), kind="train")
    cell = build_cell(cfg, shape, mesh)
    params = _split(inp, "tp/")
    opt = adamw.adamw_init(params)
    n = cell["args"][2]["tokens"].shape[0]
    batch = {k: torch.from_numpy(v) for k, v in make_batch(
        cfg, shape, step=0, num_microbatches=n).items()}
    args = place((params, opt, batch), cell["in_shardings"])
    out.update(_local_shapes({"params": args[0], "opt": args[1]}, "train"))
    new_p, new_o, m = full(cell["fn"](*args))
    trees = {"p": new_p, **{t: new_o[t] for t in ("mu", "nu", "master")}}
    out.update({f"{t}/{k}": v.numpy() for t, tree in trees.items()
                for k, v in tree.items()})
    out.update({f"m/{k}": v.numpy() for k, v in m.items()})
    # ---- prefill ---------------------------------------------------
    cfg = _cfg(str(inp["serve_arch"]))
    sp = _split(inp, "sp/")
    toks = torch.from_numpy(inp["tokens"])
    B, S = toks.shape
    shape = ShapeConfig("p", seq_len=S, global_batch=B, kind="prefill")
    cell = build_cell(cfg, shape, mesh)
    args = place((sp, {"tokens": toks}), cell["in_shardings"])
    out.update(_local_shapes({"params": args[0]}, "serve"))
    logits, cache = full(cell["fn"](*args))
    out["logits"] = logits.numpy()
    out.update({f"cache/{k}": v.numpy() for k, v in cache.items()})
    # ---- decode: the plain prefill, then the cell's steps ----------
    steps = int(inp["decode_steps"])
    shape = ShapeConfig("d", seq_len=S + steps, global_batch=B,
                        kind="decode")
    cell = build_cell(cfg, shape, mesh)
    lg, cache = cell["model"].prefill(sp, {"tokens": toks},
                                      max_len=shape.seq_len)
    tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
    in_sh = cell["in_shardings"]
    p_d, c_d = place(sp, in_sh[0]), place(cache, in_sh[2])
    out.update(_local_shapes({"cache": c_d}, "decode"))
    got = [tok]
    for _ in range(steps):
        tok_d, c_d = cell["fn"](p_d, place({"token": tok}, in_sh[1]), c_d)
        tok = full(tok_d)
        got.append(tok)
    out["tokens"] = torch.cat(got, dim=1).numpy()
    return out


class _PlainRecord:
    """For the `with` block, every plain tensor that DTensor's dispatch
    counts as replicated (`implicit_replication()`): its op, shape, dtype
    and a digest of its values, in call order (`calls`)."""

    def __enter__(self):
        from torch.distributed.tensor._dispatch import OpDispatcher
        self.cls, self.calls = OpDispatcher, []
        self.orig = OpDispatcher._try_replicate_spec_for_scalar_tensor
        orig, calls = self.orig, self.calls

        def recording(this, op_call, tensor, mesh):
            t = tensor.detach()
            digest = float(t.double().sum()) if t.numel() else 0.0
            calls.append((str(op_call), list(t.shape), str(t.dtype),
                          round(digest, 6)))
            return orig(this, op_call, tensor, mesh)

        OpDispatcher._try_replicate_spec_for_scalar_tensor = recording
        return self

    def __exit__(self, *exc):
        self.cls._try_replicate_spec_for_scalar_tensor = self.orig


def _family(inp, mesh) -> dict:
    """The three cells of IN's config (`tests/_torch_mesh_families.py`),
    the plain tensors that met DTensors and the padded parts recorded."""
    from repro_torch.distributed import sharding
    padded, take = [], sharding.take_padded

    def recording(t, dim, start, count):
        padded.append((dim, start, count, t.shape[dim]))
        return take(t, dim, start, count)

    sharding.take_padded = recording
    try:
        with _PlainRecord() as plain:
            out = _family_runs(inp, mesh)
    finally:
        sharding.take_padded = take
    out["plain"] = np.array(json.dumps(plain.calls))
    out["padded"] = np.array(json.dumps(padded))
    return out


def _family_runs(inp, mesh) -> dict:
    import _torch_mesh_families as fam
    from repro_torch import configs
    from repro_torch.data.pipeline import make_batch
    from repro_torch.distributed.sharding import full, place
    from repro_torch.launch.steps import build_cell
    from repro_torch.optim import adamw
    cfg = fam.family_cfg(configs, inp)
    audio = cfg.frontend.kind == "audio"
    cells = str(inp["cells"]).split(",")
    dev = torch.device(_device(inp))
    out = {}
    params = {k: v.to(dev) for k, v in _split(inp, "p/").items()}
    if "train" in cells:
        shape = configs.ShapeConfig("t", seq_len=int(inp["train_seq"]),
                                    global_batch=int(inp["train_batch"]),
                                    kind="train")
        cell = build_cell(cfg, shape, mesh)
        opt = adamw.adamw_init(params)
        n = next(iter(cell["args"][2].values())).shape[0]
        batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
            cfg, shape, step=0, num_microbatches=n).items()}
        args = place((params, opt, batch), cell["in_shardings"])
        out.update(_local_shapes({"params": args[0], "opt": args[1]},
                                 "train"))
        new_p, new_o, m = full(cell["fn"](*args))
        trees = {"p": new_p, **{t: new_o[t] for t in ("mu", "nu",
                                                      "master")}}
        out.update({f"{t}/{k}": v.cpu().numpy() for t, tree in trees.items()
                    for k, v in tree.items()})
        out.update({f"m/{k}": v.cpu().numpy() for k, v in m.items()})
    prompt = ({"frame_embeds": torch.from_numpy(inp["frames"]).to(dev)}
              if audio else {"tokens": torch.from_numpy(inp["tokens"])
                             .to(dev)})
    B, S = next(iter(prompt.values())).shape[:2]
    if "prefill" in cells:
        cell = build_cell(cfg, configs.ShapeConfig(
            "p", seq_len=S, global_batch=B, kind="prefill"), mesh)
        args = place((params, prompt), cell["in_shardings"])
        out.update(_local_shapes({"params": args[0]}, "serve"))
        logits, cache = full(cell["fn"](*args))
        out["logits"] = logits.cpu().numpy()
        out.update(fam.flat(_numpy(cache), "cache"))
    if "decode" in cells:
        steps = int(inp["decode_steps"])
        shape = configs.ShapeConfig("d", seq_len=S + steps, global_batch=B,
                                    kind="decode")
        cell = build_cell(cfg, shape, mesh)
        lg, cache = cell["model"].prefill(params, prompt,
                                          max_len=shape.seq_len)
        tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        in_sh = cell["in_shardings"]
        p_d, c_d = place(params, in_sh[0]), place(cache, in_sh[2])
        out.update(_local_shapes({"cache": c_d}, "decode"))
        got = [tok]
        for i in range(steps):
            b = ({"frame_embed": torch.from_numpy(inp["dec_frames"][i])
                  .to(dev)} if audio else {"token": tok})
            tok_d, c_d = cell["fn"](p_d, place(b, in_sh[1]), c_d)
            tok = full(tok_d)
            got.append(tok)
        out["tokens"] = torch.stack(got, dim=1).cpu().numpy()
        out["launches"] = np.array(_launches())
    return out


def _device(inp) -> str:
    return str(inp["device"]) if "device" in inp.files else "cpu"


def _launches() -> list:
    """The RMSNorm and paged-attention kernels' launch counts so far."""
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    return [rms_kernel.launches, pa_kernel.launches]


def _numpy(tree):
    """A nested dict of tensors as numpy arrays."""
    return {k: _numpy(v) if isinstance(v, dict) else v.cpu().numpy()
            for k, v in tree.items()}


def _norm(inp, mesh) -> dict:
    from repro_torch.distributed.sharding import (NamedSharding,
                                                  PartitionSpec as P, place)
    from repro_torch.models import layers
    x = torch.from_numpy(inp["x"])
    scale = torch.from_numpy(inp["scale"])
    dy = torch.from_numpy(inp["dy"])
    rows = NamedSharding(mesh, P("data", None, None))
    xd = place(x, rows).requires_grad_(True)
    sd = place(scale, NamedSharding(mesh, P(None))).requires_grad_(True)
    y = layers.rms_norm(xd, sd, 1e-6)
    dx, ds = torch.autograd.grad(y, (xd, sd), place(dy, rows))
    def names(placements):
        return ["Partial" if p.is_partial() else
                f"Shard({p.dim})" if p.is_shard() else "Replicate"
                for p in placements]

    return {"json": np.array(json.dumps({
        "y": names(y.placements), "dscale": names(ds.placements)})),
        "dscale_local": ds.to_local().numpy(),
        "dscale": ds.full_tensor().numpy(),
        "dx": dx.full_tensor().numpy(),
        "y_full": y.full_tensor().detach().numpy()}


def _paged(inp, mesh) -> dict:
    """`transformer._paged_kernel` on DTensors laid out as the decode
    cell lays them out (pools by the cache's logical axes, q by the
    kv heads', the table's rows as the pool's), its lens made as
    `decode_step` makes them from the replicated length, under
    `implicit_replication()`: the whole output and the lens each rank
    passed (`lens/<rank>`)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (full, make_rules, place,
                                                  replicated, sharding_for)
    from repro_torch.models import transformer
    cfg = get_config("qwen3-1.7b")
    rules = make_rules(cfg, mesh)
    q, kp, vp = (torch.from_numpy(inp[k]) for k in ("q", "k", "v"))
    table = torch.from_numpy(inp["table"])
    B, K = kp.shape[0], kp.shape[3]
    pool_sh = sharding_for(("batch", "kv_seq", None, "kv_heads",
                            "head_dim"), mesh, rules, tuple(kp.shape))
    seen = []
    paged = transformer.paged_decode_attention

    def recording(qq, k_pool, v_pool, tab, lens):
        seen.append(lens.clone())
        return paged(qq, k_pool, v_pool, tab, lens)

    transformer.paged_decode_attention = recording
    try:
        with implicit_replication():
            pos = place(torch.tensor(int(inp["pos"]), dtype=torch.int32),
                        replicated(mesh))
            lens = (pos + 1).to(torch.int32).reshape(1).expand(B) \
                .contiguous()
            out = transformer._paged_kernel(
                place(q, sharding_for(("batch", "kv_heads", None), mesh,
                                      rules, tuple(q.shape))),
                place(kp, pool_sh), place(vp, pool_sh),
                place(table, sharding_for(("batch", None), mesh, rules,
                                          tuple(table.shape))), lens)
    finally:
        transformer.paged_decode_attention = paged
    return {"out": full(out).numpy(), "lens": seen[0].numpy(),
            "local_pool": np.array(place(kp, pool_sh).to_local().shape),
            "kv_heads": np.array(K)}


def _collectives(rank: int, world: int) -> dict:
    """torch's functional collectives on seeded tensors, first through
    gloo's own kernels, then through `shared_card`'s (installed for CPU
    tensors: buffers in /dev/shm): each result under `native/<op>` and
    `shared/<op>`, and this rank's inputs (`x`, `y`)."""
    import torch.distributed._functional_collectives as funcol
    from repro_torch.distributed import shared_card
    g = dist.group.WORLD
    gen = torch.Generator().manual_seed(rank)
    x = torch.randn(4 * world, 3, generator=gen)
    splits = [r + 1 for r in range(world)]          # uneven, as ranks differ
    y = torch.randn(sum(splits), 3, generator=gen)
    got = {"x": x.numpy(), "y": y.numpy()}
    counted = shared_card.moved["calls"]
    for mode in ("native", "shared"):
        if mode == "shared":
            shared_card.install("CPU")
        outs = {
            "all_gather": funcol.all_gather_tensor(x, 0, g),
            "reduce_scatter": funcol.reduce_scatter_tensor(x, "sum", 0, g),
            "reduce_scatter_avg": funcol.reduce_scatter_tensor(x, "avg", 0,
                                                               g),
            "all_reduce": funcol.all_reduce(x, "sum", g),
            "all_reduce_max": funcol.all_reduce(x, "max", g),
            "all_to_all": funcol.all_to_all_single(
                y, [rank + 1] * world, splits, g)}
        for k, v in outs.items():
            v = v.wait() if hasattr(v, "wait") else v
            got[f"{mode}/{k}"] = v.numpy()
    got["shared_calls"] = np.array(shared_card.moved["calls"] - counted)
    shared_card.release()
    return got


def _train(inp, mesh, rank) -> dict:
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import ShapeConfig
    from repro_torch.distributed.sharding import full
    from repro_torch.launch.train import make_store_for_checkpoints, train
    cfg = _cfg(str(inp["arch"]))
    shape = ShapeConfig("t", seq_len=int(inp["seq_len"]),
                        global_batch=int(inp["batch"]), kind="train")
    steps, seed = int(inp["steps"]), int(inp["seed"])
    scenario = str(inp["scenario"])
    kw = dict(seed=seed, num_microbatches=int(inp["microbatches"]))
    if scenario == "straight":
        res = train(cfg, shape, steps=steps, mesh=mesh, device="cpu", **kw)
        return {"losses": np.array(res.losses),
                "grad_norms": np.array(res.grad_norms)}
    if scenario == "refused":
        # a checkpointer on rank 1: refused before any collective
        msg = ""
        if rank == 1:
            try:
                train(cfg, shape, steps=steps, mesh=mesh, device="cpu",
                      checkpointer=Checkpointer(
                          make_store_for_checkpoints(device="cpu")), **kw)
            except ValueError as e:
                msg = str(e)
        return {"refused": np.array(msg)}
    ckpt = int(inp["ckpt"])
    ck = Checkpointer(make_store_for_checkpoints(device="cpu")) \
        if rank == 0 else None
    out = {}
    if scenario == "save":
        first = train(cfg, shape, steps=ckpt, mesh=mesh, checkpointer=ck,
                      checkpoint_every=ckpt, device="cpu", **kw)
        saved = full(first.state)
        out["losses"] = np.array(first.losses)
        if rank == 0:
            res = train(cfg, shape, steps=steps, checkpointer=ck,
                        resume=True, device="cpu", **kw)
            back = ck.restore(ckpt, like=saved)
            same = all(torch.equal(a, b) for a, b in zip(
                _leaves(saved), _leaves(back)))
            out.update(resumed=np.array(res.losses),
                       restored_from=np.array(res.restored_from),
                       same_state=np.array(same))
        return out
    if rank == 0:
        first = train(cfg, shape, steps=ckpt, checkpointer=ck,
                      checkpoint_every=ckpt, device="cpu", **kw)
        out["losses"] = np.array(first.losses)
    res = train(cfg, shape, steps=steps, mesh=mesh, checkpointer=ck,
                resume=True, device="cpu", **kw)
    out.update(resumed=np.array(res.losses),
               restored_from=np.array(res.restored_from))
    return out


def _leaves(tree):
    from repro_torch.distributed.sharding import tree_leaves
    return tree_leaves(tree)


def main(argv) -> int:
    mode, rank, world, init_file, src, dst = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=180))
    try:
        from repro_torch.launch.mesh import make_test_mesh
        inp = np.load(src)
        if "shared" in inp.files and bool(inp["shared"]):
            # DTensor's collectives through shared buffers (the card's
            # transport for ranks sharing one card), here in /dev/shm
            from repro_torch.distributed import shared_card
            shared_card.install("CPU")
        if _device(inp) == "cuda":
            torch.cuda.set_device(0)
        mesh = make_test_mesh(int(inp["data"]), int(inp["model"]),
                              device=_device(inp))
        if mode == "collectives":
            out = _collectives(rank, world)
        elif mode == "paged":
            out = _paged(inp, mesh)
        elif mode == "cells":
            out = _cells(inp, mesh)
        elif mode == "family":
            out = _family(inp, mesh)
        elif mode == "norm":
            out = _norm(inp, mesh)
        else:
            out = _train(inp, mesh, rank)
        np.savez(dst.replace(".npz", f"_r{rank}.npz"), **out)
    finally:
        from repro_torch.distributed import shared_card
        shared_card.release()
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
