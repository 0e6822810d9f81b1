"""One rank of a two-process gloo world on the CPU, for the parity tests
of the port's pod-axis code (`psum_compressed` and the compressed train
step of `build_cell`).

    python tests/_torch_pods.py MODE RANK WORLD INIT_FILE IN.npz OUT.npz

MODE "psum": `psum_compressed` over the world on this rank's gradients
and errors (`g/<name>`, `e/<name>` in IN_r<rank>.npz); writes the mean
and the new errors (`mean/<name>`, `err/<name>`).
MODE "mesh": on the mesh (pod=WORLD, data=1, model=1), a (2, 3 WORLD,
4) tensor placed by three specs (its local shard, placements, and
`full_tensor()` against the whole), `local` with and without the pod
axis manual, and `constrain` of a replicated DTensor under rules
(IN.npz unused); writes `<spec>/local`, `<spec>/full_ok`, the
placements and messages as a JSON string under `json`.
MODE "step": one step of `build_cell(..., grad_compress=True)`'s fn on
the mesh (pod=WORLD, data=1, model=1) for a reduced f32 config (IN.npz:
`arch`, `seq_len`, `batch` and the params `p/<name>`; the batch is
`make_batch`'s step 0); writes the new params (`p/<name>`), the AdamW
moments and master copy (`mu/`, `nu/`, `master/<name>`), this pod's
err (`err/<name>`), the largest |g + e| it quantized per leaf
(`amax/<name>`) and the loss. With `data` in IN.npz (WORLD a multiple
of it) the mesh is (pod=WORLD / data, data, model=1): each pod's batch
and FSDP state split over its `data` ranks, the step run on the per-pod
views; the outputs are then the whole tensors (this pod's own `err`),
and the grad norm is written too (`grad_norm`).

`run(mode, tmp)` starts the ranks and returns what each wrote.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


SRC = Path(__file__).resolve().parents[1] / "src"


def run(mode: str, tmp: Path, world: int = 2, timeout: float = 180):
    """Run `world` ranks of `mode` over files in `tmp` (IN: tmp/in.npz or
    tmp/in_r<rank>.npz); returns each rank's outputs as a dict. Every
    rank is killed at `timeout` seconds."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
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


def _mesh_checks(world: int) -> dict:
    import json

    from repro_torch.distributed.sharding import (NamedSharding,
                                                  PartitionSpec as P, constrain,
                                                  installed_rules, local,
                                                  place, replicated)
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh(1, 1, pod=world, device="cpu")
    x = torch.arange(2 * 3 * world * 4, dtype=torch.float32).reshape(
        2, 3 * world, 4)
    out, info = {}, {}
    specs = {"batch": P(None, ("pod", "data"), None),
             "pod_model": P("pod", "model", None), "replicated": P()}
    for name, spec in specs.items():
        d = place(x, NamedSharding(mesh, spec))
        info[name] = [str(p) for p in d.placements]
        out[f"{name}/local"] = d.to_local().numpy()
        out[f"{name}/full_ok"] = np.array(torch.equal(d.full_tensor(), x))
    sharded = place(x, NamedSharding(mesh, specs["batch"]))
    try:
        local(sharded)
        info["local_raises"] = None
    except ValueError as e:
        info["local_raises"] = str(e)
    out["manual/local"] = local(sharded, manual=("pod",)).numpy()
    with installed_rules({"batch": ("pod", "data")}):
        y = constrain(place(x, replicated(mesh)), (None, "batch", None))
    info["constrained"] = [str(p) for p in y.placements]
    out["constrained/local"] = y.to_local().numpy()
    out["json"] = np.array(json.dumps(info))
    return out


def main(argv) -> int:
    mode, rank, world, init_file, src, dst = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    try:
        if mode == "mesh":
            out = _mesh_checks(world)
        elif mode == "psum":
            from repro_torch.optim.compression import psum_compressed
            inp = np.load(src.replace(".npz", f"_r{rank}.npz"))
            mean, err = psum_compressed(_split(inp, "g/"), dist.group.WORLD,
                                        _split(inp, "e/"))
            out = {**{f"mean/{k}": v.numpy() for k, v in mean.items()},
                   **{f"err/{k}": v.numpy() for k, v in err.items()}}
        else:
            from repro_torch.configs import ShapeConfig, get_config, reduced
            from repro_torch.data.pipeline import make_batch
            from repro_torch.distributed.sharding import full, local, place
            from repro_torch.launch.mesh import make_test_mesh
            from repro_torch.launch.steps import build_cell
            from repro_torch.optim import adamw, compression
            inp = np.load(src)
            psum, amax = compression.psum_compressed, {}

            def recording(grads, group, errors):
                for k in grads:
                    g = (grads[k].float() + errors[k]).abs().max()
                    amax[k] = float(full(g))
                return psum(grads, group, errors)

            compression.psum_compressed = recording
            cfg = dataclasses.replace(reduced(get_config(str(inp["arch"]))),
                                      dtype="float32")
            shape = ShapeConfig("pods", seq_len=int(inp["seq_len"]),
                                global_batch=int(inp["batch"]), kind="train")
            data = int(inp["data"]) if "data" in inp.files else 1
            mesh = make_test_mesh(data, 1, pod=world // data, device="cpu")
            whole = local if data == 1 else full
            cell = build_cell(cfg, shape, mesh, grad_compress=True)
            params = _split(inp, "p/")
            opt = adamw.adamw_init(params)
            opt["err"] = {k: torch.zeros(p.shape) for k, p in params.items()}
            n = cell["args"][2]["tokens"].shape[0]
            batch = {k: torch.from_numpy(v) for k, v in make_batch(
                cfg, shape, step=0, num_microbatches=n).items()}
            new_p, new_o, m = whole(cell["fn"](*place(
                (params, opt, batch), cell["in_shardings"])))
            trees = {"p": new_p, **{t: new_o[t] for t in (
                "mu", "nu", "master", "err")}}
            out = {f"{t}/{k}": v.numpy() for t, tree in trees.items()
                   for k, v in tree.items()}
            out.update({f"amax/{k}": np.float32(v) for k, v in amax.items()},
                       loss=m["loss"].numpy())
            if data > 1:
                out["grad_norm"] = m["grad_norm"].numpy()
        np.savez(dst.replace(".npz", f"_r{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
