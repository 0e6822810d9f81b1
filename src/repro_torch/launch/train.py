"""Training launcher: a real training loop with InfiniStore checkpointing.

    PYTHONPATH=src python -m repro_torch.launch.train [--device cpu]

The JAX package's `launch/train.py` on torch tensors, on one device (the
card by default; `device="cpu"` runs the plain PyTorch versions of the
kernels on the CPU). Fault tolerance: periodic EC-coded checkpoints
through the store; on restart (or a simulated failure) the loop resumes
from the latest recoverable step, and the deterministic data pipeline
replays the exact stream. With a mesh the loop runs the train cell
over the caller's process group, each rank on its shards (`train`).
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.core import Clock, InfiniStore, StoreConfig
from repro_torch.core.ec import ECConfig
from repro_torch.core.gc_window import GCConfig
from repro_torch.core.payload import require_device
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.distributed.sharding import (full, place, tree_leaves,
                                              tree_shardings)
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.steps import build_cell, dp_size, make_train_step
from repro_torch.models import build_model
from repro_torch.optim import adamw

MB = 1024 * 1024


@dataclass
class TrainResult:
    steps: int
    final_loss: float
    losses: list
    wall_s: float
    restored_from: Optional[int] = None
    # not in the reference's result: each step's wall time (batch to the
    # device, the step, and its loss on the host; no checkpoint save),
    # and the train state after the last step ({"params", "opt"}, on
    # the device)
    step_seconds: list = field(default_factory=list)
    # each step's global gradient norm before clipping (AdamW's)
    grad_norms: list = field(default_factory=list)
    state: Optional[Dict] = None


def make_store_for_checkpoints(tmpdir: Optional[str] = None, *,
                               device: str = "cuda") -> InfiniStore:
    """The reference's checkpoint store: RS(4+2), 64 MB functions, 8 MB
    fragments, an hour's GC interval; `tmpdir` roots COS on disk."""
    cfg = StoreConfig(
        ec=ECConfig(k=4, p=2),
        function_capacity=64 * MB,
        fragment_bytes=8 * MB,
        gc=GCConfig(gc_interval=3600.0),
        device=device,
    )
    return InfiniStore(cfg, clock=Clock(), cos_root=tmpdir)


def train(cfg: ModelConfig, shape: ShapeConfig, *, steps: int,
          seed: int = 0, num_microbatches: int = 1,
          checkpointer: Optional[Checkpointer] = None,
          checkpoint_every: int = 0, resume: bool = False,
          opt_cfg: Optional[adamw.AdamWConfig] = None,
          mesh=None, device: str = "cuda") -> TrainResult:
    """Train `cfg` for steps [start, steps) on `device` (start is the
    latest checkpoint's step with `resume`, else 0). Parameters come from
    a `torch.Generator` seeded with `seed`, data from `TokenPipeline`.
    `float(loss)` per step is the loop's only host sync.

    With a `mesh` (over the caller's process group, every rank calling
    `train` alike) the step is the train cell's `fn` (`build_cell`):
    every rank draws the same whole params, keeps its shards of them and
    of the AdamW state by `train_shardings`, and gets its shards of each
    batch; the losses are the global mean, the same on every rank, and
    `state` holds this rank's DTensors. Checkpoints store leaves whole,
    so a checkpoint resumes on any `data` width: every rank gathers the
    state, and rank 0, the only rank that passes a `checkpointer`,
    saves it; on `resume` rank 0 picks and restores the step and sends
    the whole leaves to the others."""
    t0 = time.monotonic()
    dev = require_device(device)
    opt_cfg = opt_cfg or adamw.AdamWConfig(lr=1e-3, warmup_steps=10)
    if mesh is None:
        model = build_model(cfg)
        step_fn = make_train_step(model, opt_cfg)
    else:
        if checkpointer is not None and dist.get_rank() != 0:
            raise ValueError("with a mesh only rank 0 holds the "
                             "checkpointer")
        cell = build_cell(cfg, shape, mesh, opt_cfg=opt_cfg)
        model, step_fn = cell["model"], cell["fn"]
        p_sh, o_sh, _ = cell["in_shardings"]
        _, b_axes = specs_lib.train_batch_specs(cfg, shape,
                                                dp=dp_size(mesh))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init_params(gen)
    start = 0
    restored_from = None
    opt_state = None
    latest = None
    if resume and checkpointer is not None:
        latest = checkpointer.latest_step()
    if resume and mesh is not None:
        agreed = [latest]
        dist.broadcast_object_list(agreed, src=0)
        latest = agreed[0]
    if latest is not None:
        like = {"params": params, "opt": adamw.adamw_init(params)}
        if checkpointer is not None:
            state = _to_device(checkpointer.restore(latest, like=like), dev)
        else:
            state = like               # filled by rank 0's broadcast
        del like
        if mesh is not None:
            for leaf in tree_leaves(state):
                dist.broadcast(leaf.reshape(-1).view(torch.uint8), src=0)
        params, opt_state = state["params"], state["opt"]
        del state
        start = latest
        restored_from = latest
    if mesh is not None:
        # each rank keeps its own shards (copies: the whole leaves go)
        params = place(params, p_sh)
        if opt_state is None:
            opt_state = adamw.adamw_init(params)
            opt_state["count"] = place(opt_state["count"], o_sh["count"])
        else:
            opt_state = place(opt_state, o_sh)
    elif opt_state is None:
        opt_state = adamw.adamw_init(params)
    pipe = TokenPipeline(cfg, shape, num_microbatches=num_microbatches,
                         seed=seed, start_step=start)
    losses, step_seconds, grad_norms = [], [], []
    b_sh = None
    for step in range(start, steps):
        ts = time.monotonic()
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in next(pipe).items()}
        if mesh is not None:
            b_sh = b_sh or tree_shardings(b_axes, mesh, cell["rules"],
                                          batch)
            batch = place(batch, b_sh)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(full(metrics["loss"])))
        step_seconds.append(time.monotonic() - ts)
        grad_norms.append(float(full(metrics["grad_norm"])))
        if checkpoint_every and (step + 1) % checkpoint_every == 0 \
                and (checkpointer is not None or mesh is not None):
            state = {"params": params, "opt": opt_state}
            if mesh is not None:
                state = full(state)    # every rank takes part
            if checkpointer is not None:
                checkpointer.save(step + 1, state)
            del state
    return TrainResult(steps=steps, final_loss=losses[-1] if losses else 0.0,
                       losses=losses, wall_s=time.monotonic() - t0,
                       restored_from=restored_from,
                       step_seconds=step_seconds, grad_norms=grad_norms,
                       state={"params": params, "opt": opt_state})


def _to_device(tree, dev: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    shape = ShapeConfig("cli", seq_len=args.seq_len,
                        global_batch=args.batch, kind="train")
    ckpt = None
    if args.checkpoint_every:
        ckpt = Checkpointer(make_store_for_checkpoints(device=args.device))
    res = train(cfg, shape, steps=args.steps, checkpointer=ckpt,
                checkpoint_every=args.checkpoint_every, device=args.device)
    print(f"trained {res.steps} steps in {res.wall_s:.1f}s; "
          f"loss {res.losses[0]:.3f} -> {res.final_loss:.3f}")


if __name__ == "__main__":
    main()
