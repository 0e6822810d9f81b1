"""Step builders: the train step (gradient accumulation + AdamW), its
int8-compressed multi-pod form, and the serve steps (prefill / decode),
with their in/out shardings; `build_cell` assembles one (arch x shape)
cell on a mesh.

The JAX package's `launch/steps.py` on torch tensors. A step function
computes on whatever tensors it is given. A cell's `fn` takes the
`place`d DTensor arguments. Where each is whole on this rank (a mesh of
one rank, or a mesh split only over the compressed step's pod axis,
whose shards are each pod's own part of the batch) it computes on their
local tensors (`sharding.local`) and `place`s the results by its out
shardings. Where an argument is split over an axis of several ranks,
the step runs on the DTensors themselves: the models' DTensor paths
compute on each rank's shards (FSDP over `data`, Megatron's projections
over `model`, the kernels on local tensors), and the results are
redistributed to the out shardings. The compressed step with such an
axis beside its pod axis runs on each argument's per-pod view (the
DTensor over the mesh without the pod axis, `sharding.per_pod`), as the
reference's `shard_map` region over the pod axis does. The cell's
sharding rules are installed while `fn` runs; the models' `constrain`
calls pass plain tensors through.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig, ShapeConfig, padded_vocab
from repro_torch.distributed.sharding import (NamedSharding, PartitionSpec,
                                              Replicate, Shard, from_pod,
                                              get_global_rules,
                                              installed_rules, is_dtensor,
                                              lay_out, local, make_rules,
                                              on_locals, per_pod, place,
                                              sharding_for, tree_leaves,
                                              tree_map, tree_shardings)
from repro_torch.launch import specs as specs_lib
from repro_torch.models.registry import Model, build_model
from repro_torch.optim import adamw, compression


# --------------------------------------------------------------------------
# Train
# --------------------------------------------------------------------------

def _mean_grads(model: Model, params: Dict[str, torch.Tensor], batch):
    """(f32 gradients, loss), each the mean over the microbatches of the
    batch's leading dim. Each microbatch's gradients are taken with
    `torch.autograd.grad` and summed in f32 (a Python loop where the
    reference scans), so activation memory stays one microbatch deep. A
    leaf the loss does not use (MusicGen's token embedding: its frontend
    embeds frames) gets a zero gradient, as `jax.grad` gives it."""
    names = sorted(params)
    leaves = [params[k].detach().requires_grad_(True) for k in names]
    live = dict(zip(names, leaves))
    n = next(iter(batch.values())).shape[0]
    g_sum = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
    loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for i in range(n):
        loss, _ = model.loss_fn(live, {k: v[i] for k, v in batch.items()})
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        for acc, g in zip(g_sum, grads):
            acc.add_(g.float())
        loss_sum = loss_sum + loss.detach()
    return {k: g / n for k, g in zip(names, g_sum)}, loss_sum / n


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics).

    batch tensors have a leading num_microbatches dim; the mean gradient
    over them feeds the AdamW update. Metrics are 0-d device tensors: a
    step makes no host sync.
    """
    def train_step(params: Dict[str, torch.Tensor], opt_state, batch):
        grads, loss = _mean_grads(model, params, batch)
        new_params, new_opt, om = adamw.adamw_update(opt_cfg, grads,
                                                     opt_state, params)
        return new_params, new_opt, {"loss": loss, **om}

    return train_step


def dp_size(mesh) -> int:
    return mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)


def make_train_step_compressed(model: Model, opt_cfg: adamw.AdamWConfig,
                               mesh):
    """Multi-pod train step with int8 error-feedback gradient exchange
    over the pod axis (optim/compression.py). Each process is one pod:
    its batch is the pod's part of the global batch, its gradients that
    part's, exchanged by `psum_compressed` over the mesh's pod group;
    the loss is averaged over the pods. The opt state carries the
    quantization-error tree under "err"; everything else updates as in
    `make_train_step`, identically on every pod."""
    group = mesh.group("pod")

    def train_step(params, opt_state, batch):
        # the per-pod region: activation constraints must not mention
        # the pod axis, whose shards are this process's own
        outer = get_global_rules()
        with installed_rules(outer and {**outer, "batch": "data"}):
            grads, loss = _mean_grads(model, params, batch)
            grads, new_err = compression.psum_compressed(
                grads, group, opt_state["err"])
            # in place, on a DTensor's local tensor too
            dist.all_reduce(loss.to_local() if is_dtensor(loss) else loss,
                            group=group)
            loss = loss / dist.get_world_size(group)
        new_params, new_opt, om = adamw.adamw_update(
            opt_cfg, grads, {k: v for k, v in opt_state.items()
                             if k != "err"}, params)
        new_opt["err"] = new_err
        return new_params, new_opt, {"loss": loss, **om}

    return train_step


def train_shardings(model: Model, mesh, shape: ShapeConfig,
                    with_err: bool = False):
    """(in_shardings, out_shardings) trees for make_train_step's fn."""
    rules = make_rules(model.cfg, mesh)
    p_axes = model.logical_axes()
    ap = model.abstract_params()
    p_sh = tree_shardings(p_axes, mesh, rules, ap)
    o_axes = adamw.opt_logical_axes(p_axes)
    o_abs = adamw.abstract_opt_state(ap)
    if with_err:
        o_axes["err"] = o_axes["master"]
        o_abs["err"] = o_abs["master"]
    opt_sh = tree_shardings(o_axes, mesh, rules, o_abs)
    b_specs, b_axes = specs_lib.train_batch_specs(model.cfg, shape,
                                                  dp=dp_size(mesh))
    b_sh = tree_shardings(b_axes, mesh, rules, b_specs)
    metric_sh = NamedSharding(mesh, PartitionSpec())
    in_sh = (p_sh, opt_sh, b_sh)
    out_sh = (p_sh, opt_sh,
              {"loss": metric_sh, "grad_norm": metric_sh, "lr": metric_sh})
    return in_sh, out_sh


def abstract_train_state(model: Model):
    ap = model.abstract_params()
    return ap, adamw.abstract_opt_state(ap)


# --------------------------------------------------------------------------
# Serve
# --------------------------------------------------------------------------

def make_prefill_step(model: Model, max_len: Optional[int] = None):
    def prefill_step(params, batch):
        return model.prefill(params, batch, max_len=max_len)
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, batch, cache):
        logits, new_cache = model.decode_step(params, batch, cache)
        # greedy sampling: (B,1,V) -> (B,1), audio (B,1,C,V) -> (B,1,C)
        next_tok = _greedy(logits)
        return next_tok.to(torch.int32), new_cache
    return decode_step


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the last dim. A DTensor's split over it takes each
    rank's best of its own shard, then the best of the ranks' (DTensor's
    own argmax mis-gathers where no other dim is split: a batch of one)."""
    pl = tuple(logits.placements) if is_dtensor(logits) else ()
    split = [m for m, p in enumerate(pl) if p == Shard(logits.dim() - 1)]
    if not split:
        return torch.argmax(logits, dim=-1)
    if len(split) > 1 or any(p.is_partial() for p in pl):
        raise ValueError(f"greedy tokens of logits laid out as {pl}")
    (m,) = split
    dm = logits.device_mesh
    start = dm.get_local_rank(m) * logits.to_local().shape[-1]

    def best(x):
        val, idx = x.max(dim=-1, keepdim=True)
        return val, idx + start

    val, idx = on_locals(best, (logits,), (pl,), (pl, pl))
    whole = tuple(Replicate() if i == m else p for i, p in enumerate(pl))
    val, idx = val.redistribute(dm, whole), idx.redistribute(dm, whole)
    return torch.gather(idx, -1, torch.argmax(val, dim=-1, keepdim=True)
                        )[..., 0]


def serve_shardings(model: Model, mesh, shape: ShapeConfig, *,
                    mode: str, max_len: Optional[int] = None,
                    flash_decode: bool = False):
    """Shardings for prefill ("prefill") or decode ("decode") steps."""
    cfg = model.cfg
    rules = make_rules(cfg, mesh, flash_decode=flash_decode)
    p_sh = tree_shardings(model.logical_axes(), mesh, rules,
                          model.abstract_params())
    b_specs, b_axes = (specs_lib.prefill_batch_specs(cfg, shape)
                       if mode == "prefill"
                       else specs_lib.decode_batch_specs(cfg, shape))
    b_sh = tree_shardings(b_axes, mesh, rules, b_specs)
    c_axes = model.cache_logical_axes(max_len or shape.seq_len)
    c_abs = model.abstract_cache(shape.global_batch,
                                 max_len or shape.seq_len)
    c_sh = tree_shardings(c_axes, mesh, rules, c_abs)
    B, Vp = shape.global_batch, padded_vocab(cfg.vocab_size)
    audio = (cfg.frontend.kind == "audio"
             and cfg.frontend.num_codebooks > 1)
    C = cfg.frontend.num_codebooks
    logits_sh = sharding_for(
        ("batch", None, None, "vocab") if audio else ("batch", None, "vocab"),
        mesh, rules, shape=(B, 1, C, Vp) if audio else (B, 1, Vp))
    tok_sh = sharding_for(
        ("batch", None, None) if audio else ("batch", None), mesh, rules,
        shape=(B, 1, C) if audio else (B, 1))
    if mode == "prefill":
        return (p_sh, b_sh), (logits_sh, c_sh)
    return (p_sh, b_sh, c_sh), (tok_sh, c_sh)


# --------------------------------------------------------------------------
# Cell assembly (arch x shape -> step fn + specs + shardings)
# --------------------------------------------------------------------------

def _split(tree: Any, manual: Tuple[str, ...] = ()) -> bool:
    """Whether a DTensor leaf of `tree` is sharded over a mesh dim of
    several ranks other than the `manual` ones: this rank holds only its
    shard."""
    def split(x) -> bool:
        names = x.device_mesh.mesh_dim_names
        return any(isinstance(p, Shard) and x.device_mesh.size(m) > 1
                   and names[m] not in manual
                   for m, p in enumerate(x.placements))
    return any(is_dtensor(x) and split(x) for x in tree_leaves(tree))


def _on_mesh(step, out_shardings, rules, manual: Tuple[str, ...] = ()):
    """`step` over DTensor arguments, under `rules`. Where every argument
    is whole on this rank (sharded only over size-1 or `manual` axes),
    their local tensors in and the results `place`d by `out_shardings`
    out. Where one is split over a larger axis, `step` runs on the
    DTensors themselves (the models' DTensor paths: each rank computes
    on its shards, the kernels on its local tensors; plain tensors that
    meet them, such as positions, are the same on every rank and count
    as replicated), and the results are redistributed to
    `out_shardings`. Beside `manual` axes (the compressed step's pod) it
    runs on each argument's per-pod view (`sharding.per_pod`: the local
    tensor as a DTensor over the mesh without them), so the collectives
    of the other axes stay inside the pod's sub-mesh, and the results
    are laid out on the full mesh (`sharding.from_pod`)."""
    def fn(*args):
        with installed_rules(rules):
            if not _split(args, manual):
                return place(step(*local(args, manual)), out_shardings)
            with implicit_replication():
                if not manual:
                    return lay_out(step(*args), out_shardings)
                out = step(*tree_map(lambda x: per_pod(x, manual), args))
                return tree_map(lambda x, sh: from_pod(x, sh, manual), out,
                                out_shardings)
    return fn


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               kv_layout: str = "paged", attn_impl: str = "masked",
               wkv_impl: str = "chunked", grad_compress: bool = False,
               flash_decode: bool = False,
               opt_cfg: Optional[adamw.AdamWConfig] = None):
    """Everything needed to run one (arch x shape) cell on a mesh.

    Returns dict with: fn, args (meta tensors), in_shardings,
    out_shardings, model and donate_argnums, and what `fn` wraps: the
    plain `step`, its sharding `rules` and its `manual` axes (the
    dry-run runs `step` on DTensors itself). PyTorch has no buffer
    donation: `donate_argnums` records the reference's (the train state,
    the cache), whose buffers the port's steps replace or update in
    place.
    """
    model = build_model(cfg, kv_layout=kv_layout, attn_impl=attn_impl,
                        wkv_impl=wkv_impl)
    # activation-sharding rules, installed while fn runs (see
    # sharding.constrain); the reference installs them here for good
    rules = make_rules(cfg, mesh, flash_decode=flash_decode)
    manual: Tuple[str, ...] = ()
    if shape.kind == "train":
        compress = grad_compress and "pod" in mesh.axis_names
        ocfg = opt_cfg or adamw.AdamWConfig()
        step = (make_train_step_compressed(model, ocfg, mesh) if compress
                else make_train_step(model, ocfg))
        in_sh, out_sh = train_shardings(model, mesh, shape,
                                        with_err=compress)
        b_specs, _ = specs_lib.train_batch_specs(cfg, shape,
                                                 dp=dp_size(mesh))
        ap, aopt = abstract_train_state(model)
        if compress:
            aopt["err"] = {k: torch.empty(p.shape, dtype=torch.float32,
                                          device="meta")
                           for k, p in ap.items()}
            manual = ("pod",)
        args = (ap, aopt, b_specs)
        donate = (0, 1)          # params + opt state
    elif shape.kind == "prefill":
        step = make_prefill_step(model, max_len=shape.seq_len)
        in_sh, out_sh = serve_shardings(model, mesh, shape, mode="prefill",
                                        max_len=shape.seq_len)
        b_specs, _ = specs_lib.prefill_batch_specs(cfg, shape)
        args = (model.abstract_params(), b_specs)
        donate = ()
    else:  # decode
        step = make_decode_step(model)
        in_sh, out_sh = serve_shardings(model, mesh, shape, mode="decode",
                                        max_len=shape.seq_len,
                                        flash_decode=flash_decode)
        b_specs, _ = specs_lib.decode_batch_specs(cfg, shape)
        cache = model.abstract_cache(shape.global_batch, shape.seq_len)
        args = (model.abstract_params(), b_specs, cache)
        donate = (2,)            # KV cache / recurrent state
    return {"fn": _on_mesh(step, out_sh, rules, manual), "args": args,
            "in_shardings": in_sh, "out_shardings": out_sh, "model": model,
            "donate_argnums": donate, "step": step, "rules": rules,
            "manual": manual}
