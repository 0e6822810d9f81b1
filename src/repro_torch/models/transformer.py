"""Decoder-only transformer covering the dense / moe / vlm / audio
families, on torch tensors.

The same model as the JAX package's `models/transformer.py`: the same
flat parameter dict (`"embed"`, `"layers/wq"`, ... with a leading layer
axis on layer parameters), the same layouts and the same caches. What
differs is PyTorch idiom: layers run in a Python loop, caches are
updated in place, and the activation `constrain` calls act only on
DTensors (a plain tensor passes unchanged). Training remats
each layer with `torch.utils.checkpoint` where the reference uses
`jax.checkpoint`. The MoE FFN is `models/moe.py`'s.

Decode over a paged cache on the card runs the paged decode-attention
kernel straight on the pool (`decode_step`; a DTensor pool on each
rank's rows and kv heads, `_paged_kernel`); on the CPU it keeps the
reference's gather into logical order followed by grouped decode
attention, so the CPU tests match the reference's model.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, padded_vocab
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import (Partial, Replicate, Shard,
                                              constrain, get_global_rules,
                                              is_dtensor, on_locals,
                                              on_shards)
from repro_torch.kernels.paged_attention.ops import paged_decode_attention
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


# --------------------------------------------------------------------------
# Parameter construction
# --------------------------------------------------------------------------

def param_specs(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], Tuple]]:
    """name -> (shape, logical_axes). Layer params carry a leading L dim.
    Vocab dims are padded (configs.base.padded_vocab); pad logits are
    masked in output_logits."""
    d, H, K, hd, ff, V, nl = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                              cfg.head_dim, cfg.d_ff,
                              padded_vocab(cfg.vocab_size), cfg.num_layers)
    s: Dict[str, Tuple[Tuple[int, ...], Tuple]] = {}
    s["embed"] = ((V, d), ("vocab", "embed"))
    if not cfg.tie_embeddings:
        if cfg.frontend.kind == "audio" and cfg.frontend.num_codebooks > 1:
            s["head"] = ((cfg.frontend.num_codebooks, V, d),
                         (None, "vocab", "embed"))
        else:
            s["head"] = ((V, d), ("vocab", "embed"))
    s["final_norm"] = ((d,), (None,))
    if cfg.frontend.kind == "vlm":
        s["patch_proj"] = ((cfg.frontend.patch_embed_dim, d),
                           (None, "embed"))

    def lyr(name, shape, axes):
        s[f"layers/{name}"] = ((nl,) + shape, ("layers",) + axes)

    lyr("ln1", (d,), (None,))
    lyr("ln2", (d,), (None,))
    lyr("wq", (d, H, hd), ("embed", "heads", None))
    lyr("wk", (d, K, hd), ("embed", "kv_heads", "head_dim"))
    lyr("wv", (d, K, hd), ("embed", "kv_heads", "head_dim"))
    lyr("wo", (H, hd, d), ("heads", None, "embed"))
    if cfg.qkv_bias:
        lyr("bq", (H, hd), ("heads", None))
        lyr("bk", (K, hd), ("kv_heads", "head_dim"))
        lyr("bv", (K, hd), ("kv_heads", "head_dim"))
    if cfg.qk_norm:
        lyr("q_norm", (hd,), (None,))
        lyr("k_norm", (hd,), (None,))
    if cfg.moe is None:
        if cfg.mlp_glu:
            lyr("w_gate", (d, ff), ("embed", "ff"))
        lyr("w_up", (d, ff), ("embed", "ff"))
        lyr("w_down", (ff, d), ("ff", "embed"))
    else:
        m = cfg.moe
        lyr("router", (d, m.num_experts), ("embed", "experts"))
        lyr("we_gate", (m.num_experts, d, m.d_expert),
            ("experts", "embed", "expert_ff"))
        lyr("we_up", (m.num_experts, d, m.d_expert),
            ("experts", "embed", "expert_ff"))
        lyr("we_down", (m.num_experts, m.d_expert, d),
            ("experts", "expert_ff", "embed"))
        if m.num_shared_experts:
            lyr("ws_gate", (d, m.d_shared), ("embed", "ff"))
            lyr("ws_up", (d, m.d_shared), ("embed", "ff"))
            lyr("ws_down", (m.d_shared, d), ("ff", "embed"))
            lyr("shared_gate", (d,), ("embed",))
    return s


def logical_axes(cfg: ModelConfig) -> Dict[str, Tuple]:
    return {k: v[1] for k, v in param_specs(cfg).items()}


def init_params(cfg: ModelConfig,
                generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Random weights on the generator's device, with the reference's
    scheme: normal * 1/sqrt(fan_in) drawn in f32 then cast, norms at one,
    biases at zero. A layer parameter is drawn one layer at a time, so
    the f32 scratch is one layer's slice (an MoE model's stacked experts
    would need tens of GB of it at once). (`torch.Generator` and
    `jax.random` give different numbers; tests carry the reference's
    weights over with `convert.params_from_numpy`.)"""
    dt = _dtype(cfg)
    dev = generator.device
    params = {}
    for name, (shape, _) in sorted(param_specs(cfg).items()):
        if "norm" in name or name.endswith(("ln1", "ln2")):
            params[name] = torch.ones(shape, dtype=dt, device=dev)
        elif name.endswith(("bq", "bk", "bv", "shared_gate")):
            params[name] = torch.zeros(shape, dtype=dt, device=dev)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            std = 1.0 / math.sqrt(max(fan_in, 1))
            w = torch.empty(shape, dtype=dt, device=dev)
            for part in (w if name.startswith("layers/") else (w,)):
                part.copy_(torch.randn(part.shape, generator=generator,
                                       dtype=torch.float32,
                                       device=dev).mul_(std))
            params[name] = w
    return params


def abstract_params(cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Shape-and-dtype-only parameters on the meta device (no memory)."""
    dt = _dtype(cfg)
    return {k: torch.empty(shape, dtype=dt, device="meta")
            for k, (shape, _) in param_specs(cfg).items()}


def param_count_tree(params) -> int:
    """Elements of every tensor leaf of `params` (nested dicts, lists,
    tuples; meta tensors too)."""
    return sum(int(p.numel()) for p in sharding.tree_leaves(params))


# --------------------------------------------------------------------------
# Layer
# --------------------------------------------------------------------------

def _proj(x: torch.Tensor, w: torch.Tensor, b=None,
          axes: Optional[Tuple] = None) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") (+ b): (B, S, d) x (d, N, k) -> (B, S, N,
    k). DTensors project on each rank's shards
    (`_proj_local`), into the layout of the logical `axes` where the
    weight is whole on a mesh dim that they split."""
    if is_dtensor(w):
        return _proj_local(x, w, b, axes)
    d, N, k = w.shape
    out = (x @ w.reshape(d, N * k)).unflatten(-1, (N, k))
    return out if b is None else out + b


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd"). DTensors project on each
    rank's shards (`_out_proj_local`)."""
    if is_dtensor(wo):
        return _out_proj_local(o, wo)
    H, k, d = wo.shape
    return o.flatten(-2) @ wo.reshape(H * k, d)


def _cols(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w, w (d, n). A DTensor weight projects column-parallel under
    FSDP on each rank's own columns, as `_proj_local` (DTensor's own
    choice can gather a weight whole where the activations are small)."""
    if is_dtensor(w):
        return _proj_local(x, w.unsqueeze(1)).squeeze(2)
    return x @ w


def _rows(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h @ w, w (n, d), h's n split as w's rows. On DTensors each rank
    contracts its own part (`_out_proj_local`), the result a partial
    sum over the dims that split it."""
    if is_dtensor(w):
        return _out_proj_local(h.unsqueeze(2), w.unsqueeze(0))
    return h @ w


def _proj_local(x, w, b=None, axes=None):
    """Megatron's column-parallel projection under FSDP, on DTensors: the
    weight gathered over the mesh dims that split its d (rows of the
    batch stay split), each rank projecting its rows onto its own heads
    or head_dim. Where the weight is whole on a mesh dim over which
    `axes` split the heads or head_dim, each rank takes its own part of
    it, zero-padded where the dim does not divide (GSPMD slicing a
    replicated operand: Qwen3-14B's 40 heads are 48 over 16 ranks, 3
    each). Where x comes split over its d as the weight's rows are (a
    batch of one, laid out by the weight), each rank contracts its own
    part of d, the result a partial sum there. The bias `b` (N, k) goes
    with the weight's columns. Its gradients: x's partial over the dims
    that split the heads or d, w's and b's over those that split the
    rows or cut the whole weight. (DTensor's own propagation cannot keep
    a head_dim shard through the (N, k) flatten, and picks layouts its
    views then refuse.)"""
    px, pw = tuple(x.placements), tuple(w.placements)
    dm = w.device_mesh
    n = len(px)
    R, P = Replicate(), Partial()
    want = sharding.wanted(axes, dm) if axes is not None else (R,) * n
    rows = [isinstance(p, Shard) and p.dim == 0 for p in px]
    cols = [isinstance(p, Shard) and p.dim in (1, 2) for p in pw]
    cut = [not rows[m] and pw[m] == R and isinstance(want[m], Shard)
           and want[m].dim in (2, 3) for m in range(n)]
    inner = [px[m] == Shard(x.dim() - 1) and pw[m] == Shard(0)
             for m in range(n)]
    if any(r and c for r, c in zip(rows, cols)):
        raise ValueError(f"rows {px} and heads {pw} on one mesh dim")
    # (w's dim, count per rank, this rank's start) of each cut
    cuts = [(want[m].dim - 1,) + sharding.rank_split(
        w.shape[want[m].dim - 1], dm, m) for m in range(n) if cut[m]]
    # a partial sum over d takes the bias once, on the first of its ranks
    bias_here = all(dm.get_local_rank(m) == 0 for m in range(n) if inner[m])

    def proj(xl, wl, bl=None):
        for dim, per, start in cuts:
            wl = sharding.take_padded(wl, dim, start, per)
            if bl is not None:
                bl = sharding.take_padded(bl, dim - 1, start, per)
        return _proj(xl, wl, bl if bias_here else None)

    out = tuple(Shard(0) if rows[m] else Shard(pw[m].dim + 1) if cols[m]
                else want[m] if cut[m] else P if inner[m] else R
                for m in range(n))
    x_pl = tuple(Shard(0) if rows[m] else px[m] if inner[m] else R
                 for m in range(n))
    w_pl = tuple(pw[m] if cols[m] or inner[m] else R for m in range(n))
    x_grad = tuple(x_pl[m] if rows[m] or inner[m] else P if cols[m]
                   or cut[m] else R for m in range(n))
    w_grad = tuple(pw[m] if cols[m] or inner[m] else P if rows[m] or cut[m]
                   else R for m in range(n))
    if b is None:
        return on_locals(proj, (x, w), (x_pl, w_pl), out,
                         in_grad_placements=(x_grad, w_grad))
    b_pl = tuple(Shard(pw[m].dim - 1) if cols[m] else R for m in range(n))
    b_grad = tuple(b_pl[m] if cols[m] else P if rows[m] or cut[m]
                   or inner[m] else R for m in range(n))
    return on_locals(proj, (x, w, b), (x_pl, w_pl, b_pl), out,
                     in_grad_placements=(x_grad, w_grad, b_grad))


def _out_proj_local(o, wo):
    """Megatron's row-parallel projection under FSDP, on DTensors: each
    rank contracts its own heads or head_dim (the weight gathered over
    the dims that split its d), the result a partial sum over the dims
    that split them; wo's gradient partial over those that split the
    rows. Where wo is whole on such a dim, each rank takes the rows of
    its own heads (zero rows for padded ones, `_proj_local`), and wo's
    gradient is partial there too."""
    po, pwo = tuple(o.placements), tuple(wo.placements)
    if any(isinstance(p, Shard) and p.dim == 1 for p in po):
        raise ValueError(f"an attention output laid out as {po}")
    rows = [p == Shard(0) for p in po]
    # o's heads (dim 2) or head_dim (dim 3) are wo's dims 0 or 1
    inner = [p.dim - 2 if isinstance(p, Shard) and p.dim >= 2 else None
             for p in po]
    R, P = Replicate(), Partial()
    n = len(po)
    cut = [inner[m] is not None and pwo[m] == R for m in range(n)]
    dm = wo.device_mesh
    cuts = [(inner[m], o.to_local().shape[inner[m] + 2],
             dm.get_local_rank(m) * o.to_local().shape[inner[m] + 2])
            for m in range(n) if cut[m]]

    def proj(ol, wl):
        for dim, per, start in cuts:
            wl = sharding.take_padded(wl, dim, start, per)
        return _out_proj(ol, wl)

    o_pl = tuple(Shard(0) if rows[m] else R if inner[m] is None
                 else Shard(inner[m] + 2) for m in range(n))
    wo_pl = tuple(R if inner[m] is None or cut[m] else Shard(inner[m])
                  for m in range(n))
    return on_locals(
        proj, (o, wo), (o_pl, wo_pl),
        tuple(Shard(0) if rows[m] else R if inner[m] is None else P
              for m in range(n)),
        in_grad_placements=(
            o_pl, tuple(wo_pl[m] if inner[m] is not None and not cut[m]
                        else P if rows[m] or cut[m] else R
                        for m in range(n))))


def _kv_for_heads(k, q, num_heads: int):
    """A DTensor's kv (B, S, K, hd) for the heads of q (B, S, Hp, hd),
    laid out as q: each rank gathers the kv heads and picks those of its
    own heads of q, which may run past `num_heads` (padded, `_proj_local`;
    their q and wo rows are zero). The gradient is partial over the
    dims that split q's heads."""
    pq = tuple(q.placements)
    dm = q.device_mesh
    G = num_heads // k.shape[2]
    per = q.to_local().shape[2]
    start = sum(dm.get_local_rank(m) * per for m, p in enumerate(pq)
                if p == Shard(2))
    R, P = Replicate(), Partial()
    k_pl = tuple(p if p == Shard(0) else R for p in pq)

    def pick(kl):
        heads = torch.arange(start, start + per, device=kl.device)
        return kl.index_select(2, (heads // G).clamp(max=kl.shape[2] - 1))

    return on_locals(pick, (k,), (k_pl,), pq, in_grad_placements=(
        tuple(P if p == Shard(2) else k_pl[m] for m, p in enumerate(pq)),))


def _qkv(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
         positions: torch.Tensor, q_axes: Tuple):
    """q, k and v, rotated; on DTensors q in the layout of `q_axes` and
    k, v in the cache's."""
    kv_axes = ("batch", None, "kv_heads", "head_dim")
    if cfg.qkv_bias:
        q = _proj(x, p["wq"], p["bq"], q_axes)
        k = _proj(x, p["wk"], p["bk"], kv_axes)
        v = _proj(x, p["wv"], p["bv"], kv_axes)
    else:
        q = _proj(x, p["wq"], axes=q_axes)
        k = _proj(x, p["wk"], axes=kv_axes)
        v = _proj(x, p["wv"], axes=kv_axes)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.rms_eps)
    q = L.rope_for_seq(q, positions, cfg.rope_theta)
    k = L.rope_for_seq(k, positions, cfg.rope_theta)
    return q, k, v


def _attn(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
          positions: torch.Tensor, *, mode: str,
          kv_in: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
          cache_len=None, attn_impl: str = "masked",
          window: Optional[int] = None):
    """Self-attention. Returns (out, (k, v)) with this segment's keys and
    values (decode reads kv_in as the full cache, new kv written)."""
    H = cfg.num_heads
    heads = ("batch", None, "heads", None)
    q, k, v = _qkv(cfg, p, x, positions, heads)
    q = constrain(q, heads)
    k = constrain(k, ("batch", None, "kv_heads", "head_dim"))
    v = constrain(v, ("batch", None, "kv_heads", "head_dim"))
    if mode == "decode":
        k_cache, v_cache = kv_in
        out = L.decode_attention(q, L.expand_kv(k_cache, H),
                                 L.expand_kv(v_cache, H), cache_len,
                                 window=window)
    else:
        if q.shape[2] != H:
            # a DTensor's heads padded over the mesh: the kv of each
            # rank's own heads
            ke, ve = _kv_for_heads(k, q, H), _kv_for_heads(v, q, H)
        else:
            # the expanded kv laid out as q's heads: a DTensor's kv
            # sharded over head_dim reshards here, not in the repeat's
            # backward
            ke = constrain(L.expand_kv(k, H), heads)
            ve = constrain(L.expand_kv(v, H), heads)
        # batch rows and heads attend apart: a DTensor's shards each
        # run the plain attention on their own (q, k, v)
        if window is not None:
            out = on_shards(functools.partial(
                L.local_chunked_attention, window=window), q, ke, ve)
        else:
            out = on_shards(functools.partial(
                L.chunked_attention, causal=True, impl=attn_impl), q, ke, ve)
    return _out_proj(out.to(x.dtype), p["wo"]), (k, v)


def _ffn(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor):
    """Dense or MoE FFN. Returns (out, aux_loss)."""
    if cfg.moe is None:
        if cfg.mlp_glu:
            return L.mlp_glu(x, p["w_gate"], p["w_up"], p["w_down"],
                             cfg.act), 0.0
        return L.mlp_classic(x, p["w_up"], p["w_down"], cfg.act), 0.0
    out, aux = moe_lib.moe_ffn(cfg, p, x)
    if cfg.moe.num_shared_experts:
        shared = L.mlp_glu(x, p["ws_gate"], p["ws_up"], p["ws_down"], cfg.act)
        if is_dtensor(x):
            gate = torch.sigmoid(_cols(x.float(),
                                       p["shared_gate"].float()[:, None]))
        else:
            gate = torch.sigmoid(
                x.float() @ p["shared_gate"].float())[..., None]
        out = out + (gate * shared.float()).to(out.dtype)
    return out, aux


def _layer(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
           positions, *, mode: str, kv_in=None, cache_len=None,
           attn_impl: str = "masked"):
    x = constrain(x, ("batch", None, None))
    h = L.rms_norm(x, p["ln1"], cfg.rms_eps)
    attn_out, kv = _attn(cfg, p, h, positions, mode=mode, kv_in=kv_in,
                         cache_len=cache_len, attn_impl=attn_impl)
    # reduced here: a DTensor would carry the projection's partial sums
    # into the norm and the FFN
    x = constrain(x + attn_out, ("batch", None, None))
    h = L.rms_norm(x, p["ln2"], cfg.rms_eps)
    ffn_out, aux = _ffn(cfg, p, h)
    return constrain(x + ffn_out, ("batch", None, None)), kv, aux


def _split_layers(params: Dict[str, torch.Tensor]):
    lyr = {k[len("layers/"):]: v for k, v in params.items()
           if k.startswith("layers/")}
    top = {k: v for k, v in params.items() if not k.startswith("layers/")}
    return top, lyr


def _layer_params(lyr: Dict[str, torch.Tensor], i: int):
    return {k: v[i] for k, v in lyr.items()}


# --------------------------------------------------------------------------
# Input embedding / output head (family hooks)
# --------------------------------------------------------------------------

def embed_tokens(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """table[tokens]. A DTensor table looks up Megatron's
    way, on each rank's own vocab rows (`_vocab_parallel`)."""
    if is_dtensor(table):
        return _vocab_parallel(table, tokens)
    return table[tokens.long()]


def _vocab_parallel(table, tokens):
    """The lookup of a DTensor table sharded over its vocab rows on (at
    most) one mesh dim: the table gathered over its other dims, each rank
    looks up the ids in its own rows (zero elsewhere) and the result is
    a partial sum over the vocab dim's ranks. The gradient of each rank's
    rows is partial over the ranks that split the tokens."""
    tpl, ipl = tuple(table.placements), tuple(tokens.placements)
    vocab = [m for m, p in enumerate(tpl) if p == Shard(0)]
    if len(vocab) > 1 or any(ipl[m] != Replicate() for m in vocab):
        raise ValueError(f"a lookup of ids {ipl} in a table {tpl}")
    dm = table.device_mesh
    rows = -(-table.shape[0] // dm.size(vocab[0])) if vocab else 0
    v0 = dm.get_local_rank(vocab[0]) * rows if vocab else 0

    def lookup(tab, ids):
        rel = ids.long() - v0
        hit = ((rel >= 0) & (rel < tab.shape[0]))[..., None]
        return torch.where(hit, tab[rel.clamp(0, tab.shape[0] - 1)],
                           torch.zeros((), dtype=tab.dtype,
                                       device=tab.device))

    def out(m):
        if m in vocab:
            return Partial()
        return ipl[m]

    def grad(m):
        if m in vocab:
            return Shard(0)
        return Partial() if isinstance(ipl[m], Shard) else Replicate()

    n = len(tpl)
    return on_locals(
        lookup, (table, tokens),
        (tuple(Shard(0) if m in vocab else Replicate() for m in range(n)),
         ipl), tuple(out(m) for m in range(n)),
        in_grad_placements=(tuple(grad(m) for m in range(n)), ipl))


def embed_inputs(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]):
    """Returns (x, positions, label_mask_prefix_len)."""
    top, _ = _split_layers(params)
    dev = top["embed"].device
    if cfg.frontend.kind == "audio":
        # stub frontend supplies precomputed frame embeddings (B, S, d)
        x = batch["frame_embeds"].to(_dtype(cfg))
        pos = torch.arange(x.shape[1], device=dev)
        x = x + L.sinusoidal_pos_embed(pos, cfg.d_model).to(x.dtype)[None]
        return constrain(x, ("batch", None, None)), pos, 0
    x = embed_tokens(top["embed"], batch["tokens"])
    prefix = 0
    if cfg.frontend.kind == "vlm":
        patches = batch["patch_embeds"].to(_dtype(cfg))
        px = patches @ top["patch_proj"]
        x = torch.cat([px, x], dim=1)
        prefix = px.shape[1]
    return constrain(x, ("batch", None, None)), \
        torch.arange(x.shape[1], device=dev), prefix


def output_logits(cfg: ModelConfig, params, h: torch.Tensor) -> torch.Tensor:
    top, _ = _split_layers(params)
    w = top["embed"] if cfg.tie_embeddings else top["head"]
    if cfg.frontend.kind == "audio" and cfg.frontend.num_codebooks > 1:
        # a DTensor head (C, V, d) projects on each rank's own vocab rows
        # of every codebook, as a (d, C, V) column-parallel projection
        logits = constrain(_proj_local(h, w.permute(2, 0, 1))
                           if is_dtensor(w) else
                           torch.einsum("bsd,cvd->bscv", h, w),
                           ("batch", None, None, "vocab"))
    else:
        logits = constrain(h @ w.T, ("batch", None, "vocab"))
    return L.mask_pad_logits(logits, cfg.vocab_size)


# --------------------------------------------------------------------------
# Forward passes
# --------------------------------------------------------------------------

def forward(cfg: ModelConfig, params, batch, *, attn_impl: str = "masked",
            remat: bool = True):
    """Training/scoring forward: returns (logits, aux_loss).

    With `remat` and autograd recording, each layer runs under
    `torch.utils.checkpoint` (non-reentrant): it keeps only its input and
    recomputes its activations in the backward, as the reference's
    `jax.checkpoint(..., nothing_saveable)` does — so a CUDA run
    launches each layer's RMSNorm kernels twice."""
    top, lyr = _split_layers(params)
    x, positions, prefix = embed_inputs(cfg, params, batch)

    def body(x, lp):
        x, _, a = _layer(cfg, lp, x, positions, mode="train",
                         attn_impl=attn_impl)
        return x, a

    aux = 0.0
    for i in range(cfg.num_layers):
        lp = _layer_params(lyr, i)
        if remat and torch.is_grad_enabled():
            x, a = checkpoint(body, x, lp, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = body(x, lp)
        aux = aux + a
    x = L.rms_norm(x, top["final_norm"], cfg.rms_eps)
    logits = output_logits(cfg, params, x)
    if prefix:
        logits = logits[:, prefix:]
    return logits, aux


def loss_fn(cfg: ModelConfig, params, batch, *, attn_impl: str = "masked",
            remat: bool = True):
    """Mean next-token cross entropy plus the MoE router loss: returns
    (loss, {"ce", "aux"})."""
    logits, aux = forward(cfg, params, batch, attn_impl=attn_impl,
                          remat=remat)
    loss = L.softmax_cross_entropy(logits, batch["labels"])
    coef = cfg.moe.router_aux_coef if cfg.moe is not None else 0.0
    return loss + coef * aux, {"ce": loss, "aux": aux}


# ---- KV cache ------------------------------------------------------------

@dataclass(frozen=True)
class CacheSpec:
    layout: str            # "contiguous" | "paged"
    max_len: int
    page_size: int = 256

    @property
    def num_pages(self) -> int:
        return -(-self.max_len // self.page_size)


def init_cache(cfg: ModelConfig, batch: int, spec: CacheSpec, *,
               device="cuda"):
    K, hd, nl = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    dt = _dtype(cfg)
    length = torch.zeros((), dtype=torch.int32, device=device)
    if spec.layout == "contiguous":
        shape = (nl, batch, spec.max_len, K, hd)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device),
                "len": length}
    P, ps = spec.num_pages, spec.page_size
    shape = (nl, batch, P, ps, K, hd)
    table = torch.arange(P, dtype=torch.int32,
                         device=device)[None].repeat(batch, 1)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "block_table": table, "len": length}


def abstract_cache(cfg: ModelConfig, batch: int, spec: CacheSpec):
    """The cache's shapes and dtypes on the meta device: never allocated
    (a 32k-context cache is hundreds of GB)."""
    return init_cache(cfg, batch, spec, device="meta")


def cache_logical_axes(cfg: ModelConfig, spec: CacheSpec):
    if spec.layout == "contiguous":
        kv = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
        return {"k": kv, "v": kv, "len": ()}
    kv = ("layers", "batch", "kv_seq", None, "kv_heads", "head_dim")
    return {"k": kv, "v": kv, "block_table": ("batch", None), "len": ()}


def _gather_pages(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """pool: (B, P, ps, K, hd); table: (B, P) logical->physical page ids.

    Returns the logically ordered copy (B, P*ps, K, hd): the plain paged
    read, which the paged decode-attention kernel does without the copy.
    A DTensor pool reads on each rank's own shard: its
    rows, kv heads and head_dim (`_page_local`)."""
    if is_dtensor(pool):
        pl, rows, out = _page_local(pool, 4)
        return on_locals(_gather_pages, (pool, table), (pl, rows), out)
    B, P, ps, K, hd = pool.shape
    rows = torch.arange(B, device=pool.device)[:, None]
    return pool[rows, table.long()].reshape(B, P * ps, K, hd)


def _scatter_token(pool: torch.Tensor, table: torch.Tensor,
                   pos: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Write val (B, K, hd) at logical position pos into the paged pool,
    in place; returns the pool. A DTensor pool is written
    on each rank's own shard (`_page_local`)."""
    if is_dtensor(pool):
        pl, rows, val_pl = _page_local(pool, 3)
        on_locals(_scatter_token, (pool, table, pos, val),
                  (pl, rows, (Replicate(),) * len(pl), val_pl), pl)
        return pool
    B, P, ps, K, hd = pool.shape
    # (1,) index tensors, not 0-d ones: torch turns a 0-d tensor index
    # into a Python int, a device-to-host copy that waits for the card
    pos = pos.reshape(1).long()
    page, off = pos // ps, pos % ps
    rows = torch.arange(B, device=pool.device)
    phys = table[rows, page].long()                      # (B,)
    pool[rows, phys, off] = val.to(pool.dtype)
    return pool


def _page_local(pool, ndim: int):
    """A DTensor pool (B, P, ps, K, hd)'s placements, the block table's
    that line up with them (rows as the pool's, pages whole) and those of
    a tensor (B, [positions,] K, hd) of `ndim` dims in the same rows and
    heads. The pages must be whole on every rank: the table's page ids
    are global."""
    pl = tuple(pool.placements)
    if any(isinstance(p, Shard) and p.dim in (1, 2) for p in pl):
        raise ValueError(f"a paged cache sharded over its pages ({pl}) "
                         f"has no local page read or write")

    def moved(p):
        if isinstance(p, Shard) and p.dim >= 3:
            return Shard(p.dim - 5 + ndim)
        return p

    rows = tuple(p if p == Shard(0) else Replicate() for p in pl)
    return pl, rows, tuple(moved(p) for p in pl)


def _grouped_attention(q, k_cache, v_cache, cache_len):
    """`decode_attention_grouped`. DTensors split over rows or kv heads
    alone (q's heads in the kv heads' groups) attend on each rank's own
    shards; split over head_dim (or the cache's positions) they take
    DTensor's propagation, whose scores sum over the shards."""
    if is_dtensor(q):
        pq, pk = tuple(q.placements), tuple(k_cache.placements)
        if all(a == b and (not isinstance(a, Shard) or a.dim in (0, 2))
               for a, b in zip(pq, pk)):
            return on_locals(L.decode_attention_grouped,
                             (q, k_cache, v_cache, cache_len),
                             (pq, pk, pk, (Replicate(),) * len(pq)), pq)
    return L.decode_attention_grouped(q, k_cache, v_cache, cache_len)


def _paged_kernel(q, k_pool, v_pool, table, lens):
    """`paged_decode_attention` (q (B, H, hd), pools (B, P, ps, K, hd)).
    On DTensors the kernel runs on each rank's own shards: its rows and
    kv heads of the pools, q's heads of those kv heads (a GQA group's
    heads are adjacent), the table's and lens' rows; the output laid out
    as that q. A pool split over head_dim or its pages has no such call
    (the kernel reduces over whole head_dims and pages) and raises."""
    if not is_dtensor(k_pool):
        return paged_decode_attention(q, k_pool, v_pool, table, lens)
    pl, rows, _ = _page_local(k_pool, 3)
    if any(isinstance(p, Shard) and p.dim == 4 for p in pl):
        raise ValueError(f"the paged kernel has no per-shard call on a "
                         f"pool split over head_dim ({pl}): its kv heads "
                         f"do not divide the mesh's model axis")
    q_pl = tuple(Shard(0) if p == Shard(0) else Shard(1) if p == Shard(3)
                 else Replicate() for p in pl)
    return on_locals(paged_decode_attention,
                     (q, k_pool, v_pool, table, lens),
                     (q_pl, pl, pl, rows, rows), q_pl)


def decode_step(cfg: ModelConfig, params, batch, cache, *,
                spec: CacheSpec):
    """One token of autoregressive decode against the KV cache.

    batch: {"token": (B,1) int} (or {"frame_embed": (B,1,d)} for audio).
    Returns (logits_last, new_cache). The cache's pools are updated in
    place and the returned cache holds the same tensors: the reference
    gets the same effect from XLA aliasing its `fori_loop` carry, here
    each layer writes its new k/v straight into its slice of the pool.
    """
    top, lyr = _split_layers(params)
    pos = cache["len"]                           # 0-d int32 current length
    if cfg.frontend.kind == "audio":
        x = batch["frame_embed"].to(_dtype(cfg))
        x = x + L.sinusoidal_pos_embed(pos[None], cfg.d_model).to(
            x.dtype)[None]
    else:
        x = embed_tokens(top["embed"], batch["token"])
    positions = pos[None]                        # (1,)
    x = constrain(x, ("batch", None, None))
    paged = spec.layout == "paged"
    kv_axes = ("batch", "kv_seq", "kv_heads", "head_dim")
    # flash-decoding: per-S-shard scores need the (tiny) q on every
    # model shard; replicating q beats gathering the cache
    replicate_q = bool((get_global_rules() or {}).get("kv_seq"))
    kernel = paged and cache["k"].device.type == "cuda"
    B = x.shape[0]
    if kernel:
        lens = (pos + 1).to(torch.int32).reshape(1).expand(B).contiguous()
        table = cache["block_table"]

    for i in range(cfg.num_layers):
        lp = _layer_params(lyr, i)
        kc, vc = cache["k"][i], cache["v"][i]    # views into the pools
        h = L.rms_norm(x, lp["ln1"], cfg.rms_eps)
        # q laid out as the cache's heads (the grouped attention splits
        # H into (K, G)); flash-decoding replicates it instead
        q_axes = (("batch", None, None, None) if replicate_q
                  else ("batch", None, "kv_heads", "head_dim"))
        q, k, v = _qkv(cfg, lp, h, positions, q_axes)
        q = constrain(q, q_axes)
        if paged:
            _scatter_token(kc, cache["block_table"], pos, k[:, 0])
            _scatter_token(vc, cache["block_table"], pos, v[:, 0])
            if kernel:
                out = _paged_kernel(q[:, 0], kc, vc, table, lens)[:, None]
            else:
                out = _grouped_attention(
                    q, constrain(_gather_pages(kc, cache["block_table"]),
                                 kv_axes),
                    constrain(_gather_pages(vc, cache["block_table"]),
                              kv_axes), pos + 1)
        else:
            idx = pos.long().reshape(1)
            kc.index_copy_(1, idx, k.to(kc.dtype))
            vc.index_copy_(1, idx, v.to(vc.dtype))
            out = _grouped_attention(q, constrain(kc, kv_axes),
                                     constrain(vc, kv_axes), pos + 1)
        x = constrain(x + _out_proj(out.to(x.dtype), lp["wo"]),
                      ("batch", None, None))
        h = L.rms_norm(x, lp["ln2"], cfg.rms_eps)
        ffn_out, _ = _ffn(cfg, lp, h)
        x = constrain(x + ffn_out, ("batch", None, None))
    x = L.rms_norm(x, top["final_norm"], cfg.rms_eps)
    logits = output_logits(cfg, params, x)
    return logits, dict(cache, len=pos + 1)


def prefill(cfg: ModelConfig, params, batch, *, spec: CacheSpec,
            attn_impl: str = "masked"):
    """Prefill: run the full prompt, return (last_logits, cache). Each
    layer's k/v go straight into the cache, allocated once at its padded
    length (contiguous: max_len; paged: identity table over whole
    pages)."""
    top, lyr = _split_layers(params)
    x, positions, prefix = embed_inputs(cfg, params, batch)
    B, S = x.shape[:2]
    K, hd, nl = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    T = spec.max_len if spec.layout == "contiguous" else \
        spec.num_pages * spec.page_size
    kv_axes = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    ks = sharding.zeros((nl, B, T, K, hd), x.dtype, x, kv_axes)
    vs = torch.zeros_like(ks)
    for i in range(nl):
        x, (k, v), _ = _layer(cfg, _layer_params(lyr, i), x, positions,
                              mode="prefill", attn_impl=attn_impl)
        ks[i, :, :S] = k
        vs[i, :, :S] = v
    x = L.rms_norm(x, top["final_norm"], cfg.rms_eps)
    logits = output_logits(cfg, params, x[:, -1:])
    length = torch.tensor(S, dtype=torch.int32, device=x.device)
    if spec.layout == "paged":
        P, ps = spec.num_pages, spec.page_size
        table = torch.arange(P, dtype=torch.int32,
                             device=x.device)[None].repeat(B, 1)
        return logits, {"k": ks.reshape(nl, B, P, ps, K, hd),
                        "v": vs.reshape(nl, B, P, ps, K, hd),
                        "block_table": table, "len": length}
    return logits, {"k": ks, "v": vs, "len": length}
