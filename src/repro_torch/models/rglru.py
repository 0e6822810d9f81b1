"""RecurrentGemma / Griffin (arXiv:2402.19427): RG-LRU recurrent blocks
interleaved with local (sliding-window) attention, 1 attention : 2
recurrent, on torch tensors.

The JAX package's `models/rglru.py`, with the same flat parameter dict
(`"super/<i>/<leaf>"` with a leading superlayer axis for the pattern
unit (recurrent, recurrent, attention), `"tail/<i>/<leaf>"` for the
`num_layers % 3` trailing blocks) and the same state layout. `a_param`
stays f32 in a bf16 model, as in the reference.

What differs is PyTorch idiom: superlayers run in a Python loop where
the reference scans them, and the RG-LRU recurrence runs as a log-depth
(Hillis–Steele) scan of torch ops where the reference calls
`lax.associative_scan`: both combine the same pairs, in another
association order, so they agree to f32 rounding. Decode writes the
attention ring buffer at `pos % window` with `pos` a device tensor.

Sub-quadratic: prefill attention touches only O(S·window) pairs
(`local_chunked_attention`), decode keeps a ring buffer of `window` kv.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, RGLRUConfig, padded_vocab
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import (Partial, Replicate, Shard,
                                              constrain, is_dtensor,
                                              on_locals, on_shards)
from repro_torch.models import layers as L
from repro_torch.models.transformer import (_cols, _dtype, _kv_for_heads,
                                            _out_proj, _proj, _rows)
from repro_torch.models.transformer import embed_tokens as lookup

RG_C = 8.0  # Griffin's fixed `c` exponent scale


def _cfg(cfg: ModelConfig) -> RGLRUConfig:
    return cfg.rglru or RGLRUConfig()


def _num_blocks(cfg):  # block-diagonal gate blocks
    return cfg.num_heads


# --------------------------------------------------------------------------
# Params
# --------------------------------------------------------------------------

def _block_specs(cfg: ModelConfig, kind: str):
    d, ff = cfg.d_model, cfg.d_ff
    rg = _cfg(cfg)
    W, nb = rg.lru_width, _num_blocks(cfg)
    bw = W // nb
    s = {
        "ln1": ((d,), (None,)),
        "ln2": ((d,), (None,)),
        "w_gate": ((d, ff), ("embed", "ff")),
        "w_up": ((d, ff), ("embed", "ff")),
        "w_down": ((ff, d), ("ff", "embed")),
    }
    if kind == "recurrent":
        s.update({
            "wx": ((d, W), ("embed", "lru")),
            "wg": ((d, W), ("embed", "lru")),
            "wout": ((W, d), ("lru", "embed")),
            "conv_w": ((rg.conv_width, W), (None, "lru")),
            "conv_b": ((W,), ("lru",)),
            "rg_a": ((nb, bw, bw), ("lru_blocks", None, None)),
            "rg_a_b": ((W,), ("lru",)),
            "rg_x": ((nb, bw, bw), ("lru_blocks", None, None)),
            "rg_x_b": ((W,), ("lru",)),
            "a_param": ((W,), ("lru",)),
        })
    else:  # attention
        H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        s.update({
            "wq": ((d, H, hd), ("embed", "heads", None)),
            "wk": ((d, K, hd), ("embed", "kv_heads", "head_dim")),
            "wv": ((d, K, hd), ("embed", "kv_heads", "head_dim")),
            "wo": ((H, hd, d), ("heads", None, "embed")),
        })
    return s


def layer_plan(cfg: ModelConfig) -> Tuple[int, Tuple[str, ...]]:
    """(num_superlayers, tail_kinds)."""
    pat = _cfg(cfg).block_pattern
    n_super = cfg.num_layers // len(pat)
    tail = tuple(pat[: cfg.num_layers % len(pat)])
    return n_super, tail


def param_specs(cfg: ModelConfig):
    d, V = cfg.d_model, padded_vocab(cfg.vocab_size)
    pat = _cfg(cfg).block_pattern
    n_super, tail = layer_plan(cfg)
    s = {"embed": ((V, d), ("vocab", "embed")),
         "final_norm": ((d,), (None,))}
    if not cfg.tie_embeddings:
        s["head"] = ((V, d), ("vocab", "embed"))
    if n_super:
        for bi, kind in enumerate(pat):
            for name, (shape, axes) in _block_specs(cfg, kind).items():
                s[f"super/{bi}/{name}"] = ((n_super,) + shape,
                                           ("layers",) + axes)
    for ti, kind in enumerate(tail):
        for name, (shape, axes) in _block_specs(cfg, kind).items():
            s[f"tail/{ti}/{name}"] = (shape, axes)
    return s


def logical_axes(cfg: ModelConfig):
    return {k: v[1] for k, v in param_specs(cfg).items()}


def init_params(cfg: ModelConfig,
                generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Random weights on the generator's device with the reference's
    scheme (norms at one, biases at zero, `a_param` spread over [-3, 0]
    and kept f32, the rest normal * 1/sqrt(fan_in) drawn in f32 then
    cast). (`torch.Generator` and `jax.random` give different numbers;
    tests carry the reference's weights over with
    `convert.params_from_numpy`.)"""
    dt = _dtype(cfg)
    dev = generator.device
    params = {}
    for name, (shape, _) in sorted(param_specs(cfg).items()):
        leaf = name.split("/")[-1]
        if leaf in ("ln1", "ln2", "final_norm"):
            params[name] = torch.ones(shape, dtype=dt, device=dev)
        elif leaf in ("conv_b", "rg_a_b", "rg_x_b"):
            params[name] = torch.zeros(shape, dtype=dt, device=dev)
        elif leaf == "a_param":
            # softplus(a_param) in ~(0.04, 0.6) -> per-channel decay spread
            params[name] = torch.linspace(
                -3.0, 0.0, math.prod(shape), dtype=torch.float32,
                device=dev).reshape(shape)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            w = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=dev)
            params[name] = w.mul_(1.0 / math.sqrt(max(fan_in, 1))).to(dt)
    return params


def abstract_params(cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Shape-and-dtype-only parameters on the meta device (no memory);
    `a_param` is f32 whatever the model's dtype."""
    dt = _dtype(cfg)
    return {k: torch.empty(shape, dtype=torch.float32
                           if k.endswith("a_param") else dt, device="meta")
            for k, (shape, _) in param_specs(cfg).items()}


# --------------------------------------------------------------------------
# RG-LRU + conv
# --------------------------------------------------------------------------

def _block_diag(u: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """u: (B,S,W), w: (nb,bw,bw), b: (W,) -> (B,S,W)."""
    if is_dtensor(u):
        return _block_diag_local(u, w, b)
    B, S, W = u.shape
    nb, bw, _ = w.shape
    ub = u.reshape(B, S, nb, bw)
    out = torch.einsum("bsnw,nwv->bsnv", ub, w)
    return out.reshape(B, S, W) + b


def _block_diag_local(u, w, b):
    """`_block_diag` on DTensors, each rank on its own lru channels: u
    gathered over the dims that split them, each rank's outputs from the
    one or two blocks they lie in (10 blocks of 256 over 16 ranks of 160
    channels: no block-aligned split exists), so a rank does 1/16 of
    the product. The gradient of u and w is partial over those dims."""
    pu = tuple(u.placements)
    dm = u.device_mesh
    R, P = Replicate(), Partial()
    lru = [pl == Shard(2) for pl in pu]
    rows = tuple(pl if pl == Shard(0) else R for pl in pu)
    width = u.to_local().shape[2]
    c0 = sum(dm.get_local_rank(m) * width for m in range(len(pu)) if lru[m])
    bw = w.shape[1]

    def product(ul, wl, bl):
        parts = []
        for n in range(c0 // bw, (c0 + width - 1) // bw + 1):
            lo, hi = max(c0, n * bw), min(c0 + width, (n + 1) * bw)
            parts.append(ul[..., n * bw:(n + 1) * bw]
                         @ wl[n, :, lo - n * bw:hi - n * bw])
        return torch.cat(parts, dim=-1) + bl

    out = tuple(Shard(2) if lru[m] else rows[m] for m in range(len(pu)))
    b_pl = tuple(Shard(0) if lru[m] else R for m in range(len(pu)))
    return on_locals(
        product, (u, w, b), (rows, (R,) * len(pu), b_pl), out,
        in_grad_placements=(
            tuple(P if lru[m] else rows[m] for m in range(len(pu))),
            tuple(P if lru[m] or rows[m] != R else R
                  for m in range(len(pu))),
            tuple(b_pl[m] if lru[m] else P if rows[m] != R else R
                  for m in range(len(pu)))))


def causal_conv1d(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  state: torch.Tensor):
    """Depthwise causal conv. u: (B,S,W), w: (cw,W), state: (B,cw-1,W).
    Returns (out (B,S,W), new_state)."""
    cw = w.shape[0]
    full = torch.cat([state.to(u.dtype), u], dim=1)
    out = sum(full[:, i:i + u.shape[1]] * w[i] for i in range(cw))
    new_state = full[:, -(cw - 1):] if cw > 1 else state
    return out + b, new_state


def linear_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of h_t = a_t·h_{t-1} + b_t along axis 1 from h = 0:
    returns (a_cum, b_cum), a_cum_t = a_0···a_t and b_cum_t = h_t.

    Hillis–Steele: ⌈log2 S⌉ passes, pass d combining each t with t − d
    by the reference's `combine` ((a1, b1), (a2, b2)) -> (a1·a2,
    a2·b1 + b2), all of S at once."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return a, b


def rg_lru(u: torch.Tensor, p: Dict[str, torch.Tensor], h0: torch.Tensor):
    """u: (B,S,W); h0: (B,W) f32. Returns (h_seq (B,S,W) f32, hT)."""
    r = torch.sigmoid(_block_diag(u, p["rg_a"], p["rg_a_b"]).float())
    i = torch.sigmoid(_block_diag(u, p["rg_x"], p["rg_x_b"]).float())
    log_a = -RG_C * r * F.softplus(p["a_param"].float())
    a = torch.exp(log_a)
    gated = i * u.float()
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    if is_dtensor(a):
        # channels scan apart: each rank scans its own
        pl = tuple(a.placements)
        a_cum, b_cum = on_locals(linear_scan, (a, beta * gated), (pl, pl),
                                 (pl, pl))
    else:
        a_cum, b_cum = linear_scan(a, beta * gated)
    h = b_cum + a_cum * h0[:, None, :]
    return h, h[:, -1, :]


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------

def recurrent_block(cfg, p, x, st, *, decode: bool):
    """st: {"h": (B,W) f32, "conv": (B,cw-1,W)}."""
    u = constrain(_cols(x, p["wx"]), ("batch", None, "lru"))
    u, conv_state = causal_conv1d(u, p["conv_w"], p["conv_b"], st["conv"])
    h, hT = rg_lru(u, p, st["h"])
    gate = F.gelu(_cols(x, p["wg"]), approximate="tanh")
    y = _rows(gate * h.to(x.dtype), p["wout"])
    return y, {"h": hT, "conv": conv_state.to(st["conv"].dtype)}


def _to_ring(k: torch.Tensor, window: int) -> torch.Tensor:
    """(B, S, K, hd) -> ring buffer (B, window, K, hd), slot = pos % window.
    A DTensor's shards each build their own (its positions are whole on
    every rank; torch 2.11 has no DTensor strategy for `roll`)."""
    if is_dtensor(k):
        pl = tuple(k.placements)
        return on_locals(functools.partial(_to_ring, window=window), (k,),
                         (pl,), pl)
    S = k.shape[1]
    if S >= window:
        last = k[:, -window:]
    else:
        last = F.pad(k, (0, 0, 0, 0, window - S, 0))
    return torch.roll(last, S % window, dims=1)


def _ring_write(ring: torch.Tensor, slot: torch.Tensor,
                val: torch.Tensor) -> torch.Tensor:
    """ring.index_copy(1, slot, val): the new token's k or v at its ring
    slot. DTensors write each rank's own shard (torch 2.11 has no
    DTensor strategy for `index_copy`)."""
    if is_dtensor(ring):
        pl = tuple(ring.placements)
        return on_locals(_ring_write, (ring, slot, val),
                         (pl, (Replicate(),) * len(pl), pl), pl)
    return ring.index_copy(1, slot, val)


def _decode_attention_local(q, kc, vc, valid):
    """`L.decode_attention` of DTensors q (B, 1, H, hd) and the ring
    (B, window, K, hd), q laid out as the ring first (rows over `data`;
    head_dim over `model` where the one kv head does not divide it), on
    each rank's shards: the scores partial over the dims that split
    head_dim and summed there, the softmax on the whole scores, the
    weighted sum on each rank's part of head_dim. (On torch 2.11
    DTensor's own einsum refuses to flatten the split head_dim.)"""
    pl = tuple(kc.placements)
    q = constrain(q, ("batch", None, "kv_heads", "head_dim"))  # the ring's
    if tuple(q.placements) != pl:
        raise ValueError(f"q laid out as {tuple(q.placements)}, its ring "
                         f"as {pl}")
    scale = 1.0 / math.sqrt(q.shape[-1])
    rows = tuple(Shard(0) if p == Shard(0) else Replicate() for p in pl)
    s_pl = tuple(Partial() if isinstance(p, Shard) and p.dim == 3 else r
                 for p, r in zip(pl, rows))
    dtype = q.dtype

    def scores(ql, kl):
        return torch.einsum("bqhd,bkhd->bhqk", ql.float(), L.expand_kv(
            kl, ql.shape[2]).float()) * scale

    def weighted(sl, vl, n):
        mask = L._len_mask(sl.shape[-1], n, None, sl.device)
        w = torch.softmax(torch.where(mask[:, None, None, :], sl,
                                      L.NEG_INF), dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", w.to(vl.dtype).float(),
                            L.expand_kv(vl, sl.shape[1]).float()).to(dtype)

    s = on_locals(scores, (q, kc), (pl, pl), s_pl)
    s = s.redistribute(s.device_mesh, rows)
    n_pl = tuple(valid.placements) if is_dtensor(valid) else None
    return on_locals(weighted, (s, vc, valid), (rows, pl, n_pl), pl)


def attention_block(cfg, p, x, st, *, decode: bool, pos=None):
    """st: {"k": (B,window,K,hd), "v": ..., } ring buffer (decode only)."""
    rg = _cfg(cfg)
    B, S, d = x.shape
    H = cfg.num_heads
    # on DTensors q laid out as the cache's head_dim (decode) or by its
    # own heads, padded (prefill), as the transformer's attention
    kv_axes = ("batch", None, "kv_heads", "head_dim")
    q = _proj(x, p["wq"], axes=kv_axes if decode
              else ("batch", None, "heads", None))
    k, v = _proj(x, p["wk"], axes=kv_axes), _proj(x, p["wv"], axes=kv_axes)
    if decode:
        positions = pos[None]
        q = L.rope_for_seq(q, positions, cfg.rope_theta)
        k = L.rope_for_seq(k, positions, cfg.rope_theta)
        slot = (pos % rg.attention_window).reshape(1).long()
        kc = _ring_write(st["k"], slot, k.to(st["k"].dtype))
        vc = _ring_write(st["v"], slot, v.to(st["v"].dtype))
        valid = torch.clamp(pos + 1, max=rg.attention_window)
        if is_dtensor(q):
            out = _decode_attention_local(q, kc, vc, valid)
        else:
            out = L.decode_attention(q, L.expand_kv(kc, H),
                                     L.expand_kv(vc, H), valid)
        new_st = {"k": kc, "v": vc}
    else:
        positions = torch.arange(S, device=x.device)
        q = L.rope_for_seq(q, positions, cfg.rope_theta)
        k = L.rope_for_seq(k, positions, cfg.rope_theta)
        if is_dtensor(q):
            # each rank's own (padded) heads attend on their own
            out = on_shards(functools.partial(
                L.local_chunked_attention, window=rg.attention_window), q,
                _kv_for_heads(k, q, H), _kv_for_heads(v, q, H))
        else:
            out = L.local_chunked_attention(q, L.expand_kv(k, H),
                                            L.expand_kv(v, H),
                                            window=rg.attention_window)
        # stash the last `window` kv as a ring buffer (slot = pos % window)
        # so a subsequent decode phase can continue seamlessly
        w = rg.attention_window
        new_st = {"k": _to_ring(k, w).to(st["k"].dtype),
                  "v": _to_ring(v, w).to(st["v"].dtype)}
    return _out_proj(out.to(x.dtype), p["wo"]), new_st


def _block(cfg, kind, p, x, st, *, decode=False, pos=None):
    x = constrain(x, ("batch", None, None))
    h = L.rms_norm(x, p["ln1"], cfg.rms_eps)
    if kind == "recurrent":
        out, st = recurrent_block(cfg, p, h, st, decode=decode)
    else:
        out, st = attention_block(cfg, p, h, st, decode=decode, pos=pos)
    x = x + out
    h = L.rms_norm(x, p["ln2"], cfg.rms_eps)
    mlp = L.mlp_glu(h, p["w_gate"], p["w_up"], p["w_down"], cfg.act,
                    cols=_cols, rows=_rows)
    return constrain(x + mlp, ("batch", None, None)), st


# --------------------------------------------------------------------------
# State
# --------------------------------------------------------------------------

def _block_state(cfg: ModelConfig, kind: str, batch: int, lead=(), *,
                 device):
    rg = _cfg(cfg)
    dt = _dtype(cfg)
    if kind == "recurrent":
        return {"h": torch.zeros(lead + (batch, rg.lru_width),
                                 dtype=torch.float32, device=device),
                "conv": torch.zeros(lead + (batch, rg.conv_width - 1,
                                            rg.lru_width), dtype=dt,
                                    device=device)}
    K, hd = cfg.num_kv_heads, cfg.head_dim
    shape = lead + (batch, rg.attention_window, K, hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def init_state(cfg: ModelConfig, batch: int, *, device="cuda"):
    pat = _cfg(cfg).block_pattern
    n_super, tail = layer_plan(cfg)
    st: Dict[str, Any] = {"len": torch.zeros((), dtype=torch.int32,
                                             device=device)}
    if n_super:
        for bi, kind in enumerate(pat):
            st[f"super/{bi}"] = _block_state(cfg, kind, batch, (n_super,),
                                             device=device)
    for ti, kind in enumerate(tail):
        st[f"tail/{ti}"] = _block_state(cfg, kind, batch, device=device)
    return st


def abstract_state(cfg: ModelConfig, batch: int):
    """The state's shapes and dtypes on the meta device (no memory)."""
    return init_state(cfg, batch, device="meta")


def state_logical_axes(cfg: ModelConfig):
    pat = _cfg(cfg).block_pattern
    n_super, tail = layer_plan(cfg)

    def ax(kind, lead):
        if kind == "recurrent":
            return {"h": lead + ("batch", "lru"),
                    "conv": lead + ("batch", None, "lru")}
        return {"k": lead + ("batch", None, "kv_heads", "head_dim"),
                "v": lead + ("batch", None, "kv_heads", "head_dim")}

    st: Dict[str, Any] = {"len": ()}
    if n_super:
        for bi, kind in enumerate(pat):
            st[f"super/{bi}"] = ax(kind, ("layers",))
    for ti, kind in enumerate(tail):
        st[f"tail/{ti}"] = ax(kind, ())
    return st


# --------------------------------------------------------------------------
# Forward passes
# --------------------------------------------------------------------------

def _split(params):
    top, sup, tail = {}, {}, {}
    for kname, v in params.items():
        if kname.startswith("super/"):
            _, bi, leaf = kname.split("/", 2)
            sup.setdefault(int(bi), {})[leaf] = v
        elif kname.startswith("tail/"):
            _, ti, leaf = kname.split("/", 2)
            tail.setdefault(int(ti), {})[leaf] = v
        else:
            top[kname] = v
    return top, sup, tail


def embed_tokens(cfg: ModelConfig, embed: torch.Tensor,
                 tok: torch.Tensor) -> torch.Tensor:
    """Embedding rows of `tok` (a DTensor table's looked up on each
    rank's own vocab rows, `transformer.embed_tokens`), times
    sqrt(d_model) with `scale_embed`: the constant rounded to the
    embedding's dtype first, as the reference rounds it (50.5 in bf16 at
    d = 2560, not 50.596)."""
    x = lookup(embed, tok)
    if cfg.scale_embed:
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
    return x


def forward(cfg: ModelConfig, params, batch, *, state=None,
            remat: bool = True, return_state: bool = False,
            last_only: bool = False, decode: bool = False):
    """Scoring/prefill (or, with `decode`, one-token) forward. With
    `remat` and autograd recording, each superlayer runs under
    `torch.utils.checkpoint` (non-reentrant), as the reference's
    `jax.checkpoint(..., nothing_saveable)` over its scanned unit."""
    pat = _cfg(cfg).block_pattern
    n_super, tail_kinds = layer_plan(cfg)
    top, sup, tail = _split(params)
    tok = batch["tokens"]
    x = constrain(embed_tokens(cfg, top["embed"], tok), ("batch", None, None))
    B = x.shape[0]
    if state is not None:
        st = state
    elif is_dtensor(x):
        st = sharding.zeros_tree(abstract_state(cfg, B), x,
                                 state_logical_axes(cfg))
    else:
        st = init_state(cfg, B, device=x.device)
    pos = st["len"]

    def body(x, lp_by_block, s_by_block):
        new_s = []
        for bi, kind in enumerate(pat):
            x, s = _block(cfg, kind, lp_by_block[bi], x, s_by_block[bi],
                          decode=decode, pos=pos)
            new_s.append(s)
        return x, new_s

    new_sup = [[] for _ in pat] if n_super else []
    for i in range(n_super):
        lp = [{k: v[i] for k, v in sup[bi].items()} for bi in range(len(pat))]
        s = [{k: v[i] for k, v in st[f"super/{bi}"].items()}
             for bi in range(len(pat))]
        if remat and torch.is_grad_enabled():
            x, s_new = checkpoint(body, x, lp, s, use_reentrant=False,
                                  preserve_rng_state=False)
        else:
            x, s_new = body(x, lp, s)
        for bi, sb in enumerate(s_new):
            new_sup[bi].append(sb)
    new_tail = []
    for ti, kind in enumerate(tail_kinds):
        x, s = _block(cfg, kind, tail[ti], x, st[f"tail/{ti}"],
                      decode=decode, pos=pos)
        new_tail.append(s)
    x = L.rms_norm(x, top["final_norm"], cfg.rms_eps)
    if last_only:
        x = x[:, -1:]
    w = top["embed"] if cfg.tie_embeddings else top["head"]
    logits = constrain(_cols(x, w.T), ("batch", None, "vocab"))
    logits = L.soft_cap(logits, cfg.logit_softcap)
    logits = L.mask_pad_logits(logits, cfg.vocab_size)
    if return_state:
        new_state: Dict[str, Any] = {"len": pos + tok.shape[1]}
        for bi, blocks in enumerate(new_sup):
            new_state[f"super/{bi}"] = {
                k: torch.stack([b[k] for b in blocks]) for k in blocks[0]}
        for ti, s in enumerate(new_tail):
            new_state[f"tail/{ti}"] = s
        return logits, new_state
    return logits, 0.0


def loss_fn(cfg: ModelConfig, params, batch, **kw):
    logits, _ = forward(cfg, params, batch, **kw)
    loss = L.softmax_cross_entropy(logits, batch["labels"])
    return loss, {"ce": loss, "aux": 0.0}


def prefill(cfg: ModelConfig, params, batch, **kw):
    return forward(cfg, params, batch, return_state=True, last_only=True,
                   **kw)


def decode_step(cfg: ModelConfig, params, batch, state):
    return forward(cfg, params, {"tokens": batch["token"]}, state=state,
                   remat=False, return_state=True, decode=True)
