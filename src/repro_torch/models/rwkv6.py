"""RWKV6 "Finch" (arXiv:2404.05892): attention-free LM with data-dependent
per-channel decay, on torch tensors.

The JAX package's `models/rwkv6.py`, with the same flat parameter dict
(`"embed"`, `"layers/wr"`, ... with a leading layer axis) and the same
state `{"tm", "cm", "wkv", "len"}`. Two WKV implementations:

  * ``wkv_scan``    — sequential over time (a Python loop where the
                      reference uses `lax.scan`). The correctness
                      oracle; decode runs it for its one token.
  * ``wkv_chunked`` — the chunk-parallel linear-attention form with
                      exact per-pair exponents, in f32. Train and
                      prefill run it.

What differs is PyTorch idiom: layers run in a Python loop over the
stacked `layers/*` parameters, and a layer is rematerialised with
`torch.utils.checkpoint` only while autograd records.

State per layer: wkv state (B, H, hs, hs) f32 + token-shift registers.
Decode is O(1) in context length.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, RWKVConfig, padded_vocab
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import (Partial, Replicate, Shard,
                                              constrain, is_dtensor,
                                              on_locals)
from repro_torch.models import layers as L
from repro_torch.models.transformer import _cols, _dtype, _rows, embed_tokens


# --------------------------------------------------------------------------
# Params
# --------------------------------------------------------------------------

def param_specs(cfg: ModelConfig):
    d, ff, V, nl = (cfg.d_model, cfg.d_ff, padded_vocab(cfg.vocab_size),
                    cfg.num_layers)
    rw = cfg.rwkv or RWKVConfig()
    H = d // rw.head_size
    s = {}
    s["embed"] = ((V, d), ("vocab", "embed"))
    s["embed_norm"] = ((d,), (None,))
    if not cfg.tie_embeddings:
        s["head"] = ((V, d), ("vocab", "embed"))
    s["final_norm"] = ((d,), (None,))

    def lyr(name, shape, axes):
        s[f"layers/{name}"] = ((nl,) + shape, ("layers",) + axes)

    lyr("ln1", (d,), (None,))
    lyr("ln2", (d,), (None,))
    # time-mix token-shift ddlerp
    lyr("mu_x", (d,), (None,))
    lyr("mu", (5, d), (None, None))                    # w,k,v,r,g bases
    lyr("w_mix1", (d, 5 * rw.mix_lora), ("embed", None))
    lyr("w_mix2", (5, rw.mix_lora, d), (None, None, "embed"))
    # projections
    for n in ("wr", "wk", "wv", "wg"):
        lyr(n, (d, d), ("embed", "heads_d"))
    lyr("wo", (d, d), ("heads_d", "embed"))
    # data-dependent decay
    lyr("w_base", (d,), (None,))
    lyr("wd1", (d, rw.decay_lora), ("embed", None))
    lyr("wd2", (rw.decay_lora, d), (None, "heads_d"))
    lyr("u", (H, rw.head_size), ("heads", None))       # bonus
    lyr("ln_x_scale", (d,), (None,))
    lyr("ln_x_bias", (d,), (None,))
    # channel-mix
    lyr("c_mu_k", (d,), (None,))
    lyr("c_mu_r", (d,), (None,))
    lyr("wck", (d, ff), ("embed", "ff"))
    lyr("wcv", (ff, d), ("ff", "embed"))
    lyr("wcr", (d, d), ("embed", "heads_d"))
    return s


def logical_axes(cfg: ModelConfig):
    return {k: v[1] for k, v in param_specs(cfg).items()}


def init_params(cfg: ModelConfig,
                generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Random weights on the generator's device with the reference's
    scheme (norms and ln_x at one, token-shift mixes uniform in [0, 0.5),
    the decay base spread over [-6, 1], the bonus normal * 0.1, the rest
    normal * 1/sqrt(fan_in)), drawn in f32 then cast. (`torch.Generator`
    and `jax.random` give different numbers; tests carry the reference's
    weights over with `convert.params_from_numpy`.)"""
    dt = _dtype(cfg)
    dev = generator.device
    params = {}
    for name, (shape, _) in sorted(param_specs(cfg).items()):
        leaf = name.split("/")[-1]
        if "norm" in name or "ln" in leaf[:2] or name.endswith("ln_x_scale"):
            params[name] = torch.ones(shape, dtype=dt, device=dev)
        elif name.endswith(("mu_x", "mu", "c_mu_k", "c_mu_r", "ln_x_bias")):
            w = torch.rand(shape, generator=generator, dtype=torch.float32,
                           device=dev)
            params[name] = w.mul_(0.5).to(dt)
        elif name.endswith("w_base"):
            # decay base: spread so w = exp(-exp(w_base)) covers (0, 1)
            params[name] = torch.linspace(
                -6.0, 1.0, math.prod(shape), dtype=torch.float32,
                device=dev).reshape(shape).to(dt)
        elif name.endswith("u"):
            w = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=dev)
            params[name] = w.mul_(0.1).to(dt)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            w = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=dev)
            params[name] = w.mul_(1.0 / math.sqrt(max(fan_in, 1))).to(dt)
    return params


def abstract_params(cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Shape-and-dtype-only parameters on the meta device (no memory)."""
    dt = _dtype(cfg)
    return {k: torch.empty(shape, dtype=dt, device="meta")
            for k, (shape, _) in param_specs(cfg).items()}


# --------------------------------------------------------------------------
# WKV (plain torch, f32)
# --------------------------------------------------------------------------

def wkv_scan(r, k, v, w, u, state0):
    """Oracle. r,k,v,w: (B, S, H, hs) (w = decay in (0,1), f32 math);
    u: (H, hs); state0: (B, H, hs, hs) [key, value]. Returns (y, stateT)."""
    r, k, v, w = (t.float() for t in (r, k, v, w))
    u = u.float()
    state = state0.float()
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]   # (B, H, hs)
        kv = kt[..., :, None] * vt[..., None, :]              # (B,H,hs,hs)
        ys.append(torch.einsum("bhi,bhij->bhj", rt,
                               state + u[None, :, :, None] * kv))
        state = wt[..., :, None] * state + kv
    return torch.stack(ys, dim=1), state        # (B,S,H,hs), (B,H,hs,hs)


def wkv_chunked(r, k, v, w, u, state0, *, chunk: int = 32):
    """Chunk-parallel WKV (log-domain linear attention).

    Within a chunk of length C:
      y_t = r~_t·S_0 + sum_{s<t} (r~_t·k~_s) v_s + (r_t·(u∘k_t)) v_t
      with r~_t = r_t∘P⁻_t, k~_s = k_s/P_s, P_t = prod_{s<=t} w_s.
    S_{chunk end} = diag(P_C) S_0 + sum_t diag(P_C/P_t) k_t^T v_t.

    All cross-chunk factors have exponents <= 0 and the intra-chunk
    matrix uses exact per-pair exponents (also <= 0): a factored form
    around one reference overflows once a chunk spans more than ~80 nats
    of decay. Every step is in f32. Matches `wkv_scan` to f32 tolerance.
    """
    B, S, H, hs = r.shape
    C = min(chunk, S)
    n = -(-S // C)
    pad = n * C - S
    if pad:
        r, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    rc, kc, vc, wc = (t.float().reshape(B, n, C, H, hs)
                      for t in (r, k, v, w))
    u = u.float()
    ii = torch.arange(C, device=r.device)
    causal = (ii[None, :] < ii[:, None])[None, :, :, None, None]
    state = state0.float()
    ys = []
    for c in range(n):
        rt, kt, vt, wt = rc[:, c], kc[:, c], vc[:, c], wc[:, c]  # (B,C,H,hs)
        lw = torch.log(torch.clamp(wt, 1e-12, 1.0))    # <= 0
        cum = torch.cumsum(lw, dim=1)                  # log P_t (inclusive)
        cum_ex = cum - lw                              # log P⁻_t (exclusive)
        total = cum[:, -1:]                            # log P_C
        # A_ij = sum_e r_ie k_je exp(cum_ex_ie - cum_je), j < i, with the
        # exponent formed per pair: (B, Ci, Cj, H, hs)
        expo = cum_ex[:, :, None] - cum[:, None, :]
        expo = torch.where(causal, expo, -torch.inf)
        A = torch.einsum("bijhe,bijhe->bhij",
                         rt[:, :, None] * kt[:, None, :], torch.exp(expo))
        intra = torch.einsum("bhij,bjhe->bihe", A, vt)
        diag = torch.einsum("bihe,bihe->bih", rt, u[None, None] * kt)
        intra = intra + diag[..., None] * vt
        inter = torch.einsum("bihe,bhef->bihf", rt * torch.exp(cum_ex), state)
        ys.append(inter + intra)
        decay_out = torch.exp(total - cum)             # P_C / P_t (<= 1)
        state = (torch.exp(total)[:, 0, :, :, None] * state
                 + torch.einsum("bihe,bihf->bhef", kt * decay_out, vt))
    y = torch.stack(ys, dim=1).reshape(B, n * C, H, hs)[:, :S]
    return y, state


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------

def _token_shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """x: (B,S,d); last: (B,d) = final token of the previous segment.
    Returns the 1-step-shifted sequence."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def _ddlerp(p, x, xx):
    """Data-dependent lerp producing the 5 mixed inputs (w,k,v,r,g)."""
    B, S, d = x.shape
    mlora = p["w_mix1"].shape[1] // 5
    base = x + xx * p["mu_x"]
    if is_dtensor(x):
        offs = _offsets(p, base, mlora)
    else:
        s = torch.tanh(base @ p["w_mix1"]).reshape(B, S, 5, mlora)
        offs = torch.einsum("bsfm,fmd->bsfd", s, p["w_mix2"])  # (B,S,5,d)
    mix = p["mu"][None, None] + offs                        # (B,S,5,d)
    xi = x[:, :, None, :] + xx[:, :, None, :] * mix         # (B,S,5,d)
    return tuple(xi[:, :, i] for i in range(5))             # w,k,v,r,g


def _offsets(p, base, mlora: int):
    """The lerp's lora offsets (B, S, 5, d) on DTensors: the lora rows
    laid out whole around their (5, mix_lora) split (the gradient too),
    the offsets by the batch's rows where they split, else by d as the
    weight splits it (a batch of one), as GSPMD lays them out."""
    B, S, d = base.shape
    s = constrain(constrain(torch.tanh(base @ p["w_mix1"]),
                            ("batch", None, None)).reshape(B, S, 5, mlora),
                  ("batch", None, None, None))
    rows = any(pl == Shard(0) for pl in base.placements)
    return constrain(torch.einsum("bsfm,fmd->bsfd", s, p["w_mix2"]),
                     ("batch", None, None, None) if rows
                     else (None, None, None, "embed"))


def time_mix(cfg: ModelConfig, p, x, tm_state, wkv_state, *,
             wkv_impl: str = "chunked"):
    """x: (B,S,d). tm_state: (B,d) shift register; wkv_state: (B,H,hs,hs).
    Returns (out, new_tm_state, new_wkv_state)."""
    rw = cfg.rwkv or RWKVConfig()
    B, S, d = x.shape
    H, hs = d // rw.head_size, rw.head_size
    xx = _token_shift(x, tm_state) - x
    xw, xk, xv, xr, xg = _ddlerp(p, x, xx)
    fn = wkv_chunked if wkv_impl == "chunked" else wkv_scan
    if is_dtensor(x):
        out, wkv_state = _heads_local(cfg, p, x, (xw, xk, xv, xr, xg),
                                      wkv_state, fn)
        return out, x[:, -1, :], wkv_state
    r = constrain((xr @ p["wr"]).reshape(B, S, H, hs),
                  ("batch", None, "heads", None))
    k = constrain((xk @ p["wk"]).reshape(B, S, H, hs),
                  ("batch", None, "heads", None))
    v = constrain((xv @ p["wv"]).reshape(B, S, H, hs),
                  ("batch", None, "heads", None))
    g = F.silu(xg @ p["wg"])
    dlog = (p["w_base"].float()
            + (torch.tanh(xw @ p["wd1"]) @ p["wd2"]).float())
    w = torch.exp(-torch.exp(dlog)).reshape(B, S, H, hs)    # decay in (0,1)
    y, wkv_state = fn(r, k, v, w, p["u"], wkv_state)
    y = y.reshape(B, S, d)
    y = L.group_norm(y, p["ln_x_scale"], p["ln_x_bias"], num_groups=H)
    out = (y * g).to(x.dtype) @ p["wo"]
    return out, x[:, -1, :], wkv_state


def _heads_local(cfg: ModelConfig, p, x, mixed, wkv_state, fn):
    """`time_mix` from its projections on, on DTensors: r, k, v, g and
    the decay projected on each rank's own heads_d columns and gathered,
    then each rank runs the WKV, ln_x and its rows of wo on its own heads,
    padded as GSPMD pads them (40 heads over 16 ranks are 48, 3 each;
    zero r, k, v and wo rows). Returns the output, a partial sum over the
    dims that split the heads, and the new state laid out as the old."""
    rw = cfg.rwkv or RWKVConfig()
    B, S, d = x.shape
    H, hs = d // rw.head_size, rw.head_size
    xw, xk, xv, xr, xg = mixed
    rows_ax = ("batch", None, None)
    r = constrain(_cols(xr, p["wr"]), rows_ax)
    k = constrain(_cols(xk, p["wk"]), rows_ax)
    v = constrain(_cols(xv, p["wv"]), rows_ax)
    g = constrain(F.silu(_cols(xg, p["wg"])), rows_ax)
    dlog = constrain(p["w_base"].float()
                     + (torch.tanh(xw @ p["wd1"]) @ p["wd2"]).float(),
                     rows_ax)
    dm = x.device_mesh
    R, P = Replicate(), Partial()
    rows = tuple(pl if pl == Shard(0) else R for pl in r.placements)
    split = [pl == Shard(2) for pl in sharding.wanted(
        ("batch", None, "heads", None), dm)]
    per, h0 = H, 0
    for m, s in enumerate(split):
        if s:
            per, h0 = sharding.rank_split(H, dm, m)
    dtype = x.dtype

    def local(r, k, v, dlog, g, u, scale, bias, wo, st):
        Bl = r.shape[0]

        def heads(t):
            return sharding.take_padded(t.reshape(Bl, S, H, hs), 2, h0, per)

        def chans(t, dim):
            return sharding.take_padded(t, dim, h0 * hs, per * hs)

        w = torch.exp(-torch.exp(heads(dlog)))
        y, st = fn(heads(r), heads(k), heads(v), w,
                   sharding.take_padded(u, 0, h0, per),
                   sharding.take_padded(st, 1, h0, per))
        y = L.group_norm(y.reshape(Bl, S, per * hs), chans(scale, 0),
                         chans(bias, 0), num_groups=per)
        return (y * chans(g, 2)).to(dtype) @ chans(wo, 0), st

    part = tuple(P if split[m] else rows[m] for m in range(len(rows)))
    whole = tuple(P if split[m] or rows[m] != R else R
                  for m in range(len(rows)))
    out, st = on_locals(
        local, (r, k, v, dlog, g, p["u"], p["ln_x_scale"], p["ln_x_bias"],
                p["wo"], wkv_state),
        (rows,) * 5 + ((R,) * len(rows),) * 4 + (rows,),
        (part, tuple(Shard(1) if split[m] else rows[m]
                     for m in range(len(rows)))),
        in_grad_placements=(part,) * 5 + (whole,) * 4 + (part,))
    if st.shape[1] != H:
        # the padded heads gathered and cut off: the state's own layout
        st = st.redistribute(dm, rows)[:, :H]
    return out, st


def channel_mix(cfg: ModelConfig, p, x, cm_state):
    xx = _token_shift(x, cm_state) - x
    xk = x + xx * p["c_mu_k"]
    xr = x + xx * p["c_mu_r"]
    kk = F.relu(_cols(xk, p["wck"]))
    kk = kk * kk
    out = torch.sigmoid(_cols(xr, p["wcr"])) * _rows(kk, p["wcv"])
    return out, x[:, -1, :]


def _layer(cfg, lp, x, st, *, wkv_impl):
    """st = {"tm": (B,d), "cm": (B,d), "wkv": (B,H,hs,hs)}."""
    x = constrain(x, ("batch", None, None))
    h = L.rms_norm(x, lp["ln1"], cfg.rms_eps)
    out, tm, wkv = time_mix(cfg, lp, h, st["tm"], st["wkv"],
                            wkv_impl=wkv_impl)
    x = x + out
    h = L.rms_norm(x, lp["ln2"], cfg.rms_eps)
    out, cm = channel_mix(cfg, lp, h, st["cm"])
    return constrain(x + out, ("batch", None, None)), \
        {"tm": tm, "cm": cm, "wkv": wkv}


def _split(params):
    lyr = {k[len("layers/"):]: v for k, v in params.items()
           if k.startswith("layers/")}
    top = {k: v for k, v in params.items() if not k.startswith("layers/")}
    return top, lyr


def init_state(cfg: ModelConfig, batch: int, *, device="cuda"):
    rw = cfg.rwkv or RWKVConfig()
    d, nl = cfg.d_model, cfg.num_layers
    H, hs = d // rw.head_size, rw.head_size
    dt = _dtype(cfg)
    return {"tm": torch.zeros((nl, batch, d), dtype=dt, device=device),
            "cm": torch.zeros((nl, batch, d), dtype=dt, device=device),
            "wkv": torch.zeros((nl, batch, H, hs, hs), dtype=torch.float32,
                               device=device),
            "len": torch.zeros((), dtype=torch.int32, device=device)}


def abstract_state(cfg: ModelConfig, batch: int):
    """The state's shapes and dtypes on the meta device (no memory)."""
    return init_state(cfg, batch, device="meta")


def state_logical_axes(cfg: ModelConfig):
    return {"tm": ("layers", "batch", None),
            "cm": ("layers", "batch", None),
            "wkv": ("layers", "batch", "heads", None, None),
            "len": ()}


def forward(cfg: ModelConfig, params, batch, *, state=None,
            wkv_impl: str = "chunked", remat: bool = True,
            return_state: bool = False, last_only: bool = False):
    """Training/scoring/prefill forward. batch: {"tokens": (B,S)}.

    With `remat` and autograd recording, each layer runs under
    `torch.utils.checkpoint` (non-reentrant), as the reference's
    `jax.checkpoint(..., nothing_saveable)` over its scanned layer."""
    top, lyr = _split(params)
    tok = batch["tokens"]
    x = constrain(embed_tokens(top["embed"], tok), ("batch", None, None))
    x = L.rms_norm(x, top["embed_norm"], cfg.rms_eps)
    B = x.shape[0]
    if state is not None:
        st = state
    elif is_dtensor(x):
        st = sharding.zeros_tree(abstract_state(cfg, B), x,
                                 state_logical_axes(cfg))
    else:
        st = init_state(cfg, B, device=x.device)

    def body(x, lp, s):
        return _layer(cfg, lp, x, s, wkv_impl=wkv_impl)

    new = {"tm": [], "cm": [], "wkv": []}
    for i in range(cfg.num_layers):
        lp = {k: v[i] for k, v in lyr.items()}
        s = {k: st[k][i] for k in new}
        if remat and torch.is_grad_enabled():
            x, s_new = checkpoint(body, x, lp, s, use_reentrant=False,
                                  preserve_rng_state=False)
        else:
            x, s_new = body(x, lp, s)
        for k in new:
            new[k].append(s_new[k])
    x = L.rms_norm(x, top["final_norm"], cfg.rms_eps)
    if last_only:
        x = x[:, -1:]
    w = top["embed"] if cfg.tie_embeddings else top["head"]
    logits = constrain(_cols(x, w.T), ("batch", None, "vocab"))
    logits = L.mask_pad_logits(logits, cfg.vocab_size)
    if return_state:
        new_state = {k: torch.stack(v) for k, v in new.items()}
        new_state["len"] = st["len"] + tok.shape[1]
        return logits, new_state
    return logits, 0.0


def loss_fn(cfg: ModelConfig, params, batch, *, wkv_impl: str = "chunked"):
    logits, _ = forward(cfg, params, batch, wkv_impl=wkv_impl)
    loss = L.softmax_cross_entropy(logits, batch["labels"])
    return loss, {"ce": loss, "aux": 0.0}


def prefill(cfg: ModelConfig, params, batch, **kw):
    logits, state = forward(cfg, params, batch, return_state=True,
                            last_only=True, **kw)
    return logits, state


def decode_step(cfg: ModelConfig, params, batch, state):
    """One-token decode: O(1) in context length."""
    logits, new_state = forward(cfg, params, {"tokens": batch["token"]},
                                state=state, wkv_impl="scan",
                                remat=False, return_state=True)
    return logits, new_state
