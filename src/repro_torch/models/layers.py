"""Shared model layers: norms, rotary embeddings, chunked (flash-style)
attention, decode attention, MLPs and the loss, on torch tensors.

The same functions as the JAX package's `models/layers.py`, with the
same layouts and the same order of f32 operations, so both packages
agree within float rounding. `rms_norm` goes through the RMSNorm op
(the Hopper kernel for a CUDA tensor, the plain version on the CPU), on
each rank's local tensor for a DTensor.
Prefill attention (`chunked_attention`, `local_chunked_attention`) and
the contiguous decode attention are plain PyTorch: the reference
computes them outside any Pallas kernel.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (Partial, Replicate, Shard,
                                              constrain, is_dtensor,
                                              on_locals)
from repro_torch.kernels.rmsnorm.ops import rms_norm_op

NEG_INF = -1e30


# --------------------------------------------------------------------------
# Norms & activations
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm through `rms_norm_op`. A DTensor x normalizes on each
    rank's own rows (the op on its local tensor: the kernel on the
    card), its last dim whole on every rank, partial sums reduced
    first. The replicated scale's
    gradient is then each rank's sum over its own rows: a partial sum
    over every mesh dim that splits x. A DTensor split over its last dim
    (k's head_dim where the kv heads do not divide the model axis) has
    no per-rank norm and raises, but for the dry-run's meta DTensors,
    which trace the plain version through DTensor's propagation."""
    if not is_dtensor(x):
        return rms_norm_op(x, scale, eps)
    pl = tuple(x.placements)
    if any(isinstance(p, Shard) and p.dim == x.dim() - 1 for p in pl):
        if x.device.type == "meta":
            return rms_norm_op(x, scale, eps)
        raise ValueError(f"an RMSNorm over a dim split as {pl}")
    x_pl = tuple(p if isinstance(p, Shard) else Replicate() for p in pl)
    whole = (Replicate(),) * len(pl)
    return on_locals(
        functools.partial(rms_norm_op, eps=eps), (x, scale),
        (x_pl, whole), x_pl,
        in_grad_placements=(x_pl, tuple(
            Partial() if isinstance(p, Shard) else Replicate()
            for p in x_pl)))


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the last dim (used by RWKV6's ln_x): statistics in
    f32 with the biased variance, `* scale + bias` in f32, cast back."""
    dtype = x.dtype
    *lead, d = x.shape
    xg = x.float().reshape(*lead, num_groups, d // num_groups)
    mean = xg.mean(dim=-1, keepdim=True)
    var = xg.var(dim=-1, keepdim=True, correction=0)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    return (xg.reshape(*lead, d) * scale + bias).to(dtype)


def activate(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return F.silu(x)
    if act == "gelu":
        return F.gelu(x, approximate="tanh")
    if act == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown activation {act!r}")


def soft_cap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-style logit soft cap: cap * tanh(x / cap)."""
    if not cap:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


# --------------------------------------------------------------------------
# Position embeddings
# --------------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (...,) int -> (cos, sin) of shape (..., head_dim//2)."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    # a Python scalar base: f32 pow on the device, no host-to-device copy
    freqs = theta ** exps
    ang = positions.float()[..., None] * freqs                 # (..., half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, N, D); cos/sin: (S, D//2) or broadcastable (B, S, D//2)."""
    dtype = x.dtype
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    while cos.dim() < x1.dim():  # (S, half) -> (1, S, 1, half)
        cos, sin = cos[None], sin[None]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(dtype)


def rope_for_seq(x: torch.Tensor, positions: torch.Tensor,
                 theta: float) -> torch.Tensor:
    """Apply RoPE to (B, S, N, D) given positions (S,) or (B, S)."""
    cos, sin = rope_tables(positions, x.shape[-1], theta)
    if cos.dim() == 2:           # (S, half) -> (1, S, 1, half)
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:                        # (B, S, half) -> (B, S, 1, half)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    dtype = x.dtype
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)


def sinusoidal_pos_embed(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """(S,) -> (S, dim) classic transformer sinusoidal embedding."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------

def expand_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, K, D) -> (B, S, H, D) by repeating each kv head H/K times.
    A DTensor repeats the kv heads of each shard (its kv heads split
    evenly, or whole): DTensor's own repeat is a view it refuses over a
    sharded dim."""
    K = k.shape[2]
    if K == num_heads:
        return k
    if is_dtensor(k):
        pl = tuple(k.placements)
        return on_locals(functools.partial(
            torch.repeat_interleave, repeats=num_heads // K, dim=2),
            (k,), (pl,), pl)
    return torch.repeat_interleave(k, num_heads // K, dim=2)


def _block_mask(qpos, kpos, *, causal: bool, window: Optional[int],
                kv_len):
    """qpos: (bq,), kpos: (bk,) -> bool (bq, bk). True = attend."""
    m = (kpos[None, :] < kv_len).expand(qpos.shape[0], kpos.shape[0])
    if causal:
        m = m & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        m = m & (kpos[None, :] > qpos[:, None] - window)
    return m


def _scores(qi, kj, scale):
    """(B, bq, H, D) x (B, bk, H, D) -> f32 (B, H, bq, bk), the operands
    widened to f32 first (the reference's preferred_element_type)."""
    return torch.einsum("bqhd,bkhd->bhqk", qi.float(), kj.float()) * scale


def _pv(p, vj):
    """p (B, H, bq, bk) f32 cast to v's dtype, times v, summed in f32."""
    return torch.einsum("bhqk,bkhd->bhqd", p.to(vj.dtype).float(),
                        vj.float())


def _pad_seq(x, n):
    return F.pad(x, (0, 0, 0, 0, 0, n)) if n else x


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      q_start=0, kv_len=None,
                      block_q: int = 512, block_k: int = 512,
                      impl: str = "masked") -> torch.Tensor:
    """Flash-style chunked attention with online softmax.

    q: (B, Sq, H, D); k, v: (B, Sk, H, D) (kv already expanded to H heads).
    Never materializes the (Sq, Sk) score matrix; peak score memory is
    (B, H, block_q, block_k).

    impl:
      "masked" — visit all (q-block, kv-block) pairs, mask invalid ones.
      "tri"    — visit only lower-triangle block pairs (causal, no
                 window).
    """
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    kv_len = Sk if kv_len is None else kv_len
    scale = 1.0 / math.sqrt(D)
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    nq, nk = -(-Sq // bq), -(-Sk // bk)
    q = _pad_seq(q, nq * bq - Sq)
    k = _pad_seq(k, nk * bk - Sk)
    v = _pad_seq(v, nk * bk - Sk)
    dev = q.device
    tri = impl == "tri" and causal and window is None
    off = int(q_start) // bk if tri else 0
    outs = []
    for i in range(nq):
        qi = q[:, i * bq:(i + 1) * bq]
        qpos = q_start + i * bq + torch.arange(bq, device=dev)
        m = torch.full((B, H, bq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, bq, D), dtype=torch.float32, device=dev)
        last = min(nk, i * bq // bk + off + 1) if tri else nk
        for j in range(last):
            kj = k[:, j * bk:(j + 1) * bk]
            vj = v[:, j * bk:(j + 1) * bk]
            s = _scores(qi, kj, scale)
            kpos = j * bk + torch.arange(bk, device=dev)
            mask = _block_mask(qpos, kpos, causal=causal, window=window,
                               kv_len=kv_len)
            s = torch.where(mask[None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + _pv(p, vj)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.to(q.dtype).transpose(1, 2))      # (B, bq, H, D)
    return torch.cat(outs, dim=1)[:, :Sq]


def local_chunked_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, window: int, q_start=0,
                            kv_len=None, block_q: int = 512) -> torch.Tensor:
    """Sliding-window attention that only touches the window: each q
    block reads a `window + block_q` span of kv."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    kv_len = Sk if kv_len is None else kv_len
    scale = 1.0 / math.sqrt(D)
    bq = min(block_q, Sq)
    nq = -(-Sq // bq)
    q = _pad_seq(q, nq * bq - Sq)
    span = window + bq
    # pad kv in front so every slice start is valid
    kpad = F.pad(k, (0, 0, 0, 0, window, 0))
    vpad = F.pad(v, (0, 0, 0, 0, window, 0))
    dev = q.device
    outs = []
    for i in range(nq):
        qi = q[:, i * bq:(i + 1) * bq]
        p0 = q_start + i * bq                     # first q position
        start = min(max(p0, 0), Sk + window - span)
        kj = kpad[:, start:start + span]
        vj = vpad[:, start:start + span]
        kpos = start + torch.arange(span, device=dev) - window
        qpos = p0 + torch.arange(bq, device=dev)
        s = _scores(qi, kj, scale)
        mask = ((kpos[None, :] <= qpos[:, None])
                & (kpos[None, :] > qpos[:, None] - window)
                & (kpos[None, :] >= 0) & (kpos[None, :] < kv_len))
        s = torch.where(mask[None, None], s, NEG_INF)
        pr = torch.softmax(s, dim=-1)
        outs.append(_pv(pr, vj).transpose(1, 2).to(q.dtype))
    return torch.cat(outs, dim=1)[:, :Sq]


def _len_mask(S: int, cache_len, window: Optional[int], device):
    pos = torch.arange(S, device=device)
    clen = torch.as_tensor(cache_len, device=device).reshape(-1, 1)
    mask = pos[None, :] < clen
    if window is not None:
        mask = mask & (pos[None, :] > clen - 1 - window)
    return mask                                          # (B|1, S)


def decode_attention_grouped(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, cache_len, *,
                             window: Optional[int] = None) -> torch.Tensor:
    """GQA decode attention WITHOUT expanding kv to H heads.

    q: (B, 1, H, D); k_cache/v_cache: (B, S, K, D) with H % K == 0.
    Returns (B, 1, H, D). The plain path of decode: the paged kernel
    computes the same function without a logically ordered cache.
    """
    B, _, H, D = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    q5 = q.reshape(B, 1, K, G, D)
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bqkgd,btkd->bkgqt", q5.float(),
                     k_cache.float()) * scale
    mask = _len_mask(S, cache_len, window, q.device)
    s = torch.where(mask[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqt,btkd->bqkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """Single-position attention against a cache.

    q: (B, 1, H, D); k_cache/v_cache: (B, S, H, D) (expanded heads).
    cache_len: number of valid cache positions (new token already written).
    """
    B, _, H, D = q.shape
    S = k_cache.shape[1]
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_cache.float()) * scale
    mask = _len_mask(S, cache_len, window, q.device)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.to(q.dtype)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def mlp_glu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor, act: str, *, cols=torch.matmul,
            rows=torch.matmul) -> torch.Tensor:
    """`cols` and `rows` multiply by the column- and row-split weights
    (a model's shard-local products for DTensors)."""
    h = activate(cols(x, w_gate), act) * cols(x, w_up)
    return rows(h, w_down)


def mlp_classic(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                act: str) -> torch.Tensor:
    return activate(x @ w_up, act) @ w_down


# --------------------------------------------------------------------------
# Logits
# --------------------------------------------------------------------------

def mask_pad_logits(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Mask build-time vocab padding (configs.base.padded_vocab) to -inf
    so softmax/argmax semantics match the unpadded vocabulary."""
    if logits.shape[-1] == vocab_size:
        return logits
    idx = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(idx < vocab_size, logits,
                       torch.tensor(NEG_INF, dtype=logits.dtype,
                                    device=logits.device))


# --------------------------------------------------------------------------
# Loss
# --------------------------------------------------------------------------

def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          z_loss: float = 0.0) -> torch.Tensor:
    """logits: (..., V), labels: (...). Mean token loss in f32.

    The log-sum-exp is the reference's (a max held out of the gradient,
    then log of the summed exponentials). The gold logit is gathered with
    `take_along_dim`; the reference picks it with an iota mask, which
    keeps a vocab-sharded reduction local, and on one device would build
    an index tensor the size of the logits for the same number. A
    DTensor (the dry-run) takes the reference's mask: DTensor cannot
    reduce a gather from vocab-sharded logits."""
    logits = logits.float()
    m = logits.amax(dim=-1, keepdim=True).detach()
    if is_dtensor(logits):
        # each vocab shard's sums reduced over the rows' own layout
        rows = ("batch",) + (None,) * (logits.dim() - 2)
        m = constrain(m, rows + (None,))
        lse = m[..., 0] + torch.log(constrain(
            torch.exp(logits - m).sum(dim=-1), rows))
        iota = torch.arange(logits.shape[-1], device=logits.device)
        gold = constrain(torch.where(iota == labels.long()[..., None],
                                     logits, 0.0).sum(dim=-1), rows)
    else:
        lse = m[..., 0] + torch.log(torch.exp(logits - m).sum(dim=-1))
        gold = torch.take_along_dim(logits, labels.long()[..., None],
                                    dim=-1)[..., 0]
    loss = lse - gold
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    if mask is not None:
        loss = loss * mask
        return loss.sum() / torch.clamp(mask.sum(), min=1.0)
    return loss.mean()
