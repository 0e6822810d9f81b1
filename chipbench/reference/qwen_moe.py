"""Plain PyTorch reference of the Qwen1.5-MoE-A2.7B decoder (the
Qwen2-MoE architecture of hf:Qwen/Qwen1.5-MoE-A2.7B), frozen here, and
the benchmark's seeded weights for it.

The forward is teacher-forced and computed one layer at a time in
float32 (TF32 off), so that it fits beside the served model's bf16
weights: each layer's weights are upcast, used and dropped. Per layer:
RMSNorm, q/k/v projections with biases, rotary embedding (rotate-half,
base `rope_theta`), causal softmax attention over 16 heads of 128,
output projection, RMSNorm, then the sparse MoE block: softmax router
over 60 experts, the top 4 gates used as they are (`norm_topk_prob`
false), SwiGLU experts of width 1408, plus a SwiGLU shared expert of
width 5632 scaled by sigmoid(x . shared_gate). Final RMSNorm and an
untied LM head.

One departure from the Hugging Face model, which is part of the
configuration served: expert capacity. Each dispatch group (a
sequence's prompt in the prefill; each decoded token on its own) keeps,
per expert, only its first C (token, expert) pairs in token order, C =
max(4, 4 * ceil(ceil(n * top_k * capacity_factor / E) / 4)) for a group
of n tokens; a dropped pair adds nothing.

`precision="fp8"` is the control: every product with a weight takes
its operands rounded to float8 e4m3 (per row of the activations, per
output column of the weight), as a W8A8 path would.

Nothing here imports the program under test.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

# layer leaves, in the order the weights are carved from one buffer
LAYER_KEYS = ("bk", "bq", "bv", "ln1", "ln2", "router", "shared_gate",
              "we_down", "we_gate", "we_up", "wk", "wo", "wq", "ws_down",
              "ws_gate", "ws_up", "wv")
FP8_MAX = 448.0


def dims(c: dict) -> dict:
    d = c["hidden_size"]
    H = c["num_attention_heads"]
    return dict(d=d, H=H, K=c["num_key_value_heads"], hd=d // H,
                L=c["num_hidden_layers"], V=c["vocab_size"],
                E=c["num_experts"], top_k=c["num_experts_per_tok"],
                f=c["moe_intermediate_size"],
                fs=c["shared_expert_intermediate_size"])


def param_shapes(c: dict) -> Dict[str, Tuple[int, ...]]:
    """Leaf name -> shape; layer leaves carry a leading layer dim."""
    z = dims(c)
    d, H, K, hd, L, V = z["d"], z["H"], z["K"], z["hd"], z["L"], z["V"]
    E, f, fs = z["E"], z["f"], z["fs"]
    lyr = {"ln1": (d,), "ln2": (d,), "wq": (d, H, hd), "wk": (d, K, hd),
           "wv": (d, K, hd), "wo": (H, hd, d), "bq": (H, hd),
           "bk": (K, hd), "bv": (K, hd), "router": (d, E),
           "we_gate": (E, d, f), "we_up": (E, d, f), "we_down": (E, f, d),
           "ws_gate": (d, fs), "ws_up": (d, fs), "ws_down": (fs, d),
           "shared_gate": (d,)}
    out = {"embed": (V, d), "head": (V, d), "final_norm": (d,)}
    out.update({f"layers/{k}": (L,) + s for k, s in lyr.items()})
    return out


def _fan_in(name: str, shape: Tuple[int, ...]) -> int:
    """Inputs summed by one output of a matrix leaf (shapes without the
    layer dim: wq (d, H, hd), wo (H, hd, d), head (V, d), shared_gate
    (d,), the rest (..., in, out))."""
    leaf = name.split("/")[-1]
    if leaf == "embed":
        return 1
    if leaf == "wo":
        return shape[-3] * shape[-2]
    if leaf in ("wq", "wk", "wv"):
        return shape[-3]
    if leaf in ("head", "shared_gate"):
        return shape[-1]
    return shape[-2]


def make_weights(c: dict, seed: int, device, dtype=torch.bfloat16,
                 chunk: int = 1 << 30) -> Dict[str, torch.Tensor]:
    """The model's weights from `seed`, on `device` in `dtype`: one flat
    buffer of standard normals from a generator on that device (filled
    in calls of `chunk` elements), carved into the leaves in name order
    and scaled in place. Matrices get std 1/sqrt(fan in) (the embedding
    std 1), norm scales 1 + 0.1 n, biases 0.1 n. The same seed gives the
    same weights on the same device."""
    shapes = param_shapes(c)
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    flat = torch.empty(sum(sizes), dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for s in range(0, flat.numel(), chunk):
        flat[s:s + chunk].normal_(generator=gen)
    out, off = {}, 0
    for name, n in zip(names, sizes):
        w = flat[off:off + n].view(shapes[name])
        off += n
        leaf = name.split("/")[-1]
        if "norm" in leaf or leaf in ("ln1", "ln2"):
            w.mul_(0.1).add_(1.0)
        elif leaf in ("bq", "bk", "bv"):
            w.mul_(0.1)
        else:
            w.mul_(1.0 / math.sqrt(_fan_in(name, shapes[name])))
        out[name] = w
    return out


# ---- arithmetic ---------------------------------------------------------

def _q8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """t rounded to float8 e4m3 with one scale per slice along `dim`."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x (..., n) @ w (n, m) in float32, or with fp8 operands."""
    if precision == "fp8":
        x, w = _q8(x, -1), _q8(w, 0)
    return x @ w


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (N, T, heads, hd) at positions 0..T-1, rotate-half form."""
    T, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[None, :, None]
    sin = torch.sin(ang).float()[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def capacity(n: int, top_k: int, E: int, factor: float) -> int:
    c = int(-(-(n * top_k * factor) // E))
    return max(4, -(-c // 4) * 4)


def kept_pairs(expert_ids: torch.Tensor, groups: Sequence[Tuple[int, int]],
               E: int, factor: float) -> torch.Tensor:
    """(T, k) bool: which (token, expert) pairs of one sequence survive
    the capacity of their dispatch group [start, end)."""
    T, k = expert_ids.shape
    keep = torch.zeros((T, k), dtype=torch.bool, device=expert_ids.device)
    for s, e in groups:
        if e - s == 1:
            # one token's k experts are distinct: each pair ranks first
            keep[s] = capacity(1, k, E, factor) >= 1
            continue
        ids = expert_ids[s:e].reshape(-1)
        onehot = F.one_hot(ids, E)
        # rank of each pair among its expert's pairs, in token order
        pos = (onehot.cumsum(0) * onehot).sum(-1) - 1
        keep[s:e] = (pos < capacity(e - s, k, E, factor)).view(e - s, k)
    return keep


def _attention(q, k, v) -> torch.Tensor:
    """Causal softmax attention of one sequence: (T, H, hd) each."""
    T, H, hd = q.shape
    s = torch.einsum("thd,shd->hts", q, k) / math.sqrt(hd)
    mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("hts,shd->thd", torch.softmax(s, dim=-1), v)


def _layer(c: dict, w: Dict[str, torch.Tensor], x: torch.Tensor,
           groups: Sequence[Tuple[int, int]], precision: str,
           drops: Optional[List[int]] = None):
    z = dims(c)
    N, T, d = x.shape
    H, K, hd = z["H"], z["K"], z["hd"]
    eps = c["rms_norm_eps"]
    h = _rms(x, w["ln1"], eps)
    q = _mm(h, w["wq"].reshape(d, H * hd), precision).view(N, T, H, hd) \
        + w["bq"]
    k = _mm(h, w["wk"].reshape(d, K * hd), precision).view(N, T, K, hd) \
        + w["bk"]
    v = _mm(h, w["wv"].reshape(d, K * hd), precision).view(N, T, K, hd) \
        + w["bv"]
    q, k = _rope(q, c["rope_theta"]), _rope(k, c["rope_theta"])
    if K != H:
        k = k.repeat_interleave(H // K, dim=2)
        v = v.repeat_interleave(H // K, dim=2)
    o = torch.stack([_attention(q[n], k[n], v[n]) for n in range(N)])
    x = x + _mm(o.reshape(N, T, H * hd), w["wo"].reshape(H * hd, d),
                precision)
    h = _rms(x, w["ln2"], eps)
    return x + moe_block(c, w, h, groups, precision, drops)


def moe_block(c: dict, w: Dict[str, torch.Tensor], h: torch.Tensor,
              groups: Sequence[Tuple[int, int]], precision: str = "f32",
              drops: Optional[List[int]] = None) -> torch.Tensor:
    """The sparse MoE block of one layer on normed h (N, T, d): routed
    experts over the pairs that survive capacity, plus the gated shared
    expert. `drops`, where given, gains the pairs routed and the pairs
    dropped."""
    z = dims(c)
    N, T, d = h.shape
    E, top_k = z["E"], z["top_k"]
    probs = torch.softmax(_mm(h, w["router"], precision), dim=-1)
    gates, ids = torch.topk(probs, top_k, dim=-1)           # (N, T, k)
    if c["norm_topk_prob"]:
        gates = gates / gates.sum(-1, keepdim=True)
    keep = torch.stack([kept_pairs(ids[n], groups, E,
                                   c["capacity_factor"]) for n in range(N)])
    gates = gates * keep
    if drops is not None:
        drops[0] += keep.numel()
        drops[1] += int((~keep).sum())
    flat_h = h.reshape(N * T, d)
    flat_ids, flat_g = ids.reshape(N * T, top_k), gates.reshape(N * T, top_k)
    moe = torch.zeros_like(flat_h)
    for e in range(E):
        g = (flat_g * (flat_ids == e)).sum(-1)
        rows = torch.nonzero(g, as_tuple=True)[0]
        if rows.numel() == 0:
            continue
        he = flat_h[rows]
        a = F.silu(_mm(he, w["we_gate"][e], precision)) \
            * _mm(he, w["we_up"][e], precision)
        moe.index_add_(0, rows, _mm(a, w["we_down"][e], precision)
                       * g[rows, None])
    a = F.silu(_mm(h, w["ws_gate"], precision)) * _mm(h, w["ws_up"],
                                                       precision)
    shared = _mm(a, w["ws_down"], precision) \
        * torch.sigmoid(_mm(h, w["shared_gate"][:, None], precision))
    return moe.view(N, T, d) + shared


@torch.no_grad()
def logits(c: dict, weights: Dict[str, torch.Tensor], tokens: torch.Tensor,
           prompt_len: int, precision: str = "f32",
           drops: Optional[List[int]] = None) -> torch.Tensor:
    """Teacher-forced logits (N, T - prompt_len + 1, V) in float32 at
    positions prompt_len - 1 .. T - 1 of `tokens` (N, T): the prompt
    followed by the served tokens but the last. The prompt is one
    dispatch group; every later token is a group of its own. `drops`,
    where given ([0, 0]), gains the (token, expert) pairs routed and
    dropped over all layers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    N, T = tokens.shape
    groups: List[Tuple[int, int]] = [(0, prompt_len)] + \
        [(t, t + 1) for t in range(prompt_len, T)]
    x = weights["embed"][tokens.long()].float()
    for i in range(c["num_hidden_layers"]):
        w = {k: weights[f"layers/{k}"][i].float() for k in LAYER_KEYS}
        x = _layer(c, w, x, groups, precision, drops)
        del w
    x = _rms(x[:, prompt_len - 1:], weights["final_norm"].float(),
             c["rms_norm_eps"])
    return _mm(x, weights["head"].float().T, precision)


def served_gaps(ref_logits: torch.Tensor, served: torch.Tensor
                ) -> torch.Tensor:
    """How far each served token's logit lies below the reference's best
    at its position: (N, n) float32, zero where they agree."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, served.long()[..., None])[..., 0]
    return best - got
