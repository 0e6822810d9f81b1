"""The yardstick's arithmetic: the published peaks of one NVIDIA H100
(SXM, dense, NVIDIA's data sheet, at its 700 W limit) and the bytes and
operations that a kernel's call or a model's step needs, counted from
shapes. Each input byte is counted read once and each output byte
written once."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12


def bound_s(nbytes: float, flops: float = 0.0,
            flops_per_s: float = F32_FLOPS_PER_S) -> float:
    """Least time for work of `nbytes` and `flops`: the larger bound."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flops_per_s)


def gf256_bytes(m: int, k: int, L: int) -> int:
    """One (m, k) x (k, L) GF(256) product: k input rows and the matrix
    read, m output rows written."""
    return (k + m) * L + m * k


def rs_chunk_len(nbytes: int, k: int) -> int:
    """A payload's chunk length: 4-byte length header, k rows."""
    return -(-(nbytes + 4) // k)


def rmsnorm_bytes(rows: int, d: int, elem: int = 2) -> int:
    """x read, out written, the scale read."""
    return 2 * rows * d * elem + d * elem


def rmsnorm_flops(rows: int, d: int) -> int:
    return 3 * rows * d


def paged_attn_bytes(B: int, H: int, K: int, hd: int, length: int,
                     pages: int, elem: int = 2) -> int:
    """One decode call: q read and the output written, `length` keys and
    values of K heads per row read, the block table and lengths read."""
    return 2 * B * H * hd * elem + 2 * B * length * K * hd * elem \
        + B * pages * 4 + B * 4


def paged_attn_flops(B: int, H: int, hd: int, length: int) -> int:
    return 4 * B * H * hd * length


def moe_token_flops(z: dict) -> int:
    """Weight-product flops of one token through one layer, the experts
    it is routed to only: q/k/v/o, router, top_k experts, shared
    expert and its gate."""
    d, H, K, hd = z["d"], z["H"], z["K"], z["hd"]
    attn = 2 * d * (H * hd + 2 * K * hd) + 2 * H * hd * d
    return attn + 2 * d * z["E"] + z["top_k"] * 6 * d * z["f"] \
        + 6 * d * z["fs"] + 2 * d


def moe_prefill_flops(z: dict, B: int, S: int) -> int:
    """A prefill of B prompts of S tokens: every token through every
    layer, causal attention over S(S+1)/2 pairs, the head at the last
    position."""
    per_layer = B * S * moe_token_flops(z) \
        + 4 * B * z["H"] * z["hd"] * S * (S + 1) // 2
    return z["L"] * per_layer + 2 * B * z["d"] * z["V"]


def moe_decode_flops(z: dict, B: int, length: int) -> int:
    """One decode step of B sequences at `length` positions (the new one
    included)."""
    per_layer = B * moe_token_flops(z) + 4 * B * z["H"] * z["hd"] * length
    return z["L"] * per_layer + 2 * B * z["d"] * z["V"]
