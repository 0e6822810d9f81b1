"""Config schema: every architecture is a `ModelConfig`, input shapes
are `ShapeConfig`s. Plain dataclasses with no framework code, carried
over from the JAX package unchanged so both packages read the same
values. Tests use `reduced()` variants; the serving path runs the
published widths on the card.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""
    num_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden size
    num_shared_experts: int = 0   # always-active shared experts
    d_shared: int = 0             # hidden size of the (merged) shared expert
    router_aux_coef: float = 0.001
    capacity_factor: float = 1.25
    renorm_topk: bool = True
    # "expert": shard the expert dim over the model axis (requires
    # num_experts % tp == 0); "ffn": shard each expert's hidden dim instead.
    expert_sharding: str = "expert"

    def __post_init__(self):
        if self.expert_sharding not in ("expert", "ffn"):
            raise ValueError(f"bad expert_sharding {self.expert_sharding}")


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV6 (Finch) time-mix configuration."""
    head_size: int = 64
    # low-rank sizes for the data-dependent decay / token-shift mixers
    decay_lora: int = 64
    mix_lora: int = 32
    gate_lora: int = 64


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma (Griffin) recurrent-block configuration."""
    lru_width: int = 2560
    conv_width: int = 4
    block_pattern: Tuple[str, ...] = ("recurrent", "recurrent", "attention")
    attention_window: int = 2048


@dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend STUB (vlm/audio): input_specs() supplies
    precomputed frame/patch embeddings; the frontend itself is not built."""
    kind: str = "none"            # none | vlm | audio
    num_codebooks: int = 1        # audio: EnCodec codebooks (parallel heads)
    patch_embed_dim: int = 0      # vlm: dimension of incoming patch embeds
    num_prefix_embeds: int = 0    # vlm: patch embeds prepended to the text


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    act: str = "silu"             # silu (swiglu) | gelu (geglu) | relu2
    mlp_glu: bool = True          # False → classic 2-matrix MLP (e.g. musicgen)
    logit_softcap: float = 0.0    # Gemma-style tanh logit cap (0 = off)
    scale_embed: bool = False     # multiply embeddings by sqrt(d_model)
    moe: Optional[MoEConfig] = None
    rwkv: Optional[RWKVConfig] = None
    rglru: Optional[RGLRUConfig] = None
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    dtype: str = "bfloat16"
    # set False for archs whose attention is sub-quadratic / absent
    full_attention: bool = True
    source: str = ""              # provenance tag

    # ---- derived helpers -------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count (matches the built model; see tests)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        emb = V * d
        head = 0 if self.tie_embeddings else V * d
        if self.frontend.kind == "audio" and self.frontend.num_codebooks > 1:
            head *= self.frontend.num_codebooks
        per_layer = 0
        if self.family == "ssm":  # rwkv6
            rw = self.rwkv or RWKVConfig()
            H = d // rw.head_size
            per_layer = (
                5 * d * d                       # r,k,v,g,o (time-mix)
                + 6 * rw.mix_lora * d + rw.mix_lora * 5 + 6 * d  # ddlerp mixers
                + 2 * rw.decay_lora * d + d     # decay lora + base
                + H * rw.head_size              # bonus u
                + 2 * d                         # ln_x scale/bias (groupnorm)
                + d * self.d_ff + self.d_ff * d + d   # channel mix r + kv
                + 2 * d                         # 2 layernorm scales
            )
            return emb + head + L * per_layer + d
        # attention (or hybrid) families
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.qkv_bias:
            attn += self.q_dim + 2 * self.kv_dim
        if self.qk_norm:
            attn += 2 * self.head_dim
        glu = (3 if self.mlp_glu else 2) * d * self.d_ff  # up[, gate], down
        if self.moe is not None:
            m = self.moe
            glu = d * m.num_experts  # router
            glu += m.num_experts * 3 * d * m.d_expert
            if m.num_shared_experts:
                glu += 3 * d * m.d_shared + d  # shared expert + gate
        per_layer = attn + glu + 2 * d  # 2 rmsnorm scales
        if self.family == "hybrid":
            rg = self.rglru or RGLRUConfig()
            W = rg.lru_width
            rec = (
                2 * d * W + W * d               # in x2 (x & gate), out
                + rg.conv_width * W             # conv1d
                + 2 * W * W // 1                # rg-lru input & rec gates (block-diag approx: W*W/heads*heads) — see models/rglru.py
                + 2 * W                         # a_param, gate biases
            )
            n_attn = sum(1 for b in rg.block_pattern if b == "attention")
            n_rec = len(rg.block_pattern) - n_attn
            frac_attn = n_attn / len(rg.block_pattern)
            per_layer = (frac_attn * (attn + 2 * d)
                         + (1 - frac_attn) * (rec + 2 * d)
                         + 3 * d * self.d_ff + d)  # MLP shared by both + final norm share
            return int(emb + head + L * per_layer + d)
        return emb + head + L * per_layer + d  # final norm


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode
    # decode shapes: cache of seq_len tokens, one new token generated
    num_microbatches: int = 1     # train only: gradient accumulation


# The four assigned LM shapes (identical for every arch; applicability
# filtering happens in launch/dryrun.py per DESIGN.md §5).
TRAIN_4K = ShapeConfig("train_4k", seq_len=4096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32768, global_batch=128, kind="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524288, global_batch=1, kind="decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 64,
            heads: int = 4, kv_heads: Optional[int] = None, d_ff: int = 128,
            vocab: int = 256) -> ModelConfig:
    """Smoke-test variant of a config: same family/features, tiny dims."""
    kv = kv_heads if kv_heads is not None else max(1, heads // max(1, cfg.num_heads // max(cfg.num_kv_heads, 1)))
    kv = max(1, min(kv, heads))
    head_dim = d_model // heads
    kw = dict(
        num_layers=layers, d_model=d_model, num_heads=heads,
        num_kv_heads=kv, head_dim=head_dim, d_ff=d_ff, vocab_size=vocab,
        name=cfg.name + "-reduced",
    )
    if cfg.moe is not None:
        kw["moe"] = replace(cfg.moe, num_experts=8,
                            top_k=min(cfg.moe.top_k, 4), d_expert=32,
                            d_shared=64 if cfg.moe.num_shared_experts else 0)
    if cfg.rwkv is not None:
        kw["rwkv"] = replace(cfg.rwkv, head_size=16, decay_lora=8, mix_lora=8)
    if cfg.rglru is not None:
        kw["rglru"] = replace(cfg.rglru, lru_width=d_model, conv_width=4,
                              attention_window=32)
    if cfg.frontend.kind == "vlm":
        kw["frontend"] = replace(cfg.frontend, patch_embed_dim=d_model,
                                 num_prefix_embeds=4)
    return replace(cfg, **kw)


def shapes_for(cfg: ModelConfig) -> Sequence[ShapeConfig]:
    """Applicable shapes for an arch (DESIGN.md §5): long_500k only for
    sub-quadratic families."""
    if cfg.full_attention:
        return (TRAIN_4K, PREFILL_32K, DECODE_32K)
    return ALL_SHAPES


def to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def padded_vocab(vocab_size: int, multiple: int = 128) -> int:
    """Build-time vocab padding (MaxText-style): embedding/head tables are
    padded to a lane- and TP-friendly multiple; pad logits are masked to
    -inf so semantics are unchanged (tests assert this)."""
    return -(-vocab_size // multiple) * multiple
