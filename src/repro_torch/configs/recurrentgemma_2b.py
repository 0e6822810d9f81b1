"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (GQA kv=1, MQA)
d_ff=7680 vocab=256000 — RG-LRU + local attention, 1 attention : 2 recurrent.
[arXiv:2402.19427; hf]

Sub-quadratic: local attention window 2048 + O(1) RG-LRU state, so
long_500k runs for this arch.
"""
from repro_torch.configs.base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    act="gelu",               # GeGLU MLP
    full_attention=False,
    tie_embeddings=True,
    logit_softcap=30.0,
    scale_embed=True,
    rglru=RGLRUConfig(lru_width=2560, conv_width=4,
                      block_pattern=("recurrent", "recurrent", "attention"),
                      attention_window=2048),
    source="arXiv:2402.19427 (RecurrentGemma-2B / Griffin)",
)
