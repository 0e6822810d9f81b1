"""internvl2-1b [vlm] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 — InternViT + (Qwen2-0.5B) LM backbone. [arXiv:2404.16821; hf]

Per the assignment, the VLM entry specifies the transformer BACKBONE only;
the InternViT modality frontend is a STUB — input_specs() provides
precomputed patch embeddings prepended to the token stream.
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=True,            # Qwen2-family backbone keeps QKV bias
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    frontend=FrontendConfig(kind="vlm", patch_embed_dim=1024,
                            num_prefix_embeds=256),
    source="arXiv:2404.16821 (InternVL2-1B: InternViT-300M + Qwen2-0.5B)",
)
