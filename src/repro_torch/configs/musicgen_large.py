"""musicgen-large [audio] — 48L d_model=2048 32H (kv=32, MHA) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

Backbone only: the EnCodec frontend is a STUB. Four codebooks are summed at
the input (input_specs() provides the precomputed frame embeddings) and four
parallel LM heads (one per codebook) project the output, per the paper's
delay interleaving pattern. Classic 2-matrix GELU MLP (no GLU).
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    act="gelu",
    mlp_glu=False,
    frontend=FrontendConfig(kind="audio", num_codebooks=4),
    source="arXiv:2306.05284 (MusicGen-large)",
)
