"""rwkv6-3b [ssm] — 32L d_model=2560 (attention-free) d_ff=8960
vocab=65536 — Finch, data-dependent decay. [arXiv:2404.05892; hf]

Attention-free: long_500k runs (O(1) recurrent state). The SMS paged-KV
technique is inapplicable to this family (DESIGN.md §5); the EC-checkpoint
and state-snapshot paths apply instead.
"""
from repro_torch.configs.base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,             # d_model / head_size
    num_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    full_attention=False,
    act="relu2",              # RWKV channel-mix uses squared ReLU
    rwkv=RWKVConfig(head_size=64, decay_lora=64, mix_lora=32),
    source="arXiv:2404.05892 (RWKV-6 Finch 3B)",
)
