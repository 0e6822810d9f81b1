"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60 routed experts top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

The 4 shared experts are merged into one always-active expert of hidden
size 4×1408=5632 (matching the HF shared_expert_intermediate_size).
Expert sharding: 60 % 16 != 0, so the per-expert FFN hidden dim (1408) is
sharded over the model axis instead ("ffn" mode).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,                # routed-expert hidden size
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=60, top_k=4, d_expert=1408,
                  num_shared_experts=4, d_shared=5632,
                  expert_sharding="ffn", renorm_topk=False),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
