"""Models on torch tensors: shared layers, the decoder-only transformer
(dense, MoE, VLM and audio), RWKV6, RG-LRU, the registry, and the weight
converter from the JAX package's layout."""
from repro_torch.models.registry import Model, build_model  # noqa: F401
