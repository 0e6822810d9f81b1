"""Uniform model API: `build_model(cfg)` returns a `Model` whose methods
take and return plain dicts of tensors, so the serving layer never
branches on family. Every family is ported: dense, moe, vlm and audio
(`models/transformer.py`), ssm (`models/rwkv6.py`) and hybrid
(`models/rglru.py`), training loss included.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import rglru, rwkv6, transformer
from repro_torch.models.transformer import CacheSpec


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init_params: Callable[[torch.Generator], Dict[str, torch.Tensor]]
    abstract_params: Callable[[], Dict[str, torch.Tensor]]
    logical_axes: Callable[[], Dict[str, tuple]]
    loss_fn: Callable[..., Any]          # (params, batch) -> (loss, metrics)
    forward: Callable[..., Any]          # (params, batch) -> (logits, aux)
    prefill: Callable[..., Any]          # (params, batch) -> (logits, cache)
    # (params, batch, cache) -> (logits, cache)
    decode_step: Callable[..., Any]
    init_cache: Callable[..., Dict]      # (batch_size, max_len) -> cache
    # (batch_size, max_len) -> the cache as meta tensors (no memory)
    abstract_cache: Callable[..., Dict]
    cache_logical_axes: Callable[..., Dict]   # (max_len) -> axes tree

    @property
    def name(self) -> str:
        return self.cfg.name

    def param_count(self, params: Optional[Dict] = None) -> int:
        tree = params if params is not None else self.abstract_params()
        return sum(int(p.numel()) for p in tree.values())


def build_model(cfg: ModelConfig, *, kv_layout: str = "paged",
                page_size: int = 256, attn_impl: str = "masked",
                wkv_impl: str = "chunked") -> Model:
    if cfg.family == "ssm":
        return Model(
            cfg=cfg,
            init_params=lambda gen: rwkv6.init_params(cfg, gen),
            abstract_params=lambda: rwkv6.abstract_params(cfg),
            logical_axes=lambda: rwkv6.logical_axes(cfg),
            loss_fn=lambda p, b: rwkv6.loss_fn(cfg, p, b, wkv_impl=wkv_impl),
            forward=lambda p, b: rwkv6.forward(cfg, p, b, wkv_impl=wkv_impl),
            prefill=lambda p, b, max_len=None: rwkv6.prefill(
                cfg, p, b, wkv_impl=wkv_impl),
            decode_step=lambda p, b, c: rwkv6.decode_step(cfg, p, b, c),
            init_cache=lambda bs, max_len, device="cuda": rwkv6.init_state(
                cfg, bs, device=device),
            abstract_cache=lambda bs, max_len: rwkv6.abstract_state(cfg, bs),
            cache_logical_axes=lambda max_len=0: rwkv6.state_logical_axes(
                cfg),
        )
    if cfg.family == "hybrid":
        return Model(
            cfg=cfg,
            init_params=lambda gen: rglru.init_params(cfg, gen),
            abstract_params=lambda: rglru.abstract_params(cfg),
            logical_axes=lambda: rglru.logical_axes(cfg),
            loss_fn=lambda p, b: rglru.loss_fn(cfg, p, b),
            forward=lambda p, b: rglru.forward(cfg, p, b),
            prefill=lambda p, b, max_len=None: rglru.prefill(cfg, p, b),
            decode_step=lambda p, b, c: rglru.decode_step(cfg, p, b, c),
            init_cache=lambda bs, max_len, device="cuda": rglru.init_state(
                cfg, bs, device=device),
            abstract_cache=lambda bs, max_len: rglru.abstract_state(cfg, bs),
            cache_logical_axes=lambda max_len=0: rglru.state_logical_axes(
                cfg),
        )
    # dense / moe / vlm / audio -> transformer

    def spec(max_len):
        return CacheSpec(layout=kv_layout, max_len=max_len,
                         page_size=min(page_size, max_len))

    def prefill(p, b, max_len=None):
        n = max_len if max_len else b["tokens"].shape[1]
        return transformer.prefill(cfg, p, b, spec=spec(n),
                                   attn_impl=attn_impl)

    return Model(
        cfg=cfg,
        init_params=lambda gen: transformer.init_params(cfg, gen),
        abstract_params=lambda: transformer.abstract_params(cfg),
        logical_axes=lambda: transformer.logical_axes(cfg),
        loss_fn=lambda p, b: transformer.loss_fn(cfg, p, b,
                                                 attn_impl=attn_impl),
        forward=lambda p, b: transformer.forward(cfg, p, b,
                                                 attn_impl=attn_impl),
        prefill=prefill,
        decode_step=lambda p, b, c: transformer.decode_step(
            cfg, p, b, c, spec=_infer_spec(cfg, c, kv_layout)),
        init_cache=lambda bs, max_len, device="cuda": transformer.init_cache(
            cfg, bs, spec(max_len), device=device),
        abstract_cache=lambda bs, max_len: transformer.abstract_cache(
            cfg, bs, spec(max_len)),
        cache_logical_axes=lambda max_len: transformer.cache_logical_axes(
            cfg, spec(max_len)),
    )


def _infer_spec(cfg: ModelConfig, cache: Dict, kv_layout: str) -> CacheSpec:
    k = cache["k"]
    if "block_table" in cache:
        _, _, P, ps, _, _ = k.shape
        return CacheSpec(layout="paged", max_len=P * ps, page_size=ps)
    return CacheSpec(layout="contiguous", max_len=k.shape[2])
