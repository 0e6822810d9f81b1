"""Input specs (meta-tensor stand-ins) for every (arch x shape) cell.

The JAX package's `launch/specs.py` on torch: meta tensors take the
place of `ShapeDtypeStruct`s, so a spec has a shape and a dtype and no
memory, at any size (`long_500k` included). Each spec comes with a
logical-axis tree so launch code derives input shardings from the same
rules as the params.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.transformer import DTYPES

Tree = Any

# Per-arch gradient-accumulation microbatch counts for train_4k, sized so
# one microbatch's activations fit next to the ZeRO-sharded state (the
# reference's numbers).
TRAIN_MICROBATCHES: Dict[str, int] = {
    "qwen1.5-0.5b": 1,
    "qwen3-1.7b": 2,
    "qwen3-14b": 8,
    "qwen1.5-110b": 16,
    "internvl2-1b": 1,
    "rwkv6-3b": 4,
    "recurrentgemma-2b": 4,
    "qwen2-moe-a2.7b": 4,
    "granite-moe-1b-a400m": 2,
    "musicgen-large": 4,
}


def num_microbatches(cfg: ModelConfig, shape: ShapeConfig,
                     dp: int = 1) -> int:
    """Gradient-accumulation depth, clamped so each microbatch's batch dim
    stays divisible by the data-parallel degree."""
    if shape.kind != "train":
        return 1
    n = TRAIN_MICROBATCHES.get(cfg.name, shape.num_microbatches)
    n = max(1, min(n, shape.global_batch // max(dp, 1)))
    while n > 1 and (shape.global_batch % n
                     or (shape.global_batch // n) % max(dp, 1)):
        n -= 1
    return n


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig, dp: int = 1
                      ) -> Tuple[Tree, Tree]:
    """Returns (specs, logical_axes). Leading dim = microbatches, second
    dim = per-microbatch global batch (sharded over dp)."""
    n = num_microbatches(cfg, shape, dp)
    B = shape.global_batch // n
    S = shape.seq_len
    i32, dt = torch.int32, DTYPES[cfg.dtype]
    if cfg.frontend.kind == "audio":
        C = cfg.frontend.num_codebooks
        specs = {"frame_embeds": _meta((n, B, S, cfg.d_model), dt),
                 "labels": _meta((n, B, S, C), i32)}
        axes = {"frame_embeds": (None, "batch", None, None),
                "labels": (None, "batch", None, None)}
    elif cfg.frontend.kind == "vlm":
        Pn = cfg.frontend.num_prefix_embeds
        St = S - Pn
        specs = {"tokens": _meta((n, B, St), i32),
                 "patch_embeds": _meta(
                     (n, B, Pn, cfg.frontend.patch_embed_dim), dt),
                 "labels": _meta((n, B, St), i32)}
        axes = {"tokens": (None, "batch", None),
                "patch_embeds": (None, "batch", None, None),
                "labels": (None, "batch", None)}
    else:
        specs = {"tokens": _meta((n, B, S), i32),
                 "labels": _meta((n, B, S), i32)}
        axes = {"tokens": (None, "batch", None),
                "labels": (None, "batch", None)}
    return specs, axes


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig
                        ) -> Tuple[Tree, Tree]:
    B, S = shape.global_batch, shape.seq_len
    i32, dt = torch.int32, DTYPES[cfg.dtype]
    if cfg.frontend.kind == "audio":
        return ({"frame_embeds": _meta((B, S, cfg.d_model), dt)},
                {"frame_embeds": ("batch", None, None)})
    if cfg.frontend.kind == "vlm":
        Pn = cfg.frontend.num_prefix_embeds
        return ({"tokens": _meta((B, S - Pn), i32),
                 "patch_embeds": _meta(
                     (B, Pn, cfg.frontend.patch_embed_dim), dt)},
                {"tokens": ("batch", None),
                 "patch_embeds": ("batch", None, None)})
    return ({"tokens": _meta((B, S), i32)}, {"tokens": ("batch", None)})


def decode_batch_specs(cfg: ModelConfig, shape: ShapeConfig
                       ) -> Tuple[Tree, Tree]:
    B = shape.global_batch
    i32, dt = torch.int32, DTYPES[cfg.dtype]
    if cfg.frontend.kind == "audio":
        return ({"frame_embed": _meta((B, 1, cfg.d_model), dt)},
                {"frame_embed": ("batch", None, None)})
    return ({"token": _meta((B, 1), i32)}, {"token": ("batch", None)})


def input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """Meta stand-ins for every model input of this cell (training batch,
    prefill prompt, or decode batch), with their logical axes."""
    if shape.kind == "train":
        return train_batch_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_batch_specs(cfg, shape)
    return decode_batch_specs(cfg, shape)
