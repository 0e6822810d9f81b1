"""Deterministic synthetic token pipeline, family-aware.

The JAX package's `data/pipeline.py`, carried over (numpy only; the
caller moves a batch to its device). Batches have a leading
(num_microbatches, B, S) shape, the layout the train step loops over.
Deterministic in (seed, step) — restart at step k reproduces the same
stream, which the checkpoint/restart tests assert.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


def make_batch(cfg: ModelConfig, shape: ShapeConfig, *, step: int,
               num_microbatches: int = 1, seed: int = 0
               ) -> Dict[str, np.ndarray]:
    """One global training batch for `step` (numpy; the caller moves it
    to its device)."""
    n = num_microbatches
    B = shape.global_batch // n
    S = shape.seq_len
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    if cfg.frontend.kind == "audio":
        C = cfg.frontend.num_codebooks
        return {
            "frame_embeds": rng.standard_normal(
                (n, B, S, cfg.d_model)).astype(np.float32) * 0.02,
            "labels": rng.integers(0, cfg.vocab_size, (n, B, S, C),
                                   dtype=np.int32),
        }
    if cfg.frontend.kind == "vlm":
        Pn = cfg.frontend.num_prefix_embeds
        St = S - Pn
        return {
            "tokens": rng.integers(0, cfg.vocab_size, (n, B, St),
                                   dtype=np.int32),
            "patch_embeds": rng.standard_normal(
                (n, B, Pn, cfg.frontend.patch_embed_dim)
            ).astype(np.float32) * 0.02,
            "labels": rng.integers(0, cfg.vocab_size, (n, B, St),
                                   dtype=np.int32),
        }
    toks = rng.integers(0, cfg.vocab_size, (n, B, S + 1), dtype=np.int32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


class TokenPipeline:
    """Iterator over training batches; stateless given (seed, step)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, *,
                 num_microbatches: int = 1, seed: int = 0,
                 start_step: int = 0):
        self.cfg = cfg
        self.shape = shape
        self.n = num_microbatches
        self.seed = seed
        self.step = start_step

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = make_batch(self.cfg, self.shape, step=self.step,
                       num_microbatches=self.n, seed=self.seed)
        self.step += 1
        return b
