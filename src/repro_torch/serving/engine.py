"""Batched serving engine over the SMS-paged KV cache, on torch tensors.

Lockstep continuous batching: a batch of sequences prefills into SMS-
managed pages, decodes greedily, and the GC window handles page
lifecycle — active sequences stay hot, finished sequences' pages cool,
get RELEASED, and their device slots are reused by the next batch; an
evicted sequence can resume via on-demand restore (the paper's
demand-caching path). The two-queue scheme separates short decode steps
from long prefill work so prefill bursts don't convoy decodes.

The engine runs on the card by default (`device="cuda"`, which raises
where CUDA is absent) and eagerly: each decode step writes the new
token's k/v into the pools in place and, on the card, reads them back
through the paged decode-attention kernel. Everything stays on
PyTorch's default stream.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.clock import Clock
from repro_torch.core.gc_window import GCConfig
from repro_torch.core.payload import require_device
from repro_torch.models.registry import Model, build_model
from repro_torch.serving.kv_cache import SMSPagedKV


@dataclass
class ServeConfig:
    batch_slots: int = 4
    max_len: int = 256
    page_size: int = 32
    gc_interval: float = 60.0
    active_intervals: int = 2
    degraded_intervals: int = 2
    small_queue_max_tokens: int = 8     # decode batch = small queue


@dataclass
class ServeStats:
    prefills: int = 0
    decode_steps: int = 0
    tokens_generated: int = 0
    prefill_seconds: float = 0.0
    decode_seconds: float = 0.0
    # wall time of each decode step, up to its tokens reaching the host
    step_seconds: List[float] = field(default_factory=list)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, scfg: ServeConfig = ServeConfig(),
                 *, params=None, seed: int = 0,
                 clock: Optional[Clock] = None, device="cuda", store=None):
        self.cfg = cfg
        self.scfg = scfg
        self.device = require_device(device)
        self.clock = clock or Clock()
        self.model: Model = build_model(cfg, kv_layout="paged",
                                        page_size=scfg.page_size)
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = self.model.init_params(gen)
        self.params = params
        # `store` (optional) is SMSPagedKV's eviction tier
        self.kv = SMSPagedKV(
            cfg, batch_slots=scfg.batch_slots, max_len=scfg.max_len,
            page_size=scfg.page_size, clock=self.clock, store=store,
            device=self.device,
            gc=GCConfig(gc_interval=scfg.gc_interval,
                        active_intervals=scfg.active_intervals,
                        degraded_intervals=scfg.degraded_intervals))
        self.stats = ServeStats()
        self._seq_len: Dict[str, int] = {}

    def _decode_fn(self, params, batch, cache):
        logits, cache = self.model.decode_step(params, batch, cache)
        return logits[:, -1].argmax(dim=-1).to(torch.int32), cache

    # ---- serving ------------------------------------------------------------

    def generate(self, prompts: np.ndarray, max_new_tokens: int,
                 seq_ids: Optional[List[str]] = None) -> np.ndarray:
        """prompts: (B, S) int32, B == batch_slots (lockstep batch).
        Returns generated tokens (B, max_new_tokens)."""
        B, S = prompts.shape
        assert B == self.scfg.batch_slots
        seq_ids = seq_ids or [f"seq{i}" for i in range(B)]
        t0 = time.monotonic()
        # large queue: prefill. Allocate pages ahead of the fill.
        total = S + max_new_tokens
        for b, sid in enumerate(seq_ids):
            for j in range(-(-total // self.scfg.page_size)):
                self.kv.alloc_page(b, sid, j)
            self._seq_len[sid] = S
        tokens = torch.as_tensor(np.asarray(prompts, dtype=np.int32),
                                 device=self.device)
        logits, cache = self.model.prefill(
            self.params, {"tokens": tokens}, max_len=self.scfg.max_len)
        # prefill produced identity-table pools; copy into the SMS layout
        self._absorb_prefill(cache, seq_ids)
        del cache
        tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats.prefills += B
        self.stats.prefill_seconds += time.monotonic() - t0

        # small queue: decode loop
        t0 = time.monotonic()
        out = []
        length = S
        for step in range(max_new_tokens):
            ts = time.monotonic()
            cache = self.kv.device_cache(length)
            next_tok, cache = self._decode_fn(
                self.params, {"token": tok}, cache)
            self.kv.absorb(cache)
            out.append(next_tok.cpu().numpy().reshape(B))
            self.stats.step_seconds.append(time.monotonic() - ts)
            tok = next_tok.reshape(B, 1)
            length += 1
            for b, sid in enumerate(seq_ids):
                self._seq_len[sid] = length
                self.kv.touch_sequence(
                    sid, -(-length // self.scfg.page_size))
            self.kv.gc_tick()
        self.stats.decode_steps += max_new_tokens
        self.stats.tokens_generated += max_new_tokens * B
        self.stats.decode_seconds += time.monotonic() - t0
        return np.stack(out, axis=1)

    def _absorb_prefill(self, cache, seq_ids: List[str]) -> None:
        """Copy prefill's identity-layout pools into the SMS pools via each
        sequence's block table, in place (one gather-scatter per
        sequence and pool)."""
        k, v = cache["k"], cache["v"]         # (L, B, P', ps, K, hd)
        Pp = k.shape[2]
        for b, sid in enumerate(seq_ids):
            js, phys = [], []
            for j in range(min(Pp, self.kv.P)):
                key = self.kv._key(sid, j)
                if key in self.kv.pages:
                    js.append(j)
                    phys.append(self.kv.pages[key][2])
            if not js:
                continue
            src = torch.tensor(js, device=self.device)
            dst = torch.tensor(phys, device=self.device)
            self.kv.k_pool[:, b, dst] = k[:, b, src]
            self.kv.v_pool[:, b, dst] = v[:, b, src]

    def resume(self, seq_id: str, slot: int) -> int:
        """Bring an evicted sequence's pages back (on-demand migration),
        fetched as ONE batched parallel fan-out instead of a
        page-at-a-time loop. Returns the number of restored pages."""
        length = self._seq_len.get(seq_id, 0)
        n = -(-length // self.scfg.page_size)
        return self.kv.restore_pages(slot, seq_id, list(range(n)))
