"""SMS-managed paged KV cache (the paper's technique applied to LLM
serving), on torch tensors.

KV pages are InfiniStore chunks: `PlaceChunk` assigns each page to a slab
(HBM capacity unit), the sliding GC window ages pages (active sequences
keep their pages hot; finished sequences' pages cool and are RELEASED),
and released pages' device slots are freed for reuse. Page payloads stay
on the device (`sms.Ref` entries); an evicted page is persisted, and
restored on demand when its sequence resumes — the paper's on-demand
migration.

The eviction tier is pluggable: by default pages round-trip through a
private raw `COS` (host bytes: one device-to-host copy per page), but
passing `store=` (a `StoreFrontend`, e.g. the port's `InfiniStore`)
routes evict/restore through the full store data path instead:
erasure-coded on the store's device, versioned and crash-journaled.

The device pools use the reference's layout, k/v (L, B, P, ps, K, hd),
with per-sequence block tables (B, P) mapping logical page -> physical
slot within the sequence's region. Pages are written and restored in
place: the reference's functional `.at[].set` would copy a whole pool.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.clock import Clock
from repro_torch.core.cos import COS
from repro_torch.core.gc_window import BucketState, GCConfig, SlidingWindow
from repro_torch.core.payload import as_u8, require_device, to_host
from repro_torch.core.placement import PlacementManager
from repro_torch.core.sms import SMS, Ref
from repro_torch.models.transformer import DTYPES


@dataclass
class KVStats:
    pages_allocated: int = 0
    pages_released: int = 0
    pages_evicted_to_cos: int = 0
    pages_restored: int = 0
    compactions: int = 0


class SMSPagedKV:
    """Host control plane for one device-resident paged KV pool."""

    def __init__(self, cfg: ModelConfig, *, batch_slots: int,
                 max_len: int, page_size: int = 64,
                 gc: Optional[GCConfig] = None,
                 pages_per_slab: int = 64,
                 clock: Optional[Clock] = None,
                 store=None, device="cuda"):
        self.cfg = cfg
        self.device = require_device(device)
        self.B = batch_slots
        self.ps = page_size
        self.P = -(-max_len // page_size)
        self.clock = clock or Clock()
        # optional StoreFrontend eviction tier (see module docstring);
        # None keeps the raw private-COS baseline
        self.store = store
        self.cos = COS(self.clock) if store is None else None
        self.sms = SMS(self.clock)
        gc = gc or GCConfig(gc_interval=60.0, active_intervals=2,
                            degraded_intervals=2)
        self.window = SlidingWindow(gc, self.clock)
        K, hd, L = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
        # PlaceChunk's accounting unit: always counts k+v in bf16, as the
        # reference does, whatever the pools' dtype
        self.page_bytes = L * page_size * K * hd * 2 * 2
        self.placement = PlacementManager(
            1, self.page_bytes * pages_per_slab,
            new_function_cb=self._on_new_slab)
        shape = (L, self.B, self.P, page_size, K, hd)
        dt = DTYPES[cfg.dtype]
        self.k_pool = torch.zeros(shape, dtype=dt, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=dt, device=self.device)
        self.table = np.tile(np.arange(self.P, dtype=np.int32)[None],
                             (self.B, 1))
        # free physical slots per sequence region
        self._free: List[Set[int]] = [set(range(self.P))
                                      for _ in range(self.B)]
        # chunk key ("kv/<seq>/p<j>") -> (slot b, logical j, phys, fid)
        self.pages: Dict[str, Tuple[int, int, int, int]] = {}
        self.stats = KVStats()
        self.rng = np.random.default_rng(0)

    def _on_new_slab(self, fid: int, fg_id: int, capacity: int) -> None:
        self.sms.add(fid, capacity)
        self.window.latest.add_function(fid, fg_id)

    # ---- page lifecycle ---------------------------------------------------

    def _key(self, seq_id: str, j: int) -> str:
        return f"kv/{seq_id}/p{j}"

    def alloc_page(self, b: int, seq_id: str, j: int) -> int:
        """Allocate logical page j for the sequence in slot b; returns the
        physical slot. PlaceChunk picks the slab (capacity accounting +
        auto-scaling); the physical slot comes from the slot's region."""
        key = self._key(seq_id, j)
        if key in self.pages:
            return self.pages[key][2]
        if not self._free[b]:
            self._reclaim_released(b)
        if not self._free[b]:
            raise MemoryError(f"no free KV page slots in region {b}")
        phys = min(self._free[b])
        self._free[b].discard(phys)
        fid = self.placement.place_chunk(0, self.page_bytes)
        self.sms.get(fid).store(key, Ref(self.page_bytes))
        self.pages[key] = (b, j, phys, fid)
        self.table[b, j] = phys
        self.stats.pages_allocated += 1
        return phys

    def touch_sequence(self, seq_id: str, num_pages: int) -> None:
        """Decode touched all pages of this sequence: mark hot."""
        for j in range(num_pages):
            key = self._key(seq_id, j)
            if key in self.pages:
                self.window.mark(key)
                fid = self.pages[key][3]
                slab = self.sms.slabs.get(fid)
                if slab is not None:
                    slab.invoke(0.0)

    def page_payload(self, b: int, phys: int) -> torch.Tensor:
        """The page's bytes on the pools' device: k then v, each (L, ps,
        K, hd) in the pools' dtype, as one flat uint8 tensor."""
        return torch.cat([as_u8(self.k_pool[:, b, phys]),
                          as_u8(self.v_pool[:, b, phys])])

    def evict_page_to_cos(self, key: str) -> None:
        """Persist the page and free its device slot. The store tier takes
        the device bytes as they are (it encodes on its own device); the
        raw COS tier holds host bytes, so the page crosses to the host
        once."""
        b, j, phys, fid = self.pages[key]
        payload = self.page_payload(b, phys)
        if self.store is not None:
            # store-backed tier: versioned, erasure-coded, journaled
            self.store.put(key, payload)
        else:
            self.cos.put(key, to_host(payload))
        self._free[b].add(phys)
        slab = self.sms.slabs.get(fid)
        if slab is not None:
            slab.delete(key)
        del self.pages[key]
        self.stats.pages_evicted_to_cos += 1

    def restore_page(self, b: int, seq_id: str, j: int) -> int:
        """On-demand migration: bring an evicted page back from COS into
        a free slot of region b (paper §5.3.3)."""
        key = self._key(seq_id, j)
        raw = self.store.get_array(key) if self.store is not None \
            else self.cos.get(key)
        if raw is None:
            raise KeyError(f"page {key} not in COS")
        return self._install_page(b, seq_id, j, raw)

    def restore_pages(self, b: int, seq_id: str, js: List[int]) -> int:
        """Batched on-demand migration for a resuming sequence: the
        missing pages' payloads are fetched with one bounded parallel
        fan-out and installed in page order. Returns the pages restored."""
        todo = [(j, self._key(seq_id, j)) for j in js
                if self._key(seq_id, j) not in self.pages]
        if not todo:
            return 0
        if self.store is not None:
            # one batched gather: the store groups SMS reads per
            # function and fans COS fallbacks out on its I/O executor
            arrs = self.store.get_many_arrays([key for _, key in todo])
            for j, key in todo:
                raw = arrs.get(key)
                if raw is None:
                    raise KeyError(f"page {key} not in COS")
                self._install_page(b, seq_id, j, raw)
            return len(todo)
        # COS's own worker pool does the fan-out: no per-call executor
        futs = [(j, key, self.cos.get_async(key)) for j, key in todo]
        for j, key, fut in futs:
            raw = fut.result()
            if raw is None:
                raise KeyError(f"page {key} not in COS")
            self._install_page(b, seq_id, j, raw)
        return len(todo)

    def _install_page(self, b: int, seq_id: str, j: int, raw) -> int:
        L, _, _, ps, K, hd = self.k_pool.shape
        buf = as_u8(raw)                       # bytes or uint8 tensor alike
        half = buf.numel() // 2
        dt = self.k_pool.dtype
        kp = buf[:half].view(dt).reshape(L, ps, K, hd)
        vp = buf[half:].view(dt).reshape(L, ps, K, hd)
        phys = self.alloc_page(b, seq_id, j)
        self.k_pool[:, b, phys].copy_(kp)      # in place, on the pools'
        self.v_pool[:, b, phys].copy_(vp)      # device
        self.stats.pages_restored += 1
        return phys

    def _reclaim_released(self, b: int) -> None:
        """Free device slots whose pages' buckets were RELEASED (their
        content persists in COS)."""
        for key, (bb, j, phys, fid) in list(self.pages.items()):
            if bb != b:
                continue
            state = self.window.state_of_function(fid)
            if state in (None, BucketState.RELEASED) \
                    or not self.sms.slabs.get(fid, None) \
                    or not self.sms.get(fid).alive:
                self.evict_page_to_cos(key)
                self.stats.pages_released += 1

    # ---- GC tick -----------------------------------------------------------

    def gc_tick(self) -> None:
        if self.window.due():
            ev = self.window.run_gc()
            for fg_id in self.placement.carry_over_open_fgs():
                for fid in self.placement.fgs[fg_id].fids:
                    ev.new_bucket.add_function(fid, fg_id)
            for fid in ev.released_functions:
                slab = self.sms.slabs.get(fid)
                if slab is not None:
                    # persist + free every page on the released slab
                    for key in list(slab.keys()):
                        if key in self.pages:
                            self.evict_page_to_cos(key)
                            self.stats.pages_released += 1
                    slab.reclaim()
        # compaction round: re-place marked-hot pages into the latest
        # bucket's slabs (control-plane move; device slot unchanged)
        for key in self.window.take_compaction_round(self.rng):
            if key not in self.pages:
                continue
            b, j, phys, old_fid = self.pages[key]
            state = self.window.state_of_function(old_fid)
            if state in (BucketState.ACTIVE, None):
                continue
            new_fid = self.placement.place_chunk(0, self.page_bytes)
            self.sms.get(new_fid).store(key, Ref(self.page_bytes))
            old = self.sms.slabs.get(old_fid)
            if old is not None:
                old.delete(key)
            self.pages[key] = (b, j, phys, new_fid)
            self.stats.compactions += 1

    # ---- views ------------------------------------------------------------

    def device_cache(self, length: int):
        """Cache dict for transformer.decode_step: the pools themselves
        (decode writes into them in place), the block table on the
        pools' device, and the current length."""
        return {"k": self.k_pool, "v": self.v_pool,
                "block_table": torch.tensor(self.table, device=self.device),
                "len": torch.tensor(length, dtype=torch.int32,
                                    device=self.device)}

    def absorb(self, cache) -> None:
        """Take the pools back after a decode step (the same tensors,
        updated in place)."""
        self.k_pool = cache["k"]
        self.v_pool = cache["v"]
