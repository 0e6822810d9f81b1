"""ServerlessMemory Store: the slab pool (paper §4, §5.4).

A Slab is the TPU-world analogue of a Lambda instance's function-memory
(DESIGN.md §2): a fixed-capacity memory unit that can be reclaimed at any
time by the platform. Each slab's memory is split into a *storage
partition* (regular object chunks, counted against HARDCAP) and a *cache
space* (demand-cached chunks, evictable, NOT counted against HARDCAP —
paper §5.4).

Payloads are flat uint8 tensors on the store's device (or bytes); the
serving integration keeps its data elsewhere on the device and stores a
size-only `Ref` here, using the slabs as the control-plane ledger.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Tuple

from repro_torch.core.clock import Clock
from repro_torch.core.locks import make_rlock

# Lambda runtime overhead the paper excludes from HARDCAP (~100 MB of a
# 1536 MB function) and the fraction reserved for recovery buffers §5.5.2.
RUNTIME_OVERHEAD_FRACTION = 100 / 1536
RECOVERY_RESERVE_FRACTION = 0.10


def hardcap(capacity: int) -> int:
    return int(capacity * (1 - RUNTIME_OVERHEAD_FRACTION
                           - RECOVERY_RESERVE_FRACTION))


@dataclass
class SlabStats:
    invocations: int = 0
    busy_seconds: float = 0.0        # billed execution time
    stored_bytes: int = 0
    cached_bytes: int = 0


class Ref:
    """Size-only entry for device-resident chunks (e.g. KV pages): SMS
    tracks placement/accounting while the payload stays in HBM."""
    __slots__ = ("size",)

    def __init__(self, size: int):
        self.size = size


def _nbytes(v) -> int:
    return v.size if isinstance(v, Ref) else len(v)


class Slab:
    """One function instance's memory."""

    def __init__(self, fid: int, capacity: int, clock: Clock):
        self.fid = fid
        self.capacity = capacity
        self.hardcap = hardcap(capacity)
        self.clock = clock
        # optional FaultPlan (set by SMS.add); a "reclaim" advisory at
        # sms.store / sms.load reclaims this slab mid-operation — the
        # FaaS provider killing the instance under us.
        self.faults = None
        self.storage: Dict[str, bytes] = {}
        self.cache: "OrderedDict[str, bytes]" = OrderedDict()
        # incremental byte accounting: `used`/cache totals used to be
        # recomputed by summing every entry on EVERY store/trim — O(n)
        # per chunk write on the PUT hot path, pure-Python and
        # GIL-bound, which throttled multi-daemon scale-out long before
        # the encode did. Maintained on each insert/delete instead.
        self._used = 0
        self._cached = 0
        self.alive = True                  # False = reclaimed by provider
        self.term = 0                      # insertion-log term (§5.5.1)
        self.log_hash = ""
        self.diff_rank = 0
        self.last_invoked = clock.now()
        self.stats = SlabStats()
        self._lock = make_rlock("sms.Slab._lock")

    # ---- billing / liveness -------------------------------------------------

    def invoke(self, busy_s: float = 0.0) -> None:
        with self._lock:
            if not self.alive:   # cold start: fresh instance, empty memory
                self.alive = True
            self.last_invoked = self.clock.now()
            self.stats.invocations += 1
            self.stats.busy_seconds += busy_s

    def reclaim(self) -> None:
        """Provider reclaims the instance: memory is lost. The insertion
        log (in COS) survives; term/hash mismatch on the next invocation
        triggers failure detection (§5.5.1)."""
        with self._lock:
            self.alive = False
            self.storage.clear()
            self.cache.clear()
            self._used = 0
            self._cached = 0
            self.stats.stored_bytes = 0
            self.stats.cached_bytes = 0
            self.term = 0
            self.log_hash = ""
            self.diff_rank = 0

    # ---- storage partition ---------------------------------------------------

    @property
    def used(self) -> int:
        return self._used

    def store(self, key: str, data) -> bool:
        """data: bytes payload, or a `Ref` for device-resident chunks.
        Accepts writes while under HARDCAP (the crossing write goes
        through — the placement layer then seals the FG, §5.3.1); the raw
        capacity is the absolute bound, with cache-space eviction first."""
        if self.faults is not None:
            if self.faults.fire("sms.store", key) == "reclaim":
                self.reclaim()            # instance died mid-store
                return False
        with self._lock:
            if not self.alive:
                return False
            needed = _nbytes(data)
            if self._used >= self.hardcap:
                return False
            if self._used + needed > self.capacity:
                self._evict_cache(needed)                # paper §5.4
                if self._used + needed > self.capacity:
                    return False
            old = self.storage.get(key)
            if old is not None:                # same-key overwrite
                self._used -= _nbytes(old)
            self.storage[key] = data
            self._used += needed
            self.stats.stored_bytes = self._used
            return True

    def load(self, key: str) -> Optional[bytes]:
        if self.faults is not None:
            if self.faults.fire("sms.load", key) == "reclaim":
                self.reclaim()            # instance died mid-gather
                return None
        with self._lock:
            if not self.alive:
                return None
            if key in self.storage:
                return self.storage[key]
            if key in self.cache:
                self.cache.move_to_end(key)
                return self.cache[key]
            return None

    def delete(self, key: str) -> bool:
        with self._lock:
            v = self.storage.pop(key, None)
            if v is not None:
                self._used = max(0, self._used - _nbytes(v))
                self.stats.stored_bytes = self._used
                return True
            v = self.cache.pop(key, None)
            if v is None:
                return False
            self._cached = max(0, self._cached - _nbytes(v))
            self.stats.cached_bytes = self._cached
            return True

    # ---- cache space (demand-cached chunks, §5.3.3/§5.4) --------------------

    def cache_put(self, key: str, data: bytes) -> None:
        with self._lock:
            if not self.alive:
                return
            old = self.cache.get(key)
            if old is not None:
                self._cached -= _nbytes(old)
            self.cache[key] = data
            self.cache.move_to_end(key)
            self._cached += _nbytes(data)
            budget = self.capacity - self.hardcap
            self._trim_cache(budget)

    def _trim_cache(self, budget: int) -> None:
        while self.cache and self._cached > budget:
            _, v = self.cache.popitem(last=False)
            self._cached -= _nbytes(v)
        self._cached = max(0, self._cached)
        self.stats.cached_bytes = self._cached

    def cache_delete(self, key: str) -> bool:
        """Drop a cache-space entry WITHOUT touching the storage
        partition (expired temporary recovery placements, §5.5.2)."""
        with self._lock:
            v = self.cache.pop(key, None)
            if v is None:
                return False
            self._cached = max(0, self._cached - _nbytes(v))
            self.stats.cached_bytes = self._cached
            return True

    def _evict_cache(self, needed: int) -> None:
        freed = 0
        while self.cache and freed < needed:
            _, v = self.cache.popitem(last=False)
            freed += _nbytes(v)
        self._cached = max(0, self._cached - freed)
        self.stats.cached_bytes = self._cached

    def keys(self) -> Iterable[str]:
        with self._lock:
            return list(self.storage.keys())


class SMS:
    """The collective function-memory pool."""

    def __init__(self, clock: Clock):
        self.clock = clock
        self.slabs: Dict[int, Slab] = {}
        self.faults = None               # propagated to new slabs
        self._lock = make_rlock("sms.SMS._lock")

    def add(self, fid: int, capacity: int) -> Slab:
        with self._lock:
            slab = Slab(fid, capacity, self.clock)
            slab.faults = self.faults
            self.slabs[fid] = slab
            return slab

    def get(self, fid: int) -> Slab:
        return self.slabs[fid]

    def remove(self, fid: int) -> None:
        with self._lock:
            self.slabs.pop(fid, None)

    def reclaim_idle(self, idle_threshold: float) -> list:
        """Provider-side reclamation of instances idle beyond threshold —
        the FaaS behaviour InfiniStore's warmups fight against."""
        now = self.clock.now()
        out = []
        for slab in self.slabs.values():
            if slab.alive and now - slab.last_invoked > idle_threshold:
                slab.reclaim()
                out.append(slab.fid)
        return out

    @property
    def total_stored(self) -> int:
        return sum(s.used for s in self.slabs.values())

    def alive_count(self) -> int:
        return sum(1 for s in self.slabs.values() if s.alive)
