"""Sliding-window GC-bucket management (paper §5.3, Fig. 4).

The ServerlessMemory space is organized as GC-buckets of function groups.
Buckets age ACTIVE (M intervals) -> DEGRADED (N intervals) -> RELEASED;
data re-accessed within H = (M+N)*interval is *marked* and compacted into
the latest bucket, so a released bucket only holds cold data. Function
management policy (FMP) differs per state: active buckets get frequent
warmup ticks, degraded buckets get infrequent ones, released buckets none
(the provider reclaims them).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set

from repro_torch.core.clock import Clock


class BucketState(enum.Enum):
    ACTIVE = "active"
    DEGRADED = "degraded"
    RELEASED = "released"


@dataclass
class GCConfig:
    gc_interval: float = 600.0        # seconds (paper IBM config: 10 min)
    active_intervals: int = 6         # M
    degraded_intervals: int = 12      # N
    active_warmup: float = 60.0       # warmup period for active FMP
    degraded_warmup: float = 300.0    # reduced warmup for degraded FMP
    compaction_fraction: float = 0.5  # random subset migrated per round
    compaction_max_interval: float = 30.0

    @property
    def horizon(self) -> float:       # H
        return (self.active_intervals + self.degraded_intervals) \
            * self.gc_interval


@dataclass
class GCBucket:
    index: int
    created_at: float
    state: BucketState = BucketState.ACTIVE
    fg_ids: List[int] = field(default_factory=list)
    function_ids: Set[int] = field(default_factory=set)

    def add_function(self, fid: int, fg_id: int) -> None:
        self.function_ids.add(fid)
        if fg_id not in self.fg_ids:
            self.fg_ids.append(fg_id)


@dataclass
class WindowEvent:
    """Result of one GC execution."""
    demoted_buckets: List[GCBucket] = field(default_factory=list)
    released_buckets: List[GCBucket] = field(default_factory=list)
    released_functions: Set[int] = field(default_factory=set)
    new_bucket: Optional[GCBucket] = None


class SlidingWindow:
    """Owns bucket lifecycle; placement/compaction layers consult it."""

    def __init__(self, cfg: GCConfig, clock: Clock):
        self.cfg = cfg
        self.clock = clock
        self._buckets: List[GCBucket] = []
        self._next_index = 0
        self._last_gc = clock.now()
        self._marked: Set[str] = set()        # chunks re-accessed within H
        self._new_bucket()

    # ---- bucket access ---------------------------------------------------

    def _new_bucket(self) -> GCBucket:
        b = GCBucket(index=self._next_index, created_at=self.clock.now())
        self._next_index += 1
        self._buckets.append(b)
        return b

    @property
    def latest(self) -> GCBucket:
        return self._buckets[-1]

    def buckets(self, state: Optional[BucketState] = None) -> List[GCBucket]:
        return [b for b in self._buckets
                if state is None or b.state == state]

    def bucket_of_function(self, fid: int) -> Optional[GCBucket]:
        for b in reversed(self._buckets):
            if fid in b.function_ids:
                return b
        return None

    def state_of_function(self, fid: int) -> Optional[BucketState]:
        b = self.bucket_of_function(fid)
        return b.state if b else None

    def warmup_period(self, fid: int) -> Optional[float]:
        st = self.state_of_function(fid)
        if st == BucketState.ACTIVE:
            return self.cfg.active_warmup
        if st == BucketState.DEGRADED:
            return self.cfg.degraded_warmup
        return None

    # ---- marking / compaction -------------------------------------------

    def mark(self, chunk_key: str) -> None:
        """Chunk re-accessed within H: candidate for compaction."""
        self._marked.add(chunk_key)

    def unmark(self, chunk_key: str) -> None:
        self._marked.discard(chunk_key)

    def marked(self) -> Set[str]:
        return set(self._marked)

    def take_compaction_round(self, rng) -> List[str]:
        """Random `compaction_fraction` subset of marked chunks (paper
        §5.3.3: the daemon migrates marked chunks in bounded rounds)."""
        marked = sorted(self._marked)
        if not marked:
            return []
        n = max(1, int(len(marked) * self.cfg.compaction_fraction))
        idx = rng.permutation(len(marked))[:n]
        picked = [marked[i] for i in idx]
        for c in picked:
            self._marked.discard(c)
        return picked

    # ---- GC execution -----------------------------------------------------

    def due(self) -> bool:
        return self.clock.now() - self._last_gc >= self.cfg.gc_interval

    def run_gc(self, *, carry_open_fgs: Callable[[GCBucket, GCBucket], None]
               = lambda old, new: None) -> WindowEvent:
        """Execute the GC procedure (paper Fig. 4):
        1. active buckets older than M intervals become degraded,
        2. degraded buckets older than M+N intervals are released,
        3. a fresh latest bucket is opened; open FGs are carried over."""
        now = self.clock.now()
        self._last_gc = now
        ev = WindowEvent()
        M = self.cfg.active_intervals * self.cfg.gc_interval
        H = self.cfg.horizon
        for b in self._buckets:
            age = now - b.created_at
            if b.state == BucketState.ACTIVE and age >= M:
                b.state = BucketState.DEGRADED
                ev.demoted_buckets.append(b)
            if b.state == BucketState.DEGRADED and age >= H:
                b.state = BucketState.RELEASED
                ev.released_buckets.append(b)
                ev.released_functions |= b.function_ids
        old_latest = self.latest
        ev.new_bucket = self._new_bucket()
        carry_open_fgs(old_latest, ev.new_bucket)
        # drop fully-released buckets from the window front; the new
        # bucket was appended by _new_bucket and is ACTIVE, so it always
        # survives this filter — no re-append, which would duplicate it
        self._buckets = [b for b in self._buckets
                         if b.state != BucketState.RELEASED]
        return ev

    def release_function(self, fid: int) -> None:
        """Remove a (failed degraded) function from the memory space
        immediately (paper §5.3: degraded + failure => removal)."""
        for b in self._buckets:
            b.function_ids.discard(fid)
