"""Failure detection + local/parallel recovery (paper §5.5, Fig. 19-21).

Detection: on invocation, the instance compares its local (term, hash)
with the daemon's piggybacked view — mismatch means the instance was
reclaimed and restarted cold (§5.5.1). The diff_rank delta decides local
vs parallel recovery: if many chunks are missing, a pre-selected group of
R recovery functions each restores `hash(key) % R == i`'s portion from
COS in parallel and serves GETs for that portion until the storage
function resumes (§5.5.2, RAMCloud-style but with *temporary* recovery
placement to survive cascading reclamations).
"""
from __future__ import annotations

import hashlib
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set

from repro_torch.core.cos import COS
from repro_torch.core.faults import RetryPolicy
from repro_torch.core.insertion_log import InsertionLog, Piggyback
from repro_torch.core.payload import to_device
from repro_torch.core.sms import SMS, Slab


def _chunk_shard(key: str, groups: int) -> int:
    return int.from_bytes(hashlib.md5(key.encode()).digest()[:4],
                          "little") % groups


@dataclass
class RecoveryStats:
    detections: int = 0
    local_recoveries: int = 0
    parallel_recoveries: int = 0
    chunks_recovered: int = 0
    bytes_recovered: int = 0
    recovery_seconds: float = 0.0


@dataclass
class RecoverySession:
    fid: int
    group: List[int]
    pending: Set[str]
    recovered: Dict[str, bytes] = field(default_factory=dict)
    done: bool = False
    completed_at: Optional[float] = None      # clock time of phase 3
    # temporary cache placements in the recovery group: (rfid, chunk key)
    placements: List[tuple] = field(default_factory=list)


class RecoveryManager:
    def __init__(self, sms: SMS, cos: COS, logs: Dict[int, InsertionLog], *,
                 num_recovery_functions: int = 20, workers: int = 8,
                 retain_seconds: float = 60.0, writeback=None, clock=None,
                 thread_prefix: str = "recovery",
                 retry: Optional[RetryPolicy] = None, device="cuda"):
        self.sms = sms
        # the slabs' device: COS downloads cross host-to-device into it
        self.device = device
        self.cos = cos
        # unified retry policy (repro_torch.core.faults) for recovery-time COS
        # downloads: a recovery session racing a transient COS blip must
        # retry rather than silently dropping chunks from the restore
        self.retry = retry or RetryPolicy(max_attempts=6,
                                          backoff_base_s=0.005,
                                          backoff_cap_s=0.25)
        # WritebackQueue (or None): chunks acked but not yet persisted to
        # COS are restored from its pending map — the async-writeback
        # durability contract (§5.3.2)
        self.writeback = writeback
        self.logs = logs
        self.R = num_recovery_functions
        # §5.5.2: recovery-group placements are TEMPORARY — they expire
        # this long after the session completes (swept by sweep_expired)
        self.retain_seconds = retain_seconds
        self.clock = clock                    # store Clock, or wall time
        self.stats = RecoveryStats()
        # per-shard prefix so a multi-daemon deployment's recovery pools
        # are tell-apart-able in thread dumps
        self._pool = ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix=thread_prefix)
        self._lock = threading.RLock()
        # fid -> pre-selected recovery group (function ids)
        self.recovery_groups: Dict[int, List[int]] = {}
        # functions currently acting as a recovery function (one storage
        # function each, §5.5.2 phase 1)
        self._busy_recovery: Set[int] = set()
        self.sessions: Dict[int, RecoverySession] = {}
        # sessions displaced from `sessions` by a same-fid re-failure
        # while still running: their placements are still being
        # appended, so they are parked here and swept once done
        self._orphans: List[RecoverySession] = []

    def _now(self) -> float:
        return self.clock.now() if self.clock is not None \
            else time.monotonic()

    def shutdown(self) -> None:
        """Release the recovery worker pool. Without this every store
        leaks up to `workers` live recovery-* threads on close."""
        self._pool.shutdown(wait=True)

    # ---- group management (phase 1) -------------------------------------

    def assign_group(self, fid: int, candidates: List[int]) -> List[int]:
        """Pre-select (or refresh) the recovery group for a storage
        function from the non-recovering pool."""
        with self._lock:
            group = [c for c in candidates
                     if c != fid and c not in self._busy_recovery][:self.R]
            self.recovery_groups[fid] = group
            return group

    def _claim_group(self, fid: int, candidates: List[int]) -> List[int]:
        with self._lock:
            group = self.recovery_groups.get(fid, [])
            group = [g for g in group if g not in self._busy_recovery]
            for c in candidates:
                if len(group) >= self.R:
                    break
                if c != fid and c not in self._busy_recovery \
                        and c not in group:
                    group.append(c)
            for g in group:
                self._busy_recovery.add(g)
            return group

    def _release_group(self, group: List[int]) -> None:
        with self._lock:
            for g in group:
                self._busy_recovery.discard(g)

    # ---- detection (§5.5.1) ----------------------------------------------

    def check_failed(self, slab: Slab, daemon_view: Piggyback) -> bool:
        """Consistency check an invoked instance performs against the
        piggybacked insertion info."""
        failed = (slab.term != daemon_view.term
                  or slab.log_hash != daemon_view.hash)
        if failed and daemon_view.term > 0:
            self.note_detection()
            return True
        return False

    def note_detection(self) -> None:
        """Count one failure detection. The store calls this for the
        invoke-path `was_dead` case (an instance observed reclaimed at
        invocation) that a matching term/hash would otherwise hide from
        `check_failed` — both paths are real detections."""
        with self._lock:
            self.stats.detections += 1

    def needs_parallel(self, slab: Slab, daemon_view: Piggyback) -> bool:
        """diff_rank difference significantly larger than the recovery
        group size => parallel recovery (§5.5.1)."""
        diff = daemon_view.diff_rank - slab.diff_rank
        return diff > self.R

    # ---- recovery (§5.5.2) -------------------------------------------------

    def _download(self, keys: List[str]) -> Dict[str, bytes]:
        out: Dict[str, bytes] = {}
        for key in keys:
            try:
                if self.writeback is not None:   # pending map, then COS
                    data = self.retry.run(
                        lambda k=key:
                        self.writeback.read_through(f"chunk/{k}"))
                else:
                    data = self.retry.run(
                        lambda k=key: self.cos.get(f"chunk/{k}"))
            except Exception as e:                # noqa: BLE001
                if self.retry.classify(e) == RetryPolicy.PERMANENT:
                    raise
                # transient budget exhausted (COS outage): skip — the
                # chunk stays recoverable from COS once it heals, and
                # readers fall back to EC reconstruction meanwhile
                continue
            if data is not None:
                out[key] = to_device(data, self.device)
        return out

    def recover_local(self, slab: Slab) -> int:
        """The failed instance replays its manifest and restores every
        missing chunk from COS by itself."""
        t0 = time.monotonic()
        log = self.logs.get(slab.fid)
        if log is None:                       # no durable history: no-op
            return 0
        manifest = log.manifest()
        missing = [k for k in manifest if slab.load(k) is None]
        got = self._download(missing)
        for key, data in got.items():
            slab.store(key, data)
        slab.term = log.term
        slab.log_hash = log.last_hash
        slab.diff_rank = log.diff_rank
        with self._lock:                  # pool workers may be running
            self.stats.local_recoveries += 1
            self.stats.chunks_recovered += len(got)
            self.stats.bytes_recovered += sum(len(v) for v in got.values())
            self.stats.recovery_seconds += time.monotonic() - t0
        return len(got)

    def recover_parallel(self, slab: Slab, candidates: List[int],
                         *, on_ready: Optional[Callable] = None
                         ) -> RecoverySession:
        """Phase 2: fan the missing chunk set out over the recovery group;
        each worker i downloads keys with hash(key) % R == i. Phase 3:
        the storage instance reabsorbs the chunks and resumes service."""
        t0 = time.monotonic()
        log = self.logs.get(slab.fid)
        if log is None:
            return RecoverySession(fid=slab.fid, group=[], pending=set(),
                                   done=True)
        manifest = log.manifest()
        missing = [k for k in manifest if slab.load(k) is None]
        group = self._claim_group(slab.fid, candidates)
        R = max(len(group), 1)
        session = RecoverySession(fid=slab.fid, group=group,
                                  pending=set(missing))
        with self._lock:
            # a prior session for this fid (re-failure inside
            # retain_seconds) leaves the dict here and would never be
            # swept — evict its temporary placements now. If it is
            # still RUNNING its workers are still appending placements
            # (an eviction now would miss the later ones): park it on
            # the orphan list for sweep_expired instead.
            prior = self.sessions.get(slab.fid)
            prior_placements: List[tuple] = []
            if prior is not None:
                if prior.done:
                    prior_placements = list(prior.placements)
                else:
                    self._orphans.append(prior)
            self.sessions[slab.fid] = session
        for rfid, key in prior_placements:
            rslab = self.sms.slabs.get(rfid)
            if rslab is not None:
                rslab.cache_delete(key)

        def worker(i: int) -> Dict[str, bytes]:
            mine = [k for k in missing if _chunk_shard(k, R) == i]
            got = self._download(mine)
            with self._lock:
                session.recovered.update(got)
                session.pending -= set(got.keys())
                # recovery functions hold the data TEMPORARILY in their
                # cache space and serve GETs for their portion
                if i < len(group) and group[i] in self.sms.slabs:
                    rslab = self.sms.slabs[group[i]]
                    for k2, v in got.items():
                        rslab.cache_put(k2, v)
                        session.placements.append((group[i], k2))
            return got

        futures = [self._pool.submit(worker, i) for i in range(R)]
        wait(futures)
        # phase 3: service resumption — the storage instance restores all
        for key, data in session.recovered.items():
            slab.store(key, data)
        slab.term = log.term
        slab.log_hash = log.last_hash
        slab.diff_rank = log.diff_rank
        session.done = True
        session.completed_at = self._now()
        self._release_group(group)
        with self._lock:                  # other sessions may be running
            self.stats.parallel_recoveries += 1
            self.stats.chunks_recovered += len(session.recovered)
            self.stats.bytes_recovered += sum(
                len(v) for v in session.recovered.values())
            self.stats.recovery_seconds += time.monotonic() - t0
        if on_ready:
            on_ready(session)
        return session

    def serve_during_recovery(self, fid: int, key: str) -> Optional[bytes]:
        """GETs rerouted to the recovery group while a storage function
        recovers (§5.5.2 phase 2)."""
        with self._lock:
            session = self.sessions.get(fid)
            if session is None:
                return None
            return session.recovered.get(key)

    def sweep_expired(self, now: Optional[float] = None) -> int:
        """Expire completed sessions past `retain_seconds` (the gc_tick
        hook): the recovery group's cache placements are TEMPORARY per
        §5.5.2 — evict them and drop the finished session. Returns the
        number of sessions expired."""
        if now is None:
            now = self._now()
        with self._lock:
            expired = [fid for fid, s in self.sessions.items()
                       if s.done and s.completed_at is not None
                       and now - s.completed_at >= self.retain_seconds]
            swept = [self.sessions.pop(fid) for fid in expired]
            keep: List[RecoverySession] = []
            for s in self._orphans:           # displaced sessions expire
                if s.done and s.completed_at is not None \
                        and now - s.completed_at >= self.retain_seconds:
                    swept.append(s)
                else:
                    keep.append(s)
            self._orphans = keep
        for session in swept:
            for rfid, key in session.placements:
                rslab = self.sms.slabs.get(rfid)
                if rslab is not None:
                    rslab.cache_delete(key)
        return len(swept)
