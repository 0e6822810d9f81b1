"""Sharded multi-daemon scale-out: a keyspace-partitioned front-end
over N independent `InfiniStore` shards (ROADMAP "Multi-daemon
scale-out").

One `InfiniStore` funnels every mutation through a single client-daemon
thread — the right model for the paper's single-client sections, but a
throughput ceiling long before the function pool saturates. This is the
contrast InfiniStore draws against shared-nothing partitioned designs
(Anna's hash-partitioned actors, Faa$T's per-application hash-
distributed cache): partition the METADATA TABLE and CHUNK MAP by key
so independent daemons serve disjoint keyspaces.

`ShardedStore` implements exactly that while preserving the whole
`StoreFrontend` contract at the sharded surface:

- **Partitioning**: a deterministic, pluggable `ShardRouter` (stable
  CRC-32 `HashRouter` by default, contiguous `RangeRouter` for ordered
  keyspaces) maps every object key to one shard. Each shard is a full
  `InfiniStore` — its own client daemon, `WritebackQueue` writer,
  `SpillJournal` under `<spill_dir>/shard-<i>/`, placement state, GC
  window, and recovery manager — all sharing ONE `COS` backend (the
  cloud object store is the global layer in the paper; everything
  daemon-local is per-shard). Chunk keys derive from object keys, so
  disjoint object keyspaces imply disjoint chunk/metadata/journal
  keyspaces: shards never coordinate on the data path.
- **Scatter/gather**: the batched APIs (`put_many_async`,
  `get_many_async`, `get_many_arrays_async`) split a batch into
  per-shard sub-batches, pipeline them on the shard daemons
  concurrently, and join the sub-results into one `StoreFuture`.
- **Cross-shard atomic `put_many`**: a multi-key batch spanning shards
  commits via a leader-sequenced two-round protocol. The protocol
  provides failure atomicity, not read isolation: while round 2 lands
  shard by shard, a concurrent reader may observe some shards' new
  versions before the others commit. Round 1 (prepare) runs each
  shard's sub-batch through the shard's one multi-key CAS + fragment +
  slab/journal path but stops BEFORE the ack point — the new versions
  stay PENDING, invisible to readers and blocking same-key writers —
  and journals a durable `prepared/<ticket>` record in the shard's
  spill journal. The leader then records a durable COMMIT DECISION
  (`decision/<ticket>` in its own journal under `<spill_root>/leader/`,
  or a `2pc/decision/<ticket>` COS stub when running journal-less) and
  round 2 finalizes every sub-batch (ack + metadata journal, ticket
  stamped into each shard's journal record); if ANY shard fails to
  prepare, every prepared shard aborts and readers keep seeing the
  previous versions everywhere. Single-shard batches skip the protocol
  entirely (the common, fast case).

  **The in-doubt window is CLOSED** (presumed abort): a shard that
  crashes — or whose commit submission fails — between prepare and
  commit restarts with the batch withheld as in-doubt (its journal
  replay finds `prepared/<ticket>` with no resolution). The
  `resolve_indoubt()` sweep — run at construction, on every
  `restart_shard`, on every `gc_tick`, or explicitly — queries the
  leader's durable decision for each in-doubt ticket and rolls the
  sub-batch FORWARD (decision record found: the versions become
  readable heads exactly as if round 2 had run) or BACK (no record:
  the leader never decided, so the batch aborts everywhere). The
  invariant: once the decision record is durable the batch can only
  ever commit; before it, only ever abort — no key stays PENDING
  across a crash, and no batch is ever half-visible after resolution.
  Decision records are retired once every participant has resolved.
- **Failure domains**: `simulate_crash(shard=i)` kills one daemon; the
  surviving shards keep serving their keyspaces and `restart_shard(i)`
  rebuilds the dead one from its own spill journal (per-shard recovery
  session) with zero acked loss — the single-store kill/restart contract per
  failure domain. `flush_writeback` / `close` / `gc_tick` fan out.
- **Observability**: `stats` aggregates every shard's `StoreStats`
  (per-counter atomic reads — see the StoreStats consistency model;
  the aggregate is not a consistent cut), `stats_per_shard` keeps the
  breakdown, and `snapshot_metadata()` adds a shard-balance histogram
  (distinct object keys per shard) plus the router description.
"""
from __future__ import annotations

import bisect
import dataclasses
import itertools
import os
import shutil
import tempfile
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Union

import torch

from repro_torch.core.clock import Clock
from repro_torch.core.cos import COS
from repro_torch.core.faults import RetryPolicy
from repro_torch.core.locks import make_lock
from repro_torch.core.payload import require_device
from repro_torch.core.spill import SpillJournal
from repro_torch.core.store import (_STAT_FIELDS, InfiniStore, StoreConfig,
                              StoreStats)
from repro_torch.core.writeback import StoreFuture
from repro_torch.obs import NOOP_CM, ObsPlane, merge_metric_snapshots


class HashRouter:
    """Stable hash partitioning: CRC-32 of the key modulo the shard
    count. Deterministic across processes and restarts (never Python's
    salted `hash`), uniform for generic key populations."""

    def __init__(self, num_shards: int):
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        self.num_shards = num_shards

    def shard_of(self, key: str) -> int:
        return zlib.crc32(key.encode()) % self.num_shards

    def snapshot(self) -> Dict:
        return {"kind": "hash", "num_shards": self.num_shards}


class RangeRouter:
    """Contiguous key-range partitioning: `boundaries` are the N-1
    split points of an N-shard keyspace; shard i serves
    [boundaries[i-1], boundaries[i]). Ordered keyspaces (checkpoint
    shards, KV pages) stay shard-local per scan run — at the cost of
    skew when the workload concentrates on one range."""

    def __init__(self, boundaries: Sequence[str]):
        self.boundaries = sorted(boundaries)
        self.num_shards = len(self.boundaries) + 1

    def shard_of(self, key: str) -> int:
        return bisect.bisect_right(self.boundaries, key)

    def snapshot(self) -> Dict:
        return {"kind": "range", "num_shards": self.num_shards,
                "boundaries": list(self.boundaries)}


ShardRouter = Union[HashRouter, RangeRouter]


class ShardedStore:
    """Keyspace-partitioned `StoreFrontend` over N `InfiniStore` shards
    (see the module docstring for the design)."""

    def __init__(self, cfg: Optional[StoreConfig] = None, *,
                 num_shards: int = 4,
                 router: Union[str, ShardRouter] = "hash",
                 range_boundaries: Optional[Sequence[str]] = None,
                 clock: Optional[Clock] = None,
                 cos_root: Optional[str] = None, seed: int = 0):
        self.cfg = cfg = cfg if cfg is not None else StoreConfig()
        # every shard runs on this device; raises where it is absent
        # (the default "cuda" without a card), before any shard is built
        self.device = require_device(cfg.device)
        self.clock = clock or Clock()
        # ONE shared COS backend: the global persistence layer. Shards
        # receive it pre-built and never shut it down (_owns_cos=False).
        self.cos = COS(self.clock, visibility_lag=cfg.cos_visibility_lag,
                       root=cos_root)
        if isinstance(router, str):
            if router == "hash":
                router = HashRouter(num_shards)
            elif router == "range":
                if range_boundaries is None:
                    raise ValueError("router='range' needs range_boundaries")
                router = RangeRouter(range_boundaries)
            else:
                raise ValueError(f"unknown router {router!r}")
        self.router = router
        self.num_shards = router.num_shards
        # per-shard spill layout: <root>/shard-<i>/ — each journal is a
        # private failure domain. "auto" makes one private temp root
        # (reclaimed on graceful close, like the single-store auto mode).
        self._spill_auto = False
        self._spill_root = cfg.spill_dir
        if cfg.async_writeback and cfg.spill_dir == "auto":
            self._spill_root = tempfile.mkdtemp(
                prefix="infinistore-shards-")
            self._spill_auto = True
        self._seed = seed
        # deterministic fault plan (repro_torch.core.faults): shared COS gets
        # it here (shards never overwrite a COS they don't own); the
        # per-shard layers get it through cfg
        self.faults = cfg.faults
        if cfg.faults is not None:
            self.cos.faults = cfg.faults
        # observability plane (repro_torch.obs), resolved BEFORE the shards
        # are built: the front-end binds the root flight file first, so
        # in-process shards' own binds no-op (one file per crash
        # domain) while worker processes bind their shard directories.
        # ISTORE_METRICS_DUMP auto-attaches a plane like InfiniStore.
        if cfg.obs is None and os.environ.get("ISTORE_METRICS_DUMP"):
            cfg.obs = ObsPlane(name="frontend")
        self.obs = cfg.obs
        if self.obs is not None:
            if self._spill_root is not None:
                self.obs.bind_flight(
                    os.path.join(self._spill_root, "flight.bin"))
            if cfg.faults is not None:
                # leader-side fires mirror on the front-end's copy
                cfg.faults.obs = self.obs
        self.shards: List[InfiniStore] = [
            self._make_shard(i) for i in range(self.num_shards)]
        # leader decision journal (2PC in-doubt closure): the durable
        # commit decisions, one `decision/<ticket>` record per
        # cross-shard batch, retired once every participant resolved.
        # Journal-less deployments fall back to COS decision stubs.
        # NOT fault-instrumented: the dedicated "shard.decision" site
        # models decision loss without entangling shard spill schedules.
        self._tlock = make_lock("shard.ShardedStore._tlock")
        self._decisions: Dict[int, int] = {}     # ticket -> record seq
        self._inflight_tickets: set = set()
        self._decision_retry = RetryPolicy(
            max_attempts=6, backoff_base_s=0.005, backoff_cap_s=0.1,
            seed=seed)
        self._leader_spill: Optional[SpillJournal] = None
        if cfg.async_writeback and self._spill_root is not None:
            self._leader_spill = SpillJournal(
                os.path.join(self._spill_root, "leader"),
                fsync=cfg.spill_fsync, sync_each=False)
            for seq, key, _data in self._leader_spill.take_pending():
                if key.startswith("decision/"):
                    try:
                        self._decisions[int(key[len("decision/"):])] = seq
                        continue
                    except ValueError:
                        pass
                self._leader_spill.mark_persisted(seq)
        # leader side: commit tickets are one monotonic sequence across
        # the whole store (itertools.count: atomic under the GIL), and
        # cross-shard batches coordinate on a small leader pool so
        # put_many_async stays non-blocking for the caller. A rebuilt
        # store reseeds the sequence past every replayed decision and
        # in-doubt ticket — reusing a live ticket would supersede its
        # `prepared/<t>` journal record mid-doubt.
        maxt = max([0, *self._decisions,
                    *(t for s in self.shards
                      for t in self._shard_indoubt(s))])
        self._tickets = itertools.count(maxt + 1)
        self._leader = ThreadPoolExecutor(
            max_workers=max(2, min(8, self.num_shards)),
            thread_name_prefix="shard-leader")
        self._closed = False
        # restart-time sweep: no key may stay PENDING across a crash
        self.resolve_indoubt()

    # ------------------------------------------------------------------
    # shard lifecycle
    # ------------------------------------------------------------------

    def _shard_spill_dir(self, i: int) -> Optional[str]:
        if self._spill_root is None:
            return None
        return os.path.join(self._spill_root, f"shard-{i}")

    def _make_shard(self, i: int) -> InfiniStore:
        scfg = dataclasses.replace(self.cfg,
                                   spill_dir=self._shard_spill_dir(i))
        return InfiniStore(scfg, clock=self.clock, cos=self.cos,
                           seed=self._seed + i, name=f"s{i}")

    def restart_shard(self, i: int) -> InfiniStore:
        """Rebuild a (crashed) shard on its own spill journal: replays
        surviving metadata + pending writes exactly like a single-store
        daemon restart, while the other shards keep serving. Any 2PC
        batch the replay found in doubt is resolved against the
        leader's decisions before this returns."""
        if self.obs is not None:
            self.obs.event("shard.restart", shard=i)
        self.shards[i] = self._make_shard(i)
        self.resolve_indoubt()
        return self.shards[i]

    # ------------------------------------------------------------------
    # 2PC decision plane + in-doubt resolution
    # ------------------------------------------------------------------

    @staticmethod
    def _shard_indoubt(s: InfiniStore) -> List[int]:
        try:
            return s.indoubt_tickets()
        except Exception:                             # noqa: BLE001
            return []            # daemon dead: restart_shard re-sweeps

    def _record_decision(self, ticket: int) -> None:
        """DECISION DURABILITY POINT: once this returns, the batch can
        only ever commit — a restart-time resolver finding the record
        rolls every in-doubt participant forward. Registered before the
        sync so a failed sync can still retire the (possibly-landed)
        record before the batch aborts."""
        if self._leader_spill is not None:
            seq = self._leader_spill.append(f"decision/{ticket}",
                                            b"commit")
            with self._tlock:
                self._decisions[ticket] = seq
            self._leader_spill.sync()
            return
        # journal-less fallback: a COS stub. Weaker — subject to the
        # backend's visibility lag and injected faults like any PUT.
        self.cos.put(f"2pc/decision/{ticket}", b"commit")
        with self._tlock:
            self._decisions[ticket] = -1

    def _retire_decision(self, ticket: int) -> None:
        """Truncate a decision record every participant has resolved
        (or one being withdrawn because the batch aborts before any
        commit was submitted)."""
        with self._tlock:
            seq = self._decisions.pop(ticket, None)
        if seq is None:
            return
        if self._leader_spill is not None:
            self._leader_spill.mark_persisted(seq)
            try:
                self._leader_spill.sync()
            except Exception:                         # noqa: BLE001
                pass             # truncation retries on the next sync
        else:
            try:
                self.cos.delete(f"2pc/decision/{ticket}")
            except Exception:                         # noqa: BLE001
                pass             # stale stub: harmless, re-swept later

    def _decision(self, ticket: int) -> bool:
        """The leader's verdict for an in-doubt ticket: True = a durable
        commit decision exists (roll forward), False = none was ever
        recorded (presumed abort). Raises only on the stub path when COS
        stays unreadable through the retry budget — the sweep then skips
        the ticket and retries next round rather than mis-aborting."""
        with self._tlock:
            if ticket in self._decisions:
                return True
        if self._leader_spill is None:
            return self._decision_retry.run(
                lambda: self.cos.get(f"2pc/decision/{ticket}")) is not None
        return False

    def resolve_indoubt(self) -> Dict[int, str]:
        """Sweep every shard's in-doubt tickets (journal-replayed AND
        live prepared batches whose round 2 never arrived — leader
        death, commit-submission failure) and resolve each against the
        leader's durable decision. Returns {ticket: "commit"|"abort"}
        for everything resolved this round. Idempotent and safe to run
        any time: tickets of batches still in flight are skipped, and a
        shard whose daemon is down is picked up by `restart_shard`'s
        sweep. Decision records no participant still reports are
        retired at the end."""
        out: Dict[int, str] = {}
        all_answered = True
        for s in self.shards:
            try:
                tickets = s.indoubt_tickets()
            except Exception:                         # noqa: BLE001
                all_answered = False
                continue
            for t in tickets:
                with self._tlock:
                    if t in self._inflight_tickets:
                        continue
                try:
                    commit = self._decision(t)
                except Exception:                     # noqa: BLE001
                    all_answered = False
                    continue     # decision unreadable: retry next sweep
                try:
                    s.resolve_indoubt(t, commit=commit).result()
                except Exception:                     # noqa: BLE001
                    all_answered = False
                    continue
                out[t] = "commit" if commit else "abort"
                if self.obs is not None:
                    self.obs.event("2pc.indoubt_resolved",
                                   ticket=t, decision=out[t])
        with self._tlock:
            candidates = [t for t in self._decisions
                          if t not in self._inflight_tickets]
        if candidates and all_answered:
            remaining: set = set()
            for s in self.shards:
                remaining.update(self._shard_indoubt(s))
            for t in candidates:
                if t not in remaining:
                    self._retire_decision(t)
        return out

    def indoubt_tickets(self) -> List[int]:
        """Union of every shard's unresolved prepared tickets."""
        out: set = set()
        for s in self.shards:
            out.update(self._shard_indoubt(s))
        return sorted(out)

    def simulate_crash(self, shard: Optional[int] = None):
        """Kill one shard's daemon mid-flight (`shard=i`) — its journal
        segments survive for `restart_shard(i)`, every other shard keeps
        serving — or the whole store (`shard=None`), returning the spill
        root a rebuilt `ShardedStore` would replay from."""
        if shard is not None:
            return self.shards[shard].simulate_crash()
        for s in self.shards:
            s.simulate_crash()
        self._leader.shutdown(wait=False, cancel_futures=True)
        if self._leader_spill is not None:
            # hard close: only synced decision records survive — the
            # same SIGKILL contract as the shard journals
            self._leader_spill.close(reclaim=False, hard=True)
        self.cos.shutdown()
        self._closed = True
        return self._spill_root

    def close(self, *, flush: bool = True) -> bool:
        """Close every shard (drain daemons, flush writebacks), then the
        leader pool and the shared COS. False if any shard left writes
        unpersisted."""
        if self._closed:
            return True
        self._closed = True
        self._leader.shutdown(wait=True)      # in-flight batches first
        self.resolve_indoubt()                # no ticket left PENDING
        oks = [s.close(flush=flush) for s in self.shards]
        if self._leader_spill is not None:
            self._leader_spill.close()
        self.cos.shutdown()
        if self._spill_auto:
            shutil.rmtree(self._spill_root, ignore_errors=True)
        return all(oks)

    # ------------------------------------------------------------------
    # routing + scatter/join plumbing
    # ------------------------------------------------------------------

    def _shard(self, key: str) -> InfiniStore:
        return self.shards[self.router.shard_of(key)]

    def _scatter(self, keys) -> Dict[int, List[str]]:
        groups: Dict[int, List[str]] = {}
        for k in keys:
            groups.setdefault(self.router.shard_of(k), []).append(k)
        return groups

    @staticmethod
    def _join(futs: List[StoreFuture]) -> StoreFuture:
        """Join per-shard dict futures into one: merge results, first
        exception wins. Callbacks run on the shard daemons; the merge
        is locked, the resolve happens exactly once."""
        out = StoreFuture()
        if not futs:
            out._resolve({})
            return out
        merged: Dict = {}
        lock = make_lock("shard.ShardedStore._join.lock")
        remaining = [len(futs)]

        def on_done(f):
            with lock:
                if out.done():
                    return
                err = f.exception()
                if err is not None:
                    out.set_exception(err)
                    return
                # lint: allow(blocking-under-lock): future is already done inside its own done-callback; result() cannot block
                merged.update(f.result())
                remaining[0] -= 1
                if remaining[0] == 0:
                    out._resolve(merged)

        for f in futs:
            f.add_done_callback(on_done)
        return out

    # ------------------------------------------------------------------
    # single-key API (pure delegation)
    # ------------------------------------------------------------------

    def put(self, key: str, value) -> int:
        return self._shard(key).put(key, value)

    def put_async(self, key: str, value) -> StoreFuture:
        return self._shard(key).put_async(key, value)

    def get(self, key: str):
        return self._shard(key).get(key)

    def get_async(self, key: str) -> StoreFuture:
        return self._shard(key).get_async(key)

    def get_array(self, key: str) -> Optional[torch.Tensor]:
        return self._shard(key).get_array(key)

    # ------------------------------------------------------------------
    # batched GET (scatter / join)
    # ------------------------------------------------------------------

    def get_many_async(self, keys) -> StoreFuture:
        groups = self._scatter(dict.fromkeys(keys))
        obs = self.obs
        with (obs.span("client.get_many", shards=len(groups))
              if obs is not None else NOOP_CM):
            return self._join([self.shards[sid].get_many_async(sub)
                               for sid, sub in groups.items()])

    def get_many(self, keys) -> Dict[str, Optional[bytes]]:
        return self.get_many_async(keys).result()

    def get_many_arrays_async(self, keys) -> StoreFuture:
        groups = self._scatter(dict.fromkeys(keys))
        return self._join([self.shards[sid].get_many_arrays_async(sub)
                           for sid, sub in groups.items()])

    def get_many_arrays(self, keys) -> Dict[str, Optional[torch.Tensor]]:
        return self.get_many_arrays_async(keys).result()

    # ------------------------------------------------------------------
    # batched PUT (leader-sequenced two-round cross-shard commit)
    # ------------------------------------------------------------------

    def put_many(self, items, *, raise_on_conflict: bool = False
                 ) -> Dict[str, int]:
        return self.put_many_async(
            items, raise_on_conflict=raise_on_conflict).result()

    def put_many_async(self, items, *, raise_on_conflict: bool = False
                       ) -> StoreFuture:
        """Batch PUT across shards. A single-shard batch delegates to
        that shard's one-CAS-round fast path; a cross-shard batch runs
        the two-round protocol: per-shard CAS prepare (versions stay
        PENDING/invisible), then a leader commit ticket finalizes every
        shard — or, if any shard failed to prepare, every prepared
        shard aborts. A prepare-stage failure is therefore never
        half-visible: readers observe either no key or every key of
        the batch (per-key CAS conflicts keep the single-store
        contract: -1 for just that key, or `ConcurrentPutError`
        aborting the whole batch when raise_on_conflict). A failure
        inside the COMMIT round — after the leader's decision became
        durable — leaves the affected shards IN DOUBT, never
        half-aborted: the error propagates (the batch is un-acked),
        and the `resolve_indoubt` sweep rolls every in-doubt shard
        forward per the durable decision, so the batch converges to
        fully-committed (see the module docstring's in-doubt
        contract)."""
        items = list(items.items()) if isinstance(items, dict) \
            else list(items)
        if len({k for k, _ in items}) != len(items):
            raise ValueError("duplicate keys in put_many batch")
        groups: Dict[int, List] = {}
        for k, v in items:
            groups.setdefault(self.router.shard_of(k), []).append((k, v))
        obs = self.obs
        with (obs.span("client.put_many", n=len(items),
                       shards=len(groups))
              if obs is not None else NOOP_CM):
            if len(groups) == 1:
                # single-shard fast path: the shard's own put_many_async
                # captures payloads at submission (snapshot copy
                # in-process, arena copy over IPC) — snapshotting here
                # too would be a second full memcpy of the batch
                sid = next(iter(groups))
                return self.shards[sid].put_many_async(
                    groups[sid], raise_on_conflict=raise_on_conflict)
            # cross-shard: the leader thread touches payloads AFTER this
            # returns, so mutable buffers must be snapshotted NOW — the
            # caller may reuse them the moment this returns
            groups = {sid: [(k, InfiniStore._snapshot_value(v))
                            for k, v in sub]
                      for sid, sub in groups.items()}
            fut = StoreFuture()
            # executor hop: carry the client span's context onto the
            # leader thread so the 2PC span stitches under it
            self._leader.submit(
                obs.bind_current(self._cross_shard_put)
                if obs is not None else self._cross_shard_put,
                groups, raise_on_conflict, fut)
            return fut

    def _cross_shard_put(self, groups: Dict[int, List],
                         raise_on_conflict: bool, fut: StoreFuture) -> None:
        try:
            fut._resolve(self._cross_shard_put_impl(groups,
                                                    raise_on_conflict))
        except BaseException as e:                    # noqa: BLE001
            fut.set_exception(e)

    def _cross_shard_put_impl(self, groups: Dict[int, List],
                              raise_on_conflict: bool) -> Dict[str, int]:
        # the leader ticket is issued FIRST: round 1 journals it into
        # each shard's durable `prepared/<ticket>` record, which is what
        # a crashed shard replays to know the batch was in doubt
        ticket = next(self._tickets)
        with self._tlock:
            self._inflight_tickets.add(ticket)
        obs = self.obs
        try:
            with (obs.span("leader.2pc", ticket=ticket,
                           shards=len(groups))
                  if obs is not None else NOOP_CM):
                return self._cross_shard_rounds(ticket, groups,
                                                raise_on_conflict)
        finally:
            with self._tlock:
                self._inflight_tickets.discard(ticket)

    def _cross_shard_rounds(self, ticket: int, groups: Dict[int, List],
                            raise_on_conflict: bool) -> Dict[str, int]:
        # round 1: prepare on every touched shard, in parallel on the
        # shard daemons. A shard that cannot prepare (daemon dead, CAS
        # conflict under raise_on_conflict, encode/placement failure)
        # fails the whole batch.
        prep_futs: Dict[int, StoreFuture] = {}
        errors: List[BaseException] = []
        for sid, sub in groups.items():
            try:
                prep_futs[sid] = self.shards[sid].prepare_put_many_async(
                    sub, raise_on_conflict=raise_on_conflict,
                    ticket=ticket)
            except BaseException as e:                # noqa: BLE001
                errors.append(e)                      # dead daemon
        preps: Dict[int, object] = {}
        for sid, pf in prep_futs.items():
            try:
                preps[sid] = pf.result()
            except BaseException as e:                # noqa: BLE001
                errors.append(e)
        if errors:
            # round 2 (abort): no shard may expose its sub-batch. No
            # decision was recorded, so a shard that dies before its
            # abort lands resolves by presumed abort at restart.
            for sid, prep in preps.items():
                try:
                    self.shards[sid].abort_put_many_async(prep).result()
                except BaseException:                 # noqa: BLE001
                    pass         # aborting a shard that died meanwhile
            raise errors[0]
        # decision point: make the commit decision durable BEFORE any
        # shard is told to commit. Fails closed — a leader death (or
        # journal failure) here aborts the still-PENDING batch
        # everywhere, matching what a restart-time resolver would
        # presume for a ticket with no decision record.
        try:
            if self.faults is not None:
                self.faults.fire("shard.decision", str(ticket))
            self._record_decision(ticket)
        except BaseException:
            self._retire_decision(ticket)
            for sid, prep in preps.items():
                try:
                    self.shards[sid].abort_put_many_async(prep).result()
                except BaseException:                 # noqa: BLE001
                    pass
            raise
        # the decision is durable: from here the batch can ONLY commit.
        # An injected leader death leaves every prepared shard in doubt
        # — the resolve_indoubt sweep rolls them all forward.
        if self.faults is not None:
            self.faults.fire("shard.leader_death", str(ticket))
        # round 2 (commit): shards stamp the ticket into their journaled
        # metadata records. Commit is submitted to EVERY prepared shard
        # even if one submission fails — skipping a live shard would
        # strand its prepared heads; a shard whose submission failed (or
        # that died mid-commit) stays in doubt and is rolled forward by
        # the sweep against the durable decision.
        out: Dict[str, int] = {}
        commit_errs: List[BaseException] = []
        commits = []
        for sid, prep in preps.items():
            try:
                if self.faults is not None:
                    self.faults.fire("shard.commit_submit", str(sid))
                commits.append(self.shards[sid].commit_put_many_async(
                    prep, ticket=ticket))
            except BaseException as e:                # noqa: BLE001
                commit_errs.append(e)                 # in doubt: swept
        for cf in commits:
            try:
                out.update(cf.result())
            except BaseException as e:                # noqa: BLE001
                # ticketed commits never abort on failure — the shard
                # stays registered in doubt and the sweep retries the
                # idempotent commit, converging forward
                commit_errs.append(e)
        if commit_errs:
            raise commit_errs[0]
        # every participant committed: the decision has no readers left
        self._retire_decision(ticket)
        return out

    # ------------------------------------------------------------------
    # maintenance fan-out
    # ------------------------------------------------------------------

    def flush_writeback(self, timeout: Optional[float] = None) -> bool:
        """Barrier across every shard's writeback queue. The timeout is
        a SHARED deadline — each shard gets what remains of it, so the
        call honors the caller's bound instead of num_shards x timeout."""
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        ok = True
        for s in self.shards:
            remaining = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            ok = s.flush_writeback(timeout=remaining) and ok
        return ok

    def gc_tick(self) -> None:
        # the maintenance tick doubles as the in-doubt retry point:
        # tickets stranded by a leader death or a failed commit
        # submission converge here without waiting for a restart
        self.resolve_indoubt()
        for s in self.shards:
            s.gc_tick()

    def pause_writeback(self) -> None:
        """Hold every shard's COS writes in-queue (tests/benchmarks)."""
        for s in self.shards:
            s.pause_writeback()

    def resume_writeback(self) -> None:
        for s in self.shards:
            s.resume_writeback()

    def cos_keys(self, prefix: str = "") -> List[str]:
        keys = set()
        for s in self.shards:
            keys.update(s.cos_keys(prefix))
        return sorted(keys)

    def num_functions(self, state=None) -> int:
        return sum(s.num_functions(state) for s in self.shards)

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------

    @property
    def stats(self) -> StoreStats:
        """Aggregate of every shard's counters. Each underlying read is
        atomic; the aggregate is NOT a consistent cut across shards or
        counters (see StoreStats). The sums are seeded directly — the
        aggregate is a fresh snapshot object, not a live multi-writer
        counter, so no atomic increments are needed."""
        snaps = self.stats_per_shard()      # ONE snapshot per shard
        return StoreStats(**{
            f: sum(snap[f] for snap in snaps) for f in _STAT_FIELDS})

    def stats_per_shard(self) -> List[Dict[str, int]]:
        return [s.stats.as_dict() for s in self.shards]

    def shard_balance(self) -> List[int]:
        """Distinct object keys (metadata heads) per shard — the
        router-quality histogram."""
        return [s.balance_count() for s in self.shards]

    def tickets_issued(self) -> int:
        """Cross-shard commit tickets handed out so far."""
        return self._tickets.__reduce__()[1][0] - 1

    def ledger_dollars(self) -> Dict[str, float]:
        """Summed cost breakdown across shards."""
        out: Dict[str, float] = {}
        for s in self.shards:
            for k, v in s.ledger_dollars().items():
                out[k] = out.get(k, 0.0) + v
        return out

    def snapshot_metadata(self):
        """Aggregated snapshot: router + balance histogram + per-shard
        breakdowns. Same consistency model as the per-shard snapshot —
        atomic counter reads, no global cut."""
        shards = [s.snapshot_metadata() for s in self.shards]
        states = {s["health"]["state"] for s in shards}
        with self._tlock:
            decisions = sorted(self._decisions)
        # ONE aggregated counter snapshot: every derived ratio below
        # comes from this dict, not from fresh per-ratio counter reads
        # (see StoreStats.derived)
        stats = self.stats.as_dict()
        return {"router": self.router.snapshot(),
                "num_shards": self.num_shards,
                "balance": self.shard_balance(),
                "commit_tickets_issued": self.tickets_issued(),
                "health": {
                    # a dead shard dominates; else degraded if ANY
                    # shard's writeback is degraded
                    "state": "SHARD_DOWN" if "SHARD_DOWN" in states
                    else "DEGRADED_WRITEBACK"
                    if "DEGRADED_WRITEBACK" in states else "OK",
                    "shard_states": sorted(states),
                    "indoubt_tickets": self.indoubt_tickets(),
                    "decisions_held": decisions,
                    # process/tcp frontends overlay per-shard transport
                    # health (state/epoch/heartbeat age); None for
                    # in-process shards
                    "shard_transports": [
                        s["health"].get("transport") for s in shards]},
                "stats": stats,
                "derived": StoreStats.derived(stats),
                "shards": shards}

    # ------------------------------------------------------------------
    # unified metrics export (repro_torch.obs)
    # ------------------------------------------------------------------

    def _shard_metric_snapshots(self) -> List[Dict]:
        """Plane snapshots beyond the front-end's own. In-process
        shards SHARE the front-end plane (their spans and histogram
        samples are already in its snapshot), so there is nothing extra
        here; the process host overrides this with one RPC-collected
        snapshot per worker."""
        return []

    def transport_metrics(self) -> Dict:
        """Per-shard transport counters + summed totals. In-process
        shards have no transport; the process host overlays heartbeat
        health and the TCP fencing counters (stale_acks_suppressed,
        dup_frames_dropped, fenced_connects, stale_frames_dropped,
        reconnects)."""
        return {"per_shard": [], "totals": {}}

    def snapshot_metrics(self) -> Dict:
        """Store-wide unified observability export: the front-end
        plane's snapshot merged with every worker process's (histograms
        sum bucket-wise; spans stitch by trace id; flight events and
        forensics concatenate), plus the aggregated store counters and
        the transport section."""
        snaps = []
        if self.obs is not None:
            snaps.append(self.obs.snapshot())
        snaps.extend(self._shard_metric_snapshots())
        merged = merge_metric_snapshots(snaps)
        merged["counters"] = self.stats.as_dict()
        merged["transport"] = self.transport_metrics()
        return merged

    def dump_metrics(self, path: str) -> str:
        """Write `snapshot_metrics()` to `path` — Prometheus text, or
        JSON when the path ends in `.json`. Returns the path."""
        from repro_torch.obs.metrics import dump_json, to_prometheus
        snap = self.snapshot_metrics()
        if path.endswith(".json"):
            dump_json(snap, path)
        else:
            with open(path, "w") as f:
                f.write(to_prometheus(snap))
        return path
