"""InfiniStore facade: an async, futures-based GET/PUT client API over
the SMS + COS layers (paper §5).

The client surface is non-blocking: `put_async` / `get_async` (and the
batched `put_many_async` / `get_many_async`) return a `StoreFuture`
(result / exception / done-callback; PUT futures carry the committed
version). The classic `put` / `get` / `put_many` / `get_many` are thin
blocking wrappers over the same path. All store mutation runs on one
internal client-daemon thread, so queued requests pipeline in submission
order and the data structures never see concurrent writers.

Ack point + durability contract (§5.3.2): a PUT acknowledges once every
fragment's chunks sit in SMS slabs AND the fragment sits in the
persistent buffer with its insertion-log node persisted — COS chunk
persistence is OFF the critical path, drained in the background by the
`WritebackQueue` (writer thread + `gc_tick`, bounded depth, retry with
backoff, `flush()` barrier). Until a chunk lands in COS, reads and
recovery are served from the persistent buffer / pending-writeback map,
so an instance failure between ack and persistence loses nothing.
`StoreConfig(async_writeback=False)` restores the legacy inline-COS ack
path (the benchmark baseline).

The durability contract also survives the DAEMON: every enqueued write
(and each PUT's committed metadata) is appended to a crash-consistent
local spill journal (`repro_torch.core.spill`) before the ack, and a store
rebuilt on the same `StoreConfig(spill_dir=...)` replays surviving
records on construction — metadata is restored, pending writes re-enter
the queue, and post-restart GETs / instance recovery serve them exactly
like live pending data. `spill_dir=None` restores the memory-only
pending map; `simulate_crash()` is the kill half of the kill/restart
tests.

Payloads follow the `Payload` protocol: `bytes`, numpy arrays, or
torch tensors are fragmented as flat uint8 views. The store lives on one
device (`StoreConfig(device="cuda")` by default): its codec buffers and
SMS slab chunks are uint8 tensors there and every GF(256) product is the
hand-written Hopper kernel's. A host payload crosses to the device once,
inside the codec; the spill journal and COS hold host bytes, copied
device-to-host explicitly (the journal before the ack, COS on the
writeback thread). `get` / `get_many` return bytes; `get_array` /
`get_many_arrays` return uint8 tensors on the store's device. All
threads (client daemon, writeback writer, GET I/O executor) use the
default CUDA stream, so their device work is ordered by that stream and
by the synchronising device-to-host copies.

GET is a pipeline (§5.3.3 + readahead): one grouped SMS sweep per batch
(at most one invoke per function), then every still-short fragment's
missing chunks fan out to COS concurrently on a bounded I/O executor
while fragments decode in ready-order `decode_many` batches — decode of
fragment A overlaps the gather of fragment B. Degraded-bucket compaction
migrates from `gc_tick`, off the read critical path. A sequential-scan
prefetcher (`repro_torch.core.prefetch`) watches the object-key stream and
warms the predicted next objects' chunks into bucket cache space during
decode (checkpoint shard restore and KV page restore both scan ordered
trailing-index keys). `StoreConfig(pipelined_get=False)` restores the
legacy serial gather -> barrier -> decode path for A/B comparison.

Also wired through: CAS versioning with multi-key batch commit (one
leader-sequenced metadata round per `put_many`), RS erasure coding,
PlaceChunk over the sliding-window GC-buckets, insertion logs, failure
detection + local/parallel recovery, demand caching, compaction,
large-object fragmentation, grouped per-function invokes on BOTH the
PUT and GET data paths, the two-queue scheme, and pay-per-access cost
accounting.
"""
from __future__ import annotations

import itertools
import json
import logging
import os
import shutil
import tempfile
import threading
import time
from concurrent.futures import (FIRST_COMPLETED, Future,
                                ThreadPoolExecutor, wait)
from dataclasses import dataclass, field
from typing import (Dict, List, Optional, Protocol, Sequence, Set, Tuple,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch.core.clock import Clock
from repro_torch.core.cos import COS
from repro_torch.core.costmodel import CostLedger
from repro_torch.core.ec import ECConfig, RSCodec
from repro_torch.core.faults import (FaultPlan, OpDeadlineExceeded, RetryPolicy)
from repro_torch.core.gc_window import BucketState, GCConfig, SlidingWindow
from repro_torch.core.insertion_log import InsertionLog, Piggyback, PutRecord
from repro_torch.core.locks import make_rlock
from repro_torch.core.payload import (as_u8, host_u8, is_array_payload,
                                      needs_snapshot, payload_nbytes,
                                      require_device, to_bytes, to_device,
                                      to_host)
from repro_torch.core.placement import PlacementManager
from repro_torch.core.prefetch import PrefetchConfig, SequentialPrefetcher
from repro_torch.core.recovery import RecoveryManager
from repro_torch.core.sms import SMS
from repro_torch.core.spill import SpillJournal
from repro_torch.core.versioning import Meta, MetadataTable, PersistentBuffer
from repro_torch.core.writeback import StoreFuture, WritebackQueue
from repro_torch.obs import NOOP_CM, ObsPlane, to_prometheus
from repro_torch.obs.metrics import dump_json

MB = 1024 * 1024

_LOG = logging.getLogger("repro_torch.core.store")

# sentinel seq for a metadata record whose durable copy lives inside the
# journal's `metasnap` snapshot rather than an individual `meta/` frame
_SNAP_COVERED = -1


@dataclass
class StoreConfig:
    ec: ECConfig = field(default_factory=ECConfig)       # RS(10+2)
    # where payload chunks, slabs and the codec live; "cpu" runs the
    # plain PyTorch GF(256) product (tests), "cuda" the Hopper kernel
    device: str = "cuda"
    function_capacity: int = 1536 * MB                   # Lambda memory
    fragment_bytes: int = 200 * MB                       # §5.3.4
    small_request_bytes: int = 1 * MB                    # two-queue split
    gc: GCConfig = field(default_factory=GCConfig)
    num_recovery_functions: int = 20
    enable_recovery: bool = True       # False = SNR ablation (Fig. 22/23)
    provider_idle_reclaim: float = 3600.0                # FaaS reclamation
    cos_visibility_lag: float = 0.0
    autoscale: str = "linear"
    # estimated per-request function busy time model (seconds/byte + base),
    # calibrated to the paper's ~75 MB/s per-instance bandwidth
    busy_base_s: float = 0.001
    busy_per_byte_s: float = 1.0 / (75 * MB)
    # ---- async writeback (§5.3.2) --------------------------------------
    # True: PUT acks after SMS slabs + persistent buffer + insertion log;
    # COS chunk writes drain in the background. False: legacy inline COS
    # writes on the ack path (benchmark baseline / strict-persist mode).
    async_writeback: bool = True
    writeback_depth: int = 512         # queue bound (backpressure)
    writeback_retries: int = 8
    writeback_backoff_s: float = 0.005
    # consecutive transient COS failures before the writeback queue
    # declares an outage and enters DEGRADED_WRITEBACK (retry budgets
    # freeze, producers feel backpressure, reads keep serving from the
    # pending map / spill journal; see repro_torch.core.writeback)
    writeback_degraded_after: int = 12
    # ---- unified retry policy (repro_torch.core.faults) ----------------------
    # demand COS reads retry transient/throttle errors and eventual-
    # consistency misses up to cos_retries attempts; an optional per-op
    # deadline turns an exhausted budget into OpDeadlineExceeded
    # surfaced through the GET's StoreFuture instead of a silent miss
    cos_retries: int = 16
    cos_op_deadline_s: Optional[float] = None
    # ---- deterministic fault injection (repro_torch.core.faults) -------------
    # an optional FaultPlan threaded through COS, SMS slabs, the spill
    # journal, and the writeback writer; None (default) keeps every
    # instrumented site a single attribute check
    faults: Optional[FaultPlan] = None
    # ---- observability plane (repro_torch.obs) -------------------------------
    # an optional ObsPlane threaded through the same layers as `faults`
    # (client daemon, writeback writer, GET I/O executor, spill journal,
    # and across the shard transports so worker-process spans stitch
    # into the frontend's trace); None (default) keeps every
    # instrumented site a single attribute check
    obs: Optional[ObsPlane] = None
    # ---- crash-consistent writeback spill (§5.3.2 durability) ----------
    # The durable half of the persistent buffer: enqueued writes are
    # journaled to an append-only, CRC-framed, segment-rotated local log
    # BEFORE the PUT acks, and replayed into the queue when a store is
    # rebuilt on the same directory after a daemon crash/restart.
    # "auto" = private tempdir (journaling on, restart resume opted out);
    # a path = durable across restarts; None = the pre-journal in-memory
    # pending map (A/B baseline). Only meaningful with async_writeback.
    spill_dir: Optional[str] = "auto"
    spill_segment_bytes: int = 64 * MB
    spill_fsync: bool = False          # True: machine-crash durability
    # size-bounded metadata log: once this many superseded-able metadata
    # records (individual `meta/` frames + tombstones) accumulate in the
    # journal, gc_tick snapshots the whole journaled metadata table into
    # ONE `metasnap` record at a fresh journal generation (forced
    # segment rotation) and truncates everything the snapshot covers —
    # replay work for a long-lived daemon is capped at one snapshot plus
    # the post-snapshot tail instead of growing with PUT history. 0
    # disables snapshotting (the PR-4 retain-until-superseded baseline).
    spill_meta_snapshot_records: int = 1024
    # temporary recovery placements (cache_put into the recovery group,
    # §5.5.2) expire this many seconds after the session completes
    recovery_retain_seconds: float = 60.0
    # ---- pipelined GET (§5.3.3 + readahead) ----------------------------
    # True: grouped SMS reads, then COS demand reads fan out concurrently
    # on a bounded I/O executor while fragments decode in ready-order
    # batches; compaction migration drains from gc_tick. False: the
    # legacy serial gather -> barrier -> decode path (A/B baseline).
    pipelined_get: bool = True
    get_io_workers: int = 8            # COS fallback / prefetch fan-out
    decode_batch_fragments: int = 4    # fragments per ready-order decode
    # sequential-scan readahead: after `prefetch_min_run` consecutive
    # trailing-index keys, the next `prefetch_depth` objects' missing
    # chunks are warmed into bucket cache space during decode
    prefetch: bool = True
    prefetch_min_run: int = 3
    prefetch_depth: int = 2
    prefetch_max_inflight: int = 64    # warm fetches in flight at once


class AtomicCounter:
    """Lock-free monotonic counter that is safe under concurrent
    writers in CPython: `add` advances an `itertools.count` — each step
    is one C call, atomic under the GIL, so increments from any number
    of threads never lose updates — and `value` snapshots the iterator
    state via `__reduce__` (also a single C call) without consuming a
    tick."""
    __slots__ = ("_c",)

    def __init__(self, start: int = 0):
        self._c = itertools.count(start)

    def add(self, n: int = 1) -> None:
        if n == 1:
            next(self._c)
        else:
            # n is small (chunks per fragment / items per sweep); each
            # step is individually atomic, so concurrent adders
            # interleave without losing increments
            for _ in range(n):
                next(self._c)

    @property
    def value(self) -> int:
        return self._c.__reduce__()[1][0]


class _Stat:
    """Counter field of `StoreStats`: reads return the plain int value;
    assignment RESEEDS the counter (single-writer sites only — the
    prefetch mirror and stats aggregation)."""
    __slots__ = ("attr",)

    def __set_name__(self, owner, name) -> None:
        self.attr = "_" + name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return getattr(obj, self.attr).value

    def __set__(self, obj, value) -> None:
        setattr(obj, self.attr, AtomicCounter(int(value)))


_STAT_FIELDS = (
    "puts",
    "gets",
    "sms_chunk_hits",
    "sms_chunk_misses",
    "buffer_hits",
    "migrations",
    "compactions",
    "degraded_hits",
    "small_requests",
    "large_requests",
    "cas_rounds",             # multi-key CAS: metadata rounds issued
    "gather_invokes",         # GET-side grouped per-function invokes
    "array_payload_puts",     # PUTs that arrived as array payloads
    "prefetch_hits",          # warmed chunks consumed by a GET
    "prefetch_wasted",        # warmed chunks dropped unconsumed
    "cos_fallback_reads",     # demand chunk reads sent to COS
    "decode_batches",         # ready-order decode_many calls
    "spill_replayed_writes",  # journal records re-enqueued at open
    "spill_replayed_metas",   # metadata records restored at open
    "spill_meta_snapshots",   # metadata-table snapshots journaled
    "commit_tickets",         # leader-sequenced cross-shard commits
    "writeback_permanent_failures",   # mirror of queue data-at-risk count
    "indoubt_resolved",       # prepared 2PC batches rolled forward/back
)


class StoreStats:
    """Store counters, every field an `AtomicCounter`.

    Consistency model: each counter is individually atomic and
    monotonic — increments come from the client-daemon thread, the
    writeback writer, and GET I/O workers WITHOUT the store lock, and
    none are lost. Reads (attribute access, `snapshot_metadata()`, the
    sharded aggregation) are per-counter atomic but NOT a consistent
    cut across counters: a reader racing a PUT may observe `puts`
    already bumped while `cas_rounds` is not yet. Derived ratios are
    therefore approximate while traffic is in flight and exact once the
    store is quiescent."""

    for _f in _STAT_FIELDS:
        locals()[_f] = _Stat()
    del _f

    def __init__(self, **kw):
        for f in _STAT_FIELDS:
            setattr(self, f, kw.pop(f, 0))
        if kw:
            raise TypeError(f"unknown StoreStats fields: {sorted(kw)}")

    def inc(self, name: str, n: int = 1) -> None:
        """Atomically add `n` to one counter (lock-free, multi-writer
        safe — see the class docstring)."""
        getattr(self, "_" + name).add(n)

    def as_dict(self) -> Dict[str, int]:
        return {f: getattr(self, f) for f in _STAT_FIELDS}

    def __repr__(self) -> str:
        body = ", ".join(f"{f}={getattr(self, f)}" for f in _STAT_FIELDS)
        return f"StoreStats({body})"

    @property
    def hit_ratio(self) -> float:
        return self.derived(self.as_dict())["hit_ratio"]

    @staticmethod
    def derived(snap: Dict[str, int]) -> Dict[str, float]:
        """Ratios computed from ONE `as_dict()` snapshot, so each
        numerator/denominator pair comes from the same read pass.
        Reading the live counters once per ratio (the old pattern) let
        in-flight traffic skew a ratio's own terms against each other;
        a single snapshot keeps every reported ratio internally
        consistent (still approximate vs other counters — see the class
        docstring's consistency model)."""
        hits, misses = snap["sms_chunk_hits"], snap["sms_chunk_misses"]
        tot = hits + misses
        warmed = snap["prefetch_hits"] + snap["prefetch_wasted"]
        gets = snap["gets"]
        return {"hit_ratio": hits / tot if tot else 0.0,
                "prefetch_efficiency":
                    snap["prefetch_hits"] / warmed if warmed else 0.0,
                "cos_fallback_per_get":
                    snap["cos_fallback_reads"] / gets if gets else 0.0,
                "decode_batches_per_get":
                    snap["decode_batches"] / gets if gets else 0.0}


@dataclass
class _PreparedBatch:
    """Round-1 state of a (possibly cross-shard) PUT batch: everything
    `_put_many_prepare` installed, for `_put_many_commit` to finalize or
    `_put_many_abort` to roll back. Opaque to callers."""
    raise_on_conflict: bool = False
    conflicted: List[str] = field(default_factory=list)
    # (key, value, candidate Meta) CAS-installed as PENDING heads
    installed: List[Tuple[str, object, object]] = field(default_factory=list)
    # (key, candidate Meta, version, fragment keys)
    metas: List[Tuple[str, object, int, List[str]]] = \
        field(default_factory=list)
    failed: Set[str] = field(default_factory=set)  # fragments that failed
    resolved: bool = False            # committed or aborted
    # cross-shard batches only: the leader ticket this batch was prepared
    # under, and the journal seq of its durable `prepared/<ticket>`
    # record (truncated when the batch resolves)
    ticket: Optional[int] = None
    prepared_seq: Optional[int] = None
    # objs ("key|ver") whose commit-side finalization fully ran — a
    # RETRIED ticketed commit (in-doubt roll-forward after a journal
    # error) skips them instead of double-releasing buffer refs
    committed: Set[str] = field(default_factory=set)


@runtime_checkable
class StoreFrontend(Protocol):
    """The client-facing store surface shared by the singleton
    `InfiniStore` and the keyspace-partitioned `ShardedStore`
    (`repro_torch.core.shard`). Anything program-level — checkpointing, KV
    eviction, benchmarks — should accept this protocol rather than a
    concrete store so it runs unchanged on one daemon or many."""

    def put(self, key: str, value) -> int: ...
    def put_async(self, key: str, value) -> StoreFuture: ...
    def put_many(self, items, *, raise_on_conflict: bool = False
                 ) -> Dict[str, int]: ...
    def put_many_async(self, items, *, raise_on_conflict: bool = False
                       ) -> StoreFuture: ...
    def get(self, key: str) -> Optional[bytes]: ...
    def get_async(self, key: str) -> StoreFuture: ...
    def get_many(self, keys) -> Dict[str, Optional[bytes]]: ...
    def get_many_async(self, keys) -> StoreFuture: ...
    def get_array(self, key: str) -> Optional[torch.Tensor]: ...
    def get_many_arrays(self, keys) -> Dict[str, Optional[torch.Tensor]]: ...
    def get_many_arrays_async(self, keys) -> StoreFuture: ...
    def flush_writeback(self, timeout: Optional[float] = None) -> bool: ...
    def close(self, *, flush: bool = True) -> bool: ...
    def gc_tick(self) -> None: ...
    def cos_keys(self, prefix: str = "") -> List[str]: ...
    def snapshot_metadata(self): ...
    def snapshot_metrics(self) -> Dict: ...


class InfiniStore:
    def __init__(self, cfg: Optional[StoreConfig] = None, *,
                 clock: Optional[Clock] = None,
                 cos_root: Optional[str] = None, seed: int = 0,
                 cos: Optional[COS] = None, name: str = ""):
        # NOTE: cfg default must be constructed per-instance — a dataclass
        # default in the signature would be shared (and cross-mutated)
        # between every default-constructed store.
        self.cfg = cfg = cfg if cfg is not None else StoreConfig()
        # raises where the configured device is absent (the default
        # "cuda" on a machine without a card): never a silent CPU run
        self.device = require_device(cfg.device)
        self.clock = clock or Clock()
        # `name` tags this store's threads (and nothing else) so a
        # multi-shard deployment is debuggable; `cos` shares one COS
        # backend between shards — a store that did not construct its
        # COS must not shut it down either (the front-end owns it)
        self.name = name
        tag = f"-{name}" if name else ""
        self._owns_cos = cos is None
        self.cos = cos if cos is not None else \
            COS(self.clock, visibility_lag=cfg.cos_visibility_lag,
                root=cos_root)
        if cfg.faults is not None and self._owns_cos:
            # a shared (front-end-owned) COS gets its plan from the
            # front-end, not from each shard
            self.cos.faults = cfg.faults
        self.sms = SMS(self.clock)
        self.sms.faults = cfg.faults
        # unified transient/throttle retry policy for demand COS reads
        # (also handed to the recovery manager's chunk downloads)
        self.cos_retry = RetryPolicy(
            max_attempts=max(1, cfg.cos_retries),
            backoff_base_s=max(cfg.cos_visibility_lag / 8.0, 1e-3),
            backoff_cap_s=max(cfg.cos_visibility_lag, 0.05),
            seed=seed)
        self.window = SlidingWindow(cfg.gc, self.clock)
        self.codec = RSCodec(cfg.ec, device=self.device)
        self.mt = MetadataTable()
        self.pb = PersistentBuffer()
        self.logs: Dict[int, InsertionLog] = {}
        self.ledger = CostLedger()
        self.stats = StoreStats()
        self.rng = np.random.default_rng(seed)
        self._lock = make_rlock("store.InfiniStore._lock")
        # observability plane (repro_torch.obs): threaded through the same
        # layers as `faults`. ISTORE_METRICS_DUMP=<path> auto-attaches
        # an enabled plane so the atexit Prometheus dump has a source
        # even when the caller configured none.
        if cfg.obs is None and os.environ.get("ISTORE_METRICS_DUMP"):
            cfg.obs = ObsPlane(name=name or "store")
        self._obs = cfg.obs
        if cfg.faults is not None and self._obs is not None:
            # mirror fault-plane fires into the flight recorder
            cfg.faults.obs = self._obs
        # crash-consistent spill journal (§5.3.2): the writeback queue
        # appends every enqueue here before the PUT acks; metadata
        # records ("meta/<key>|<ver>") journal the table entry so a
        # restarted daemon can serve replayed pending data. Journal seq
        # of each live object version's metadata record, truncated when
        # the version is superseded or the PUT aborts:
        self._spill_meta_seqs: Dict[str, int] = {}
        # metadata-snapshot generation state (size-bounded replay): the
        # live `metadrop/` tombstone seqs the NEXT snapshot truncates.
        # (The snapshot record itself needs no tracked seq — `metasnap`
        # is a constant key, so the journal's same-key supersession
        # retires the previous snapshot on every new append.)
        self._spill_tombstones: List[int] = []
        self.spill: Optional[SpillJournal] = None
        self._spill_auto = False
        spill_dir = cfg.spill_dir
        if cfg.async_writeback and spill_dir is not None:
            if spill_dir == "auto":
                spill_dir = tempfile.mkdtemp(prefix="infinistore-spill-")
                self._spill_auto = True
            # group-commit mode: enqueues buffer their journal frames;
            # the PUT path syncs ONCE at its ack point (one flush per
            # PUT, not one per chunk record)
            self.spill = SpillJournal(
                spill_dir, segment_bytes=cfg.spill_segment_bytes,
                fsync=cfg.spill_fsync, sync_each=False,
                faults=cfg.faults)
            self.spill.obs = self._obs
        self.spill_dir = spill_dir if self.spill is not None else None
        if self._obs is not None and self.spill_dir is not None:
            # one flight file per crash domain (= process): first bind
            # wins, so a worker process binds its shard directory here
            # while thread shards under a ShardedStore no-op (the
            # front-end bound the root's file before building shards)
            self._obs.bind_flight(
                os.path.join(self.spill_dir, "flight.bin"))
        self.writeback = WritebackQueue(
            self.cos, max_depth=cfg.writeback_depth,
            max_retries=cfg.writeback_retries,
            backoff_base_s=cfg.writeback_backoff_s,
            start_thread=cfg.async_writeback,
            spill=self.spill,
            name=f"cos-writeback{tag}",
            degraded_after=cfg.writeback_degraded_after,
            faults=cfg.faults, obs=self._obs)
        # chunk key -> function id (the daemon's chunk-function mapping)
        self.chunk_map: Dict[str, int] = {}
        # daemon's piggybacked view of each function's insertion state
        self.daemon_view: Dict[int, Piggyback] = {}
        from repro_torch.core.sms import hardcap
        self.placement = PlacementManager(
            cfg.ec.n, hardcap(cfg.function_capacity),
            autoscale=cfg.autoscale,
            new_function_cb=self._on_new_function)
        self.recovery = RecoveryManager(
            self.sms, self.cos, self.logs,
            num_recovery_functions=cfg.num_recovery_functions,
            retain_seconds=cfg.recovery_retain_seconds,
            clock=self.clock,
            writeback=self.writeback,
            thread_prefix=f"recovery{tag}",
            retry=self.cos_retry,
            device=self.device)
        self._pending_records: Dict[int, List[PutRecord]] = {}
        # the client-daemon thread: every mutating request runs here, in
        # submission order — async callers pipeline, sync callers block
        self._daemon_ident: Optional[int] = None
        self._exec = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"store-client{tag}",
            initializer=self._register_daemon)
        # GET-side I/O executor: COS demand reads + prefetch warms fan
        # out here while the daemon thread decodes (the workers only
        # touch thread-safe layers: writeback.peek / cos.get / clock)
        self._io = ThreadPoolExecutor(
            max_workers=max(1, cfg.get_io_workers),
            thread_name_prefix=f"store-io{tag}")
        self.prefetcher = SequentialPrefetcher(PrefetchConfig(
            enabled=cfg.prefetch and cfg.pipelined_get,
            min_run=cfg.prefetch_min_run, depth=cfg.prefetch_depth))
        # warm fetches in flight: chunk key -> Future (daemon thread only)
        self._prefetch_inflight: Dict[str, Future] = {}
        # degraded-read compaction candidates deferred off the GET
        # critical path; drained by gc_tick on the daemon thread. An
        # insertion-ordered de-dup set: bounded by the number of distinct
        # degraded chunks, not the read rate
        self._pending_migrations: Dict[str, None] = {}
        # chunk journal records pre-appended by _put_fragments that have
        # not yet been handed to the writeback queue (ckey -> seq); any
        # left behind by a failed/aborted PUT are marked dead. Daemon-
        # thread only.
        self._spill_put_seqs: Dict[str, int] = {}
        # fragment payload records: the journal holds each fragment's
        # pre-EC payload ONCE (chunk records are tiny stubs replay
        # re-encodes); the record lives until the persistent-buffer
        # entry fully drains. In-flight (this PUT) vs committed:
        self._spill_put_frag_seqs: Dict[str, int] = {}
        self._spill_frag_seqs: Dict[str, int] = {}
        # 2PC in-doubt state (daemon thread only). Live prepared batches
        # registered under a leader ticket (durable `prepared/<t>`
        # journal record appended + synced at prepare):
        self._prepared_tickets: Dict[int, _PreparedBatch] = {}
        # prepared-uncommitted batches found in the journal at restart:
        # ticket -> {"objs": [...], "seq": rec seq, "frags": {...},
        # "stubs": {...}} — their fragment/stub frames are WITHHELD from
        # ordinary replay until the leader's decision resolves them
        # (resolve_indoubt), so an aborted batch can never leak a head
        self._indoubt: Dict[int, dict] = {}
        # daemon-restart resume: replay journal records that survived a
        # crash — metadata records restore the table, pending writes
        # re-enter the queue (and thus the pending map, so GETs and
        # RecoveryManager._download serve them like live pending data)
        if self.spill is not None:
            self._replay_spill()
        if self._obs is not None:
            self._obs.event("store.open", store=name or "store",
                            pid=os.getpid())

    # ------------------------------------------------------------------
    # async plumbing
    # ------------------------------------------------------------------

    def _register_daemon(self) -> None:
        self._daemon_ident = threading.get_ident()

    def _submit(self, fn) -> StoreFuture:
        obs = self._obs
        if obs is not None:
            # executor hop: the daemon runs `fn` on its own thread —
            # close it over the submitter's ambient trace context so
            # daemon-side spans stitch under the caller's span
            fn = obs.bind_current(fn)
        fut = StoreFuture()
        if threading.get_ident() == self._daemon_ident:
            # re-entrant call from the daemon thread itself: run inline
            # (queueing would deadlock the single worker)
            try:
                fut._resolve(fn())
            except BaseException as e:            # noqa: BLE001
                fut.set_exception(e)
            return fut
        # a disabled plane reads no clock
        t_sub = (time.perf_counter() if obs is not None and obs.enabled
                 else None)

        def run():
            if obs is not None and t_sub is not None:
                obs.record("daemon.queue_wait_us",
                           (time.perf_counter() - t_sub) * 1e6)
            try:
                fut._resolve(fn())
            except BaseException as e:            # noqa: BLE001
                fut.set_exception(e)
        try:
            self._exec.submit(run)
        except RuntimeError as e:
            # dead daemon (closed store): the same error class every
            # other frontend raises for an unreachable shard, so
            # callers need one except-clause across thread/process/tcp
            raise ShardWorkerDied(
                f"store {self.name!r} daemon is shut down",
                op="submit") from e
        return fut

    def flush_writeback(self, timeout: Optional[float] = None) -> bool:
        """Barrier: block until every acked PUT is persisted in COS.
        False on timeout or if any write failed out permanently (those
        payloads remain pinned in the persistent buffer). Permanent
        failures are data-at-risk: the False return path names the
        affected keys (log + `snapshot_metadata()["health"]`) instead
        of burying them in a counter."""
        ok = self.writeback.flush(timeout=timeout)
        self.stats.writeback_permanent_failures = \
            self.writeback.stats.failures
        if not ok:
            h = self.writeback.health()
            if h["failed_keys"]:
                _LOG.warning(
                    "flush_writeback%s: %d permanently-failed writes; "
                    "data-at-risk keys (first %d): %s",
                    f" [{self.name}]" if self.name else "",
                    h["permanent_failures"],
                    min(8, len(h["failed_keys"])), h["failed_keys"][:8])
            else:
                _LOG.warning(
                    "flush_writeback%s: timed out with state=%s "
                    "depth=%d consecutive_errors=%d",
                    f" [{self.name}]" if self.name else "",
                    h["state"], h["depth"], h["consecutive_errors"])
        return ok

    def pause_writeback(self) -> None:
        """Hold COS writes in-queue (tests/benchmarks). Part of the
        shard surface: front-ends (in-process or over IPC) call this
        instead of reaching into `self.writeback`."""
        self.writeback.pause()

    def resume_writeback(self) -> None:
        self.writeback.resume()

    def balance_count(self) -> int:
        """Distinct object keys (metadata heads) this store serves —
        one bar of the router-quality histogram."""
        snap = self.mt.snapshot()
        return sum(1 for k in snap if "|" not in k)

    def ledger_dollars(self) -> Dict[str, float]:
        return self.ledger.dollars()

    def close(self, *, flush: bool = True) -> bool:
        """Release the store's threads: drain the client-daemon executor
        FIRST (in-flight PUTs may still enqueue writebacks), then flush +
        stop the writeback writer, the recovery pool, and COS. Returns
        False if writes were left unpersisted. The store must not be
        used afterwards."""
        self._exec.shutdown(wait=True)
        self._io.shutdown(wait=True)
        ok = self.writeback.close(flush=flush)
        self.recovery.shutdown()
        if self._owns_cos:          # a shared (front-end-owned) COS
            self.cos.shutdown()     # outlives any one shard
        if self.spill is not None:
            self.spill.close()
            if self._spill_auto:
                # private tempdir journal: a restart can't find it, so a
                # graceful close reclaims it outright
                shutil.rmtree(self.spill_dir, ignore_errors=True)
        return ok

    def simulate_crash(self) -> Optional[str]:
        """Drop the client daemon mid-flight WITHOUT flushing — the kill
        half of the kill/restart durability tests. The queue, pending
        map, persistent buffer, and metadata table are abandoned exactly
        as a process crash would abandon them; the spill journal's
        segments (and a disk-backed COS root) survive. Returns the
        spill_dir so the caller can rebuild a store on it."""
        self._exec.shutdown(wait=True, cancel_futures=True)
        self._io.shutdown(wait=False, cancel_futures=True)
        self.writeback.close(flush=False)
        self.recovery.shutdown()
        if self._owns_cos:          # COS survives a one-shard crash
            self.cos.shutdown()
        if self.spill is not None:
            # hard close: the journal's unsynced buffer tail is
            # discarded, as a real SIGKILL would — only frames an
            # ack-point sync() covered survive
            self.spill.close(reclaim=False, hard=True)
        return self.spill_dir

    # ------------------------------------------------------------------
    # spill journal: metadata records + restart replay (§5.3.2)
    # ------------------------------------------------------------------

    def _spill_journal_meta(self, key: str, c, *,
                            ticket: Optional[int] = None) -> None:
        """Journal the committed metadata of one PUT ('meta/<key>|<ver>')
        — appended at commit, after the version's fragment/stub frames
        (replay does not depend on file order: metadata is restored
        during the scan, chunks re-enqueue afterwards). The record lives
        until the version is superseded (or folded into a `metasnap`
        snapshot) — it is what makes an acked object *resolvable* after
        a restart. A cross-shard commit stamps its leader ticket into
        the record (diagnostic ordering evidence across shard journals)."""
        obj = f"{key}|{c.ver}"
        rec = {"key": key, "ver": c.ver, "prev_ver": c.prev_ver,
               "num_fragments": c.num_fragments, "size": c.size}
        if ticket is not None:
            rec["ticket"] = ticket
        seq = self.spill.append(f"meta/{obj}", json.dumps(rec).encode())
        with self._lock:
            self._spill_meta_seqs[obj] = seq

    def _spill_drop_meta(self, obj: str) -> None:
        """Logically truncate a metadata record (version superseded, PUT
        failed, or PUT aborted mid-flight). A record whose durable copy
        lives inside the current `metasnap` snapshot cannot be
        individually truncated — a `metadrop/` tombstone is journaled
        instead (replayed in seq order, so it kills the snapshot's copy
        but never a later re-PUT); the NEXT snapshot truncates the
        tombstones it obsoletes."""
        if self.spill is None:
            return
        with self._lock:
            seq = self._spill_meta_seqs.pop(obj, None)
        if seq is None:
            return
        if seq == _SNAP_COVERED:
            ts = self.spill.append(f"metadrop/{obj}", b"")
            with self._lock:
                self._spill_tombstones.append(ts)
        else:
            self.spill.mark_persisted(seq)

    def _maybe_snapshot_meta(self) -> None:
        """Size-bounded metadata log (gc_tick): once enough individual
        `meta/` records + `metadrop/` tombstones accumulate, fold the
        whole journaled metadata table into ONE `metasnap` record at a
        fresh journal generation (forced segment rotation) and truncate
        everything it supersedes. Caps a long-lived daemon's replay at
        one snapshot plus the post-snapshot tail.

        Crash-window ordering: the snapshot is appended FIRST; the
        truncation (PERSIST) frames follow it into the same group
        commit. A torn tail can therefore only lose truncations — replay
        then sees both the snapshot and some superseded records, and the
        seq-ordered merge (newest head wins, tombstones kill only older
        registrations) converges to the same table. The `metasnap` key
        is constant, so the journal's same-key supersession retires the
        previous snapshot automatically even if its PERSIST frame tears."""
        lim = self.cfg.spill_meta_snapshot_records
        if self.spill is None or not lim:
            return
        with self._lock:
            individual = sum(1 for s in self._spill_meta_seqs.values()
                             if s != _SNAP_COVERED)
            work = individual + len(self._spill_tombstones)
        if work < lim:
            return
        with self._lock:
            objs = list(self._spill_meta_seqs)
        entries = []
        for obj in objs:
            m = self.mt.load(obj)
            if m is None or not m.is_done_ok():
                continue
            entries.append({"key": m.key, "ver": m.ver,
                            "prev_ver": m.prev_ver,
                            "num_fragments": m.num_fragments,
                            "size": m.size})
        self.spill.rotate()               # new journal generation
        # constant key: the journal's same-key supersession retires the
        # previous snapshot the moment this one is appended
        self.spill.append("metasnap", json.dumps(entries).encode())
        with self._lock:
            old_seqs = [s for s in self._spill_meta_seqs.values()
                        if s != _SNAP_COVERED]
            for obj in self._spill_meta_seqs:
                self._spill_meta_seqs[obj] = _SNAP_COVERED
            tombs, self._spill_tombstones = self._spill_tombstones, []
        for s in old_seqs + tombs:
            self.spill.mark_persisted(s)
        self.spill.sync()
        self.stats.inc("spill_meta_snapshots")

    def _replay_spill(self) -> None:
        """Re-enqueue every journal record that survived the previous
        daemon: metadata records rebuild the table (newest version wins
        the head); fragment records restore their persistent-buffer
        entries (one ref per surviving chunk stub) and are re-encoded —
        deterministic RS — to regenerate each stub's chunk payload for
        the queue; log/snapshot records re-enter the queue as-is. The
        pending map + buffer then serve post-restart GETs and recovery
        exactly like live pending data, and the background writer
        persists everything to COS."""
        frag_payloads: Dict[str, object] = {}
        frag_seqs: Dict[str, int] = {}
        stubs: Dict[str, List[Tuple[int, str]]] = {}  # fkey -> (seq, key)
        for seq, key, data in self.spill.take_pending():
            if key.startswith("meta/"):
                self._spill_restore_meta(seq, data)
            elif key == "metasnap":
                # a metadata-table snapshot (one per journal generation):
                # registers every contained meta as snapshot-covered
                self._spill_restore_snapshot(seq, data)
            elif key.startswith("metadrop/"):
                # tombstone for a snapshot-covered meta superseded after
                # the snapshot was taken — seq order guarantees it kills
                # only registrations made before it
                self._spill_replay_tombstone(seq, key[len("metadrop/"):])
            elif key.startswith("frag/"):
                fkey = key[len("frag/"):]
                frag_payloads[fkey] = data
                frag_seqs[fkey] = seq
            elif key.startswith("chunk/"):        # stub: payload derived
                ckey = key[len("chunk/"):]
                stubs.setdefault(ckey.rsplit("#", 1)[0],
                                 []).append((seq, key))
            elif key.startswith("prepared/"):
                # a 2PC sub-batch prepared but not resolved pre-crash:
                # in doubt until the leader's decision is consulted
                self._spill_restore_prepared(seq, key[len("prepared/"):],
                                             data)
            else:
                self.writeback.enqueue(key, data, seq=seq)
                self.stats.inc("spill_replayed_writes")
        # Withhold every in-doubt batch's fragment/stub frames from
        # ordinary replay: they must neither re-enter the writeback
        # queue nor restore buffer entries until the leader's decision
        # says commit (resolve_indoubt releases or truncates them).
        if self._indoubt:
            indoubt_objs: Dict[str, int] = {}
            for t, e in self._indoubt.items():
                for d in e["objs"]:
                    indoubt_objs[f"{d['key']}|{d['ver']}"] = t
            for fkey in list(frag_seqs):
                t = indoubt_objs.get(fkey.rpartition("/f")[0])
                if t is None:
                    continue
                e = self._indoubt[t]
                e["frags"][fkey] = (frag_seqs.pop(fkey),
                                    frag_payloads.pop(fkey))
                e["stubs"][fkey] = stubs.pop(fkey, [])
        # A superseded meta can be resurrected alongside its successor
        # when the PERSIST frame truncating it was lost (torn tail): the
        # live put path only ever truncates the current head's
        # predecessor, so a non-head record restored here would pin its
        # segment (and be replayed, and re-compacted) forever. Re-drop
        # everything below each key's restored head now.
        with self._lock:
            restored = list(self._spill_meta_seqs)
        heads: Dict[str, int] = {}
        for obj in restored:
            key, ver = obj.rsplit("|", 1)
            heads[key] = max(heads.get(key, 0), int(ver))
        for obj in restored:
            key, ver = obj.rsplit("|", 1)
            if int(ver) < heads[key]:
                self._spill_drop_meta(obj)
        live = []                                 # (fkey, u8, stub items)
        for fkey, seq in frag_seqs.items():
            items = stubs.pop(fkey, [])
            if not items:
                # every chunk persisted pre-crash (their truncation
                # frames made it, the fragment's did not): record is dead
                self.spill.mark_persisted(seq)
                continue
            u8 = as_u8(frag_payloads[fkey])
            # restore the buffer entry: one ref per outstanding chunk,
            # released as each persists — the live draining contract
            self.pb.create(fkey, u8, refs=len(items))
            with self._lock:
                self._spill_frag_seqs[fkey] = seq
            live.append((fkey, u8, items))
        for (fkey, u8, items), chunks in zip(
                live, self.codec.encode_many([u for _, u, _ in live],
                                             as_arrays=True)
                if live else []):
            for seq, cos_key in items:
                idx = int(cos_key.rsplit("#", 1)[1])
                self.writeback.enqueue(cos_key, chunks[idx].clone(),
                                       seq=seq,
                                       on_done=self._on_chunk_persisted)
                self.stats.inc("spill_replayed_writes")
        for items in stubs.values():              # stubs whose fragment
            for seq, _ in items:                  # is gone (corruption):
                self.spill.mark_persisted(seq)    # unrecoverable, drop

    def _spill_restore_prepared(self, seq: int, tstr: str, data) -> None:
        """Restore one `prepared/<ticket>` record into the in-doubt map.
        Malformed records are truncated — without a parsable object list
        there is nothing to withhold or resolve."""
        try:
            ticket = int(tstr)
            objs = json.loads(bytes(data))
            if not isinstance(objs, list):
                raise ValueError("prepared record is not a list")
            for d in objs:
                d["key"], int(d["ver"])           # shape check
        except (ValueError, KeyError, TypeError):
            self.spill.mark_persisted(seq)
            return
        self._indoubt[ticket] = {"objs": objs, "seq": seq,
                                 "frags": {}, "stubs": {}}

    # ------------------------------------------------------------------
    # 2PC in-doubt resolution (restart-time sweep; see repro_torch.core.shard)
    # ------------------------------------------------------------------

    def indoubt_tickets(self) -> List[int]:
        """Tickets of prepared-uncommitted batches this store knows
        about: live registrations plus journal-replayed ones. The
        cross-shard resolver sweeps these after any shard restart."""
        return self.indoubt_tickets_async().result()

    def indoubt_tickets_async(self) -> StoreFuture:
        """Non-blocking `indoubt_tickets` — single-threaded callers
        (the process-host worker loop) must not park behind the daemon
        queue while earlier ops depend on them for progress."""
        return self._submit(lambda: sorted(
            set(self._indoubt) | set(self._prepared_tickets)))

    def resolve_indoubt(self, ticket: int, *, commit: bool) -> StoreFuture:
        """Resolve one in-doubt prepared batch per the leader's durable
        decision: roll it forward (commit — every version becomes a
        readable head, exactly as if round 2 had run) or back (abort —
        its frames are truncated, no version ever becomes visible).
        Resolves to {key: version} on commit, None for an unknown
        ticket or an abort. Idempotent: a ticket already resolved (or
        never prepared here) is a no-op."""
        return self._submit(lambda: self._resolve_indoubt_impl(
            ticket, commit))

    def _resolve_indoubt_impl(self, ticket: int, commit: bool):
        prep = self._prepared_tickets.get(ticket)
        if prep is not None:                      # live prepared batch
            self.stats.inc("indoubt_resolved")
            if commit:
                # a failure propagates with the batch still registered:
                # the decision is durable, so the resolver retries the
                # (idempotent) commit rather than half-aborting
                return self._put_many_commit(prep, ticket=ticket)
            self._put_many_abort(prep)
            return None
        e = self._indoubt.pop(ticket, None)
        if e is None:
            return None
        self.stats.inc("indoubt_resolved")
        return self._resolve_indoubt_replayed(e, ticket, commit)

    def _resolve_indoubt_replayed(self, e: dict, ticket: int,
                                  commit: bool):
        """Resolve a journal-replayed in-doubt batch (the shard crashed
        between prepare and the leader's round 2 reaching it).

        Abort: truncate the batch's withheld frames + prepared record —
        presumed-abort finishes the roll-back the crash started.

        Commit: install + journal each object's metadata (skipping any
        already restored — the crash may have landed mid-commit, after
        some `meta/` frames synced) and re-enqueue the withheld chunk
        writes exactly like ordinary replay. An object with no withheld
        fragment frames already drained to COS pre-crash (its frames
        were truncated on full persistence), so metadata alone
        finishes it."""
        if not commit:
            for fkey, (fseq, _) in e["frags"].items():
                self.spill.mark_persisted(fseq)
            for items in e["stubs"].values():
                for seq, _ in items:
                    self.spill.mark_persisted(seq)
            self.spill.mark_persisted(e["seq"])
            self.spill.sync()
            return None
        out: Dict[str, int] = {}
        for d in e["objs"]:
            key, ver = d["key"], int(d["ver"])
            obj = f"{key}|{ver}"
            with self._lock:
                have_meta = obj in self._spill_meta_seqs
            if not have_meta:
                m = Meta(key, ver, int(d.get("prev_ver", 0)))
                m.num_fragments = int(d.get("num_fragments", 1))
                m.size = int(d.get("size", 0))
                m.done(True)
                self.mt.store(obj, m)
                head = self.mt.load(key)
                if head is None or head.ver <= ver:
                    self.mt.store(key, m)
                self._spill_journal_meta(key, m, ticket=ticket)
            out[key] = ver
        live = []                                 # (fkey, u8, stub items)
        for fkey, (fseq, payload) in e["frags"].items():
            items = e["stubs"].get(fkey) or []
            if not items:
                self.spill.mark_persisted(fseq)   # chunks fully drained
                continue
            u8 = as_u8(payload)
            self.pb.create(fkey, u8, refs=len(items))
            with self._lock:
                self._spill_frag_seqs[fkey] = fseq
            live.append((fkey, u8, items))
        for (fkey, u8, items), chunks in zip(
                live, self.codec.encode_many([u for _, u, _ in live],
                                             as_arrays=True)
                if live else []):
            for seq, cos_key in items:
                idx = int(cos_key.rsplit("#", 1)[1])
                self.writeback.enqueue(cos_key, chunks[idx].clone(),
                                       seq=seq,
                                       on_done=self._on_chunk_persisted)
                self.stats.inc("spill_replayed_writes")
        self.spill.mark_persisted(e["seq"])
        self.spill.sync()
        self.stats.inc("commit_tickets")
        return out

    def _spill_register_meta(self, d: dict, seq: int) -> None:
        """Install one replayed metadata entry (individual record or a
        snapshot element): table entry, head if newest, seq
        registration (`_SNAP_COVERED` when the durable copy is the
        snapshot). Raises on malformed input — callers decide how to
        truncate."""
        key, ver = d["key"], int(d["ver"])
        m = Meta(key, ver, int(d.get("prev_ver", 0)))
        m.num_fragments = int(d.get("num_fragments", 1))
        m.size = int(d.get("size", 0))
        m.done(True)
        self.mt.store(f"{key}|{ver}", m)
        head = self.mt.load(key)
        if head is None or head.ver <= ver:
            self.mt.store(key, m)
        obj = f"{key}|{ver}"
        with self._lock:
            old = self._spill_meta_seqs.get(obj)
            self._spill_meta_seqs[obj] = seq
        if old is not None and old != _SNAP_COVERED and old != seq:
            # the same obj was already registered from an individual
            # record whose truncation frame tore away (crash between a
            # snapshot's append and its PERSIST frames): the new
            # registration supersedes it — truncate the stale record or
            # it pins its segment (and is re-replayed) forever
            self.spill.mark_persisted(old)
        self.stats.inc("spill_replayed_metas")

    def _spill_restore_meta(self, seq: int, data) -> None:
        try:
            self._spill_register_meta(json.loads(bytes(data)), seq)
        except (ValueError, KeyError, TypeError):
            # malformed record: unrestorable — truncate it so it cannot
            # pin its segment (and replay cost) forever
            self.spill.mark_persisted(seq)

    def _spill_restore_snapshot(self, seq: int, data) -> None:
        """Restore a `metasnap` record: every contained meta registers
        as snapshot-covered (supersession must tombstone, not truncate).
        Malformed elements are skipped — each element is independent."""
        try:
            entries = json.loads(bytes(data))
        except ValueError:
            self.spill.mark_persisted(seq)        # unrestorable snapshot
            return
        if not isinstance(entries, list):
            self.spill.mark_persisted(seq)
            return
        for d in entries:
            try:
                self._spill_register_meta(d, _SNAP_COVERED)
            except (ValueError, KeyError, TypeError):
                continue

    def _spill_replay_tombstone(self, seq: int, obj: str) -> None:
        """Apply a `metadrop/` tombstone during replay: kill the earlier
        registration of `obj` (individual records additionally truncate
        — a snapshot copy cannot). The tombstone itself stays live until
        the next snapshot folds it away."""
        with self._lock:
            reg = self._spill_meta_seqs.pop(obj, None)
            self._spill_tombstones.append(seq)
        if reg is not None and reg != _SNAP_COVERED:
            self.spill.mark_persisted(reg)

    def cos_keys(self, prefix: str = "") -> List[str]:
        """COS key listing that includes acked-but-not-yet-persisted
        writes (the pending writeback map)."""
        keys = set(self.cos.list_keys(prefix))
        keys.update(self.writeback.pending_keys(prefix))
        return sorted(keys)

    # ------------------------------------------------------------------
    # function lifecycle
    # ------------------------------------------------------------------

    def _on_new_function(self, fid: int, fg_id: int, capacity: int) -> None:
        self.sms.add(fid, capacity)
        # with async writeback, log-node persistence rides the background
        # writer (the instance persists on return, §5.5.1 — not the
        # client's ack path); reads stay correct via the pending map
        self.logs[fid] = InsertionLog(
            fid, self.cos,
            writeback=self.writeback if self.cfg.async_writeback else None)
        self.daemon_view[fid] = Piggyback()
        self.window.latest.add_function(fid, fg_id)
        self.recovery.assign_group(fid, list(self.sms.slabs.keys()))

    def _invoke(self, fid: int, nbytes: int, category: str) -> None:
        """Invoke a function instance: failure detection happens here, on
        invocation, exactly as in the paper (§5.5.1)."""
        slab = self.sms.get(fid)
        busy = self.cfg.busy_base_s + nbytes * self.cfg.busy_per_byte_s
        was_dead = not slab.alive
        slab.invoke(busy)
        gb = slab.capacity / (1024 ** 3)
        self.ledger.invoke(category, gb=gb, seconds=busy)
        view = self.daemon_view.get(fid, Piggyback())
        detected = self.recovery.check_failed(slab, view)
        if was_dead and not detected:
            # observed-dead at invocation is a real detection even when
            # term/hash happen to match (e.g. a never-written instance) —
            # without this, stats.detections undercounts
            self.recovery.note_detection()
        failed = detected or was_dead
        if failed and view.term > 0 and self.cfg.enable_recovery:
            self._recover(fid)

    def _recover(self, fid: int) -> None:
        slab = self.sms.get(fid)
        view = self.daemon_view[fid]
        candidates = [f for f in self.sms.slabs
                      if self.window.state_of_function(f)
                      == BucketState.ACTIVE]
        t0 = self.clock.now()
        if self.recovery.needs_parallel(slab, view):
            session = self.recovery.recover_parallel(slab, candidates)
            nbytes = sum(len(v) for v in session.recovered.values())
            for rfid in session.group:
                self.ledger.invoke("recovery",
                                   gb=self.sms.get(rfid).capacity / 1024**3,
                                   seconds=self.cfg.busy_base_s
                                   + nbytes / max(len(session.group), 1)
                                   * self.cfg.busy_per_byte_s)
        else:
            n = self.recovery.recover_local(slab)
            self.ledger.invoke("recovery", gb=slab.capacity / 1024**3,
                               seconds=self.cfg.busy_base_s
                               + n * self.cfg.busy_per_byte_s * 1024)
        del t0

    # ------------------------------------------------------------------
    # PUT (Appendix A left + §5.3.1/§5.3.2)
    # ------------------------------------------------------------------

    def put(self, key: str, value) -> int:
        """Strongly-consistent versioned PUT (blocking wrapper over
        `put_async`). Returns the version."""
        return self.put_async(key, value).result()

    @staticmethod
    def _snapshot_value(value):
        """Snapshot mutable buffers ON THE CALLER'S THREAD, at
        submission: once put_async returns, the caller may reuse its
        buffer — the store must already own a stable copy. Every tensor
        is mutable and is cloned on its own device (device to device for
        a CUDA tensor); bytes and read-only arrays pass through
        zero-copy."""
        if not needs_snapshot(value):
            return value
        if isinstance(value, torch.Tensor):
            return as_u8(value).clone()
        snap = host_u8(value).copy()
        # the snapshot is store-owned and immutable by contract;
        # marking it read-only makes a second snapshot pass a no-op
        # instead of another full memcpy of the payload
        snap.flags.writeable = False
        return snap

    def put_async(self, key: str, value) -> StoreFuture:
        """Non-blocking PUT. The future resolves to the committed version
        once fragments land in SMS slabs + the persistent buffer; COS
        persistence continues in the background (see module docstring).
        The payload is captured at submission — the caller may mutate or
        reuse its buffer immediately."""
        value = self._snapshot_value(value)
        return self._submit(
            lambda: self._put_many_impl([(key, value)],
                                        raise_on_conflict=True)[key])

    def put_many(self, items, *, raise_on_conflict: bool = False
                 ) -> Dict[str, int]:
        """Batch PUT (blocking wrapper over `put_many_async`)."""
        return self.put_many_async(
            items, raise_on_conflict=raise_on_conflict).result()

    def put_many_async(self, items, *, raise_on_conflict: bool = False
                       ) -> StoreFuture:
        """Batch PUT: ONE leader-sequenced multi-key CAS round commits
        the whole batch's metadata, ALL fragments of ALL objects go
        through a single `encode_many` codec call, and chunk writes are
        grouped per function (one invoke + one insertion-log append
        each). items: dict or iterable of (key, value). The future
        resolves to {key: version} (-1 on failure), matching `put` per
        key. A CAS conflict on one key fails only that key (-1) unless
        raise_on_conflict (the single-key `put` contract: raise so the
        caller retries)."""
        items = list(items.items()) if isinstance(items, dict) \
            else list(items)
        items = [(k, self._snapshot_value(v)) for k, v in items]
        obs = self._obs
        with (obs.span("client.put_many", n=len(items))
              if obs is not None else NOOP_CM):
            return self._submit(
                lambda: self._put_many_impl(
                    items, raise_on_conflict=raise_on_conflict))

    def _put_many_impl(self, items, *, raise_on_conflict: bool = False
                       ) -> Dict[str, int]:
        """Single-store PUT batch: prepare + immediate self-commit (the
        degenerate one-shard case of the cross-shard protocol)."""
        obs = self._obs
        t0 = time.perf_counter() if obs is not None else 0.0
        with (obs.span("daemon.put_many", n=len(items))
              if obs is not None else NOOP_CM):
            prep = self._put_many_prepare(
                items, raise_on_conflict=raise_on_conflict)
            try:
                out = self._put_many_commit(prep)
            except BaseException:
                # a commit-side failure (GC / journal I/O) must not leave
                # PENDING heads behind — readers would block and later
                # PUTs would conflict forever
                self._put_many_abort(prep)
                raise
        if obs is not None:
            obs.record("put.ack_us", (time.perf_counter() - t0) * 1e6)
        return out

    def prepare_put_many_async(self, items, *,
                               raise_on_conflict: bool = False,
                               ticket: Optional[int] = None
                               ) -> StoreFuture:
        """Round 1 of the cross-shard commit protocol: run this shard's
        sub-batch up to (but NOT including) the ack point. The future
        resolves to an opaque prepared-batch handle for
        `commit_put_many_async` / `abort_put_many_async`. Until one of
        those runs, the new versions are PENDING — invisible to readers
        and un-acked. Same-key PUTs meanwhile wait on the pending head
        exactly like any concurrent PUT.

        `ticket` (leader-issued, cross-shard batches only) makes the
        prepare DURABLE: a `prepared/<ticket>` record naming every
        (key, version) of the sub-batch is journaled and synced before
        the future resolves, so a crashed shard restarts knowing exactly
        which batches were in doubt — `indoubt_tickets()` surfaces them
        and `resolve_indoubt()` rolls each forward or back once the
        leader's decision is known."""
        items = list(items.items()) if isinstance(items, dict) \
            else list(items)
        items = [(k, self._snapshot_value(v)) for k, v in items]

        obs = self._obs

        def run():
            with (obs.span("daemon.2pc_prepare", ticket=ticket)
                  if obs is not None else NOOP_CM):
                prep = self._put_many_prepare(
                    items, raise_on_conflict=raise_on_conflict)
                if ticket is not None:
                    try:
                        self._register_prepared(prep, ticket)
                    except BaseException:
                        self._put_many_abort(prep)
                        raise
                return prep
        return self._submit(run)

    def _register_prepared(self, prep: "_PreparedBatch",
                           ticket: int) -> None:
        """Journal + sync this batch's durable `prepared/<ticket>`
        record (PREPARE DURABILITY POINT: the record and the batch's
        payload frames — appended earlier, flushed by this same sync —
        must survive a crash for the leader's decision to be
        actionable) and register the live batch for the resolver."""
        prep.ticket = ticket
        if self.spill is not None:
            objs = [{"key": k, "ver": ver, "prev_ver": c.prev_ver,
                     "num_fragments": c.num_fragments, "size": c.size}
                    for k, c, ver, _ in prep.metas]
            prep.prepared_seq = self.spill.append(
                f"prepared/{ticket}", json.dumps(objs).encode())
            self.spill.sync()
        self._prepared_tickets[ticket] = prep

    def _drop_prepared(self, prep: "_PreparedBatch") -> None:
        """Retire a resolved batch's prepared record + registration
        (the caller's journal sync makes the truncation durable)."""
        if prep.ticket is not None:
            self._prepared_tickets.pop(prep.ticket, None)
        if prep.prepared_seq is not None and self.spill is not None:
            self.spill.mark_persisted(prep.prepared_seq)
            prep.prepared_seq = None

    def commit_put_many_async(self, prep: "_PreparedBatch", *,
                              ticket: Optional[int] = None) -> StoreFuture:
        """Round 2 (commit): finalize a prepared sub-batch under the
        leader's commit ticket. Resolves to {key: version} like
        `put_many`. A commit-side failure (journal I/O, GC) on an
        UN-ticketed batch aborts the unfinalized heads before
        propagating — a PENDING head left behind would block every
        later reader and writer of that key forever. A TICKETED batch
        must NOT abort here: the leader's commit decision is already
        durable, so aborting one shard would leave the batch
        half-visible forever — the batch stays registered in doubt and
        the cross-shard resolver retries the (idempotent) commit."""
        obs = self._obs

        def run():
            with (obs.span("daemon.2pc_commit", ticket=ticket)
                  if obs is not None else NOOP_CM):
                try:
                    return self._put_many_commit(prep, ticket=ticket)
                except BaseException:
                    if ticket is None:
                        self._put_many_abort(prep)
                    raise
        return self._submit(run)

    def abort_put_many_async(self, prep: "_PreparedBatch") -> StoreFuture:
        """Round 2 (abort): roll a prepared sub-batch back so none of
        its versions ever becomes visible (another shard failed to
        prepare — the batch must not be half-visible)."""
        return self._submit(lambda: self._put_many_abort(prep))

    def _put_many_prepare(self, items, *, raise_on_conflict: bool = False
                          ) -> "_PreparedBatch":
        """CAS-install the version heads (they stay PENDING), fragment,
        store chunks into SMS slabs, journal payload + stub frames, and
        hand chunk persistence to the writeback queue. Everything up to
        — but excluding — the ack point: metadata completion, the meta
        journal record, old-version GC, and the journal group-commit
        all wait for `_put_many_commit`."""
        if len({k for k, _ in items}) != len(items):
            # a duplicate key would CAS against its own in-flight version
            raise ValueError("duplicate keys in put_many batch")
        prep = _PreparedBatch(raise_on_conflict=raise_on_conflict)
        conflicted = prep.conflicted
        installed = prep.installed
        metas = prep.metas
        frags: List[Tuple[str, torch.Tensor]] = []
        try:
            cands = []
            for key, value in items:
                self.stats.inc("puts")
                if is_array_payload(value):
                    self.stats.inc("array_payload_puts")
                self._track_queue(payload_nbytes(value))
                cands.append((key, value, self.mt.prepare(key, 1)))
            # multi-key CAS: one metadata round per retry wave, not one
            # round per key
            pending = cands
            while pending:
                self.stats.inc("cas_rounds")
                results = self.mt.cas_many([(k, c) for k, _, c in pending])
                nxt = []
                for (key, value, c), (m, ok) in zip(pending, results):
                    if ok:
                        # prepared-but-uncommitted until _put_many_commit
                        # (see Meta.prepared; cleared by done())
                        c.prepared = True
                        installed.append((key, value, c))
                    elif not m.is_done():         # concurrent PUT in flight
                        # a prepared 2PC head resolves via a commit task
                        # queued BEHIND us on this same daemon — waiting
                        # would stall the whole shard until the timeout,
                        # so conflict immediately on those
                        if not m.prepared:
                            m.wait(timeout=5.0)
                        if raise_on_conflict:
                            raise ConcurrentPutError(key)
                        conflicted.append(key)
                    else:
                        c.revise(m.ver + 1)
                        nxt.append((key, value, c))
                pending = nxt
            for key, value, c in installed:
                ver = c.ver
                self.mt.store(f"{key}|{ver}", c)
                # register for cleanup BEFORE fragmenting: once the CAS
                # installed c as the head, any failure below must still
                # finalize this key (fkeys is mutated in place)
                fkeys: List[str] = []
                metas.append((key, c, ver, fkeys))
                # mutable buffers were snapshotted at submission
                # (_snapshot_value), so this view is store-owned or
                # immutable-backed either way
                u8 = as_u8(value)
                fb = self.cfg.fragment_bytes
                fragments = [u8[i:i + fb]
                             for i in range(0, max(u8.numel(), 1), fb)]
                c.num_fragments = len(fragments)
                c.size = u8.numel()
                for fi, frag in enumerate(fragments):
                    fkey = f"{key}|{ver}/f{fi}"
                    # persistent buffer: one ref held by the PUT itself;
                    # each async chunk writeback retains another and
                    # releases it on persistence (§5.3.2 draining)
                    self.pb.create(fkey, frag)
                    fkeys.append(fkey)
                    frags.append((fkey, frag))
            prep.failed = self._put_fragments(frags)
        except BaseException:
            # finalize every CAS-installed key that hasn't completed as
            # failed so no metadata head stays PENDING forever (readers
            # would block and later puts would raise on every attempt) —
            # covers CAS conflicts, encode/placement errors, MemoryError
            self._spill_abort_chunks()    # never handed to the queue
            for mkey, c, mver, fkeys in metas:
                if not c.is_done():
                    for fkey in fkeys:
                        self.pb.release_all(fkey)
                        self._spill_drop_frag(fkey)
                    c.done(False)
                    self._spill_drop_meta(f"{mkey}|{mver}")
            for _, _, c in installed:
                if not c.is_done():               # installed, not fragmented
                    c.done(False)
            raise
        return prep

    def _put_many_commit(self, prep: "_PreparedBatch", *,
                         ticket: Optional[int] = None) -> Dict[str, int]:
        """The ACK POINT: chunks are in SMS slabs, fragments in the
        persistent buffer, insertion logs appended — mark each version
        done, journal its metadata, GC the superseded version, and
        group-commit the journal. COS chunk persistence keeps draining
        asynchronously from the writeback queue; the buffer entry lives
        until its last chunk persists. `ticket` is the leader-issued
        cross-shard commit sequence (recorded in the journaled
        metadata); None for single-store batches."""
        if prep.resolved:                     # double-commit is a bug
            raise RuntimeError("prepared batch already resolved")
        out: Dict[str, int] = {}
        for key, c, ver, fkeys in prep.metas:
            obj = f"{key}|{ver}"
            if obj in prep.committed:         # retried ticketed commit
                out[key] = ver if c.is_done_ok() else -1
                continue
            frag_failed = any(fk in prep.failed for fk in fkeys)
            if not frag_failed and self.spill is not None:
                # journal the metadata FIRST — the only failure-prone
                # step of this obj's finalization, so an I/O error here
                # leaves the obj untouched and the commit retryable (the
                # journal's same-key supersession absorbs a duplicate
                # append on retry). The record still lands AFTER the
                # version's payload frames (appended in
                # _put_fragments): a torn tail then can only lose the
                # meta of a PUT whose data frames are also gone —
                # replay can never restore a head version with no
                # recoverable data, which would shadow the older
                # durable version
                self._spill_journal_meta(key, c, ticket=ticket)
            for fkey in fkeys:
                if frag_failed:
                    self.pb.release_all(fkey)
                    self._spill_drop_frag(fkey)
                elif self.pb.release(fkey):   # drop the PUT's own ref
                    self._spill_drop_frag(fkey)
            ok = c.done(not frag_failed)
            if ok and c.prev_ver > 0:
                self._gc_old_version(key, c.prev_ver)
            prep.committed.add(obj)
            out[key] = ver if ok else -1
        if ticket is not None:
            self.stats.inc("commit_tickets")
        self._drop_prepared(prep)
        if self.spill is not None:
            # ACK DURABILITY POINT: group-commit every journal frame
            # this batch appended (metadata + chunk + log records,
            # plus the prepared-record truncation) before any caller
            # observes the ack
            obs = self._obs
            t0 = time.perf_counter() if obs is not None else 0.0
            self.spill.sync()
            if obs is not None:
                obs.record("put.journal_sync_us",
                           (time.perf_counter() - t0) * 1e6)
        for key in prep.conflicted:
            out[key] = -1
        prep.resolved = True
        return out

    def _put_many_abort(self, prep: "_PreparedBatch") -> None:
        """Roll a prepared batch back: no version of it may ever become
        visible. Persistent-buffer entries and journal payload records
        are dropped, slab chunks rolled back out, heads finalized as
        failed (readers fall through to the previous version). Chunks
        already handed to the writeback queue may still persist as
        orphans in COS — they are unreachable: no committed metadata
        references them. Idempotent: aborting an already-resolved batch
        (the leader's best-effort abort fan-out) is a no-op."""
        if prep.resolved:
            return
        for key, c, ver, fkeys in prep.metas:
            if c.is_done():                       # already finalized
                continue
            for fkey in fkeys:
                self.pb.release_all(fkey)
                self._spill_drop_frag(fkey)
                for idx in range(self.cfg.ec.n):
                    self._free_chunk(f"{fkey}#{idx}")
            c.done(False)
        for _, _, c in prep.installed:
            if not c.is_done():
                c.done(False)
        self._drop_prepared(prep)
        if self.spill is not None:
            self.spill.sync()                     # persist the truncations
        prep.resolved = True

    def _free_chunk(self, ckey: str) -> None:
        """Drop one chunk from the daemon's chunk map and its slab,
        releasing the placement bytes — the rollback shared by
        superseded-version GC and 2PC batch abort."""
        with self._lock:
            fid = self.chunk_map.pop(ckey, None)
        if fid is not None and fid in self.sms.slabs:
            slab = self.sms.get(fid)
            data = slab.load(ckey)
            if slab.delete(ckey) and data is not None:
                self.placement.release(fid, len(data))
        self.window.unmark(ckey)

    def _gc_old_version(self, key: str, ver: int) -> None:
        """Free the superseded version's SMS chunks (COS retains them for
        any concurrent reader still on the old version)."""
        self._spill_drop_meta(f"{key}|{ver}")   # newer version journaled
        m = self.mt.load(f"{key}|{ver}")
        nfrags = m.num_fragments if m is not None else 1
        for fi in range(nfrags):
            for idx in range(self.cfg.ec.n):
                self._free_chunk(f"{key}|{ver}/f{fi}#{idx}")

    def _place_chunk(self, idx: int, nbytes: int) -> int:
        """PlaceChunk with the SLAB as the authority on fullness: if the
        placement ledger drifted (migrations/recovery add slab bytes it
        doesn't see), seal the FG to resync and probe on."""
        while True:
            fid = self.placement.place_chunk(idx, nbytes)
            slab = self.sms.get(fid)
            if slab.used < slab.hardcap:
                return fid
            self.placement.seal_fg(self.placement.functions[fid].fg_id)

    def _persist_chunk(self, fkey: str, ckey: str, chunk) -> None:
        """Route one chunk's COS persistence: inline on the ack path
        (legacy mode) or via the background writeback queue (handing
        over the journal record _put_fragments pre-appended)."""
        self.ledger.cos_op("put")
        if self.cfg.async_writeback:
            self.pb.retain(fkey)
            self.writeback.enqueue(f"chunk/{ckey}", chunk,
                                   seq=self._spill_put_seqs.pop(ckey, None),
                                   on_done=self._on_chunk_persisted)
        else:
            self.cos.put(f"chunk/{ckey}", to_host(chunk))

    def _spill_abort_chunks(self) -> None:
        """Kill pre-appended chunk/fragment journal records that were
        never handed over (their fragment failed or the PUT aborted)."""
        seqs, self._spill_put_seqs = self._spill_put_seqs, {}
        fseqs, self._spill_put_frag_seqs = self._spill_put_frag_seqs, {}
        if self.spill is not None:
            for seq in list(seqs.values()) + list(fseqs.values()):
                self.spill.mark_persisted(seq)

    def _spill_drop_frag(self, fkey: str) -> None:
        """The fragment's persistent-buffer entry fully drained (every
        chunk persisted): truncate its journal payload record."""
        if self.spill is None:
            return
        with self._lock:
            seq = self._spill_frag_seqs.pop(fkey, None)
        if seq is not None:
            self.spill.mark_persisted(seq)

    def _on_chunk_persisted(self, cos_key: str, ok: bool) -> None:
        """Writeback completion: drop the chunk's persistent-buffer ref
        (the last drop also truncates the fragment's journal record).
        A write that exhausted its retries keeps the ref — the buffer
        stays the durable copy rather than silently losing data."""
        if ok:
            fkey = cos_key[len("chunk/"):].rsplit("#", 1)[0]
            if self.pb.release(fkey):
                self._spill_drop_frag(fkey)

    def _put_fragments(self, frags: List[Tuple[str, torch.Tensor]]
                       ) -> Set[str]:
        """Encode ALL fragments in one `encode_many` call (array chunks:
        uint8 views into the stacked encode buffer, no bytes copies),
        place every chunk, then drain the writes grouped by target
        function: one `_invoke` covering the function's whole byte share
        (amortizing the per-request busy-time base of the billing model,
        §5.2) and one insertion-log append per function (§5.5.1).
        Returns the set of fragment keys whose chunks failed to store."""
        if not frags:
            return set()
        obs = self._obs
        with (obs.span("ec.encode", fragments=len(frags))
              if obs is not None else NOOP_CM):
            all_chunks = self.codec.encode_many(
                [frag for _, frag in frags], as_arrays=True)
        # single-fragment batches skip the compaction memcpy: the stacked
        # encode buffer IS that fragment's chunk set (data rows + parity,
        # ~(k+p)/k of the payload), so aliasing it pins nothing foreign —
        # and the copy was GIL-held time that throttled multi-daemon
        # scale-out. Multi-fragment batches still compact each chunk out
        # so one long-lived chunk never pins the whole batch buffer.
        compact = len(frags) > 1
        groups: Dict[int, List[Tuple[str, str, object]]] = {}
        for (fkey, _), chunks in zip(frags, all_chunks):
            for idx, chunk in enumerate(chunks):
                ckey = f"{fkey}#{idx}"
                fid = self._place_chunk(idx, len(chunk))
                groups.setdefault(fid, []).append(
                    (fkey, ckey, chunk.clone() if compact else chunk))
        if self.spill is not None and self.cfg.async_writeback:
            # journal each fragment's pre-EC payload ONCE (zero-copy u8
            # view — the chunks are deterministically derivable) plus a
            # tiny stub frame per chunk record, in one batched append.
            # Replay re-encodes the fragment to regenerate stub chunks
            # and restores the persistent-buffer entry. Stubs follow
            # their fragment in the journal, so a torn tail can only
            # cost stubs of the LAST (necessarily unacked) PUT its
            # fragment record — acked data always survives. The journal
            # holds host bytes: a device fragment is copied device-to-
            # host here, before the ack (durability is the result).
            ckeys = [ckey for items in groups.values()
                     for _, ckey, _ in items]
            seqs = self.spill.append_many(
                [(f"frag/{fk}", to_host(frag)) for fk, frag in frags]
                + [(f"chunk/{ck}", b"") for ck in ckeys])
            for (fkey, _), seq in zip(frags, seqs):
                self._spill_put_frag_seqs[fkey] = seq
            for ckey, seq in zip(ckeys, seqs[len(frags):]):
                self._spill_put_seqs[ckey] = seq
        # phase 1: slab writes only, so a fragment can still fail before
        # anything about it becomes durable
        failed: Set[str] = set()
        written: Dict[int, List[Tuple[str, str, object]]] = {}
        for fid, items in groups.items():
            slab = self.sms.get(fid)
            self._invoke(fid, sum(len(c) for _, _, c in items), "request")
            for fkey, ckey, chunk in items:
                tfid = fid
                stored = slab.store(ckey, chunk)
                if not stored:
                    # the slab refused what the ledger allowed: batch
                    # placement ran before any write, so _place_chunk's
                    # slab-authority resync (§5.3.1) never saw the bytes
                    # this batch already stored here. Release and
                    # re-place now that slab.used is live.
                    self.placement.release(tfid, len(chunk))
                    idx = int(ckey.rsplit("#", 1)[1])
                    for _ in range(3):
                        tfid = self._place_chunk(idx, len(chunk))
                        tslab = self.sms.get(tfid)
                        self._invoke(tfid, len(chunk), "request")
                        if tslab.store(ckey, chunk):
                            stored = True
                            break
                        self.placement.release(tfid, len(chunk))
                if stored:
                    written.setdefault(tfid, []).append((fkey, ckey, chunk))
                else:
                    failed.add(fkey)
        # phase 2: failed fragments roll their stored chunks back out of
        # the slabs; surviving fragments become visible (chunk_map), are
        # queued for COS persistence (§5.3.2), and land in the insertion
        # log — the durable point
        for fid, items in written.items():
            slab = self.sms.get(fid)
            records: List[PutRecord] = []
            for fkey, ckey, chunk in items:
                if fkey in failed:
                    if slab.delete(ckey):
                        self.placement.release(fid, len(chunk))
                    continue
                with self._lock:
                    self.chunk_map[ckey] = fid
                self._persist_chunk(fkey, ckey, chunk)
                records.append(PutRecord(key=ckey, size=len(chunk),
                                         version=0))
            # consolidate this window's records into insertion nodes
            if records:
                log = self.logs[fid]
                log.append(records)
                slab.term = log.term
                slab.log_hash = log.last_hash
                slab.diff_rank = log.diff_rank
                self.daemon_view[fid] = log.piggyback()
        # failed fragments' pre-appended journal records die here;
        # surviving fragments' records commit (dropped when the buffer
        # entry drains — _on_chunk_persisted / the ack-point release).
        # Only the leftover CHUNK stubs are killed — _spill_abort_chunks
        # would also void the surviving fragments' payload records,
        # losing acked data on a crash (the mixed-failure-batch hole)
        if self._spill_put_seqs:
            seqs, self._spill_put_seqs = self._spill_put_seqs, {}
            for seq in seqs.values():
                self.spill.mark_persisted(seq)
        if self._spill_put_frag_seqs:
            frag_seqs, self._spill_put_frag_seqs = \
                self._spill_put_frag_seqs, {}
            for fkey, seq in frag_seqs.items():
                if fkey in failed:
                    self.spill.mark_persisted(seq)
                else:
                    with self._lock:
                        self._spill_frag_seqs[fkey] = seq
        return failed

    # ------------------------------------------------------------------
    # GET (Appendix A right + §5.3.3)
    # ------------------------------------------------------------------

    def get(self, key: str) -> Optional[bytes]:
        return self.get_async(key).result()

    def get_async(self, key: str) -> StoreFuture:
        """Non-blocking GET; the future resolves to bytes or None."""
        return self._submit(lambda: self._get_many_impl([key])[key])

    def get_many(self, keys) -> Dict[str, Optional[bytes]]:
        return self.get_many_async(keys).result()

    def get_many_async(self, keys) -> StoreFuture:
        """Batch GET: chunk reads are grouped into ONE invoke per function
        across the whole gather, and ALL fragments needing EC
        reconstruction are decoded by a single `decode_many` call. The
        future resolves to {key: value-or-None}."""
        keys = list(keys)
        obs = self._obs
        with (obs.span("client.get_many", n=len(keys))
              if obs is not None else NOOP_CM):
            return self._submit(lambda: self._get_many_impl(keys))

    def get_array(self, key: str) -> Optional[torch.Tensor]:
        """GET returning a flat uint8 tensor on the store's device (no
        bytes materialization) — the device/checkpoint payload path."""
        return self.get_many_arrays([key])[key]

    def get_many_arrays(self, keys) -> Dict[str, Optional[torch.Tensor]]:
        return self.get_many_arrays_async(keys).result()

    def get_many_arrays_async(self, keys) -> StoreFuture:
        keys = list(keys)
        return self._submit(
            lambda: self._get_many_impl(keys, as_arrays=True))

    def _get_many_impl(self, keys, *, as_arrays: bool = False) -> Dict:
        obs = self._obs
        with (obs.span("daemon.get_many", n=len(keys))
              if obs is not None else NOOP_CM) as span:
            if self.cfg.pipelined_get:
                out = self._get_many_pipelined(keys, as_arrays=as_arrays)
            else:
                out = self._get_many_serial(keys, as_arrays=as_arrays)
        if obs is not None and span is not None:
            # the daemon's host time for the batch: the span's own length
            obs.record("daemon.get_us", span.dur_s * 1e6)
        return out

    def _plan_gets(self, keys, out: Dict, as_arrays: bool):
        """Shared GET planning: resolve metadata, serve read-after-write
        fragments from the persistent buffer, and list the fragment keys
        that need a chunk gather. Tensors are writable, so an array GET
        gets its own device copy of a buffered fragment, never an alias
        of the buffer's durable bytes."""
        plans: List[Tuple[str, object, List[object]]] = []
        gather_fkeys: List[str] = []
        for key in keys:
            self.stats.inc("gets")
            m = self._resolve_meta(key)
            if m is None:
                out[key] = None
                continue
            parts: List[object] = []   # payload, or str fkey placeholder
            for fi in range(m.num_fragments):
                fkey = f"{key}|{m.ver}/f{fi}"
                buf = self.pb.load(fkey)             # read-after-write
                if buf is not None:
                    self.stats.inc("buffer_hits")
                    parts.append(as_u8(buf).to(self.device, copy=True)
                                 if as_arrays else buf)
                else:
                    parts.append(fkey)
                    gather_fkeys.append(fkey)
            plans.append((key, m, parts))
        return plans, gather_fkeys

    def _get_many_serial(self, keys, *, as_arrays: bool = False) -> Dict:
        """The legacy GET path (pipelined_get=False, the A/B baseline):
        gather EVERY fragment's chunks — COS fallbacks one chunk at a
        time — then decode everything behind one global barrier."""
        out: Dict = {}
        plans, gather_fkeys = self._plan_gets(dict.fromkeys(keys), out,
                                              as_arrays)
        gathered = self._gather_many(gather_fkeys) if gather_fkeys else {}
        batch: List[Dict[int, object]] = []
        final: List[Tuple[str, object, List[object]]] = []
        for key, m, parts in plans:
            resolved: List[object] = []
            for p in parts:
                if isinstance(p, str):               # needs chunk gather
                    chunks = gathered.get(p)
                    if chunks is None:
                        out[key] = None
                        resolved = None
                        break
                    resolved.append(len(batch))
                    batch.append(chunks)
                else:
                    resolved.append(p)
            if resolved is not None:
                # only successful keys reach the decode batch; a failed
                # key's already-gathered fragments are dropped here
                final.append((key, m, resolved))
        # fragments decode to tensors on the device; _assemble joins
        # them there and a bytes GET crosses to the host once
        decoded = self.codec.decode_many(batch, as_arrays=True) \
            if batch else []
        for key, m, parts in final:
            pieces = [decoded[p] if isinstance(p, int) else p
                      for p in parts]
            val = self._assemble(pieces, m.size, as_arrays)
            self._track_queue(payload_nbytes(val))
            out[key] = val
        return out

    def _get_many_pipelined(self, keys, *, as_arrays: bool = False) -> Dict:
        """The pipelined GET data path: (1) plan + buffer hits, (2) one
        grouped SMS sweep (at most one invoke per function), (3) every
        still-short fragment's missing chunks fan out to COS on the
        bounded I/O executor AT ONCE, (4) fragments decode in ready-order
        batches while those reads are in flight — decode of fragment A
        overlaps the gather of fragment B instead of a global barrier.
        The sequential-scan prefetcher warms the predicted next objects'
        chunks on the same executor during decode."""
        self._harvest_prefetch()
        out: Dict = {}
        ordered = list(dict.fromkeys(keys))
        plans, gather_fkeys = self._plan_gets(ordered, out, as_arrays)
        if gather_fkeys:
            # readahead is issued inside the gather, AFTER this batch's
            # own demand reads hit the FIFO executor — warms overlap the
            # decode without ever delaying the critical path
            frags = self._gather_decode_pipelined(
                gather_fkeys, prefetch_keys=ordered)
        else:
            frags = {}
            self._maybe_prefetch(ordered)
        for key, m, parts in plans:
            pieces: Optional[List[object]] = []
            for p in parts:
                if isinstance(p, str):
                    p = frags.get(p)
                    if p is None:                    # fragment lost
                        pieces = None
                        break
                pieces.append(p)
            if pieces is None:
                out[key] = None
                continue
            val = self._assemble(pieces, m.size, as_arrays)
            self._track_queue(payload_nbytes(val))
            out[key] = val
        self._sync_prefetch_stats()
        return out

    def _sms_sweep(self, fkeys: Sequence[str],
                   have: Dict[str, Dict[int, object]],
                   degraded_out: List[str]) -> None:
        """The grouped SMS sweep shared by both GET paths: round 0 reads
        the first k mapped chunks per fragment (EC needs only k); round 1
        widens to the remaining mapped chunks for fragments a failed read
        left short. Each round groups reads by function — at most ONE
        invoke per function across the whole sweep."""
        n, k = self.cfg.ec.n, self.cfg.ec.k
        candidates: Dict[str, List[Tuple[int, str, int]]] = {}
        for fkey in fkeys:
            cand = []
            for idx in range(n):
                ckey = f"{fkey}#{idx}"
                fid = self.chunk_map.get(ckey)
                if fid is not None:
                    cand.append((idx, ckey, fid))
            candidates[fkey] = cand
        tried: Set[Tuple[str, int]] = set()
        invoked: Set[int] = set()
        for rnd in (0, 1):
            groups: Dict[int, List[Tuple[str, int, str]]] = {}
            for fkey, cand in candidates.items():
                if len(have[fkey]) >= k:
                    continue
                sel = cand[:k] if rnd == 0 else cand
                for idx, ckey, fid in sel:
                    if (fkey, idx) in tried or idx in have[fkey]:
                        continue
                    tried.add((fkey, idx))
                    groups.setdefault(fid, []).append((fkey, idx, ckey))
            for fid, group in groups.items():
                for fkey, idx, data in self._read_chunks_grouped(
                        fid, group, degraded_out, invoked):
                    have[fkey][idx] = data

    def _gather_decode_pipelined(self, fkeys: Sequence[str], *,
                                 prefetch_keys: Optional[Sequence[str]]
                                 = None) -> Dict[str, Optional[object]]:
        """fkey -> reconstructed fragment payload, a uint8 tensor on the
        store's device (None = unrecoverable).

        Degraded-bucket hits are queued for gc_tick's compaction round
        instead of migrating inline — the read path never blocks on
        maintenance COS I/O. Demand reads reuse in-flight prefetch
        futures rather than duplicating the fetch."""
        n, k = self.cfg.ec.n, self.cfg.ec.k
        fkeys = list(dict.fromkeys(fkeys))
        have: Dict[str, Dict[int, object]] = {f: {} for f in fkeys}
        degraded: List[str] = []
        obs = self._obs
        t0 = (time.perf_counter() if obs is not None and obs.enabled
              else None)
        self._sms_sweep(fkeys, have, degraded)
        if obs is not None and t0 is not None:
            obs.record("get.sms_sweep_us",
                       (time.perf_counter() - t0) * 1e6)
        if degraded:
            self._pending_migrations.update(dict.fromkeys(degraded))
        # stage 2: every short fragment's demand reads fan out at once
        # (bounded by the executor's get_io_workers), all fragments
        # concurrently. Within a fragment the reads go data-row-first:
        # exactly k-|got| missing chunks in index order, so a fully-lost
        # fragment reconstructs via the identity fast path (concat, no
        # GF(256) matmul); the remaining indices (usually parity) stay in
        # reserve and refill one-for-one when a read comes back empty.
        futs: Dict[Future, Tuple[str, int, str]] = {}
        frag_pending: Dict[str, Set[Future]] = {}
        reserve: Dict[str, List[int]] = {}

        def submit(fkey: str, idx: int) -> None:
            ckey = f"{fkey}#{idx}"
            fut = self._prefetch_inflight.pop(ckey, None)
            if fut is None:
                # no readahead in flight for this chunk — issue the read.
                # Adopted warms are counted as hits only when their data
                # actually arrives (stage 3), never at adoption time
                self.stats.inc("cos_fallback_reads")
                fut = self._io.submit(
                    obs.bind_current(self._cos_fetch_task)
                    if obs is not None else self._cos_fetch_task,
                    f"chunk/{ckey}")
            futs[fut] = (fkey, idx, ckey)
            frag_pending.setdefault(fkey, set()).add(fut)

        for fkey in fkeys:
            got = have[fkey]
            if len(got) >= k:
                continue
            missing = [idx for idx in range(n) if idx not in got]
            short = k - len(got)
            reserve[fkey] = missing[short:]
            for idx in missing[:short]:
                submit(fkey, idx)
        if prefetch_keys is not None:
            # readahead enqueues BEHIND this batch's demand reads (FIFO
            # executor): warms fill idle workers during the decode below
            # without ever delaying the critical path
            self._maybe_prefetch(prefetch_keys)
        # stage 3: ready-order decode overlapping the in-flight reads
        out: Dict[str, Optional[object]] = {}
        batch_size = max(1, self.cfg.decode_batch_fragments)
        queue: List[str] = [f for f in fkeys if len(have[f]) >= k]
        settled: Set[str] = set(queue)
        while queue or futs:
            if queue:
                batch, queue = queue[:batch_size], queue[batch_size:]
                td = (time.perf_counter()
                      if obs is not None and obs.enabled else None)
                with (obs.span("get.decode", fragments=len(batch))
                      if obs is not None else NOOP_CM):
                    vals = self.codec.decode_many(
                        [have[f] for f in batch], as_arrays=True)
                self.stats.inc("decode_batches")
                if obs is not None and td is not None:
                    obs.record("get.decode_batch_us",
                               (time.perf_counter() - td) * 1e6)
                out.update(zip(batch, vals))
                continue
            ready, _ = wait(list(futs), return_when=FIRST_COMPLETED)
            for fut in ready:
                fkey, idx, ckey = futs.pop(fut)
                frag_pending[fkey].discard(fut)
                try:
                    data = fut.result()
                except OpDeadlineExceeded:
                    # a configured per-op deadline is a caller contract:
                    # it must surface through the GET's StoreFuture, not
                    # silently degrade into a miss
                    raise
                except Exception:                     # noqa: BLE001
                    data = None
                if data is None:
                    # a failed adopted warm counts as waste, not a hit
                    self.prefetcher.discard(ckey)
                    if fkey not in settled and reserve.get(fkey):
                        submit(fkey, reserve[fkey].pop(0))
                else:
                    self.prefetcher.consume(ckey)     # adopted warm: hit
                    # a COS chunk crosses to the device once, here
                    data = to_device(data, self.device)
                    # §5.3.3 on-demand migration: cache the chunk even if
                    # its fragment already decoded — the next GET hits SMS
                    self._demand_cache(ckey, data)
                    if fkey not in settled:
                        have[fkey][idx] = data
                        if len(have[fkey]) >= k:
                            settled.add(fkey)
                            queue.append(fkey)
                if fkey not in settled and not frag_pending[fkey]:
                    settled.add(fkey)                 # short for good
                    out[fkey] = None
        for fkey in fkeys:
            out.setdefault(fkey, None)
        return out

    def _assemble(self, pieces: List[object], size: int, as_arrays: bool):
        """Join fragment payloads into the object value, trimmed to the
        metadata size. Pieces are concatenated on the store's device: an
        array GET returns that uint8 tensor, a bytes GET copies it
        device-to-host once. A bytes GET whose pieces all lie on the host
        (buffer hits of host payloads) joins them there instead."""
        if not as_arrays and not any(
                isinstance(p, torch.Tensor) and p.device.type != "cpu"
                for p in pieces):
            val = b"".join(to_bytes(p) for p in pieces)
            return val[:size] if size else val
        val = to_device(pieces[0], self.device) if len(pieces) == 1 \
            else torch.cat([to_device(p, self.device) for p in pieces])
        val = val[:size] if size else val
        return val if as_arrays else to_bytes(val)

    def _resolve_meta(self, key: str):
        """Follow the version chain to the newest done-ok metadata. A
        head prepared by an uncommitted cross-shard batch is NOT waited
        on (its commit is queued behind this GET on the same daemon):
        uncommitted data is invisible, so the read falls through to the
        previous version immediately."""
        m = self.mt.load(key)
        attempts = 0
        while m is not None and not m.is_done_ok() and attempts < 8:
            if not m.is_done() and not m.prepared:    # concurrent PUT
                m.wait(timeout=5.0)
            if m.is_done_ok():
                break
            if m.prev_ver <= 0:
                return None
            m = self.mt.load(f"{key}|{m.prev_ver}")
            attempts += 1
        if m is None or not m.is_done_ok():
            return None
        return m

    def _gather_many(self, fkeys: Sequence[str]
                     ) -> Dict[str, Optional[Dict[int, object]]]:
        """Gather >= k chunks for every fragment, issuing AT MOST ONE
        invoke per function across the whole gather (the GET-side mirror
        of the PUT-side per-function grouping). The legacy serial path:
        degraded hits migrate inline, COS fallbacks run one chunk at a
        time."""
        n, k = self.cfg.ec.n, self.cfg.ec.k
        have: Dict[str, Dict[int, object]] = {f: {} for f in fkeys}
        degraded: List[str] = []
        self._sms_sweep(fkeys, have, degraded)
        if degraded:
            self._migrate_chunks(degraded)            # sync migration
        out: Dict[str, Optional[Dict[int, object]]] = {}
        for fkey, got in have.items():
            if len(got) < k:
                # on-demand migration from COS (§5.3.3); the pending
                # writeback map covers acked-but-unpersisted chunks
                for idx in range(n):
                    if idx in got:
                        continue
                    ckey = f"{fkey}#{idx}"
                    self.stats.inc("cos_fallback_reads")
                    data = self._cos_read_consistent(f"chunk/{ckey}")
                    if data is not None:
                        data = to_device(data, self.device)
                        got[idx] = data
                        self._demand_cache(ckey, data)
                    if len(got) >= k:
                        break
            out[fkey] = got if len(got) >= k else None
        return out

    def _read_chunks_grouped(self, fid: int,
                             items: List[Tuple[str, int, str]],
                             degraded_out: List[str],
                             invoked: Set[int]) -> List[Tuple[str, int, object]]:
        """Read this function's share of a gather with ONE invoke (and
        one consolidated ledger charge for the bytes served)."""
        out: List[Tuple[str, int, object]] = []
        slab = self.sms.slabs.get(fid)
        if slab is None:                              # function released
            self.stats.inc("sms_chunk_misses", len(items))
            return out
        state = self.window.state_of_function(fid)
        if state is None or state == BucketState.RELEASED:
            self.stats.inc("sms_chunk_misses", len(items))
            return out
        if fid not in invoked:
            self._invoke(fid, 0, "request")
            self.stats.inc("gather_invokes")
            invoked.add(fid)
        nbytes = 0
        for fkey, idx, ckey in items:
            data = self.recovery.serve_during_recovery(fid, ckey)
            if data is None:
                data = slab.load(ckey)
            if data is None:
                self.stats.inc("sms_chunk_misses")
                continue
            self.stats.inc("sms_chunk_hits")
            self.prefetcher.consume(ckey)
            nbytes += len(data)
            # mark re-accessed data for compaction (§5.3.3)
            self.window.mark(ckey)
            if state == BucketState.DEGRADED:
                self.stats.inc("degraded_hits")
                degraded_out.append(ckey)
            out.append((fkey, idx, data))
        if nbytes:
            self.ledger.invoke("request", gb=slab.capacity / 1024**3,
                               seconds=nbytes * self.cfg.busy_per_byte_s)
        return out

    def _cos_read_consistent(self, key: str,
                             max_tries: Optional[int] = None):
        """SCFS-style consistency-increasing loop: retry until the
        eventually-consistent COS shows the object (Appendix A), with
        capped exponential backoff derived from the configured
        `cos_visibility_lag`. Unified with the store's RetryPolicy
        (repro_torch.core.faults): transient/throttle COS errors retry on the
        policy's backoff schedule inside the same attempt budget,
        permanent errors raise immediately, and an optional per-op
        deadline (`cfg.cos_op_deadline_s`) raises OpDeadlineExceeded —
        surfaced through the GET's StoreFuture — instead of burning the
        full budget. Writes still queued for persistence are served
        from the writeback pending map — they're not in COS yet by
        construction. Thread-safe: runs on the daemon thread (legacy
        path) or the GET I/O executor (pipelined fan-out); the ledger is
        charged under the store lock."""
        policy = self.cos_retry
        tries = max_tries if max_tries is not None else \
            policy.max_attempts
        deadline_s = self.cfg.cos_op_deadline_s
        start = time.monotonic()
        for attempt in range(1, tries + 1):
            data = self.writeback.peek(key)
            if data is not None:
                return data
            last_exc = None
            try:
                data = self.cos.get(key)
            except Exception as e:                # noqa: BLE001
                kind = policy.classify(e)
                if kind == RetryPolicy.PERMANENT:
                    raise
                last_exc, data = e, None
            with self._lock:
                self.ledger.cos_op("get")
            if data is not None:
                return data
            if last_exc is not None:              # error backoff
                delay = policy.delay(attempt, policy.classify(last_exc))
            else:                                 # visibility backoff
                delay = min(policy.backoff_base_s * (2.0 ** (attempt - 1)),
                            policy.backoff_cap_s)
            if deadline_s is not None and \
                    time.monotonic() - start + delay > deadline_s:
                raise OpDeadlineExceeded(
                    f"COS read {key!r}: {deadline_s:.3f}s deadline "
                    f"exceeded after {attempt} attempts") from last_exc
            if self.clock.is_wall:
                time.sleep(delay)
            else:
                self.clock.advance(delay)
        return None

    def _cos_fetch_task(self, cos_key: str):
        """I/O-executor body for one demand/prefetch chunk read. Touches
        only thread-safe layers (pending map, COS, clock, ledger under
        the store lock); all store mutation happens back on the daemon
        thread when the future is harvested."""
        obs = self._obs
        if obs is None:
            return self._cos_read_consistent(cos_key)
        t0 = time.perf_counter()
        with obs.span("get.cos_fallback", key=cos_key):
            data = self._cos_read_consistent(cos_key)
        obs.record("get.cos_fallback_us",
                   (time.perf_counter() - t0) * 1e6)
        return data

    # ------------------------------------------------------------------
    # prefetch (sequential-scan readahead)
    # ------------------------------------------------------------------

    def _maybe_prefetch(self, keys: Sequence[str]) -> None:
        """Sequential-scan readahead: predict the next objects of
        detected key runs (checkpoint shard restore, KV page restore —
        ordered trailing-index scans) and warm their non-resident chunks
        from COS into bucket cache space via the I/O executor. The
        fetches run while THIS GET decodes; the next GETs in the scan
        consume them as ordinary SMS cache hits."""
        if not self.prefetcher.cfg.enabled:
            return
        k, n = self.cfg.ec.k, self.cfg.ec.n
        predicted = self.prefetcher.observe(keys)
        for ckey in self.prefetcher.take_dropped():
            # a cancelled/pruned run's warms must not keep occupying the
            # executor ahead of future demand reads
            fut = self._prefetch_inflight.pop(ckey, None)
            if fut is not None:
                fut.cancel()
        for pkey, stem in predicted:
            m = self.mt.load(pkey)
            if m is None or not m.is_done_ok():
                continue                   # unknown or in-flight object
            for fi in range(m.num_fragments):
                fkey = f"{pkey}|{m.ver}/f{fi}"
                if self.pb.load(fkey) is not None:
                    continue               # persistent buffer serves it
                resident = 0
                absent: List[str] = []
                for idx in range(n):
                    ckey = f"{fkey}#{idx}"
                    if ckey in self._prefetch_inflight \
                            or self._chunk_resident(ckey):
                        resident += 1
                    else:
                        absent.append(ckey)
                # warm just enough absent chunks that any k are servable
                for ckey in absent[:max(0, k - resident)]:
                    if len(self._prefetch_inflight) >= \
                            self.cfg.prefetch_max_inflight:
                        return
                    self.prefetcher.record_issued(ckey, stem)
                    self._prefetch_inflight[ckey] = self._io.submit(
                        self._cos_fetch_task, f"chunk/{ckey}")

    def _chunk_resident(self, ckey: str) -> bool:
        """Is this chunk servable from SMS (storage or cache space)?"""
        fid = self.chunk_map.get(ckey)
        if fid is None:
            return False
        state = self.window.state_of_function(fid)
        if state is None or state == BucketState.RELEASED:
            return False
        slab = self.sms.slabs.get(fid)
        return slab is not None and slab.load(ckey) is not None

    def _harvest_prefetch(self) -> None:
        """Apply completed warm fetches (daemon thread only): loaded
        chunks go into bucket cache space + the chunk map, so the next
        GET's grouped SMS sweep serves them as cache hits."""
        if not self._prefetch_inflight:
            return
        done = [ck for ck, f in self._prefetch_inflight.items()
                if f.done()]
        for ckey in done:
            fut = self._prefetch_inflight.pop(ckey)
            try:
                data = fut.result()
            except Exception:                         # noqa: BLE001
                data = None
            if data is None:
                self.prefetcher.discard(ckey)
            else:
                self._demand_cache(ckey, data)

    def _sync_prefetch_stats(self) -> None:
        """Mirror the prefetcher's accounting into StoreStats (one sync
        point per GET / gc_tick instead of per consume/waste site)."""
        self.stats.prefetch_hits = self.prefetcher.stats.hits
        self.stats.prefetch_wasted = self.prefetcher.stats.wasted

    # ------------------------------------------------------------------
    # demand caching + compaction + GC
    # ------------------------------------------------------------------

    def _cache_target_fid(self) -> Optional[int]:
        """A slab to host evictable cache-space bytes WITHOUT forcing a
        scale-out: open-FG slabs first (the latest bucket's cache
        functions, §5.3.3), else any alive ACTIVE-bucket slab. None when
        nothing suitable exists — caching is an optimization, never
        worth spinning up a function group."""
        for fg_id in self.placement.open_fg_ids:
            for fid in self.placement.fgs[fg_id].fids:
                slab = self.sms.slabs.get(fid)
                if slab is not None and slab.alive:
                    return fid
        for fid, slab in self.sms.slabs.items():
            if slab.alive and self.window.state_of_function(fid) \
                    == BucketState.ACTIVE:
                return fid
        return None

    def _demand_cache(self, ckey: str, data) -> None:
        """GET-triggered caching into the latest bucket's cache space
        (§5.3.3 'cache functions'); evictable, not counted against
        HARDCAP, and never a reason to spin up a new function group."""
        fid = self._cache_target_fid()
        if fid is None:
            return
        self.sms.get(fid).cache_put(ckey, to_device(data, self.device))
        with self._lock:
            self.chunk_map[ckey] = fid
        self.stats.inc("migrations")

    def _migrate_chunks(self, ckeys: List[str]) -> None:
        """Compaction: move marked/hit chunks into the latest GC-bucket by
        loading them from COS into newly placed slots (§5.3.3). Under the
        pipelined GET path this runs from gc_tick, off the read critical
        path. When no open function can take the chunk it is re-marked
        and skipped: read-path maintenance must not force a scale-out
        (`try_place_chunk` never spins up a function group)."""
        for ckey in ckeys:
            if not self.placement.open_fg_ids:
                self.window.mark(ckey)
                continue
            data = self.writeback.peek(f"chunk/{ckey}")
            if data is None:
                try:
                    data = self.cos.get(f"chunk/{ckey}")
                except Exception as e:            # noqa: BLE001
                    if self.cos_retry.classify(e) \
                            == RetryPolicy.PERMANENT:
                        raise
                    # compaction is maintenance: a transient COS error
                    # re-marks the chunk for the next round rather than
                    # stalling gc_tick on a retry loop
                    self.window.mark(ckey)
                    continue
                finally:
                    with self._lock:  # I/O-executor reads charge it too
                        self.ledger.cos_op("get")
            if data is None:
                old = self.chunk_map.get(ckey)
                data = self.sms.slabs[old].load(ckey) if old is not None \
                    and old in self.sms.slabs else None
            if data is None:
                continue
            data = to_device(data, self.device)
            idx = int(ckey.rsplit("#", 1)[1])
            while True:
                fid = self.placement.try_place_chunk(idx, len(data))
                if fid is None or self.sms.get(fid).used \
                        < self.sms.get(fid).hardcap:
                    break
                # slab is the authority on fullness (§5.3.1): resync the
                # drifted ledger by sealing and probe the next open FG
                self.placement.release(fid, len(data))
                self.placement.seal_fg(self.placement.functions[fid].fg_id)
            if fid is None:
                self.window.mark(ckey)    # retry once capacity opens
                continue
            slab = self.sms.get(fid)
            self._invoke(fid, len(data), "request")
            if not slab.store(ckey, data):
                self.placement.release(fid, len(data))
            else:
                old = self.chunk_map.get(ckey)
                with self._lock:
                    self.chunk_map[ckey] = fid
                if old is not None and old != fid and old in self.sms.slabs:
                    self.sms.get(old).delete(ckey)
                    self.placement.release(old, len(data))
                log = self.logs[fid]
                log.append([PutRecord(key=ckey, size=len(data), version=0)])
                slab.term, slab.log_hash, slab.diff_rank = \
                    log.term, log.last_hash, log.diff_rank
                self.daemon_view[fid] = log.piggyback()
                self.window.unmark(ckey)
                self.stats.inc("compactions")

    def gc_tick(self) -> None:
        """Run due GC + one compaction round + warmups + a writeback
        drain slice. Call periodically (the serving engine ticks this;
        tests drive the clock). Runs on the client-daemon thread so it
        serializes with in-flight async PUT/GETs."""
        self._submit(self._gc_tick_impl).result()

    def _gc_tick_impl(self) -> None:
        self._harvest_prefetch()
        self._sync_prefetch_stats()
        if self._pending_migrations:
            # degraded-read compaction deferred by the pipelined GET path
            pending = list(self._pending_migrations)
            self._pending_migrations.clear()
            self._migrate_chunks(pending)
        if self.window.due():
            ev = self.window.run_gc()
            # carry open FGs into the new bucket (Fig. 4c)
            for fg_id in self.placement.carry_over_open_fgs():
                for fid in self.placement.fgs[fg_id].fids:
                    ev.new_bucket.add_function(fid, fg_id)
            for fid in ev.released_functions:
                slab = self.sms.slabs.get(fid)
                if slab is not None:
                    slab.reclaim()                    # provider reclaims
        round_keys = self.window.take_compaction_round(self.rng)
        if round_keys:
            self._migrate_chunks(round_keys)
        self._warmup_tick()
        if self.cfg.async_writeback:
            self.writeback.drain(32)                  # §5.3.2 retry point
        # expire temporary recovery placements past retain_seconds (§5.5.2)
        self.recovery.sweep_expired(self.clock.now())
        # provider-side reclamation of long-idle instances
        self.sms.reclaim_idle(self.cfg.provider_idle_reclaim)
        # size-bounded metadata log: fold accumulated meta records +
        # tombstones into one snapshot at a new journal generation
        self._maybe_snapshot_meta()
        if self.spill is not None:
            # group-commit any journal frames the tick produced
            # (migration/compaction insertion-log appends)
            self.spill.sync()

    def _warmup_tick(self) -> None:
        """No-op heartbeat per FMP: active buckets every active_warmup,
        degraded every degraded_warmup (§5.3)."""
        now = self.clock.now()
        for fid, slab in self.sms.slabs.items():
            period = self.window.warmup_period(fid)
            if period is None or not slab.alive:
                continue
            if now - slab.last_invoked >= period:
                slab.invoke(0.001)
                self.ledger.invoke("warmup", gb=slab.capacity / 1024**3,
                                   seconds=0.001)

    # ------------------------------------------------------------------
    # misc
    # ------------------------------------------------------------------

    def _track_queue(self, nbytes: int) -> None:
        if nbytes <= self.cfg.small_request_bytes:
            self.stats.inc("small_requests")
        else:
            self.stats.inc("large_requests")

    def inject_failure(self, fid: int) -> None:
        """Simulate provider reclaiming an instance (tests/benchmarks)."""
        self.sms.get(fid).reclaim()

    def num_functions(self, state: Optional[BucketState] = None) -> int:
        if state is None:
            return len(self.sms.slabs)
        return sum(len(b.function_ids)
                   for b in self.window.buckets(state))

    def health(self) -> dict:
        """Operator-facing health summary: the writeback queue's state
        machine (OK vs DEGRADED_WRITEBACK with its outage evidence),
        permanently-failed (data-at-risk) keys, and any 2PC tickets
        still in doubt. Racy-read consistency like every other stats
        surface — safe from any thread."""
        wb = self.writeback.health()
        self.stats.writeback_permanent_failures = wb["permanent_failures"]
        return {"state": wb["state"],
                "writeback": wb,
                "indoubt_tickets": sorted(
                    set(self._indoubt) | set(self._prepared_tickets)),
                "spill_pending": self.spill.pending_count
                if self.spill is not None else 0}

    def snapshot_metadata(self):
        """Point-in-time view of the daemon's tables and counters.

        Consistency model: every counter read is individually atomic
        (see `StoreStats`), but the snapshot is NOT a consistent cut —
        it is assembled without the store lock while the daemon, the
        writeback writer, and GET I/O workers keep mutating, so
        counters may be mutually skewed by whatever was in flight.
        Structural maps (`mt`, `chunk_map`) are copied under their own
        locks and are internally consistent."""
        with self._lock:
            meta_records = sum(1 for s in self._spill_meta_seqs.values()
                               if s != _SNAP_COVERED)
            snap_covered = len(self._spill_meta_seqs) - meta_records
            tombstones = len(self._spill_tombstones)
        # ONE counter snapshot feeds every derived field below — each
        # reported ratio is internally consistent instead of re-reading
        # live counters per term (see StoreStats.derived)
        stats = self.stats.as_dict()
        return {"mt": self.mt.snapshot(),
                "health": self.health(),
                "chunk_map": dict(self.chunk_map),
                "stats": stats,
                "derived": StoreStats.derived(stats),
                "get_pipeline": {
                    "pipelined": self.cfg.pipelined_get,
                    "prefetch_hits": stats["prefetch_hits"],
                    "prefetch_wasted": stats["prefetch_wasted"],
                    "cos_fallback_reads": stats["cos_fallback_reads"],
                    "decode_batches": stats["decode_batches"],
                    "staged_decodes": self.codec.staged_decodes,
                    "pending_migrations": len(self._pending_migrations),
                    "prefetch": self.prefetcher.snapshot()},
                "meta_log": {
                    "individual_records": meta_records,
                    "snapshot_covered": snap_covered,
                    "tombstones": tombstones,
                    "snapshots_taken": stats["spill_meta_snapshots"],
                    "generation": self.spill.generation
                    if self.spill is not None else None},
                "spill": self.spill.snapshot()
                if self.spill is not None else None}

    # ------------------------------------------------------------------
    # observability export (repro_torch.obs)
    # ------------------------------------------------------------------

    @property
    def obs(self) -> Optional[ObsPlane]:
        return self._obs

    def snapshot_metrics(self) -> Dict:
        """The unified observability export: latency histograms with
        p50/p99/p999, recent spans, flight-recorder events, recovered
        forensics, plus the store counters (one `as_dict` pass). With no
        (or a disabled) plane attached only the counters carry data —
        same shape either way, so exporters need no special case."""
        plane = self._obs
        snap = dict(plane.snapshot()) if plane is not None \
            else {"enabled": False, "histograms": {}, "spans": [],
                  "events": [], "forensics": []}
        snap["counters"] = self.stats.as_dict()
        return snap

    def dump_metrics(self, path: str) -> str:
        """Write `snapshot_metrics()` to `path` — Prometheus text, or
        JSON when the path ends in `.json`. Returns the path. (The
        `ISTORE_METRICS_DUMP` env var arranges the same dump from an
        atexit hook, covering every live plane in the process.)"""
        snap = self.snapshot_metrics()
        if path.endswith(".json"):
            dump_json(snap, path)
        else:
            with open(path, "w") as f:
                f.write(to_prometheus(snap))
        return path


class ShardWorkerDied(ConnectionError):
    """A shard's worker is unreachable with RPCs outstanding (or a new
    RPC was issued against a dead/partitioned worker): process death,
    pipe EOF, socket reset, heartbeat timeout, per-RPC deadline, or a
    call submitted to a closed in-process store — every such failure
    maps here, on every frontend (`transport.py` re-exports this class,
    so callers need one except-clause). The shard's durable state (spill
    journal, COS root) is intact; `restart_shard` (or a transport
    reconnect) rebuilds the path. Carries the failure context:
    `shard_id`, the transport `epoch` at failure time, and the `op` that
    failed (None when not op-bound)."""

    def __init__(self, msg: str = "", *, shard_id: Optional[int] = None,
                 epoch: Optional[int] = None,
                 op: Optional[str] = None) -> None:
        super().__init__(msg)
        self.shard_id = shard_id
        self.epoch = epoch
        self.op = op

    def __reduce__(self):
        return (self.__class__, (str(self),),
                {"shard_id": self.shard_id, "epoch": self.epoch,
                 "op": self.op})


class ConcurrentPutError(RuntimeError):
    def __init__(self, key: str):
        self.key = key
        super().__init__(f"concurrent PUT in flight for {key!r}; retry")

    def __reduce__(self):
        # crosses the worker->parent control pipe: rebuild from the key
        # (the default Exception reduce would re-wrap the formatted
        # message as a new key)
        return (ConcurrentPutError, (self.key,))
