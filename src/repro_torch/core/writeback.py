"""Store futures + background COS writeback (paper §5.3.2).

`StoreFuture` is the handle the async client API returns: `result()`,
`exception()`, `done()`, `add_done_callback()` — a thin veneer over
`concurrent.futures.Future` so callers can pipeline PUT/GET without
blocking on the slowest layer.

`WritebackQueue` moves COS persistence off the PUT critical path: a PUT
acknowledges once its chunks sit in SMS slabs + the persistent buffer,
and the queue persists them to COS in the background — drained by a
dedicated writer thread and opportunistically by `gc_tick`. Durability
before persistence completes is covered by the pending map: recovery and
consistent reads consult `peek()` for anything enqueued-but-not-yet-in-
COS, which is exactly the paper's "retry persistence asynchronously from
the persistent buffer" contract at chunk granularity.

Bounded depth gives backpressure (enqueue blocks when the queue is
full), failures retry under the unified `RetryPolicy` (capped
exponential backoff + jitter; transient/throttle/permanent
classification — see `repro_torch.core.faults`), and `flush()` is the barrier
checkpoint/shutdown paths use.

COS outages degrade, they don't destroy: `degraded_after` consecutive
transient failures flip the queue into the documented
`DEGRADED_WRITEBACK` state — retry budgets freeze (an outage is not the
write's fault, so nothing accumulates permanent failures), tasks probe
COS at the backoff cap, bounded depth keeps applying backpressure to
producers, and reads keep flowing from the pending map / spill journal
/ SMS. The first successful write heals the state automatically and the
queue drains. Only errors classified PERMANENT (or retry exhaustion
OUTSIDE an outage) fail a write for good; those are counted, their keys
recorded, and both surfaced through `health()` so callers can tell a
timed-out flush from data-at-risk.

With a `SpillJournal` attached, every enqueue is appended to the
durable journal BEFORE it enters the queue (so before any ack), and the
record is logically truncated when the write persists or is superseded
— a write that exhausts its retries stays journaled so a daemon restart
retries it. That closes the crash hole in the pure in-memory pending
map: a client-daemon crash no longer loses acked-but-unpersisted
writes; the constructing store replays the journal and re-enqueues them
(passing the original `seq` so nothing is double-journaled).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.core.faults import RetryPolicy
from repro_torch.core.locks import make_lock
from repro_torch.core.payload import to_host
from repro_torch.obs import NOOP_CM


class StoreFuture(Future):
    """Async PUT/GET handle. PUT futures resolve to the committed version
    (and carry it as `.version`); GET futures resolve to the payload."""

    def __init__(self):
        super().__init__()
        self.version: Optional[int] = None

    def _resolve(self, value) -> None:
        if isinstance(value, int):
            self.version = value
        self.set_result(value)


@dataclass
class WritebackStats:
    enqueued: int = 0
    persisted: int = 0
    retries: int = 0
    failures: int = 0                 # permanently-failed writes
    superseded: int = 0               # dropped: a newer same-key write won
    peak_depth: int = 0
    flushes: int = 0
    throttled: int = 0                # SlowDown-classified retries
    degraded_entries: int = 0         # OK -> DEGRADED_WRITEBACK flips
    degraded_exits: int = 0           # outages healed


@dataclass
class _Task:
    key: str
    data: object                      # bytes or uint8 tensor/ndarray
    on_done: Optional[Callable[[str, bool], None]] = None
    attempts: int = 0
    not_before: float = 0.0           # wall time; retry backoff gate
    seq: Optional[int] = None         # spill-journal record to truncate
    ctx: Optional[tuple] = None       # trace context of the causing PUT


class WritebackQueue:
    """Bounded background COS writer with retry/backoff and flush/drain
    barriers. All public methods are thread-safe."""

    def __init__(self, cos, *, max_depth: int = 256, max_retries: int = 8,
                 backoff_base_s: float = 0.005, backoff_cap_s: float = 0.5,
                 start_thread: bool = True, spill=None,
                 name: str = "cos-writeback",
                 retry: Optional[RetryPolicy] = None,
                 degraded_after: int = 12, faults=None, obs=None):
        self.cos = cos
        # optional ObsPlane (repro_torch.obs): "wb.persist" spans adopt the
        # causing PUT's trace context; degraded enter/heal transitions
        # land in the flight recorder
        self.obs = obs
        # optional SpillJournal: enqueues are journaled before ack and
        # truncated on persistence (crash-consistent pending map)
        self.spill = spill
        self.faults = faults
        self.max_depth = max_depth
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        # unified retry policy: classification + backoff shape; the
        # task-based writer keeps its own attempt counters, so only
        # classify()/delay() are used here (max_attempts comes from
        # max_retries for backward compatibility)
        self.retry = retry or RetryPolicy(max_attempts=max_retries + 1,
                                          backoff_base_s=backoff_base_s,
                                          backoff_cap_s=backoff_cap_s)
        # consecutive transient failures before declaring a COS outage
        self.degraded_after = max(1, degraded_after)
        self._consec_errors = 0
        self._degraded_since: Optional[float] = None
        self._failed_keys: List[str] = []
        self.stats = WritebackStats()
        self._q: deque = deque()
        # cos key -> payload for every write not yet persisted (including
        # in-flight and retrying) — the durability read path
        self._pending: Dict[str, object] = {}
        self._inflight = 0
        self._paused = False
        self._stop = False
        self._lock = make_lock("writeback.WritebackQueue._lock")
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._idle = threading.Condition(self._lock)    # empty + no inflight
        self._errors: List[str] = []
        self._thread: Optional[threading.Thread] = None
        if start_thread:
            # `name` tags the writer thread per store instance (shard)
            self._thread = threading.Thread(target=self._writer_loop,
                                            name=name,
                                            daemon=True)
            self._thread.start()

    # ---- producer side ----------------------------------------------------

    def enqueue(self, key: str, data, *,
                on_done: Optional[Callable[[str, bool], None]] = None,
                seq: Optional[int] = None) -> None:
        """Queue one COS write. Blocks while the queue is at max_depth
        (backpressure); the pending map serves reads immediately. With a
        spill journal the write is made durable-on-disk FIRST (so before
        the caller can ack); `seq` is passed by the restart replay path
        for records already journaled."""
        if self.spill is not None and seq is None:
            seq = self.spill.append(key, data)
        obs = self.obs
        # capture the enqueuing PUT's ambient trace context so the
        # writer thread's persist span stitches into the same trace
        ctx = obs.ctx() if obs is not None else None
        with self._lock:
            while len(self._q) >= self.max_depth and not self._stop:
                self._not_full.wait(timeout=0.1)
            self._q.append(_Task(key, data, on_done, seq=seq, ctx=ctx))
            self._pending[key] = data
            self.stats.enqueued += 1
            self.stats.peak_depth = max(self.stats.peak_depth,
                                        len(self._q) + self._inflight)
            self._not_empty.notify()

    # ---- read-your-writes / durability ------------------------------------

    def peek(self, key: str):
        """Payload of a not-yet-persisted write, or None."""
        with self._lock:
            return self._pending.get(key)

    def pending_keys(self, prefix: str = "") -> List[str]:
        with self._lock:
            return sorted(k for k in self._pending if k.startswith(prefix))

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._q) + self._inflight

    # ---- barriers ---------------------------------------------------------

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Block until every enqueued write has been persisted or given
        up after max_retries. Returns True ONLY if everything actually
        persisted — False on timeout or if any write failed out during
        the barrier (check `errors()` / `stats.failures`)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        self.stats.flushes += 1
        with self._lock:
            failures_at_entry = self.stats.failures
            while self._q or self._inflight:
                if self._paused or self._thread is None:
                    # no writer will make progress: drain from this thread
                    self._lock.release()
                    try:
                        self._drain_some(16, ignore_backoff=True)
                    finally:
                        self._lock.acquire()
                    continue
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._idle.wait(timeout=0.05 if remaining is None
                                else min(0.05, remaining))
            return self.stats.failures == failures_at_entry

    def drain(self, max_items: int = 32) -> int:
        """Synchronously persist up to max_items queued writes on the
        caller's thread (the gc_tick hook). Returns writes persisted."""
        return self._drain_some(max_items, ignore_backoff=False)

    # ---- test / lifecycle hooks -------------------------------------------

    def pause(self) -> None:
        """Stop background draining (tests use this to hold writes
        in-queue deterministically)."""
        with self._lock:
            self._paused = True

    def resume(self) -> None:
        with self._lock:
            self._paused = False
            self._not_empty.notify_all()

    def close(self, *, flush: bool = True,
              flush_timeout: Optional[float] = 30.0) -> bool:
        """Stop the writer. Returns the flush outcome: False means
        writes were left unpersisted (timeout or permanent failures) —
        callers that need durability must check it."""
        ok = True
        if flush:
            ok = self.flush(timeout=flush_timeout)
        with self._lock:
            self._stop = True
            self._not_empty.notify_all()
            self._not_full.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
        return ok

    def read_through(self, key: str):
        """Durability read path: the pending map first (acked, not yet
        persisted), then COS."""
        data = self.peek(key)
        if data is not None:
            return data
        return self.cos.get(key)

    def errors(self) -> List[str]:
        with self._lock:
            return list(self._errors)

    def health(self) -> dict:
        """Degradation/failure surface for `snapshot_metadata()["health"]`:
        distinguishes a queue that is merely deep (backpressure working)
        from one riding out a COS outage (DEGRADED_WRITEBACK) from one
        that has permanently failed writes (data-at-risk)."""
        with self._lock:
            degraded = self._degraded_since is not None
            return {
                "state": "DEGRADED_WRITEBACK" if degraded else "OK",
                "depth": len(self._q) + self._inflight,
                "consecutive_errors": self._consec_errors,
                "permanent_failures": self.stats.failures,
                "failed_keys": list(self._failed_keys),
                "degraded_since": self._degraded_since,
                "degraded_entries": self.stats.degraded_entries,
                "recoveries": self.stats.degraded_exits,
            }

    # ---- internals --------------------------------------------------------

    def _pop_task(self, ignore_backoff: bool) -> Optional[_Task]:
        """Pop the next runnable task under the lock; respects backoff
        gates by rotating not-yet-due tasks to the back."""
        if self._paused and not ignore_backoff:
            return None
        now = time.monotonic()
        for _ in range(len(self._q)):
            task = self._q.popleft()
            if ignore_backoff or task.not_before <= now:
                self._inflight += 1
                self._not_full.notify()
                return task
            self._q.append(task)                 # still backing off
        return None

    def _finalize(self, task: _Task, ok: bool,
                  exc: Optional[BaseException] = None) -> None:
        truncate = None
        with self._lock:
            self._inflight -= 1
            kind = None if ok else self.retry.classify(exc)
            degraded = self._degraded_since is not None
            # permanent = unretryable error class, or retry exhaustion
            # OUTSIDE an outage; during DEGRADED_WRITEBACK transient
            # failures never burn the budget (the outage is not this
            # write's fault)
            permanent = (not ok) and (
                kind == RetryPolicy.PERMANENT
                or (not degraded and task.attempts > self.max_retries))
            if ok or permanent:
                if ok:
                    self.stats.persisted += 1
                    # journal truncation on persistence; a PERMANENT
                    # failure keeps its record so a restart retries it
                    truncate = task.seq
                    self._consec_errors = 0
                    if degraded:                  # COS healed: auto-exit
                        self._degraded_since = None
                        self.stats.degraded_exits += 1
                        if self.obs is not None:
                            self.obs.event("wb.degraded_heal",
                                           key=task.key)
                else:
                    self.stats.failures += 1
                    self._errors.append(f"{task.key}: {exc!r}")
                    if len(self._errors) > 64:
                        del self._errors[:-64]
                    self._failed_keys.append(task.key)
                    if len(self._failed_keys) > 64:
                        del self._failed_keys[:-64]
                # drop from pending only if no NEWER write superseded it
                if self._pending.get(task.key) is task.data:
                    self._pending.pop(task.key, None)
                done = task.on_done
            else:
                self.stats.retries += 1
                if kind == RetryPolicy.THROTTLE:
                    self.stats.throttled += 1
                self._consec_errors += 1
                if not degraded \
                        and self._consec_errors >= self.degraded_after:
                    self._degraded_since = time.monotonic()
                    self.stats.degraded_entries += 1
                    degraded = True
                    if self.obs is not None:
                        self.obs.event("wb.degraded_enter",
                                       consecutive=self._consec_errors,
                                       key=task.key)
                if degraded:
                    # ride out the outage: reset the retry budget and
                    # probe COS at the backoff cap
                    task.attempts = 0
                    task.not_before = time.monotonic() + self.backoff_cap_s
                else:
                    task.not_before = time.monotonic() \
                        + self.retry.delay(task.attempts, kind)
                self._q.append(task)
                # wake the writer: it may be in an untimed wait (empty
                # queue) while this retry was produced by a drain() on
                # another thread — without the notify it never retries
                self._not_empty.notify()
                done = None
            if not self._q and not self._inflight:
                self._idle.notify_all()
        if truncate is not None and self.spill is not None:
            self.spill.mark_persisted(truncate)
        if done is not None:
            done(task.key, ok)

    def _run_one(self, task: _Task) -> None:
        with self._lock:
            # a newer write for the same key supersedes this one (e.g.
            # insertion-log snapshots reuse their key): persisting the
            # stale payload could overwrite the newer one in COS after a
            # retry reordering — drop it and let the newer task win
            superseded = self._pending.get(task.key) is not task.data
            if superseded:
                self._inflight -= 1
                self.stats.superseded += 1
                if not self._q and not self._inflight:
                    self._idle.notify_all()
        if superseded:
            if task.seq is not None and self.spill is not None:
                self.spill.mark_persisted(task.seq)   # logically dead
            if task.on_done is not None:
                task.on_done(task.key, True)
            return
        task.attempts += 1
        obs = self.obs
        t0 = time.perf_counter() if obs is not None else 0.0
        try:
            if self.faults is not None:
                self.faults.fire("writeback.persist", task.key)
            with (obs.adopt(task.ctx) if obs is not None else NOOP_CM):
                with (obs.span("wb.persist", key=task.key)
                      if obs is not None else NOOP_CM):
                    # device chunks cross to the host here, on the
                    # writer thread — off the PUT ack path
                    self.cos.put(task.key, to_host(task.data))
            if obs is not None:
                obs.record("wb.persist_us",
                           (time.perf_counter() - t0) * 1e6)
            self._finalize(task, True)
        except Exception as e:                   # noqa: BLE001
            self._finalize(task, False, e)

    def _drain_some(self, max_items: int, ignore_backoff: bool) -> int:
        n = 0
        while max_items is None or n < max_items:
            with self._lock:
                task = self._pop_task(ignore_backoff)
            if task is None:
                break
            self._run_one(task)
            n += 1
        return n

    def _writer_loop(self) -> None:
        while True:
            with self._lock:
                if self._stop:
                    return
                task = self._pop_task(ignore_backoff=False)
                if task is None:
                    # empty or paused: sleep until notified (enqueue /
                    # resume / close); tasks backing off: short timeout
                    # so their retry gate is re-checked
                    timeout = 0.02 if (self._q and not self._paused) \
                        else None
                    self._not_empty.wait(timeout=timeout)
                    continue
            self._run_one(task)
