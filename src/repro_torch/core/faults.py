"""Deterministic fault-injection plane + unified retry policy.

Failure is a first-class, replayable *input* here, not an afterthought:
a `FaultPlan` is a seeded collection of per-site `FaultPoint`s threaded
through every layer that can fail in a real deployment —

    site                    layer       injected failure
    ----------------------  ----------  --------------------------------
    cos.put / cos.get       COS         TransientCOSError, COSThrottle
                                        (SlowDown + injected latency)
    writeback.persist       writeback   writer-side COS faults
    sms.store / sms.load    SMS slab    slab reclaimed mid-store /
                                        mid-gather ("function death")
    spill.append/spill.sync journal     OSError on the ack path
    spill.io                journal     OSError on the async writer
    spill.torn_close        journal     torn frame in the unsynced tail
                                        on hard (SIGKILL) close
    shard.decision          2PC leader  death BEFORE the decision record
                                        is durable (presumed abort)
    shard.leader_death      2PC leader  death AFTER the commit decision
                                        is durable, before round 2
    shard.commit_submit     2PC leader  per-shard commit submission loss
    net.drop                transport   outbound frame silently lost
    net.delay               transport   injected latency before the send
    net.partition           transport   link blackholed both ways for
                                        `hb.partition_s` (frames lost,
                                        heartbeats fail, detector fires)
    net.dup                 transport   frame transmitted twice (worker
                                        rid-dedupe drops the replay)

Network sites key on ``op:<opname>:s<shard>`` for data frames and
``hb:s<shard>`` for heartbeat pings. A plan that targets data ops MUST
set ``match="op:..."`` — `fire()` only consumes a hit index when some
point's match passes, so unmatched heartbeat traffic never shifts a
data-op schedule and same-seed runs stay byte-identical.

Every decision is a pure function of ``(seed, site, hit_index)`` — no
shared RNG stream — so the set of triggering hits is identical run to
run even when threads race on *which* key draws a given hit index. The
plan records each trigger in ``plan.log``; two runs of the same seeded
schedule produce byte-identical logs, which is what the chaos soak
asserts. A plan is off by default (``faults=None`` everywhere) and every
instrumented site guards with a single ``is not None`` check, so the
disabled plane costs one attribute load per op (the soak benchmark gates
this at <= 2% of PUT-ack latency).

Retry policy table (``RetryPolicy.classify``):

    classification  errors                           behaviour
    --------------  -------------------------------  --------------------
    transient       TransientCOSError, Connection-   capped exponential
                    Error, TimeoutError, OSError     backoff + jitter,
                                                     retried to budget
    throttle        COSThrottleError (SlowDown)      backoff starts at
                                                     the cap (provider
                                                     asked us to slow)
    permanent       everything else (ValueError,     surfaced at once,
                    KeyError, corrupt payloads, ...) never retried

Per-op deadlines: ``RetryPolicy.run(..., deadline_s=)`` raises
``OpDeadlineExceeded`` when the budget is exhausted mid-retry; stores
surface it through the returned ``StoreFuture`` rather than swallowing
it into a miss.
"""
from __future__ import annotations

import errno
import hashlib
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "TransientCOSError", "COSThrottleError", "InjectedFault",
    "InjectedCrash", "OpDeadlineExceeded", "FaultPoint", "FaultPlan",
    "RetryPolicy",
]


# ---------------------------------------------------------------------------
# error taxonomy
# ---------------------------------------------------------------------------

class TransientCOSError(ConnectionError):
    """A retryable cloud-object-store error (5xx / reset / timeout)."""


class COSThrottleError(TransientCOSError):
    """Provider throttling ("SlowDown"): retryable, but back off hard."""


class InjectedFault(Exception):
    """Marker mixin: the fault plane manufactured this failure."""


class InjectedCrash(InjectedFault):
    """An injected process/thread death (2PC leader kill)."""


class OpDeadlineExceeded(TimeoutError):
    """A per-op deadline expired while retrying transient failures."""


class _InjectedTransient(TransientCOSError, InjectedFault):
    pass


class _InjectedThrottle(COSThrottleError, InjectedFault):
    pass


class _InjectedOSError(OSError, InjectedFault):
    pass


# ---------------------------------------------------------------------------
# fault points + plan
# ---------------------------------------------------------------------------

#: actions `fire()` RAISES (the site sees an exception)
_RAISING = {
    "transient": lambda site, idx: _InjectedTransient(
        f"injected transient error at {site} (hit {idx})"),
    "throttle": lambda site, idx: _InjectedThrottle(
        f"injected SlowDown at {site} (hit {idx})"),
    "oserror": lambda site, idx: _InjectedOSError(
        errno.EIO, f"injected I/O error at {site} (hit {idx})"),
    "crash": lambda site, idx: InjectedCrash(
        f"injected crash at {site} (hit {idx})"),
}
#: actions `fire()` RETURNS (the site interprets them in-line)
_ADVISORY = ("reclaim", "torn", "drop", "dup", "partition", "delay")

#: every instrumented `fire()` site in the tree (the table in the
#: module docstring, one entry per row).  `istore-lint` cross-checks
#: fire()/FaultPoint call sites against this manifest so a typo'd
#: site cannot silently never fire.
FAULT_SITES = frozenset({
    "cos.put", "cos.get",
    "writeback.persist",
    "sms.store", "sms.load",
    "spill.append", "spill.sync", "spill.io", "spill.torn_close",
    "shard.decision", "shard.leader_death", "shard.commit_submit",
    "net.drop", "net.delay", "net.partition", "net.dup",
})


@dataclass
class FaultPoint:
    """One schedule of failures at one named site.

    Triggering is decided per *hit* (every call to ``FaultPlan.fire``
    for the site, after the optional key ``match`` filter): a hit fires
    when its 1-based index is in ``hits``, is a multiple of ``every``,
    exceeds ``after`` (k-ops-then-fail), or draws below ``prob`` from
    the seeded per-hit hash. ``times`` caps total fires. ``latency_s``
    is slept before the action (throttle/SlowDown latency injection).
    """
    site: str
    action: str = "transient"       # transient|throttle|oserror|crash|
                                    # reclaim|torn
    hits: Sequence[int] = ()        # explicit 1-based hit indices
    every: int = 0                  # fire every Nth hit
    after: int = -1                 # fire every hit with index > after
    prob: float = 0.0               # seeded per-hit probability
    times: Optional[int] = None     # cap on total fires (None = no cap)
    latency_s: float = 0.0          # injected delay before the action
    match: Optional[str] = None     # only keys containing this substring

    def __post_init__(self):
        if self.action not in _RAISING and self.action not in _ADVISORY:
            raise ValueError(f"unknown fault action: {self.action!r}")
        if (self.site.startswith("net.") or self.site.startswith("hb")) \
                and not self.match:
            raise ValueError(
                f"FaultPoint({self.site!r}) must set match= ("
                f"'op:...' or 'hb') — an unmatched point consumes hit "
                f"indices for heartbeat traffic too, breaking same-seed "
                f"log determinism")
        self.hits = frozenset(self.hits)
        self._fired = 0

    def _triggers(self, seed: int, idx: int) -> bool:
        if self.times is not None and self._fired >= self.times:
            return False
        if idx in self.hits:
            return True
        if self.every > 0 and idx % self.every == 0:
            return True
        if self.after >= 0 and idx > self.after:
            return True
        if self.prob > 0.0:
            h = hashlib.blake2b(
                f"{seed}|{self.site}|{self.action}|{idx}".encode(),
                digest_size=8).digest()
            u = int.from_bytes(h, "big") / 2.0 ** 64
            if u < self.prob:
                return True
        return False


class FaultPlan:
    """A seeded, deterministic schedule of failures across sites.

    Thread-safe; hit counters are per-site. ``fire(site, key)`` either
    returns None (no fault), returns an advisory action string the site
    interprets ("reclaim", "torn"), or raises the scheduled exception.
    ``log`` records every trigger as ``(site, hit_index, action)`` —
    the reproducibility artifact the chaos soak compares across runs.
    """

    def __init__(self, seed: int = 0,
                 points: Sequence[FaultPoint] = ()):
        self.seed = int(seed)
        self._sites: Dict[str, List[FaultPoint]] = {}
        self._hits: Dict[str, itertools.count] = {}
        self._lock = threading.Lock()
        self.log: List[Tuple[str, int, str]] = []
        self._sleep: Callable[[float], None] = time.sleep
        # optional ObsPlane (repro_torch.obs): every trigger is mirrored into
        # the flight recorder ("fault.fire"), so post-crash forensics
        # show which injected faults preceded the failure. Set by the
        # owning store; NOT pickled (each process re-attaches its own).
        self.obs = None
        for p in points:
            self.add(p)

    def add(self, point: FaultPoint) -> "FaultPlan":
        with self._lock:
            self._sites.setdefault(point.site, []).append(point)
            self._hits.setdefault(point.site, itertools.count(1))
        return self

    def fire(self, site: str, key: str = "") -> Optional[str]:
        pts = self._sites.get(site)
        if not pts:                          # site unscheduled: no count
            return None
        with self._lock:
            hit = None
            armed = None
            for p in pts:
                if p.match is not None and p.match not in key:
                    continue
                if hit is None:              # one hit index per fire()
                    hit = next(self._hits[site])
                if p._triggers(self.seed, hit):
                    p._fired += 1
                    armed = p
                    break
            if armed is None:
                return None
            self.log.append((site, hit, armed.action))
            latency = armed.latency_s
            action = armed.action
        obs = self.obs
        if obs is not None:
            obs.event("fault.fire", at=site, hit=hit, action=action)
        if latency > 0.0:
            self._sleep(latency)
        maker = _RAISING.get(action)
        if maker is not None:
            raise maker(site, hit)
        return action            # advisory: reclaim|torn|drop|dup|...

    # -- pickling (multi-process shard host) --------------------------------
    #
    # A plan crosses into worker processes at spawn (StoreConfig.faults
    # inside the worker spec). Each process then owns an INDEPENDENT
    # copy: per-site hit counters restart from the serialized position
    # and advance with that process's own call sequence, so every
    # worker's schedule is deterministic in its own op stream (the only
    # coherent semantics without cross-process counter contention).
    # Leader sites (shard.decision / shard.leader_death /
    # shard.commit_submit) keep firing on the parent's copy.

    def __getstate__(self):
        with self._lock:
            state = dict(self.__dict__)
            # snapshot mutable containers under the lock: other threads
            # may append to `log` while pickle walks the object graph
            state["log"] = list(self.log)
            state["_sites"] = {s: list(ps)
                               for s, ps in self._sites.items()}
            state["_hits"] = dict(self._hits)  # count objects pickle
        del state["_lock"]
        state["_sleep"] = None                 # may be a test lambda
        state["obs"] = None                    # re-attached per process
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()
        self._sleep = time.sleep

    # -- introspection ------------------------------------------------------

    def fired(self, site: Optional[str] = None) -> int:
        with self._lock:
            if site is None:
                return len(self.log)
            return sum(1 for s, _, _ in self.log if s == site)

    def snapshot(self) -> dict:
        with self._lock:
            return {"seed": self.seed,
                    "fired": len(self.log),
                    "log": list(self.log)}


# ---------------------------------------------------------------------------
# unified retry policy
# ---------------------------------------------------------------------------

@dataclass
class RetryPolicy:
    """Capped exponential backoff + deterministic jitter, with the
    transient/throttle/permanent classification from the module
    docstring. One policy object replaces the three ad-hoc retry loops
    that used to live in writeback, `_cos_read_consistent`, and the
    recovery download path."""
    max_attempts: int = 8
    backoff_base_s: float = 0.01
    backoff_cap_s: float = 1.0
    jitter: float = 0.25            # +- fraction of the computed delay
    seed: int = 0

    TRANSIENT = "transient"
    THROTTLE = "throttle"
    PERMANENT = "permanent"

    def classify(self, exc: BaseException) -> str:
        if isinstance(exc, COSThrottleError):
            return self.THROTTLE
        if isinstance(exc, (TransientCOSError, ConnectionError,
                            TimeoutError, OSError)):
            return self.TRANSIENT
        return self.PERMANENT

    def retryable(self, exc: BaseException) -> bool:
        return self.classify(exc) != self.PERMANENT

    def delay(self, attempt: int, kind: str = TRANSIENT) -> float:
        """Backoff before retry number `attempt` (1-based). Throttle
        starts at the cap — the provider explicitly asked us to slow
        down, ramping up from the base just burns the budget."""
        if kind == self.THROTTLE:
            d = self.backoff_cap_s
        else:
            d = min(self.backoff_base_s * (2.0 ** (attempt - 1)),
                    self.backoff_cap_s)
        if self.jitter > 0.0 and d > 0.0:
            h = hashlib.blake2b(f"{self.seed}|{attempt}".encode(),
                                digest_size=8).digest()
            u = int.from_bytes(h, "big") / 2.0 ** 64   # [0, 1)
            d *= 1.0 + self.jitter * (2.0 * u - 1.0)
        return d

    def run(self, fn: Callable[[], object], *,
            deadline_s: Optional[float] = None,
            sleep: Callable[[float], None] = time.sleep,
            now: Callable[[], float] = time.monotonic,
            on_retry: Optional[Callable[[int, BaseException], None]]
            = None):
        """Call `fn` under this policy. Permanent errors surface at
        once; transient/throttle errors retry with backoff until the
        attempt budget or the per-op deadline runs out. Deadline
        exhaustion raises OpDeadlineExceeded chained to the last error;
        attempt exhaustion re-raises the last error itself."""
        deadline = None if deadline_s is None else now() + deadline_s
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn()
            except BaseException as e:      # noqa: BLE001 — reclassified
                kind = self.classify(e)
                if kind == self.PERMANENT:
                    raise
                if attempt >= self.max_attempts:
                    raise
                d = self.delay(attempt, kind)
                if deadline is not None and now() + d > deadline:
                    raise OpDeadlineExceeded(
                        f"op deadline ({deadline_s:.3f}s) exceeded after "
                        f"{attempt} attempts: {e!r}") from e
                if on_retry is not None:
                    on_retry(attempt, e)
                if d > 0.0:
                    sleep(d)
