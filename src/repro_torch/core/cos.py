"""Cloud Object Store (COS): the persistence layer (paper §5.2, §5.5).

Backends: in-memory dict (tests/benchmarks) or a directory on disk
(checkpointing). Eventual consistency is SIMULATED via a configurable
visibility lag: a newly PUT object/version only becomes readable after
`visibility_lag` clock time, which is exactly the behaviour the
SCFS-style consistency-increasing GET loop (Appendix A) must mask.

Concurrency: `self._lock` guards ONLY metadata (visibility map, the
in-memory dict, stats) — file I/O happens outside it, so one slow disk
write no longer serializes every other COS operation. Disk writes go to
a uniquely-named temp file and `os.replace` in atomically; visibility is
flipped only after the write lands, so readers never observe a visible
key with a half-written object.

Payloads may be `bytes` or flat uint8 `ndarray` views (the zero-copy
writeback path); the mem backend stores whatever it is handed.

`put_delay_base_s` / `put_delay_per_byte_s` optionally model real
object-store PUT latency (S3-like: ~tens of ms + bandwidth) for
benchmarks that compare sync-ack vs async-writeback PUT paths;
`get_delay_base_s` / `get_delay_per_byte_s` are the GET-side mirror
(first-byte latency + per-connection bandwidth) for benchmarks that
compare serial vs fanned-out demand reads. The sleeps happen outside
the metadata lock, so concurrent GETs overlap — exactly the property
the pipelined read path exploits.
"""
from __future__ import annotations

import hashlib
import os
import threading
import time
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.clock import Clock
from repro_torch.core.payload import payload_nbytes

# Negative-lookup cache bounds for the daemon-restart disk-adoption
# probe: absent keys are re-stat'd at most once per TTL (wall time), so
# an external writer sharing cos_root is seen within a TTL; the map is
# capped so miss-heavy scans cannot grow it without bound.
NEG_PROBE_TTL_S = 1.0
NEG_PROBE_CAP = 65536


@dataclass
class COSStats:
    puts: int = 0
    gets: int = 0
    get_misses: int = 0
    bytes_in: int = 0
    bytes_out: int = 0

    @property
    def stored_ops(self) -> Tuple[int, int]:
        return self.puts, self.gets


class COS:
    def __init__(self, clock: Clock, *, visibility_lag: float = 0.0,
                 root: Optional[str] = None, workers: int = 8,
                 put_delay_base_s: float = 0.0,
                 put_delay_per_byte_s: float = 0.0,
                 get_delay_base_s: float = 0.0,
                 get_delay_per_byte_s: float = 0.0):
        self.clock = clock
        self.visibility_lag = visibility_lag
        self.root = Path(root) if root else None
        if self.root:
            self.root.mkdir(parents=True, exist_ok=True)
        self._mem: Dict[str, bytes] = {}
        self._visible_at: Dict[str, float] = {}
        # key -> clock time of a daemon-restart disk probe that found it
        # absent: the adoption check stats the filesystem at most once
        # per key per NEG_PROBE_TTL_S, so hot miss loops (consistency-
        # increasing GET retries, visibility-lag polls) don't hit the
        # disk under the lock on every poll. Entries expire (another
        # process may share cos_root and write the key later) and the
        # map is capped (miss-heavy scans must not leak); this process's
        # own put() clears its entry immediately.
        self._probed_absent: Dict[str, float] = {}
        self._lock = threading.RLock()
        self.stats = COSStats()
        # optional FaultPlan (repro_torch.core.faults); None = zero-cost no-op.
        # Injected faults fire BEFORE any state change, modelling a
        # request that never reached the service.
        self.faults = None
        self.put_delay_base_s = put_delay_base_s
        self.put_delay_per_byte_s = put_delay_per_byte_s
        self.get_delay_base_s = get_delay_base_s
        self.get_delay_per_byte_s = get_delay_per_byte_s
        self._pool = ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix="cos")

    # ---- sync API -------------------------------------------------------

    def _path(self, key: str) -> Path:
        h = hashlib.sha1(key.encode()).hexdigest()
        return self.root / h[:2] / h[2:]

    def _adopt_locked(self, key: str) -> Optional[float]:
        """Daemon-restart path (caller holds the lock): an object this
        process never put may still exist on disk, persisted by a
        previous process — its put predates this one, so any visibility
        lag has long elapsed; adopt it as visible. The disk probe runs
        at most once per absent key per TTL (see `_probed_absent`)."""
        if self.root is None:
            return None
        # TTL on wall time, NOT self.clock: the logical clock only moves
        # when a test advances it, which would freeze the TTL and hide
        # an external writer's key forever.
        now = time.monotonic()
        probed = self._probed_absent.get(key)
        if probed is not None and now - probed < NEG_PROBE_TTL_S:
            return None
        if self._path(key).exists():
            self._probed_absent.pop(key, None)
            vis = self.clock.now()
            self._visible_at[key] = vis
            return vis
        if len(self._probed_absent) >= NEG_PROBE_CAP:
            self._probed_absent.clear()
        self._probed_absent[key] = now
        return None

    def put(self, key: str, data) -> None:
        """Store host bytes (bytes-like or a numpy array). COS is the
        persistent, inexpensive tier: a tensor here is a bug — the
        in-memory map would quietly keep device memory alive — so the
        caller copies it to the host first (`payload.to_host`)."""
        if isinstance(data, torch.Tensor):
            raise TypeError(f"COS.put({key!r}): COS holds host bytes, got a "
                            f"tensor on {data.device}")
        if self.faults is not None:
            self.faults.fire("cos.put", key)
        n = payload_nbytes(data)
        if self.put_delay_base_s or self.put_delay_per_byte_s:
            time.sleep(self.put_delay_base_s + n * self.put_delay_per_byte_s)
        if self.root:
            # write outside the lock; unique temp name so concurrent puts
            # of the same key can't clobber each other's staging file
            p = self._path(key)
            p.parent.mkdir(parents=True, exist_ok=True)
            tmp = p.with_name(f"{p.name}.{uuid.uuid4().hex}.tmp")
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, p)
        with self._lock:
            self.stats.puts += 1
            self.stats.bytes_in += n
            if not self.root:
                self._mem[key] = data
            self._probed_absent.pop(key, None)
            self._visible_at[key] = self.clock.now() + self.visibility_lag

    def get(self, key: str):
        if self.faults is not None:
            self.faults.fire("cos.get", key)
        if self.get_delay_base_s:
            time.sleep(self.get_delay_base_s)     # first-byte latency
        with self._lock:
            self.stats.gets += 1
            vis = self._visible_at.get(key)
            if vis is None:
                vis = self._adopt_locked(key)
            if vis is None or self.clock.now() < vis:
                self.stats.get_misses += 1
                return None
            data = None if self.root else self._mem.get(key)
        if self.root:
            # disk read outside the lock; a concurrent delete makes this
            # a miss, same as observing the delete first
            try:
                data = self._path(key).read_bytes()
            except FileNotFoundError:
                data = None
        if data is None:
            with self._lock:
                self.stats.get_misses += 1
            return None
        if self.get_delay_per_byte_s:             # per-connection bandwidth
            time.sleep(payload_nbytes(data) * self.get_delay_per_byte_s)
        with self._lock:
            self.stats.bytes_out += payload_nbytes(data)
        return data

    def exists(self, key: str) -> bool:
        with self._lock:
            vis = self._visible_at.get(key)
            if vis is None:
                vis = self._adopt_locked(key)
            return vis is not None and self.clock.now() >= vis

    def delete(self, key: str) -> None:
        with self._lock:
            self._visible_at.pop(key, None)
            if not self.root:
                self._mem.pop(key, None)
        if self.root:
            p = self._path(key)
            if p.exists():
                p.unlink()

    def list_keys(self, prefix: str = "") -> list:
        """Keys this process has seen (put, or adopted by get()/exists()
        after a daemon restart). NOTE: the disk layout stores objects
        under hashed paths, so keys persisted by a PREVIOUS process are
        listable only once touched by key — by-key reads (GET data path,
        recovery manifests, journal replay) work regardless."""
        with self._lock:
            return sorted(k for k in self._visible_at if k.startswith(prefix))

    @property
    def stored_bytes(self) -> int:
        with self._lock:
            keys = list(self._visible_at)
            if not self.root:
                return sum(payload_nbytes(self._mem.get(k, b"")) for k in keys)
        return sum(self._path(k).stat().st_size
                   for k in keys if self._path(k).exists())

    # ---- async API (persistent-buffer path, §5.3.2) ----------------------

    def put_async(self, key: str, data) -> Future:
        return self._pool.submit(self.put, key, data)

    def get_async(self, key: str) -> Future:
        """Fan-out read on the COS worker pool (batched page restore /
        demand-read callers)."""
        return self._pool.submit(self.get, key)

    def shutdown(self) -> None:
        self._pool.shutdown(wait=True)
