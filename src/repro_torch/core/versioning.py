"""Daemon-side versioning + persistent buffer (paper §5.3.2, Appendix A).

Objects are read-only once PUT returns; updates create new versions via
CAS on the metadata table. The persistent buffer intercepts the PUT data
path: a PUT acks after SMS insertion, while the COS write retries
asynchronously from the buffer; read-after-write GETs are served from the
buffer until release. The GET side runs the SCFS-style consistency-
increasing loop to mask COS eventual consistency.
"""
from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from repro_torch.core.payload import payload_nbytes


class MetaStatus(enum.Enum):
    PENDING = 0
    DONE_OK = 1
    DONE_FAIL = 2


class Meta:
    def __init__(self, key: str, ver: int, prev_ver: int = 0):
        self.key = key
        self.ver = ver
        self.prev_ver = prev_ver
        self.status = MetaStatus.PENDING
        self._event = threading.Event()
        self.num_fragments = 1
        self.size = 0
        # True while this head sits prepared-but-uncommitted in a
        # cross-shard two-round batch. Readers and conflicting writers
        # must NOT block on such a head (the commit/abort that resolves
        # it is queued BEHIND them on the same single-threaded shard
        # daemon — waiting would stall the whole shard until timeout):
        # reads fall through to the previous version (uncommitted data
        # is invisible), writers conflict immediately. Cleared by
        # `done()` on commit and abort alike.
        self.prepared = False

    # Fig. 24 primitives ----------------------------------------------------

    def is_done(self) -> bool:
        return self.status != MetaStatus.PENDING

    def is_done_ok(self) -> bool:
        return self.status == MetaStatus.DONE_OK

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def done(self, ok: bool) -> bool:
        self.status = MetaStatus.DONE_OK if ok else MetaStatus.DONE_FAIL
        self.prepared = False
        self._event.set()
        return ok

    def revise(self, ver: int) -> None:
        self.prev_ver = ver - 1
        self.ver = ver


class MetadataTable:
    """In-memory metadata table with CAS; persisted to local disk by the
    daemon for fault tolerance (§5.2) — here: snapshot()/restore()."""

    def __init__(self):
        self._t: Dict[str, Meta] = {}
        self._lock = threading.RLock()

    def prepare(self, key: str, ver: int = 1) -> Meta:
        return Meta(key, ver)

    def load(self, key: str) -> Optional[Meta]:
        with self._lock:
            return self._t.get(key)

    def cas(self, key: str, candidate: Meta) -> Tuple[Optional[Meta], bool]:
        """Insert candidate as the head metadata for key unless a PENDING
        or newer entry exists. Returns (current, ok)."""
        return self.cas_many([(key, candidate)])[0]

    def cas_many(self, items: "list[Tuple[str, Meta]]"
                 ) -> "list[Tuple[Optional[Meta], bool]]":
        """Multi-key CAS: commit a batch of candidates in ONE leader-
        sequenced metadata round (one lock acquisition) instead of one
        round per key. Keys succeed/fail independently — a PENDING or
        newer head fails only that key. Checkpoint saves are the main
        beneficiary: B leaf shards -> 1 metadata round."""
        out: "list[Tuple[Optional[Meta], bool]]" = []
        with self._lock:
            for key, candidate in items:
                cur = self._t.get(key)
                if cur is None or (cur.is_done()
                                   and candidate.ver == cur.ver + 1):
                    if cur is not None:
                        candidate.prev_ver = cur.ver
                    self._t[key] = candidate
                    out.append((candidate, True))
                else:
                    out.append((cur, False))
        return out

    def store(self, versioned_key: str, meta: Meta) -> None:
        with self._lock:
            self._t[versioned_key] = meta

    def snapshot(self) -> Dict[str, Tuple[int, int, int]]:
        with self._lock:
            return {k: (m.ver, m.prev_ver, m.status.value)
                    for k, m in self._t.items()}

    def restore(self, snap: Dict[str, Tuple[int, int, int]]) -> None:
        with self._lock:
            for k, (ver, prev, status) in snap.items():
                m = Meta(k, ver, prev)
                m.status = MetaStatus(status)
                if m.is_done():
                    m._event.set()
                self._t[k] = m


@dataclass
class _BufEntry:
    data: object                  # bytes or flat uint8 ndarray (zero-copy)
    refs: int = 1


class PersistentBuffer:
    """Daemon-local stream buffer keyed by `key|ver[/frag]` (§5.3.2).

    Entries are refcounted so the async writeback path can drain them
    incrementally: a PUT creates the entry with one ref per derived COS
    write, each completed (or abandoned) write releases one ref, and the
    entry — which serves read-after-write GETs and the durability
    fallback meanwhile — is freed when the last ref drops. Payloads are
    stored as handed in (bytes or uint8 views), never copied."""

    def __init__(self):
        self._buf: Dict[str, _BufEntry] = {}
        self._lock = threading.RLock()
        self.peak_bytes = 0
        self.hits = 0

    def create(self, key: str, data, refs: int = 1) -> str:
        with self._lock:
            self._buf[key] = _BufEntry(data, refs=max(refs, 1))
            self.peak_bytes = max(
                self.peak_bytes,
                sum(payload_nbytes(e.data) for e in self._buf.values()))
            return key

    def load(self, key: str):
        with self._lock:
            e = self._buf.get(key)
            if e is not None:
                self.hits += 1
                return e.data
            return None

    def retain(self, key: str) -> None:
        """Add a ref (one per in-flight writeback of derived data)."""
        with self._lock:
            e = self._buf.get(key)
            if e is not None:
                e.refs += 1

    def release(self, key: str) -> bool:
        """Drop one ref; the entry is freed when the last ref drops.
        Returns True exactly when this call freed the entry (the spill
        journal truncates the fragment record on that edge)."""
        with self._lock:
            e = self._buf.get(key)
            if e is None:
                return False
            e.refs -= 1
            if e.refs <= 0:
                self._buf.pop(key, None)
                return True
            return False

    def release_all(self, key: str) -> None:
        """Force-drop the entry regardless of refcount (failure paths)."""
        with self._lock:
            self._buf.pop(key, None)

    @property
    def size_bytes(self) -> int:
        with self._lock:
            return sum(payload_nbytes(e.data) for e in self._buf.values())
