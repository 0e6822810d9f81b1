"""Insertion logs, snapshots, and failure-detection metadata (§5.5.1, Fig 6).

Each function's log is a chain of *insertion nodes* persisted to COS; a
node consolidates the PUT records of one invocation window and carries a
monotonically increasing *term* plus a chained hash. `diff_rank` counts
all PUT records since term 1 (including deletes) — the daemon-vs-instance
diff_rank difference decides local vs parallel recovery. A *snapshot*
(chunk list at some term) bounds replay length; the *operation manifest*
= snapshot + subsequent nodes.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Set

from repro_torch.core.cos import COS


@dataclass(frozen=True)
class PutRecord:
    key: str              # chunk key ("objkey|ver#chunkidx")
    size: int
    version: int
    delete: bool = False


@dataclass
class InsertionNode:
    term: int
    records: List[PutRecord]
    prev_hash: str

    @property
    def hash(self) -> str:
        h = hashlib.sha256(self.prev_hash.encode())
        for r in self.records:
            h.update(f"{r.key}|{r.size}|{r.version}|{r.delete}".encode())
        return h.hexdigest()

    def to_bytes(self) -> bytes:
        return json.dumps({"term": self.term, "prev": self.prev_hash,
                           "records": [asdict(r) for r in self.records]}
                          ).encode()

    @classmethod
    def from_bytes(cls, b: bytes) -> "InsertionNode":
        d = json.loads(b.decode())
        return cls(term=d["term"],
                   records=[PutRecord(**r) for r in d["records"]],
                   prev_hash=d["prev"])


@dataclass
class Snapshot:
    term: int
    chunk_keys: List[str]
    hash: str

    def to_bytes(self) -> bytes:
        return json.dumps(asdict(self)).encode()

    @classmethod
    def from_bytes(cls, b: bytes) -> "Snapshot":
        return cls(**json.loads(b.decode()))


@dataclass
class Piggyback:
    """Insertion info piggybacked on GET/PUT responses (§5.5.1): the
    daemon's view of a function's latest durable state."""
    term: int = 0
    hash: str = ""
    diff_rank: int = 0
    last_node_size: int = 0
    snapshot_term: int = 0


class InsertionLog:
    """Per-function log; nodes and snapshots are persisted in COS.

    With a `writeback` queue attached, node/snapshot persistence rides
    the background writer (§5.5.1: the *instance* persists the node as
    the invocation returns — it is not on the client's ack path) and
    reads check the pending map first, so recovery sees nodes that are
    acked but not yet in COS."""

    def __init__(self, fid: int, cos: COS, *, snapshot_every: int = 8,
                 writeback=None):
        self.fid = fid
        self.cos = cos
        self.writeback = writeback
        self.snapshot_every = snapshot_every
        self.term = 0
        self.last_hash = ""
        self.diff_rank = 0
        self.snapshot_term = 0
        self._live: Set[str] = set()     # chunk keys currently stored
        self._last_node_size = 0

    # ---- key helpers ------------------------------------------------------

    def node_key(self, term: int) -> str:
        return f"ilog/{self.fid}/{term:08d}"

    @property
    def snap_key(self) -> str:
        return f"isnap/{self.fid}"

    # ---- writes -----------------------------------------------------------

    def append(self, records: List[PutRecord]) -> InsertionNode:
        """Consolidate one invocation window's PUTs into a sealed node and
        persist it to COS before the invocation returns (§5.5.1)."""
        self.term += 1
        node = InsertionNode(term=self.term, records=records,
                             prev_hash=self.last_hash)
        data = node.to_bytes()
        self._persist(self.node_key(self.term), data)
        self.last_hash = node.hash
        self.diff_rank += len(records)
        self._last_node_size = len(data)
        for r in records:
            if r.delete:
                self._live.discard(r.key)
            else:
                self._live.add(r.key)
        if self.term - self.snapshot_term >= self.snapshot_every:
            self.snapshot()
        return node

    def snapshot(self) -> Snapshot:
        """Persist the full chunk list (§5.5.1: 'On returning, the function
        instance creates a snapshot ... to speed up recovery')."""
        snap = Snapshot(term=self.term, chunk_keys=sorted(self._live),
                        hash=self.last_hash)
        self._persist(self.snap_key, snap.to_bytes())
        self.snapshot_term = self.term
        return snap

    def _persist(self, key: str, data: bytes) -> None:
        if self.writeback is not None:
            self.writeback.enqueue(key, data)
        else:
            self.cos.put(key, data)

    # ---- reads ------------------------------------------------------------

    def _read(self, key: str) -> Optional[bytes]:
        if self.writeback is not None:
            return self.writeback.read_through(key)
        return self.cos.get(key)

    def piggyback(self) -> Piggyback:
        return Piggyback(term=self.term, hash=self.last_hash,
                         diff_rank=self.diff_rank,
                         last_node_size=self._last_node_size,
                         snapshot_term=self.snapshot_term)

    def manifest(self) -> List[str]:
        """Operation manifest from COS: last snapshot's chunk list replayed
        with the insertion nodes after it. This is what a recovering
        instance downloads first (§5.5.1)."""
        live: Set[str] = set()
        start_term = 1
        snap_b = self._read(self.snap_key)
        if snap_b is not None:
            snap = Snapshot.from_bytes(snap_b)
            live = set(snap.chunk_keys)
            start_term = snap.term + 1
        t = start_term
        while True:
            b = self._read(self.node_key(t))
            if b is None:
                break
            node = InsertionNode.from_bytes(b)
            for r in node.records:
                if r.delete:
                    live.discard(r.key)
                else:
                    live.add(r.key)
            t += 1
        return sorted(live)

    def live_keys(self) -> Set[str]:
        return set(self._live)
