"""Crash-consistent writeback spill journal (paper §5.3.2).

The asynchronous writeback's ack contract — "an instance failure between
ack and persistence loses nothing" — covers *instance* failures only:
the WritebackQueue pending map is process memory, so without a journal
a client-daemon crash silently loses every acked-but-unpersisted write. The paper's persistent buffer is a
durability structure, so the buffer itself must survive the daemon.
`SpillJournal` is that durable half: an append-only, checksummed,
segment-rotated local journal the writeback path appends to BEFORE a
PUT acknowledges, replayed on daemon restart to re-enqueue every
surviving write.

On-disk format (all little-endian), one record frame per append:

    magic  u32   0x53504C31 ("SPL1")
    rtype  u8    1 = APPEND (key + payload), 2 = PERSIST (logical
                 truncation: `seq` names the APPEND now persisted)
    seq    u64   monotonically increasing enqueue sequence
    klen   u32   key length in bytes
    plen   u64   payload length in bytes
    crc    u32   CRC-32 over (rtype..plen) + key + payload digest
    key    klen bytes
    payload plen bytes

The payload enters the CRC through a 128-bit vectorized digest (u64
word sum + word xor, plus the sub-word tail bytes verbatim) rather than
byte-by-byte: full-payload corruption coverage at memory bandwidth
instead of zlib's ~1 GB/s, which is what keeps journaling inside the
PUT ack-latency budget. The digest is alignment-independent, so writer
(ndarray) and replayer (bytes) always agree.

A torn tail record (partial frame, bad magic, or CRC mismatch — the
crash-mid-append case) is detected during replay and dropped along with
anything after it in that segment; earlier complete records survive.

Segments (`seg-<id>.wal`) rotate at `segment_bytes`. Records are
*logically* truncated by appending a PERSIST record as COS persists
them; a sealed segment whose records are all persisted is deleted, and
a sealed segment pinned by only a few live bytes (small surviving
records, e.g. metadata entries) is compacted — its live frames are
re-appended verbatim to the active segment and the file reclaimed. When
nothing at all is live the active segment is truncated in place, so a
drained journal occupies no disk.

Two write disciplines:

- `sync_each=True` (default): every append is built, written, and
  flushed on the caller's thread before returning — the simple durable
  mode.
- `sync_each=False` (group commit): appends stay in the writer buffer
  until the caller's `sync()` durability barrier — one flush per ack
  batch instead of one per record. This is the store's mode: it syncs
  once at the PUT ack point. With `async_writer=True` the frame
  builds, CRCs, and file I/O additionally run in FIFO order on an
  internal `spill-journal` thread and `sync()` drains it; that only
  pays off on runtimes where the journal thread is not GIL-convoyed
  behind the caller's pure-Python phases, so it is off by default.

Flushes reach the OS (durable across a process crash — the scenario the
persistent-buffer contract names); pass `fsync=True` for machine-crash
durability at ack-latency cost. Thread-safe; same-key appends supersede
(latest seq wins), mirroring the WritebackQueue pending-map semantics.
"""
from __future__ import annotations

import os
import struct
import threading
import zlib

try:
    import fcntl                         # POSIX advisory locks
except ImportError:                      # pragma: no cover - non-POSIX
    fcntl = None
from collections import deque
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.locks import make_rlock
from repro_torch.core.payload import host_u8, payload_nbytes
from repro_torch.obs import NOOP_CM

_MAGIC = 0x53504C31                      # "SPL1"
_MAGIC_S = struct.Struct("<I")
_META_S = struct.Struct("<BQIQ")         # rtype, seq, klen, plen
_CRC_S = struct.Struct("<I")
_HDR_LEN = _MAGIC_S.size + _META_S.size + _CRC_S.size   # 29 bytes
_APPEND, _PERSIST = 1, 2
_MAX_KLEN = 64 * 1024


@dataclass
class SpillStats:
    appends: int = 0
    persists: int = 0                 # logical truncations written
    appended_bytes: int = 0           # payload bytes journaled
    replayed_records: int = 0         # live records found at open
    replayed_bytes: int = 0
    torn_records: int = 0             # frames rejected by framing/CRC
    segments_created: int = 0
    segments_reclaimed: int = 0       # deleted (fully persisted)
    segments_compacted: int = 0       # rewritten into the active segment


@dataclass
class _Rec:
    key: str
    seg: int
    offset: int                       # frame start within segment file
    frame_len: int
    payload_len: int


_SIG_WEIGHTS: Dict[int, np.ndarray] = {}   # odd-weight cache by word count


def _sig_weights(nwords: int) -> np.ndarray:
    w = _SIG_WEIGHTS.get(nwords)
    if w is None:
        if len(_SIG_WEIGHTS) > 64:          # few distinct payload sizes
            _SIG_WEIGHTS.clear()
        # odd weights (2i+1) are units mod 2^64: a swap of unequal words
        # i!=j changes the weighted sum by (2i-2j)(w_j - w_i) != 0
        w = (np.arange(nwords, dtype=np.uint64) << np.uint64(1)) \
            + np.uint64(1)
        _SIG_WEIGHTS[nwords] = w
    return w


def _payload_sig(payload) -> bytes:
    """192-bit vectorized payload digest + raw tail: u64 word sum,
    position-weighted word sum (catches word reordering, which the
    plain sum/xor alone would miss), and word xor over the 8-aligned
    prefix, then the <8 trailing bytes verbatim. Runs at memory
    bandwidth and is independent of the buffer's alignment/type, so the
    write side (ndarray views) and the replay side (bytes slices)
    always produce identical signatures. Not cryptographic — it targets
    torn/garbled frames from crashes and bit rot, not an adversary."""
    n = payload_nbytes(payload)
    if n == 0:
        return b""
    u8 = payload if isinstance(payload, np.ndarray) \
        else np.frombuffer(payload, np.uint8)
    m = n & ~7
    h_sum = h_pos = h_xor = 0
    if m:
        try:
            u64 = u8[:m].view(np.uint64)
        except ValueError:                 # unaligned base: one memcpy
            u64 = np.ascontiguousarray(u8[:m]).view(np.uint64)
        h_sum = int(u64.sum(dtype=np.uint64))
        with np.errstate(over="ignore"):   # mod-2^64 wrap is the point
            h_pos = int(np.dot(u64, _sig_weights(u64.size)))
        h_xor = int(np.bitwise_xor.reduce(u64, dtype=np.uint64))
    return struct.pack("<QQQ", (h_sum + n) & 0xFFFFFFFFFFFFFFFF,
                       h_pos & 0xFFFFFFFFFFFFFFFF,
                       h_xor) + bytes(u8[m:])


def _frame_crc(meta: bytes, key: bytes, payload) -> int:
    crc = zlib.crc32(meta)
    crc = zlib.crc32(key, crc)
    return zlib.crc32(_payload_sig(payload), crc) & 0xFFFFFFFF


class SpillJournal:
    """Durable spill for the writeback pending map. `append` before ack
    (+ `sync()` in group-commit mode), `mark_persisted` as COS confirms,
    `take_pending` after a restart."""

    def __init__(self, path, *, segment_bytes: int = 64 * 1024 * 1024,
                 fsync: bool = False, compact_below: int = 256 * 1024,
                 sync_each: bool = True, async_writer: bool = False,
                 faults=None):
        # optional FaultPlan (repro_torch.core.faults): "spill.append" /
        # "spill.sync" raise on the ack path, "spill.io" raises inside
        # the (possibly async) frame writer, "spill.torn_close" tears
        # the unsynced tail on a hard close.
        self.faults = faults
        # optional ObsPlane (repro_torch.obs), attached by the owning store
        # after construction: "journal.append" / "journal.sync" spans
        # around the ack-path journal work
        self.obs = None
        self.dir = Path(path)
        self.dir.mkdir(parents=True, exist_ok=True)
        # inter-process exclusivity: two journals on the same directory
        # (a restart racing a not-yet-dead daemon) would both replay and
        # rewrite/unlink each other's segments. Fail fast instead. A
        # real crash releases the flock with the process, so restart
        # always succeeds; close() releases it explicitly.
        self._lockf = None
        if fcntl is not None:
            lockf = open(self.dir / ".lock", "wb")
            try:
                fcntl.flock(lockf.fileno(),
                            fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError as e:
                lockf.close()
                raise RuntimeError(
                    f"spill journal directory {self.dir} is locked by "
                    "another live journal (concurrent daemon?)") from e
            self._lockf = lockf
        self.segment_bytes = segment_bytes
        self.fsync = fsync
        self.compact_below = compact_below
        self.sync_each = sync_each
        self.stats = SpillStats()
        self._lock = make_rlock("spill.SpillJournal._lock")
        self._closed = False
        # live (unpersisted) records by seq; _by_key for supersession
        self._records: Dict[int, _Rec] = {}
        self._by_key: Dict[str, int] = {}
        self._seg_live: Dict[int, int] = {}        # seg -> live record count
        self._seg_live_bytes: Dict[int, int] = {}  # seg -> live frame bytes
        self._next_seq = 1
        self._replayed: List[Tuple[int, str, bytes]] = []
        try:
            max_seg = self._replay()
            self._active_id = max_seg + 1
            self._active_size = 0
            self._f = open(self._seg_path(self._active_id), "wb",
                           buffering=64 * 1024)
        except BaseException:
            self._release_dir_lock()
            raise
        # executor-side counters for the ACTIVE file: bytes written vs
        # bytes known flushed (hard close truncates to the latter)
        self._written = self._synced = 0
        self.stats.segments_created += 1
        self._seg_live.setdefault(self._active_id, 0)
        self._seg_live_bytes.setdefault(self._active_id, 0)
        # group-commit writer: FIFO of file ops executed off the caller
        # thread; `sync()` barriers on it. In sync_each mode ops run
        # inline and the queue machinery is idle.
        self._wq: deque = deque()
        self._wcond = threading.Condition(self._lock)
        self._winflight = False
        self._wstop = False
        self._werr: Optional[BaseException] = None
        self._wthread: Optional[threading.Thread] = None
        if async_writer and not sync_each:
            self._wthread = threading.Thread(target=self._writer_loop,
                                             name="spill-journal",
                                             daemon=True)
            self._wthread.start()

    # ---- paths ------------------------------------------------------------

    def _seg_path(self, seg_id: int) -> Path:
        return self.dir / f"seg-{seg_id:08d}.wal"

    def _segment_ids(self) -> List[int]:
        out = []
        for p in self.dir.glob("seg-*.wal"):
            try:
                out.append(int(p.stem.split("-", 1)[1]))
            except ValueError:
                continue
        return sorted(out)

    # ---- replay (construction) --------------------------------------------

    def _replay(self) -> int:
        """Scan surviving segments in order, building the live set: an
        APPEND enters it (superseding an older same-key APPEND), a
        PERSIST removes its target, a torn frame ends its segment.
        Returns the highest segment id seen."""
        payloads: Dict[int, bytes] = {}
        seg_ids = self._segment_ids()
        for seg_id in seg_ids:
            data = self._seg_path(seg_id).read_bytes()
            off = 0
            while off < len(data):
                frame = self._parse_frame(data, off)
                if frame is None:
                    self.stats.torn_records += 1
                    break
                rtype, seq, key, payload, frame_len = frame
                self._next_seq = max(self._next_seq, seq + 1)
                if rtype == _APPEND:
                    self._drop_live(seq)              # re-appended frame
                    old = self._by_key.get(key)
                    if old is not None:               # newer same-key wins
                        self._drop_live(old)
                        payloads.pop(old, None)
                    self._records[seq] = _Rec(key, seg_id, off, frame_len,
                                              len(payload))
                    self._by_key[key] = seq
                    payloads[seq] = payload
                else:                                  # _PERSIST
                    self._drop_live(seq)
                    payloads.pop(seq, None)
                off += frame_len
        # per-segment live accounting; fully-persisted segments reclaim now
        for rec in self._records.values():
            self._seg_live[rec.seg] = self._seg_live.get(rec.seg, 0) + 1
            self._seg_live_bytes[rec.seg] = \
                self._seg_live_bytes.get(rec.seg, 0) + rec.frame_len
        for seg_id in seg_ids:
            if self._seg_live.get(seg_id, 0) == 0:
                self._seg_path(seg_id).unlink(missing_ok=True)
                self._seg_live.pop(seg_id, None)
                self._seg_live_bytes.pop(seg_id, None)
                self.stats.segments_reclaimed += 1
        self._replayed = [(seq, self._records[seq].key, payloads[seq])
                          for seq in sorted(self._records)]
        self.stats.replayed_records = len(self._replayed)
        self.stats.replayed_bytes = sum(len(p) for _, _, p in self._replayed)
        return seg_ids[-1] if seg_ids else 0

    @staticmethod
    def _parse_frame(data: bytes, off: int):
        """One frame at `off`, or None if torn/corrupt."""
        if off + _HDR_LEN > len(data):
            return None
        (magic,) = _MAGIC_S.unpack_from(data, off)
        if magic != _MAGIC:
            return None
        meta = data[off + _MAGIC_S.size:off + _MAGIC_S.size + _META_S.size]
        rtype, seq, klen, plen = _META_S.unpack(meta)
        if rtype not in (_APPEND, _PERSIST) or klen > _MAX_KLEN:
            return None
        frame_len = _HDR_LEN + klen + plen
        if off + frame_len > len(data):
            return None                                # torn tail
        (crc,) = _CRC_S.unpack_from(data, off + _MAGIC_S.size + _META_S.size)
        body_off = off + _HDR_LEN
        key = data[body_off:body_off + klen]
        payload = data[body_off + klen:body_off + klen + plen]
        if _frame_crc(meta, key, payload) != crc:
            return None
        return rtype, seq, key.decode(), payload, frame_len

    def _drop_live(self, seq: int) -> None:
        rec = self._records.pop(seq, None)
        if rec is not None and self._by_key.get(rec.key) == seq:
            del self._by_key[rec.key]

    def take_pending(self) -> List[Tuple[int, str, bytes]]:
        """The surviving (unpersisted) records, in enqueue-seq order.
        Payload buffers are handed over — callers re-enqueue them; the
        journal keeps only on-disk locations afterwards."""
        with self._lock:
            out, self._replayed = self._replayed, []
            return out

    # ---- writes (bookkeeping on the caller, file ops via _submit) ---------

    def append(self, key: str, data) -> int:
        """Journal one pending write BEFORE it is acknowledged. Returns
        the record's seq (handed back via `mark_persisted`). In group-
        commit mode the frame is durable only after the next `sync()`."""
        obs = self.obs
        with (obs.span("journal.append")
              if obs is not None else NOOP_CM):
            with self._lock:
                return self._append_locked(key, data)

    def append_many(self, items) -> List[int]:
        """Batch append (one lock round for a PUT's whole chunk set —
        the per-record overhead matters on the ack path). items:
        iterable of (key, payload). Returns the seqs in order."""
        items = list(items)
        obs = self.obs
        with (obs.span("journal.append", n=len(items))
              if obs is not None else NOOP_CM):
            with self._lock:
                return [self._append_locked(k, d) for k, d in items]

    def _append_locked(self, key: str, data) -> int:
        if self.faults is not None:
            self.faults.fire("spill.append", key)   # pre-bookkeeping
        kb = key.encode()
        # zero-copy host u8 view; a device tensor raises — the journal
        # is host-side and the caller pays the device-to-host copy
        body = data if isinstance(data, (bytes, bytearray, memoryview)) \
            else host_u8(data)
        nbytes = payload_nbytes(body)
        frame_len = _HDR_LEN + len(kb) + nbytes
        if self._closed:
            raise RuntimeError("spill journal is closed")
        self._raise_pending_error()
        seq = self._next_seq
        self._next_seq += 1
        offset = self._active_size
        self._submit(("frame", _APPEND, seq, kb, body))
        self._active_size += frame_len
        old = self._by_key.get(key)
        old_rec = self._records.pop(old) if old is not None else None
        self._records[seq] = _Rec(key, self._active_id, offset,
                                  frame_len, nbytes)
        self._by_key[key] = seq
        self._seg_live[self._active_id] += 1
        self._seg_live_bytes[self._active_id] += frame_len
        self.stats.appends += 1
        self.stats.appended_bytes += nbytes
        if old_rec is not None:         # superseded: dead AFTER the new
            self._note_dead(old_rec)    # frame is registered live
        self._maybe_rotate()
        return seq

    def mark_persisted(self, seq: int) -> bool:
        """Logical truncation: the write behind `seq` reached COS (or was
        superseded). Appends a PERSIST record and reclaims/compacts the
        segment once its live bytes drain. Unknown/already-dead seqs are
        no-ops (replay supersession may have dropped them)."""
        with self._lock:
            rec = self._records.pop(seq, None)
            if rec is None or self._closed:
                return False
            if self._by_key.get(rec.key) == seq:
                del self._by_key[rec.key]
            self._submit(("frame", _PERSIST, seq, b"", b""))
            self._active_size += _HDR_LEN
            self.stats.persists += 1
            self._note_dead(rec)
            self._maybe_rotate()
            return True

    def sync(self) -> None:
        """Durability barrier: every record appended so far is on disk
        when this returns. Group-commit callers MUST invoke it before
        acknowledging the writes those records cover."""
        if self.faults is not None:
            self.faults.fire("spill.sync")
        obs = self.obs
        with (obs.span("journal.sync")
              if obs is not None else NOOP_CM):
            with self._lock:
                if self._closed:
                    return
                self._submit(("flush",))
            self._drain()

    # ---- internal writer --------------------------------------------------

    def _submit(self, op: tuple) -> None:
        """Run a file op inline (sync_each) or queue it FIFO for the
        writer thread (group commit). Callers hold the lock; bookkeeping
        they did under it describes exactly the state the op will see,
        because ops execute in submission order."""
        if self._wthread is None:
            self._exec_op(op)
        else:
            self._wq.append(op)
            self._wcond.notify_all()

    def _writer_loop(self) -> None:
        while True:
            with self._lock:
                self._winflight = False
                self._wcond.notify_all()          # wake sync() barriers
                while not self._wq and not self._wstop:
                    self._wcond.wait()
                if not self._wq:                  # stopping, fully drained
                    return
                op = self._wq.popleft()
                self._winflight = True
            try:
                self._exec_op(op)                 # I/O outside the lock
            except BaseException as e:            # noqa: BLE001
                with self._lock:
                    self._werr = e
                    # wake blocked sync()/drain barriers NOW — without
                    # this, the ack path only discovered a writer-side
                    # failure on its next poll tick
                    self._wcond.notify_all()

    def _drain(self) -> None:
        """Wait until every queued file op has executed; surface any
        writer failure (original exception type) to the caller — the
        ack path. Writer-side failures notify the condition variable,
        so this blocks without polling and wakes immediately."""
        if self._wthread is None:
            self._raise_pending_error()
            return
        with self._lock:
            while (self._wq or self._winflight) and self._werr is None:
                self._wcond.wait()
            self._raise_pending_error()

    def _raise_pending_error(self) -> None:
        if self._werr is not None:
            err, self._werr = self._werr, None
            raise err

    def _exec_op(self, op: tuple) -> None:
        kind = op[0]
        if kind == "frame":
            if self.faults is not None:
                self.faults.fire("spill.io")     # writer-side I/O error
            _, rtype, seq, kb, body = op
            nbytes = payload_nbytes(body)
            meta = _META_S.pack(rtype, seq, len(kb), nbytes)
            # one small coalesced write (header + key), then the payload
            # as its own write so large bodies bypass the buffer copy
            self._f.write(_MAGIC_S.pack(_MAGIC) + meta
                          + _CRC_S.pack(_frame_crc(meta, kb, body)) + kb)
            if nbytes:
                self._f.write(body)
            self._written += _HDR_LEN + len(kb) + nbytes
            if self.sync_each:
                self._do_flush()             # survives a process crash
        elif kind == "flush":
            self._do_flush()
        elif kind == "rotate":
            _, old_id, delete_old, new_id = op
            self._do_flush()                 # seal durably: fsync=True
            self._f.close()                  # must cover sealed frames
            if delete_old:
                self._seg_path(old_id).unlink(missing_ok=True)
            self._f = open(self._seg_path(new_id), "wb",
                           buffering=64 * 1024)
            self._written = self._synced = 0
        elif kind == "truncate":
            self._f.seek(0)                  # implicit buffer flush
            self._f.truncate()
            self._written = self._synced = 0
        elif kind == "unlink":
            self._seg_path(op[1]).unlink(missing_ok=True)
        elif kind == "compact":
            _, src, entries = op
            try:
                data = src.read_bytes()
            except FileNotFoundError:
                return
            for off, ln in entries:
                self._f.write(data[off:off + ln])
                self._written += ln
            # The copies are about to become the ONLY durable frames for
            # these records: flush them (honoring fsync) before the
            # sealed source is destroyed, else a crash in between loses
            # acked data. _do_flush also advances _synced so a hard
            # close cannot truncate the compacted frames away.
            self._do_flush()
            src.unlink(missing_ok=True)

    def _do_flush(self) -> None:
        self._f.flush()
        if self.fsync:
            # lint: allow(blocking-under-lock): journal I/O is inline under _lock by design (crash-order atomicity); waiver covers all callers
            os.fsync(self._f.fileno())       # machine-crash durability
        self._synced = self._written

    # ---- segment lifecycle (bookkeeping under the lock) -------------------

    def _note_dead(self, rec: _Rec) -> None:
        self._seg_live[rec.seg] -= 1
        self._seg_live_bytes[rec.seg] -= rec.frame_len
        if rec.seg == self._active_id:
            if not self._records:
                # nothing live anywhere: the whole journal is garbage —
                # truncate the active segment in place (bounded disk)
                self._submit(("truncate",))
                self._active_size = 0
                self._seg_live[self._active_id] = 0
                self._seg_live_bytes[self._active_id] = 0
            return
        if self._seg_live[rec.seg] == 0:
            self._submit(("unlink", rec.seg))
            self._seg_live.pop(rec.seg)
            self._seg_live_bytes.pop(rec.seg)
            self.stats.segments_reclaimed += 1
        elif self._seg_live_bytes[rec.seg] <= self.compact_below:
            self._compact_segment(rec.seg)

    def _compact_segment(self, seg_id: int) -> None:
        """A sealed segment pinned by a few small live records (metadata
        entries, typically) re-appends those frames verbatim — same seqs
        — to the active segment and reclaims the file. Offsets are
        re-assigned synchronously; the copy executes in queue order, so
        it sees the sealed file complete and precedes any later op."""
        entries = []
        for seq in sorted(s for s, r in self._records.items()
                          if r.seg == seg_id):
            rec = self._records[seq]
            entries.append((rec.offset, rec.frame_len))
            rec.seg = self._active_id
            rec.offset = self._active_size
            self._active_size += rec.frame_len
            self._seg_live[self._active_id] += 1
            self._seg_live_bytes[self._active_id] += rec.frame_len
        self._seg_live.pop(seg_id, None)
        self._seg_live_bytes.pop(seg_id, None)
        self._submit(("compact", self._seg_path(seg_id), entries))
        self.stats.segments_compacted += 1

    def rotate(self) -> int:
        """Force-seal the active segment and open a new one — the
        journal-GENERATION boundary the metadata-snapshot scheme uses:
        the snapshot becomes the first record of the fresh generation,
        and everything it supersedes sits in sealed segments that
        reclaim or compact away on their own. Returns the new active
        segment id (== `generation`). No-op on an empty active segment
        or a closed journal."""
        with self._lock:
            if self._closed or self._active_size == 0:
                return self._active_id
            self._rotate_locked()
            return self._active_id

    @property
    def generation(self) -> int:
        """The active segment id — advances on every rotation (size-
        triggered or a forced `rotate()` generation boundary)."""
        with self._lock:
            return self._active_id

    def _maybe_rotate(self) -> None:
        if self._active_size < self.segment_bytes:
            return
        self._rotate_locked()

    def _rotate_locked(self) -> None:
        old = self._active_id
        delete_old = self._seg_live.get(old, 0) == 0
        if delete_old:
            self._seg_live.pop(old, None)
            self._seg_live_bytes.pop(old, None)
            self.stats.segments_reclaimed += 1
        self._active_id += 1
        self._active_size = 0
        self._seg_live.setdefault(self._active_id, 0)
        self._seg_live_bytes.setdefault(self._active_id, 0)
        self._submit(("rotate", old, delete_old, self._active_id))
        self.stats.segments_created += 1

    # ---- lifecycle / introspection ----------------------------------------

    def _release_dir_lock(self) -> None:
        lockf, self._lockf = self._lockf, None
        if lockf is not None:
            try:
                fcntl.flock(lockf.fileno(), fcntl.LOCK_UN)
            except OSError:
                pass
            lockf.close()

    def close(self, *, reclaim: bool = True, hard: bool = False) -> None:
        """Drain, flush, and close. With `reclaim` (graceful shutdown), a
        journal with zero live records deletes its files. `hard=True` is
        the crash-simulation path: after closing, the active segment is
        truncated back to its last flushed offset, discarding the
        unsynced buffer tail exactly as a SIGKILL would (only frames a
        `sync()` barrier covered — i.e. acked data — survive)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._wstop = True
            self._wcond.notify_all()
        if self._wthread is not None:
            self._wthread.join(timeout=10.0)      # drains the queue first
        if hard:
            synced = self._synced
            self._f.close()                       # flushes the tail ...
            cut = synced
            if self.faults is not None and \
                    self.faults.fire("spill.torn_close") == "torn":
                # leave a PARTIAL unsynced frame behind the synced
                # boundary — the crash-mid-append case replay must
                # detect (bad framing) and drop; synced (acked) frames
                # are never torn, the contract says they survive
                p = self._seg_path(self._active_id)
                try:
                    tail = os.path.getsize(p) - synced
                except OSError:
                    tail = 0
                if tail > 0:
                    cut = synced + min(_HDR_LEN - 12, tail)
            try:                                  # ... which a real crash
                os.truncate(self._seg_path(self._active_id), cut)
            except OSError:                       # would have lost
                pass
            self._release_dir_lock()              # as process death would
            return
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self._f.close()
        with self._lock:
            if reclaim and not self._records:
                for seg_id in self._segment_ids():
                    self._seg_path(seg_id).unlink(missing_ok=True)
        self._release_dir_lock()

    @property
    def pending_count(self) -> int:
        with self._lock:
            return len(self._records)

    @property
    def pending_bytes(self) -> int:
        with self._lock:
            return sum(r.payload_len for r in self._records.values())

    def pending_keys(self) -> List[str]:
        with self._lock:
            return sorted(r.key for r in self._records.values())

    def snapshot(self) -> Dict:
        with self._lock:
            return {"dir": str(self.dir),
                    "pending_records": len(self._records),
                    "pending_bytes": sum(r.payload_len
                                         for r in self._records.values()),
                    "segments": len(self._seg_live),
                    "appends": self.stats.appends,
                    "persists": self.stats.persists,
                    "replayed_records": self.stats.replayed_records,
                    "replayed_bytes": self.stats.replayed_bytes,
                    "torn_records": self.stats.torn_records,
                    "segments_reclaimed": self.stats.segments_reclaimed,
                    "segments_compacted": self.stats.segments_compacted}
