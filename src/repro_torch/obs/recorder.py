"""Crash-surviving flight recorder: bounded event ring + mmap mirror.

The in-memory half is a bounded ring of structured events (state
transitions: DEGRADED_WRITEBACK enter/heal, SUSPECT/DOWN, epoch bumps,
in-doubt resolutions, fault-plane fires) — `deque(maxlen)` appends are
GIL-atomic, so recording is lock-free like the histogram cells.

The durable half is a small fixed-size mmap'd file (`flight.bin` in the
owning store's spill directory — `<spill_dir>/shard-<i>/` for a worker
process): every event (and every finished span, so a trace survives its
process) is also written into a slot ring in the file. mmap stores land
in the OS page cache, which survives a SIGKILL of the process — exactly
the crash domain the recorder exists for — so `restart_shard()` can
read the dead worker's last pre-kill events back out and surface them
as forensics. (Machine-crash durability is explicitly NOT the contract;
that is the spill journal's job.)

File format, all little-endian:

    header  magic u32 0x464C5431 ("FLT1"), slot_size u16, nslots u16
    slot    length u16, then `length` bytes of compact JSON

Slots are assigned round-robin from an atomic counter, so concurrent
writers touch distinct slots; the reader orders records by the embedded
`seq` and skips anything that does not parse (a torn slot from a crash
mid-store loses that one record only).
"""
from __future__ import annotations

import itertools
import json
import mmap
import os
import struct
import time
from collections import deque
from typing import Dict, List, Optional

_MAGIC = 0x464C5431                       # "FLT1"
_HDR = struct.Struct("<IHH")
_LEN = struct.Struct("<H")
DEFAULT_SLOTS = 256
DEFAULT_SLOT_SIZE = 256


class FlightRecorder:
    """Bounded structured-event ring with an optional mmap mirror."""

    def __init__(self, capacity: int = DEFAULT_SLOTS):
        self._ring: deque = deque(maxlen=capacity)
        self._seq = itertools.count(1)
        self._slot = itertools.count(0)
        self._nslots = capacity
        self._slot_size = DEFAULT_SLOT_SIZE
        # guards the mmap handle lifecycle (bind/close vs concurrent
        # writers); a strict leaf lock — nothing is acquired under it.
        # (Constructor-time import: repro_torch.core layers import repro_torch.obs,
        # so a module-level core import here would be circular.)
        from repro_torch.core.locks import make_lock
        self._lock = make_lock("recorder.FlightRecorder._lock")
        self._mmap: Optional[mmap.mmap] = None
        self._file = None
        self._path: Optional[str] = None

    # ---- recording --------------------------------------------------------

    def event(self, site: str, **fields) -> Dict:
        """Record one structured event; returns the record dict."""
        rec = {"seq": next(self._seq), "ts": round(time.time(), 6),
               "kind": site}
        rec.update(fields)
        self._ring.append(rec)
        self._write_file(rec)
        return rec

    def mirror(self, rec: Dict) -> None:
        """Write a record to the mmap file only (no ring entry) — used
        for finished spans, which live in the tracer's own ring."""
        rec = dict(rec)
        rec.setdefault("seq", next(self._seq))
        self._write_file(rec)

    def snapshot(self) -> List[Dict]:
        return [dict(r) for r in list(self._ring)]

    # ---- mmap mirror ------------------------------------------------------

    @property
    def path(self) -> Optional[str]:
        return self._path

    def bind(self, path: str) -> bool:
        """Attach the mmap mirror at `path` (truncates any previous
        incarnation — the caller reads forensics BEFORE rebinding).
        First bind wins; returns whether this call bound it."""
        with self._lock:
            if self._mmap is not None:
                return False
            size = _HDR.size + self._nslots * self._slot_size
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            f = open(path, "w+b")
            f.truncate(size)
            m = mmap.mmap(f.fileno(), size)
            m[:_HDR.size] = _HDR.pack(_MAGIC, self._slot_size,
                                      self._nslots)
            self._file, self._mmap, self._path = f, m, path
            return True

    def _write_file(self, rec: Dict) -> None:
        if self._mmap is None:
            return
        try:
            data = json.dumps(rec, separators=(",", ":"),
                              default=str).encode()
        except (TypeError, ValueError):
            data = json.dumps({"seq": rec.get("seq"),
                               "kind": rec.get("kind")}).encode()
        limit = self._slot_size - _LEN.size
        if len(data) > limit:
            # keep the record parseable: fall back to the identity core
            data = json.dumps({"seq": rec.get("seq"), "ts": rec.get("ts"),
                               "kind": rec.get("kind"),
                               "truncated": True}).encode()[:limit]
        slot = next(self._slot) % self._nslots
        off = _HDR.size + slot * self._slot_size
        with self._lock:
            m = self._mmap
            if m is None:
                return
            m[off:off + _LEN.size] = _LEN.pack(len(data))
            m[off + _LEN.size:off + _LEN.size + len(data)] = data

    def close(self) -> None:
        with self._lock:
            m, f = self._mmap, self._file
            self._mmap = self._file = None
        if m is not None:
            m.flush()
            m.close()
        if f is not None:
            f.close()

    # ---- forensics --------------------------------------------------------

    @staticmethod
    def read_file(path: str) -> List[Dict]:
        """Recover the slot ring from a (possibly SIGKILL'd) process's
        flight file, oldest first. Torn or empty slots are skipped; a
        missing/undersized/foreign file yields []."""
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            return []
        if len(blob) < _HDR.size:
            return []
        magic, slot_size, nslots = _HDR.unpack_from(blob, 0)
        if magic != _MAGIC or slot_size < _LEN.size or nslots == 0:
            return []
        out: List[Dict] = []
        for i in range(nslots):
            off = _HDR.size + i * slot_size
            if off + slot_size > len(blob):
                break
            (length,) = _LEN.unpack_from(blob, off)
            if length == 0 or length > slot_size - _LEN.size:
                continue
            raw = blob[off + _LEN.size:off + _LEN.size + length]
            try:
                rec = json.loads(raw.decode())
            except (ValueError, UnicodeDecodeError):
                continue                      # torn slot: that record only
            if isinstance(rec, dict):
                out.append(rec)
        out.sort(key=lambda r: r.get("seq", 0))
        return out
