"""Shared-memory IPC transport for the multi-process shard host.

One `ShmArena` is a single-writer / single-reader FIFO byte ring over a
`multiprocessing.shared_memory.SharedMemory` segment.  The writer side
allocates contiguous slots (`alloc`), the reader side maps them back to
zero-copy numpy views (`view`), and consumption is acknowledged with
monotonic release watermarks carried on the control pipe
(`release_to`).  Positions are monotonic byte offsets — never wrapped —
so a watermark is unambiguous even after the ring has cycled many
times; a slot that would straddle the physical end of the segment is
pushed past the wrap point by a pad (the pad bytes sit *below* the slot
position, so releasing `pos + length` frees them too).

Payloads larger than the arena (or with no arena at all) fall back to
inline bytes on the control pipe — slower, but always correct. So does
a payload whose slot could never be allocated while the message it
rides in is still unsent: its slot, with the wrap pad before it and the
slots of the same message's earlier payloads, must fit in the ring,
because the reader releases nothing of a message it has not received
(`fits`; a writer that waited instead would wait forever).

Payloads cross the rings as host bytes. A CUDA tensor is copied
device-to-host once, straight into its slot (or into the inline bytes);
the receiving store copies it host-to-device when it encodes. Segment
names are `istore-torch-<creator pid>-<tag>-<random>`: apart from the
JAX package's `infinistore-` segments, and countable per creating
process.

Python 3.10's ``SharedMemory`` registers segments with the per-process
``resource_tracker`` on *attach*, not just create; a SIGKILLed worker's
tracker would then unlink segments the parent still owns.  `attach`
therefore unregisters immediately after attaching — the creating parent
remains the single owner responsible for unlinking.
"""
from __future__ import annotations

import os
import secrets
import threading
from multiprocessing import resource_tracker, shared_memory
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .locks import make_lock

__all__ = [
    "ArenaBroken",
    "ShmArena",
    "pack_payload",
    "unpack_payload",
]

# Payload descriptors crossing the control pipe:
#   ("a", pos, nbytes)  value lives in the arena at monotonic pos
#   ("i", bytes)        inline fallback (arena-less or oversized)
PayloadDesc = Tuple

# every shared-memory segment this package creates is named with this
# prefix (the JAX package's start with `infinistore-`)
SEGMENT_PREFIX = "istore-torch-"


class ArenaBroken(ConnectionError):
    """The peer died (or the arena was closed) while data was in flight."""


def _attach_untracked(name: str) -> shared_memory.SharedMemory:
    # Suppress the attach-side register (module attr patch: 3.10's
    # shared_memory calls `resource_tracker.register`). A
    # register+unregister pair would instead DELETE the creator's entry
    # — the tracker cache is one shared name-set — leaving a KeyError
    # at unlink and no crash coverage for the segment.
    orig = resource_tracker.register
    resource_tracker.register = lambda *a, **k: None
    try:
        return shared_memory.SharedMemory(name=name)
    finally:
        resource_tracker.register = orig


class ShmArena:
    """Bounded FIFO byte ring in shared memory (one writer, one reader)."""

    def __init__(self, shm: shared_memory.SharedMemory, size: int, *,
                 owner: bool):
        self._shm = shm
        self.size = int(size)
        self.name = shm.name
        self._owner = owner
        self._buf = np.frombuffer(shm.buf, dtype=np.uint8, count=self.size)
        # Writer-side state only; the reader never touches these.
        self._lock = make_lock("ipc.ShmArena._lock")
        self._space = threading.Condition(self._lock)
        self._head = 0          # next byte to allocate (monotonic)
        self._tail = 0          # all bytes below this are free (monotonic)
        self._broken: Optional[BaseException] = None
        self._closed = False

    # -- lifecycle ---------------------------------------------------------

    @classmethod
    def create(cls, size: int, *, tag: str = "arena") -> "ShmArena":
        name = (f"{SEGMENT_PREFIX}{os.getpid()}-{tag}-"
                f"{secrets.token_hex(6)}")
        shm = shared_memory.SharedMemory(name=name, create=True, size=size)
        return cls(shm, size, owner=True)

    @classmethod
    def attach(cls, name: str, size: int) -> "ShmArena":
        return cls(_attach_untracked(name), size, owner=False)

    def fail(self, exc: BaseException) -> None:
        """Mark the arena broken and wake any blocked allocator."""
        with self._space:
            if self._broken is None:
                self._broken = exc
            self._space.notify_all()

    @property
    def broken(self) -> bool:
        """True once `fail()`/`close()` has condemned the arena — the
        transport health probe, without touching allocator state."""
        with self._space:
            return self._broken is not None

    def close(self) -> None:
        with self._space:
            self._closed = True
            if self._broken is None:
                self._broken = ArenaBroken(f"arena {self.name} closed")
            self._space.notify_all()
        self._buf = None
        try:
            self._shm.close()
        except Exception:
            pass
        if self._owner:
            try:
                self._shm.unlink()
            except Exception:
                pass

    # -- writer side -------------------------------------------------------

    @property
    def head(self) -> int:
        """The next byte the writer allocates (monotonic)."""
        with self._space:
            return self._head

    def fits(self, nbytes: int, since: int) -> bool:
        """True when a slot of `nbytes` can be allocated once the reader
        has released every byte below monotonic position `since`: the
        bytes from `since` on belong to a message not yet sent, which
        the reader cannot release."""
        n = int(nbytes)
        with self._space:
            head, size = self._head, self.size
            off = head % size
            pad = (size - off) if off + n > size else 0
            return head + pad + n - since <= size

    def alloc(self, nbytes: int, *,
              timeout: Optional[float] = None) -> Tuple[int, np.ndarray]:
        """Reserve `nbytes` contiguous bytes; returns (pos, writable view).

        Blocks while the ring is full, until the reader releases space
        (`release_to`) or the arena breaks.  Raises ``ValueError`` when
        the request can never fit — callers fall back to inline bytes.
        """
        n = int(nbytes)
        if n > self.size:
            raise ValueError(f"{n} bytes exceeds arena capacity {self.size}")
        with self._space:
            while True:
                if self._broken is not None:
                    raise ArenaBroken(str(self._broken)) from self._broken
                head, size = self._head, self.size
                off = head % size
                pad = (size - off) if off + n > size else 0
                need = pad + n
                if (head + need) - self._tail <= size:
                    self._head = head + need
                    pos = head + pad
                    start = pos % size
                    return pos, self._buf[start:start + n]
                if not self._space.wait(timeout=timeout):
                    raise TimeoutError(
                        f"arena {self.name} full ({n} bytes) after "
                        f"{timeout}s; reader stalled?")

    def release_to(self, watermark: int) -> None:
        """Reader acknowledged everything below `watermark` (monotonic)."""
        with self._space:
            if watermark > self._tail:
                self._tail = watermark
                self._space.notify_all()

    # -- reader side -------------------------------------------------------

    def view(self, pos: int, nbytes: int) -> np.ndarray:
        """Zero-copy view of a slot the writer allocated (contiguous)."""
        start = pos % self.size
        return self._buf[start:start + nbytes]


# -- payload packing -------------------------------------------------------

def pack_payload(arena: Optional[ShmArena], value,
                 since: Optional[int] = None) -> PayloadDesc:
    """Copy one payload into the arena (bulk memcpy) or inline it.

    Accepts anything `repro_torch.core.payload.as_u8` does.  This single
    copy into shared memory IS the caller-side capture: the peer
    snapshots out of the arena at submission, then the slot is released.
    A CUDA tensor is copied device-to-host straight into the slot, or
    into the inline bytes. `since` is the arena's `head` when the
    message carrying this payload began (None: the payload travels
    alone); the payload goes inline where its slot does not `fit`.
    """
    # local import: avoid cycle at module load
    from .payload import as_u8, to_host

    u8 = as_u8(value)
    n = int(u8.numel())
    if arena is not None and arena.fits(
            n, arena.head if since is None else since):
        pos, slot = arena.alloc(n)
        if n:
            torch.from_numpy(slot).copy_(u8)
        return ("a", pos, n)
    return ("i", to_host(u8).tobytes())


def unpack_payload(arena: Optional[ShmArena], desc: PayloadDesc,
                   *, writable: bool = True):
    """Materialize a descriptor on the receiving side.

    Arena-backed descriptors come back as a *writable* numpy view by
    default: `InfiniStore._snapshot_value` copies writable buffers
    synchronously at submission, which is exactly the hand-off we want —
    the store owns a private copy, and the ring slot can be released the
    moment the call returns.  (A read-only view would be retained
    uncopied and later scribbled over by ring reuse.)
    """
    kind = desc[0]
    if kind == "a":
        _, pos, n = desc
        v = arena.view(pos, n)
        if not writable:
            v = v.copy()
            v.flags.writeable = False
        return v
    if kind == "i":
        return desc[1]
    raise ValueError(f"unknown payload descriptor {desc!r}")


def desc_watermark(descs: Sequence[PayloadDesc]) -> int:
    """Highest arena byte consumed by `descs` (0 when none are arena-backed)."""
    wm = 0
    for d in descs:
        if d[0] == "a":
            wm = max(wm, d[1] + d[2])
    return wm


def pack_items(arena: Optional[ShmArena],
               items: Sequence[Tuple[str, object]]) -> List[Tuple[str, PayloadDesc]]:
    return [(k, pack_payload(arena, v)) for k, v in items]


def unpack_items(arena: Optional[ShmArena],
                 items: Sequence[Tuple[str, PayloadDesc]]):
    return [(k, unpack_payload(arena, d)) for k, d in items]
