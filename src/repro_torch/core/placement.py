"""Function groups + the PlaceChunk algorithm (paper §5.3.1, Fig. 5).

An FG is the logical scaling unit: `fg_size = k + p` functions, one per
EC chunk slot. PlaceChunk starts at function `chunk_id` and probes in
strides of `fg_size`, so two chunks of one object can never land on the
same function; the greedy oldest-open-FG-first policy fills (and seals)
old FGs before new ones.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

AUTOSCALE_LINEAR = "linear"
AUTOSCALE_DOUBLE = "double"


@dataclass
class FunctionMeta:
    fid: int
    fg_id: int
    slot: int                      # chunk-slot index within the FG
    capacity: int                  # HARDCAP bytes (storage partition)
    used: int = 0
    sealed: bool = False
    queue_depth: int = 0           # outstanding requests (two-queue combined)
    max_queue: int = 64

    @property
    def open(self) -> bool:
        return not self.sealed

    def has_room(self, nbytes: int) -> bool:
        return self.used + nbytes <= self.capacity

    def queue_ok(self) -> bool:
        return self.queue_depth < self.max_queue


@dataclass
class FunctionGroup:
    fg_id: int
    fids: List[int]
    sealed: bool = False


@dataclass
class PlacementStats:
    scale_outs: int = 0
    placements: int = 0
    probes: int = 0
    seals: int = 0


class PlacementManager:
    """Tracks open FGs of the LATEST GC-bucket and places chunks."""

    def __init__(self, fg_size: int, function_capacity: int, *,
                 autoscale: str = AUTOSCALE_LINEAR,
                 new_function_cb: Optional[Callable[[int, int, int], None]] = None):
        self.fg_size = fg_size
        self.function_capacity = function_capacity
        self.autoscale = autoscale
        self.functions: Dict[int, FunctionMeta] = {}
        self.fgs: Dict[int, FunctionGroup] = {}
        self.open_fg_ids: List[int] = []     # oldest first
        self._next_fid = 0
        self._next_fg = 0
        self.stats = PlacementStats()
        # callback(fid, fg_id, capacity): lets SMS allocate the slab and the
        # window register the function in the latest bucket
        self._new_function_cb = new_function_cb or (lambda *a: None)

    # ---- scaling ----------------------------------------------------------

    def _add_fg(self) -> FunctionGroup:
        fg = FunctionGroup(self._next_fg, [])
        self._next_fg += 1
        for slot in range(self.fg_size):
            fid = self._next_fid
            self._next_fid += 1
            self.functions[fid] = FunctionMeta(
                fid=fid, fg_id=fg.fg_id, slot=slot,
                capacity=self.function_capacity)
            fg.fids.append(fid)
            self._new_function_cb(fid, fg.fg_id, self.function_capacity)
        self.fgs[fg.fg_id] = fg
        self.open_fg_ids.append(fg.fg_id)
        self.stats.scale_outs += 1
        return fg

    def scale_out(self) -> None:
        if self.autoscale == AUTOSCALE_DOUBLE and self.open_fg_ids:
            for _ in range(max(1, len(self.open_fg_ids))):
                self._add_fg()
        else:
            self._add_fg()

    def _open_functions(self) -> List[int]:
        """Flat probe order: slot-major across open FGs, oldest FG first.
        Index i maps to (fg = i // fg_size by age, slot = i % fg_size)."""
        out: List[int] = []
        for fg_id in self.open_fg_ids:
            out.extend(self.fgs[fg_id].fids)
        return out

    def get_open_funcs(self, min_index: int) -> List[int]:
        """Paper's GetOpenFuncs: ensure at least min_index+1 open function
        slots exist, scaling out FG-at-a-time if needed."""
        funcs = self._open_functions()
        while len(funcs) <= min_index:
            self.scale_out()
            funcs = self._open_functions()
        return funcs

    # ---- sealing -----------------------------------------------------------

    def seal_fg(self, fg_id: int) -> None:
        fg = self.fgs[fg_id]
        if fg.sealed:
            return
        fg.sealed = True
        for fid in fg.fids:
            self.functions[fid].sealed = True
        if fg_id in self.open_fg_ids:
            self.open_fg_ids.remove(fg_id)
        self.stats.seals += 1

    def maybe_seal(self, fid: int) -> None:
        """Seal the whole FG once any member reaches HARDCAP (paper
        §5.3.1: 'all functions in that FG are sealed')."""
        f = self.functions[fid]
        if f.used >= f.capacity:
            self.seal_fg(f.fg_id)

    def carry_over_open_fgs(self) -> List[int]:
        """Open FGs survive GC into the new latest bucket (Fig. 4c)."""
        return list(self.open_fg_ids)

    # ---- PlaceChunk (Fig. 5) ----------------------------------------------

    def test_and_place(self, fid: int, nbytes: int) -> bool:
        """Paper semantics: a function accepts writes while UNDER HARDCAP;
        the write that crosses HARDCAP is accepted and then the whole FG
        seals (§5.3.1)."""
        f = self.functions[fid]
        if f.sealed or f.used >= f.capacity or not f.queue_ok():
            return False
        f.used += nbytes
        self.stats.placements += 1
        self.maybe_seal(fid)
        return True

    def place_chunk(self, chunk_id: int, nbytes: int) -> int:
        """Returns the function id that stores this chunk. chunk_id is the
        chunk's slot index within its object (0..fg_size-1)."""
        if not 0 <= chunk_id < self.fg_size:
            raise ValueError(f"chunk_id {chunk_id} not in [0,{self.fg_size})")
        func_ptr = chunk_id
        functions = self.get_open_funcs(func_ptr)
        while True:
            self.stats.probes += 1
            if func_ptr >= len(functions):
                functions = self.get_open_funcs(func_ptr)  # scale out
            elif not self.test_and_place(functions[func_ptr], nbytes):
                func_ptr += self.fg_size        # next FG, same slot
            else:
                return functions[func_ptr]

    def try_place_chunk(self, chunk_id: int, nbytes: int) -> Optional[int]:
        """`place_chunk` without the auto-scale: probes only EXISTING
        open functions and returns None when none accepts. Compaction
        and cache-space callers use this — re-placed read-path bytes
        must never spin up a new function group."""
        if not 0 <= chunk_id < self.fg_size:
            raise ValueError(f"chunk_id {chunk_id} not in [0,{self.fg_size})")
        functions = self._open_functions()
        func_ptr = chunk_id
        while func_ptr < len(functions):
            self.stats.probes += 1
            if self.test_and_place(functions[func_ptr], nbytes):
                return functions[func_ptr]
            func_ptr += self.fg_size            # next FG, same slot
        return None

    def release(self, fid: int, nbytes: int) -> None:
        f = self.functions.get(fid)
        if f is not None:
            f.used = max(0, f.used - nbytes)
