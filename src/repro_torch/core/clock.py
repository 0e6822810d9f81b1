"""Logical/wall clock shared by the storage components.

Tests and trace replays drive a logical clock deterministically; the
serving engine can run it off wall time. All InfiniStore components
(GC window, COS visibility lag, cost model, warmup scheduling) read the
same clock so behaviour is reproducible.
"""
from __future__ import annotations

import threading
import time


class Clock:
    def __init__(self, *, wall: bool = False):
        self._wall = wall
        self._t = 0.0
        self._lock = threading.Lock()

    def now(self) -> float:
        if self._wall:
            return time.monotonic()
        with self._lock:
            return self._t

    def advance(self, dt: float) -> float:
        if self._wall:
            raise RuntimeError("cannot advance a wall clock")
        with self._lock:
            self._t += dt
            return self._t

    @property
    def is_wall(self) -> bool:
        return self._wall
