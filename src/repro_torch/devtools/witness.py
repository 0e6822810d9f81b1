"""Runtime lock-order witness: validates the static hierarchy under load.

Install with `repro_torch.core.locks.install_witness(LockWitness.with_static_order())`
BEFORE constructing the stores under test; every lock created through
`make_lock`/`make_rlock` afterwards reports its acquisitions here.  The
witness keeps a per-thread stack of held locks and, for each
acquisition of B while holding A, records the ordered pair (A, B).  An
**inversion** is flagged when

- the pair (B, A) was already observed at runtime (both orders really
  happen — a deadlock is one unlucky interleaving away), or
- the static acquisition graph orders B strictly before A (the code
  contradicts the hierarchy `istore-lint` derived — either the code or
  the model is wrong, and CI should say so before a deadlock does).

Reentrant re-acquisition of an already-held name (RLocks) is not a
pair.  Locks unknown to the static model participate in the dynamic
check only.  The witness itself is lock-protected but its internal
mutex is never held while taking a witnessed lock, so it adds no
ordering of its own.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, FrozenSet, List, Optional, Tuple

_static_order_cache: Optional[Dict[str, FrozenSet[str]]] = None


def load_static_order() -> Dict[str, FrozenSet[str]]:
    """Transitive closure of the acquisition graph of the installed
    `repro_torch` package (cached: one AST scan, milliseconds)."""
    global _static_order_cache
    if _static_order_cache is None:
        import repro_torch
        from repro_torch.devtools import lockgraph
        # `repro_torch` may be a namespace package (__file__ is None): take
        # the first __path__ entry instead.
        pkg = Path(next(iter(repro_torch.__path__)))
        _static_order_cache = lockgraph.static_order(
            [str(pkg)], root=pkg.parent)
    return _static_order_cache


@dataclass
class Inversion:
    first: str                  # lock held
    second: str                 # lock acquired under it
    kind: str                   # "static" | "dynamic"
    thread: str
    note: str = ""

    def render(self) -> str:
        return (f"[{self.kind}] acquired {self.second} while holding "
                f"{self.first} in thread {self.thread}: {self.note}")


class LockWitness:
    """Records acquisition orders; detects inversions (see module doc)."""

    def __init__(self, order: Optional[Dict[str, FrozenSet[str]]] = None):
        # order[a] = set of locks acquired after a on some static path
        self._order = {k: frozenset(v) for k, v in (order or {}).items()}
        self._tls = threading.local()
        self._mu = threading.Lock()
        # ordered pair -> first provenance (thread name)
        self._pairs: Dict[Tuple[str, str], str] = {}
        self._inversions: List[Inversion] = []

    @classmethod
    def with_static_order(cls) -> "LockWitness":
        return cls(order=load_static_order())

    # -- static order helpers ----------------------------------------------

    def _static_before(self, a: str, b: str) -> bool:
        """True iff the static graph orders a strictly before b."""
        fwd = b in self._order.get(a, ())
        rev = a in self._order.get(b, ())
        return fwd and not rev

    # -- hook interface (called by locks._WitnessedLock) -------------------

    def _stack(self) -> List[List]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def on_acquire(self, name: str) -> None:
        stack = self._stack()
        for entry in stack:
            if entry[0] == name:
                entry[1] += 1          # reentrant RLock re-acquisition
                return
        held = [e[0] for e in stack]
        if held:
            tname = threading.current_thread().name
            with self._mu:
                for h in held:
                    pair = (h, name)
                    if pair not in self._pairs:
                        self._pairs[pair] = tname
                    rev = self._pairs.get((name, h))
                    if rev is not None:
                        self._inversions.append(Inversion(
                            first=h, second=name, kind="dynamic",
                            thread=tname,
                            note=(f"reverse order {name} -> {h} was "
                                  f"observed earlier in thread {rev}")))
                    elif self._static_before(name, h):
                        self._inversions.append(Inversion(
                            first=h, second=name, kind="static",
                            thread=tname,
                            note=(f"the static hierarchy orders {name} "
                                  f"before {h}")))
        stack.append([name, 1])

    def on_release(self, name: str) -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] == name:
                stack[i][1] -= 1
                if stack[i][1] == 0:
                    del stack[i]
                return
        # release of a lock this thread never acquired through the
        # witness (e.g. handed across threads): ignore

    # -- results -----------------------------------------------------------

    @property
    def pairs_observed(self) -> int:
        with self._mu:
            return len(self._pairs)

    def inversions(self) -> List[Inversion]:
        with self._mu:
            return list(self._inversions)

    def assert_clean(self) -> None:
        inv = self.inversions()
        if inv:
            raise AssertionError(
                "lock-order inversions observed:\n  " +
                "\n  ".join(i.render() for i in inv))

    def snapshot(self) -> dict:
        with self._mu:
            return {"pairs_observed": len(self._pairs),
                    "inversions": [i.render() for i in self._inversions]}
