"""Named lock factory with an opt-in runtime lock-order witness.

Every lock in the concurrency-bearing core modules is created through
`make_lock` / `make_rlock` with a stable dotted name
(``module.Class.attr``).  In normal operation the factory returns a
plain ``threading.Lock`` / ``threading.RLock`` — zero wrapper, zero
per-acquisition overhead.  When a witness is installed (programmatic
`install_witness`, or ``ISTORE_LOCK_WITNESS=1`` in the environment at
first lock creation) each factory call instead returns a thin proxy
that reports acquisitions and releases to the witness, which checks the
observed acquisition order against the statically derived lock
hierarchy (`repro_torch.devtools.lockgraph`) and records any inversion.

The names passed to the factory are the SAME node names the static
analyzer derives (`python -m repro_torch.devtools.lint src/repro_torch
--emit-hierarchy ...`), which is what lets the runtime witness and the
static model cross-validate: `repro_torch.devtools.lint` checks the
literal matches the defining ``module.Class.attr`` site, so the two
views cannot drift.

Witness installation only affects locks created AFTER the install —
install one before constructing the stores under test (the conformance
suite does exactly that).
"""
from __future__ import annotations

import os
import threading
from typing import Optional

__all__ = ["make_lock", "make_rlock", "install_witness", "current_witness"]

_witness = None
_env_checked = False


def install_witness(witness) -> None:
    """Install (or with None, remove) the process-global lock witness.

    `witness` must provide ``on_acquire(name)`` / ``on_release(name)``
    — normally a `repro_torch.devtools.witness.LockWitness`.
    """
    global _witness, _env_checked
    _witness = witness
    _env_checked = True          # explicit install overrides the env path


def current_witness():
    return _witness


def _active_witness():
    global _env_checked, _witness
    if not _env_checked:
        _env_checked = True
        if _witness is None and os.environ.get("ISTORE_LOCK_WITNESS"):
            # Lazy import: devtools is pure-stdlib AST analysis; core
            # never pays for it unless the witness is switched on.
            from repro_torch.devtools.witness import LockWitness
            _witness = LockWitness.with_static_order()
    return _witness


class _WitnessedLock:
    """Transparent proxy reporting acquire/release to the witness.

    Unknown attributes delegate to the inner lock so
    ``threading.Condition`` works over both flavors: an RLock exposes
    ``_release_save``/``_acquire_restore``/``_is_owned`` (delegated,
    bypassing the witness for the wait-window release — the thread
    still logically holds the lock), while a plain Lock raises
    AttributeError and Condition falls back to ``acquire``/``release``
    through this proxy.
    """

    __slots__ = ("_inner", "name", "_w")

    def __init__(self, inner, name: str, witness):
        self._inner = inner
        self.name = name
        self._w = witness

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._w.on_acquire(self.name)
        return got

    def release(self) -> None:
        self._inner.release()
        self._w.on_release(self.name)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "_WitnessedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def __getattr__(self, item):
        return getattr(self._inner, item)

    def __repr__(self) -> str:
        return f"<witnessed {self._inner!r} name={self.name!r}>"


def make_lock(name: str):
    """A ``threading.Lock`` (or witnessed proxy) named for the witness."""
    w = _active_witness()
    inner = threading.Lock()
    return inner if w is None else _WitnessedLock(inner, name, w)


def make_rlock(name: str):
    """A ``threading.RLock`` (or witnessed proxy) named for the witness."""
    w = _active_witness()
    inner = threading.RLock()
    return inner if w is None else _WitnessedLock(inner, name, w)
