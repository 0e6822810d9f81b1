"""Run a JAX-package test file's own test bodies against the port.

`mirror("test_spill.py")` reads the reference test file, points its
imports at `repro_torch` instead of `repro`, makes the `StoreConfig`
and `RSCodec` it names default to `device="cpu"` (the port's entry
points default to the card), replaces the `tiny_store` fixture with the
port's, and returns the resulting test functions and the module's own
fixtures for a `tests/test_torch_mirror_*.py` module to publish. Tests
that check what the port deliberately does differently are left out by
name, each with its reason (ROADMAP, queue 3).

The CPU-default subclasses are defined at module level so that a store
config can be pickled into a shard worker process, which imports this
module to rebuild it.
"""
from __future__ import annotations

import dataclasses
import re
import types
from pathlib import Path

import pytest

from repro_torch.core.ec import RSCodec as _PortRSCodec
from repro_torch.core.store import StoreConfig as _PortStoreConfig

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class CPUStoreConfig(_PortStoreConfig):
    """The port's `StoreConfig` with the device defaulting to the CPU."""
    device: str = "cpu"


class CPURSCodec(_PortRSCodec):
    """The port's `RSCodec` with the device defaulting to the CPU."""

    def __init__(self, *args, device="cpu", **kw):
        super().__init__(*args, device=device, **kw)


@pytest.fixture
def tiny_store():
    """The port's small-geometry store on a logical clock, on the CPU
    (the conftest fixture of the same name builds the reference's)."""
    from repro_torch.core import Clock, InfiniStore, StoreConfig
    from repro_torch.core.ec import ECConfig
    from repro_torch.core.gc_window import GCConfig
    MB = 1024 * 1024
    cfg = StoreConfig(
        ec=ECConfig(k=4, p=2),
        function_capacity=4 * MB,
        fragment_bytes=1 * MB,
        gc=GCConfig(gc_interval=10.0, active_intervals=2,
                    degraded_intervals=2, active_warmup=5.0,
                    degraded_warmup=20.0),
        num_recovery_functions=4,
        device="cpu",
    )
    clock = Clock()
    return InfiniStore(cfg, clock=clock), clock


def port_source(src: str) -> str:
    """The reference test source with its imports retargeted at the
    port."""
    src = re.sub(r"\b(from|import) repro\.", r"\1 repro_torch.", src)
    return re.sub(r"\bfrom repro import\b", "from repro_torch import", src)


def _cpu_defaults(ns: dict) -> None:
    """Rebind the test module's `StoreConfig` / `RSCodec` to subclasses
    whose device defaults to the CPU (looked up at call time, so every
    store and codec the tests build runs the plain PyTorch product)."""
    if "StoreConfig" in ns:
        ns["StoreConfig"] = CPUStoreConfig
    if "RSCodec" in ns:
        ns["RSCodec"] = CPURSCodec


def _is_fixture(obj) -> bool:
    return type(obj).__name__ == "FixtureFunctionDefinition" \
        or hasattr(obj, "_pytestfixturefunction")


def mirror(filename: str, skip: dict | None = None,
           overrides: dict | None = None) -> dict:
    """Test functions, test classes and fixtures of `tests/<filename>`
    run against the port, plus the port's `tiny_store` fixture; `skip` maps left-out
    test names to the reason, `overrides` rebinds module globals the
    tests read at call time (e.g. the source tree a lint test scans)."""
    path = HERE / filename
    module = types.ModuleType(f"torch_mirror_{path.stem}")
    module.__file__ = str(path)
    code = compile(port_source(path.read_text()), str(path), "exec")
    exec(code, module.__dict__)
    _cpu_defaults(module.__dict__)
    module.__dict__.update(overrides or {})
    out = {"tiny_store": tiny_store}
    for name, obj in module.__dict__.items():
        if name.startswith(("test", "Test")) and callable(obj) \
                and name not in (skip or {}):
            out[name] = obj
        elif _is_fixture(obj) or name == "pytestmark":
            out[name] = obj
    missing = set(skip or {}) - set(module.__dict__)
    assert not missing, f"{filename}: no such tests {sorted(missing)}"
    return out
