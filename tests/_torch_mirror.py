"""Run a JAX-package test file's own test bodies against the port.

`mirror("test_spill.py")` reads the reference test file, points its
imports at `repro_torch` instead of `repro`, makes the `StoreConfig`
and `RSCodec` it names default to `device="cpu"` (the port's entry
points default to the card), replaces the `tiny_store` fixture with the
port's, and returns the resulting test functions for a
`tests/test_torch_mirror_*.py` module to publish. Tests that check what
the port deliberately does differently are left out by name, each with
its reason (ROADMAP, queue 3).
"""
from __future__ import annotations

import dataclasses
import re
import types
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent


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
        @dataclasses.dataclass
        class StoreConfig(ns["StoreConfig"]):
            device: str = "cpu"
        ns["StoreConfig"] = StoreConfig
    if "RSCodec" in ns:
        base = ns["RSCodec"]

        class RSCodec(base):
            def __init__(self, *args, device="cpu", **kw):
                super().__init__(*args, device=device, **kw)
        ns["RSCodec"] = RSCodec


def mirror(filename: str, skip: dict | None = None) -> dict:
    """Test functions of `tests/<filename>` run against the port, plus
    the port's `tiny_store` fixture; `skip` maps left-out test names to
    the reason."""
    path = HERE / filename
    module = types.ModuleType(f"torch_mirror_{path.stem}")
    module.__file__ = str(path)
    code = compile(port_source(path.read_text()), str(path), "exec")
    exec(code, module.__dict__)
    _cpu_defaults(module.__dict__)
    out = {"tiny_store": tiny_store}
    for name, obj in module.__dict__.items():
        if name.startswith("test") and callable(obj) \
                and name not in (skip or {}):
            out[name] = obj
    missing = set(skip or {}) - set(module.__dict__)
    assert not missing, f"{filename}: no such tests {sorted(missing)}"
    return out
