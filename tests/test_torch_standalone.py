"""The port stands alone: nothing under src/repro_torch/ and not
chip_smoke.py imports jax or the JAX package, importing the store, the
serving stack, the models, the configs and the training stack leaves
jax out of sys.modules,
and the default device of the store and of the serving engine (the
card) is refused — never silently replaced by the CPU — where CUDA is
absent."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]


def test_port_sources_import_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = [f"{f.relative_to(ROOT)}:{line} imports {mod}"
           for f in files for line, mod in _imported_roots(f)
           if mod in FORBIDDEN]
    assert bad == []


def _imports_leave_jax_unloaded(modules: str):
    code = (f"import sys, {modules}; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_store_import_leaves_jax_unloaded():
    _imports_leave_jax_unloaded("repro_torch.core.store, repro_torch.core")


def test_serving_import_leaves_jax_unloaded():
    _imports_leave_jax_unloaded(
        "repro_torch.serving, repro_torch.models, repro_torch.configs, "
        "repro_torch.launch.serve, repro_torch.models.convert")


def test_training_import_leaves_jax_unloaded():
    _imports_leave_jax_unloaded(
        "repro_torch.launch.train, repro_torch.launch.steps, "
        "repro_torch.checkpoint, repro_torch.optim, repro_torch.data")


def test_default_store_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("the machine has a card: the default device is usable")
    from repro_torch.core import InfiniStore, StoreConfig
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InfiniStore()
    assert StoreConfig().device == "cuda"


def test_default_serving_engine_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("the machine has a card: the default device is usable")
    from repro_torch.configs import get_config, reduced
    from repro_torch.serving import ServeEngine, SMSPagedKV
    cfg = reduced(get_config("qwen3-1.7b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SMSPagedKV(cfg, batch_slots=1, max_len=8)
