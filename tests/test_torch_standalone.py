"""The port stands alone: nothing under src/repro_torch/, not
chip_smoke.py and not the port's examples and scripts
(`examples/torch_*.py`, `scripts/torch_*.py`) imports jax or the JAX
package, importing the store, the
scale-out frontends, the devtools, the serving stack, the models, the
configs, the training stack, the sharding rules, meshes, specs and
compression (and `chip_smoke.py` with its spawned pod workers' entry
function) leaves jax out of sys.modules, and the
default device of the store, of the sharded and process frontends and
of the serving engine (the card) is refused — never silently replaced
by the CPU — where CUDA is absent. The process frontend's forkserver
preloads only the port's modules, and importing them touches no CUDA."""
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
    # the port's examples and scripts beside the reference's
    entry = sorted((ROOT / "examples").glob("torch_*.py")) \
        + sorted((ROOT / "scripts").glob("torch_*.py"))
    assert len(entry) >= 8
    files += entry
    assert len(files) > 20
    bad = [f"{f.relative_to(ROOT)}:{line} imports {mod}"
           for f in files for line, mod in _imported_roots(f)
           if mod in FORBIDDEN]
    assert bad == []


def _imports_leave_jax_unloaded(modules: str, then: str = ""):
    code = (f"import sys, {modules}; {then}"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_store_import_leaves_jax_unloaded():
    _imports_leave_jax_unloaded("repro_torch.core.store, repro_torch.core")


def test_scale_out_and_devtools_import_leaves_jax_unloaded():
    _imports_leave_jax_unloaded(
        "repro_torch.core.shard, repro_torch.core.ipc, "
        "repro_torch.core.transport, repro_torch.core.host, "
        "repro_torch.core.netshard, repro_torch.devtools.lint, "
        "repro_torch.devtools.witness")


def test_forkserver_preloads_only_port_modules_without_cuda():
    from repro_torch.core import host
    assert host.FORKSERVER_PRELOAD
    assert all(m.startswith("repro_torch.")
               for m in host.FORKSERVER_PRELOAD)
    # the preload must not create a CUDA context the workers would
    # inherit: importing it initialises nothing on the device
    code = ("import sys, torch; "
            + "; ".join(f"import {m}" for m in host.FORKSERVER_PRELOAD)
            + "; print(torch.cuda.is_initialized())")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "False"
    # workers start by forkserver (or spawn), never by fork
    assert host._host_context().get_start_method() in ("forkserver",
                                                      "spawn")
    with pytest.raises(ValueError, match="CUDA context"):
        host._host_context("fork")


def test_default_sharded_frontends_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("the machine has a card: the default device is usable")
    from repro_torch.core import ProcessShardedStore, ShardedStore
    from repro_torch.core.ipc import SEGMENT_PREFIX
    for build in (ShardedStore, ProcessShardedStore,
                  lambda: ProcessShardedStore(transport="tcp")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    # refused in the parent, before any worker or ring was made
    shm = Path("/dev/shm")
    if shm.is_dir():
        mine = f"{SEGMENT_PREFIX}{os.getpid()}-"
        assert not [n for n in os.listdir(shm) if n.startswith(mine)]


def test_serving_import_leaves_jax_unloaded():
    _imports_leave_jax_unloaded(
        "repro_torch.serving, repro_torch.models, repro_torch.configs, "
        "repro_torch.launch.serve, repro_torch.models.convert")


def test_training_import_leaves_jax_unloaded():
    _imports_leave_jax_unloaded(
        "repro_torch.launch.train, repro_torch.launch.steps, "
        "repro_torch.checkpoint, repro_torch.optim, repro_torch.data")


def test_sharding_and_pod_worker_imports_leave_jax_unloaded():
    # the modules of slice G, and everything chip_smoke's pod workers
    # import: the worker's entry function is importable from the script
    _imports_leave_jax_unloaded(
        "repro_torch.distributed.sharding, repro_torch.launch.mesh, "
        "repro_torch.launch.specs, repro_torch.optim.compression, "
        "repro_torch.launch.steps, repro_torch.data.pipeline, "
        "repro_torch.kernels.rmsnorm.kernel, chip_smoke",
        then="assert callable(chip_smoke.pod_worker); ")


def test_default_mesh_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("the machine has a card: the default device is usable")
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_test_mesh(1, 1)
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        make_production_mesh(multi_pod=True)


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
