"""The port's metrics-export gate passes on the CPU:
`scripts/torch_check_metrics_dump.py --device cpu` exits 0 (Prometheus
text parsed, every histogram site exported, the JSON dump's sites and
counters, the ISTORE_METRICS_DUMP atexit hook of a child store on the
same device); without a card it refuses the default device."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
GATE = ROOT / "scripts" / "torch_check_metrics_dump.py"


def _run(*args: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, str(GATE), *args],
                          env=dict(os.environ), cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_metrics_gate_passes_on_the_cpu():
    res = _run("--device", "cpu")
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    from repro_torch.obs import HISTOGRAM_SITES
    assert (f"metrics dump gate: {len(HISTOGRAM_SITES)} histogram sites "
            f"exported") in res.stdout
    assert "atexit hook OK (device cpu)" in res.stdout


def test_metrics_gate_refuses_the_cpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("the machine has a card: the default device is usable")
    res = _run()
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
