"""The port's store examples against the JAX package's: each
`examples/torch_<name>.py --device cpu` prints the lines of
`examples/<name>.py`, every number equal (versions, function counts,
balances, tickets, recoveries, dollars, stats, epochs) once pids, TCP
ports, the writeback queue's depth, times and latencies, the span and
trace counts and the failure detector's state at its first poll past
DOWN are masked (`chip_smoke.EXAMPLE_MASKS`, which phase 15 applies on
the card). Without `--device cpu` and without a card,
every port example raises instead of running on the CPU.

The quickstart's single-store GETs race the store's writeback thread in
both packages: whether they read the slabs or the persistent buffer
(its recovery count, its bill) depends on how soon the writer runs.
Both quickstart runs here wait for their writer before each GET
(`chip_smoke.drain_before_get`), as phase 15 runs both of its own."""
import importlib.util
import os
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import finish_example, start_example  # noqa: E402
from chip_smoke import masked as mask  # noqa: E402  (phase 15's masks)

STORE = ("quickstart", "async_put_get", "process_store", "networked_store")
ALL = STORE + ("serve_kv", "train_lm")


def start(name: str, port: bool):
    """examples/[torch_]<name>.py in a subprocess (the port's with
    `--device cpu`), from the repository root; the quickstart's GETs
    after its writer has drained."""
    pkg = ("repro_torch" if port else "repro") \
        if name == "quickstart" else None
    if port:
        return start_example(name, "--device", "cpu", drained=pkg)
    return start_example(name, path=ROOT / "examples" / f"{name}.py",
                         drained=pkg)


@pytest.fixture(scope="module")
def runs():
    """Every store example of both packages, one package's four at once:
    {(name, port): (stdout, pid)}."""
    pytest.importorskip("jax")
    out = {}
    for port in (False, True):
        procs = {name: start(name, port) for name in STORE}
        out.update({(name, port): (finish_example(name, p, 400)[0],
                                   p[0].pid)
                    for name, p in procs.items()})
    return out


@pytest.mark.parametrize("name", STORE)
def test_port_example_prints_the_reference_lines(runs, name):
    want, got = mask(runs[name, False][0]), mask(runs[name, True][0])
    assert got == want
    assert len(got) >= 4


@pytest.mark.parametrize("name", ["process_store", "networked_store"])
def test_process_examples_leave_no_shared_memory(runs, name):
    from repro_torch.core.ipc import SEGMENT_PREFIX
    shm = Path("/dev/shm")
    if not shm.is_dir():
        pytest.skip("no /dev/shm on this host")
    pid = runs[name, True][1]
    assert not [n for n in os.listdir(shm)
                if n.startswith(f"{SEGMENT_PREFIX}{pid}-")]


def test_masks_keep_every_other_number():
    line = ("16 keys over 4 worker processes (pids=[18237, 18240]), "
            "balance=[5, 3, 5, 3]; rpc roundtrip: n=48 p50=1116.7us; "
            "prefill 2.79s, 235 spans across 72 traces, 6 slabs")
    assert mask(line) == [
        "16 keys over 4 worker processes (pids=[*]), balance=[5, 3, 5, 3]; "
        "rpc roundtrip: n=48 p50=*us; prefill *s, * spans across * traces,"
        " 6 slabs"]


def _load(name: str):
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ALL)
def test_port_example_refuses_the_cpu_by_default(name):
    if torch.cuda.is_available():
        pytest.skip("the machine has a card: the default device is usable")
    mod = _load(name)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([])


def test_writeback_race_script_reads_the_writers_lag():
    out = finish_example("writeback race", start_example(
        "writeback race", "--device", "cpu", "--trials", "2",
        path=ROOT / "scripts" / "torch_writeback_race.py"), 300)[0]
    import json
    got = json.loads(out.strip().splitlines()[-1])
    assert got["device"] == "cpu" and got["trials"] == 2
    assert len(got["depth"]) == len(got["drain_ms"]) == 2
    assert got["behind"] == sum(d > 0 for d in got["depth"])
