"""The port's own lint gate and lock hierarchy: `repro_torch.devtools.lint`
over `src/repro_torch` with the port's baseline reports no new finding
and exits 0, the port's lock hierarchy holds its frontends' lock edges,
the witness takes its static order from the port's tree, and the
``ISTORE_LOCK_WITNESS`` environment hook installs that witness."""
import json
import os
import subprocess
import sys
from pathlib import Path

from repro_torch.devtools import lint, lockgraph
from repro_torch.devtools.scan import scan_tree
from repro_torch.devtools.witness import load_static_order

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "src" / "repro_torch"

# lock edges the port's frontends must keep (the JAX package's
# hierarchy has the same ones under the same names)
FRONTEND_EDGES = (
    ("host._ShardProxy._order_lock", "host._ShardProxy._state_lock"),
    ("transport.TcpTransport._conn_lock", "transport.TcpTransport._lock"),
)


def test_port_tree_lints_clean_against_its_baseline():
    new, tm = lint.run([str(SRC)], root=REPO)
    assert new == [], "\n".join(f.render() for f in new)
    assert len(tm.locks) >= 25
    # the port's manifests are the ones the rules read
    paths = {mm.relpath for mm in tm.modules.values()
             if mm.fault_manifest or mm.metric_manifest}
    assert paths == {"src/repro_torch/core/faults.py",
                     "src/repro_torch/obs/sites.py"}


def test_port_baseline_starts_empty():
    data = json.loads((SRC / "devtools" / "baseline.json").read_text())
    assert data["findings"] == []


def test_lint_main_exits_zero_over_the_port(capsys):
    assert lint.main([str(SRC)]) == 0
    err = capsys.readouterr().err
    assert "0 new finding(s)" in err


def test_default_target_is_the_port():
    cwd = os.getcwd()
    try:
        os.chdir(REPO)
        assert lint.main(["-q"]) == 0
    finally:
        os.chdir(cwd)


def test_port_hierarchy_holds_frontend_edges(tmp_path):
    out = tmp_path / "lock_hierarchy.md"
    assert lint.main([str(SRC), "--emit-hierarchy", str(out), "-q"]) == 0
    doc = out.read_text()
    tm = scan_tree([str(SRC)], root=REPO)
    edges, _ = lockgraph.build_edges(tm)
    for a, b in FRONTEND_EDGES:
        assert (a, b) in edges
        assert f"`{a}` -> `{b}`" in doc
    assert "`src/repro_torch`" in doc
    cycle, _ = lockgraph.check(tm)
    assert not [f for f in cycle if "cycle" in f.detail]
    # the JAX package's generated hierarchy is left as it is
    assert "`src/repro`." in (REPO / "docs" / "lock_hierarchy.md").read_text()


def test_witness_static_order_is_the_ports():
    order = load_static_order()
    for a, b in FRONTEND_EDGES:
        assert b in order[a]
    assert order == lockgraph.static_order([str(SRC)], root=SRC.parent)


def test_env_hook_installs_the_ports_witness():
    code = ("from repro_torch.core import locks; "
            "l = locks.make_lock('host._ShardProxy._order_lock'); "
            "w = locks.current_witness(); "
            "print(type(w).__module__, type(l).__name__)")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               ISTORE_LOCK_WITNESS="1")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["repro_torch.devtools.witness",
                                  "_WitnessedLock"]
