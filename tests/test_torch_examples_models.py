"""The port's serving and training examples against the JAX package's,
each at its defaults with `--device cpu`: `torch_serve_kv.py` prints the
reference's KV page counts (`KVStats` after generation and after idle
aging) and restores as many pages of seq0, over a token array of the
same shape (the weights come from each package's own generator, so the
tokens differ); `torch_train_lm.py` trains its 200 steps, restores from
the reference's step, reclaims as many slabs and recovers them as the
reference does, its own assertions holding. The port runs with two
intra-op threads (its step is many small ops; more threads contend with
the other test workers); all four runs at the lowest CPU priority, so
that the timing tests of the other test workers keep their cores."""
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import finish_example, kv_lines, start_example  # noqa: E402
from chip_smoke import train_facts  # noqa: E402  (phase 15's)


@pytest.fixture(scope="module")
def runs():
    """Both examples of both packages at their defaults, all at once:
    {(name, port): stdout}."""
    pytest.importorskip("jax")
    procs = {(name, port): start_example(name, "--device", "cpu", threads=2,
                                         low=True)
             if port else start_example(
                 name, path=ROOT / "examples" / f"{name}.py", low=True)
             for name in ("serve_kv", "train_lm") for port in (False, True)}
    return {key: finish_example(key[0], p, 900)[0]
            for key, p in procs.items()}


def _tokens_shape(out: str) -> tuple:
    text = out.split("generated token ids:")[1].split("kv pages:")[0]
    rows = re.findall(r"\[([\d\s]+)\]", text)
    return len(rows), {len(r.split()) for r in rows}


def test_serve_kv_pages_equal_the_reference(runs):
    ref, port = runs["serve_kv", False], runs["serve_kv", True]
    assert kv_lines(port) == kv_lines(ref)
    assert len(kv_lines(port)) == 3
    assert _tokens_shape(port) == _tokens_shape(ref) == (4, {12})
    serve = [line for line in port.splitlines() if line.startswith("serve:")]
    assert serve and serve[0].startswith("serve: 48 tokens")


def test_train_lm_restores_and_recovers_as_the_reference(runs):
    ref, port = runs["train_lm", False], runs["train_lm", True]
    assert train_facts(port) == train_facts(ref)
    assert train_facts(port)["restored"] == "100" and train_facts(port)["ok"]
    phase1 = re.compile(r"phase 1: training (\d+) steps \((.*)\)")
    assert phase1.search(port).groups() == phase1.search(ref).groups() \
        == ("100", "qwen1.5-0.5b-reduced, 8x64")
