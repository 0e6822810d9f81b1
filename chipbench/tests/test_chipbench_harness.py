"""The benchmark's harness on the CPU: cells resolve to their files by
name, the traffic is the same work for every seed, the yardstick's
arithmetic equals hand counts, nothing loads JAX or the JAX package,
and a run at a small size reads `correct` true, and false under each
control and each fault its cell can have."""
import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from chipbench import harness
from chipbench.drivers import serve_batches, store_reads
from chipbench.metrics import _counts, _hist

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.load_benchmark()
# with the cells held back from BENCHMARK.json, whose files stay under test
ALL = harness.with_held(BENCH)
CELLS = [w["name"] for w in ALL["workloads"]]


def test_benchmark_file_keeps_to_its_schema():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["chipbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    layers = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in layers and m["layer"].strip()
        for cell in m["workloads"]:
            e2e = layers[m["moves"]]
            assert "workloads" not in e2e or cell in e2e["workloads"]
    for thing in BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] \
            + BENCH["per_layer"]:
        assert NAME.match(thing["name"]), thing["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_to_its_files(cell):
    entry = harness.cell_entry(ALL, cell)
    assert entry["chips"] == 1
    conf = next(c for c in ALL["configs"] if c["name"] == entry["config"])
    assert (ROOT / conf["file"]).is_file()
    assert conf["file"] == f"chipbench/configs/{entry['config']}.json"
    run = harness.Run(ALL, cell, 1, 1.0, False, torch.device("cpu"))
    assert run.config["name"] == entry["config"]
    assert run.driver().__name__.endswith(run.mix["driver"])
    for kind in ("end_to_end", "per_layer"):
        for m in harness.metrics_of(ALL, cell, kind):
            assert callable(harness.metric_reader(m["name"]).read)
    # every cell reports set-up, another end-to-end metric and a layer's
    e2e = [m["name"] for m in harness.metrics_of(ALL, cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_of(ALL, cell, "per_layer")


def test_held_cells_stay_out_of_the_benchmark():
    """The held cells are whole entries beside the benchmark's, none of
    them listed in BENCHMARK.json."""
    listed = {w["name"] for w in BENCH["workloads"]}
    held = [w["name"] for w in ALL["workloads"] if w["name"] not in listed]
    assert held and len(CELLS) == len(set(CELLS))
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in ALL[kind]]
        assert len(names) == len(set(names))
    for m in ALL["end_to_end"] + ALL["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in ALL["per_layer"]:
        moves = next(e for e in ALL["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moves.get("workloads", CELLS))


def test_store_traffic_is_the_same_work_for_every_seed():
    mix = harness.load_json(harness.HERE / "traffic/ycsb-c.degraded.json")
    sizes = store_reads.object_sizes(mix)
    assert len(sizes) == 48 and sizes == store_reads.object_sizes(mix)
    assert min(sizes) >= 10 << 20 and max(sizes) <= 100 << 20
    # log-uniform quantiles: equal steps in log size
    logs = np.diff(np.log(sorted(sizes)))
    assert np.allclose(logs, math.log(10) / 48, rtol=1e-3)
    counts = store_reads.zipf_counts(mix)
    assert (np.diff(counts) <= 0).all() and counts[0] > 900
    assert abs(counts.sum() - 4800) < 48
    # zipfian: count ~ 1 / rank^0.99
    assert abs(counts[0] / counts[9] - 10 ** 0.99) < 0.1
    a, b = store_reads.request_cycle(mix, 5), store_reads.request_cycle(mix, 6)
    assert np.array_equal(a, store_reads.request_cycle(mix, 5))
    assert not np.array_equal(a, b)
    assert np.array_equal(np.sort(a), np.sort(b))
    assert np.array_equal(np.bincount(a, minlength=48), counts)
    # the window's check: every object in every cycle, and 48 more
    sample = store_reads.checked(mix, 5)
    assert sample == store_reads.checked(mix, 5) and len(sample) == 96
    assert set(a[sorted(sample)]) == set(range(48))


def test_serve_traffic_is_deterministic_per_seed():
    run = harness.Run(ALL, "serve.moe.chat", 2 ** 31 + 7, 1.0, False,
                      torch.device("cpu"))
    p = serve_batches.prompts(run, 0)
    assert p.shape == (16, 2048) and p.dtype == np.int32
    assert np.array_equal(p, serve_batches.prompts(run, 0))
    assert not np.array_equal(p, serve_batches.prompts(run, 1))
    assert p.min() >= 0 and p.max() < 151936


def test_arithmetic_equals_hand_counts():
    assert _counts.gf256_bytes(2, 10, 100) == 12 * 100 + 20
    assert _counts.rs_chunk_len(96, 10) == 10
    assert _counts.rs_chunk_len(97, 10) == 11
    assert _counts.rmsnorm_bytes(4, 8) == 4 * 8 * 2 + 4 * 8 * 2 + 8 * 2
    # B 2, H 4, K 2, hd 8, 5 positions, 3 pages: q + out, k + v, table, lens
    assert _counts.paged_attn_bytes(2, 4, 2, 8, 5, 3) == \
        2 * 64 * 2 + 2 * 2 * 5 * 2 * 8 * 2 + 2 * 3 * 4 + 2 * 4
    assert _counts.paged_attn_flops(2, 4, 8, 5) == 4 * 2 * 4 * 8 * 5
    z = {"d": 4, "H": 2, "K": 2, "hd": 2, "L": 3, "V": 10, "E": 3,
         "top_k": 2, "f": 5, "fs": 6}
    # q, k, v: 3 x 2*4*4; o: 2*4*4; router 2*4*3; experts 2 x 3 x 2*4*5;
    # shared 3 x 2*4*6; gate 2*4
    tok = 3 * 32 + 32 + 24 + 2 * 3 * 40 + 3 * 48 + 8
    assert _counts.moe_token_flops(z) == tok
    assert _counts.moe_decode_flops(z, 1, 7) == \
        3 * (tok + 4 * 2 * 2 * 7) + 2 * 4 * 10
    assert _counts.moe_prefill_flops(z, 2, 3) == \
        3 * (2 * 3 * tok + 4 * 2 * 2 * 2 * 6) + 2 * 2 * 4 * 10
    assert _counts.bound_s(3.35e12) == 1.0
    # the histogram's buckets as the program files them
    counts = [0] * 96
    counts[40] = 3
    assert _hist.quantile_us(counts, 0.5) == pytest.approx(
        math.sqrt(2 ** (39 / 4) * 2 ** (40 / 4)))
    assert _hist.quantile_us([0] * 96, 0.5) is None


def test_nothing_loads_jax_or_the_jax_package():
    code = (
        "import sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src']\n"
        "import pathlib, chipbench.harness as h, chipbench.tracing, "
        "chipbench.control\n"
        "import chipbench.drivers.store_reads, chipbench.drivers.serve_batches\n"
        "import repro_torch.core.store, repro_torch.serving, repro_torch.obs\n"
        "for p in sorted((h.HERE / 'metrics').glob('*.py')):\n"
        "    h.metric_reader(p.stem)\n"
        "print(h.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card(tmp_path):
    out = subprocess.run(
        [sys.executable, str(ROOT / "chipbench/run.py"), "--workload",
         BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"],
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""


# ---- runs at a small size on the CPU --------------------------------------

def small_store(cell):
    cfg = harness.load_json(harness.HERE / "configs/store-rs10p2-parity.json")
    cfg.update(function_capacity_bytes=8 << 20, fragment_bytes=1 << 20)
    mix = harness.load_json(
        harness.HERE / f"traffic/{harness.cell_entry(ALL, cell)['traffic']}.json")
    mix.update(objects=12, size_min_bytes=10_000, size_max_bytes=300_000,
               cycle_requests=120, warm_requests=24)
    return cfg, mix


def small_serve():
    cfg = harness.load_json(
        harness.HERE / "configs/serve-qwen1.5-moe-a2.7b.json")
    cfg.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
               num_hidden_layers=2, vocab_size=256, num_experts=4,
               num_experts_per_tok=2, moe_intermediate_size=32,
               shared_expert_intermediate_size=64)
    mix = harness.load_json(harness.HERE / "traffic/moe.chat.json")
    mix.update(batch=2, prompt_tokens=16, new_tokens=6, page_size=4,
               check_requests=2)
    return cfg, mix


def small_run(cell, seed=2 ** 31 + 11):
    """A run at a small size on the CPU; the serving window is long
    enough that a whole batch ends inside it on a loaded host."""
    serve = cell.startswith("serve")
    cfg, mix = small_serve() if serve else small_store(cell)
    return harness.Run(ALL, cell, seed, 3.0 if serve else 0.5, False,
                       torch.device("cpu"), config=cfg, mix=mix)


@contextlib.contextmanager
def patched(obj, name, make):
    """obj.name replaced by make(obj.name) (a class attribute as stored,
    so a static method stays one)."""
    real = vars(obj)[name]
    setattr(obj, name, make(real))
    try:
        yield
    finally:
        setattr(obj, name, real)


def _state_unchanged_decode(real):
    """The product returns its input rows: a decode (or encode) step that
    leaves its state as it found it."""
    def f(G, X):
        return X[:len(G)].clone()
    return f


def _answer_altered(real):
    def f(flat, as_arrays):
        out = real(flat, as_arrays)
        if as_arrays and out.numel():
            out[0] ^= 0xFF
        return out
    return staticmethod(f)


def _run_with(cell, fault, when):
    """A small run whose timed path is broken by `fault` during `when`
    ("setup" or "window")."""
    from repro_torch.core import ec
    run = small_run(cell)
    drv = run.driver()
    target = {"decode": (ec, "gf256_matmul", _state_unchanged_decode),
              "unframe": (ec.RSCodec, "_unframe_t", _answer_altered)}[fault]
    with contextlib.ExitStack() as st:
        if when == "setup":
            st.enter_context(patched(*target))
        drv.setup(run)
    drv.warm(run)
    with contextlib.ExitStack() as st:
        if when == "window":
            st.enter_context(patched(*target))
        run.t0 = time.perf_counter()
        run.t1 = run.t0 + run.seconds
        drv.window(run)
    checks = drv.check(run)
    return all(v <= lim for _, v, lim in checks), checks


@pytest.mark.parametrize("cell", ["store.ycsb-c.degraded",
                                  "store.ycsb-c.warm", "serve.moe.chat"])
def test_sound_small_run_is_correct(cell):
    res = harness.execute(small_run(cell))
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    names = {m["name"] for m in harness.metrics_of(ALL, cell, "end_to_end")}
    assert set(res["metrics"]) == names


@pytest.mark.parametrize("cell,fault,when", [
    ("store.ycsb-c.degraded", "decode", "window"),     # state unchanged
    ("store.ycsb-c.degraded", "unframe", "window"),    # answer altered
    ("store.ycsb-c.warm", "decode", "setup"),          # encode unchanged
    ("store.ycsb-c.warm", "unframe", "window"),        # answer altered
])
def test_store_faults_read_incorrect(cell, fault, when):
    ok, checks = _run_with(cell, fault, when)
    assert not ok, checks


@pytest.mark.parametrize("cell", ["store.ycsb-c.degraded",
                                  "store.ycsb-c.warm"])
def test_store_control_reads_incorrect(cell):
    """The control: RS(10+0), no redundancy, in the program's place."""
    from chipbench import control
    run = small_run(cell)
    drv = run.driver()
    with control.no_redundancy():
        drv.setup(run)
    drv.warm(run)
    run.t0 = time.perf_counter()
    run.t1 = run.t0 + run.seconds
    drv.window(run)
    checks = dict((n, v) for n, v, _ in drv.check(run))
    assert checks["parity_mismatch"] > 0
    if cell.endswith("degraded"):
        assert checks["get_mismatch"] > 0


def _serve_fault(kind):
    def make(real):
        def f(self, params, batch, cache):
            tok, cache = real(self, params, batch, cache)
            if kind == "unchanged":
                return batch["token"].reshape(-1).to(tok.dtype), cache
            return (tok + 1) % 256, cache
        return f
    return make


@pytest.mark.parametrize("kind", ["unchanged", "altered"])
def test_serve_faults_read_incorrect(kind):
    from repro_torch.serving.engine import ServeEngine
    run = small_run("serve.moe.chat")
    with patched(ServeEngine, "_decode_fn", _serve_fault(kind)):
        res = harness.execute(run)
    assert not res["correct"], res["checks"]


def test_serve_control_reads_far_above_the_program():
    """The fp8 control against the float32 program at a small size, both
    through the driver's check: the control's gap is far above the sound
    program's, and the check reads it not correct."""
    cfg, mix = small_serve()
    # wide and deep enough that fp8 operands move the logits past the
    # cell's limit at every position sampled
    cfg.update(torch_dtype="float32", vocab_size=1024, hidden_size=128,
               num_hidden_layers=4)
    mix.update(batch=4, new_tokens=64, check_requests=4)
    run = harness.Run(ALL, "serve.moe.chat", 5, 3.0, False,
                      torch.device("cpu"), config=cfg, mix=mix)
    res = harness.execute(run)
    program = res["checks"][0][1]
    assert res["correct"]
    checks = run.driver().check(run, control="fp8")
    control = checks[0][1]
    assert program < 1e-5 and control > 100 * max(program, 1e-7)
    assert not all(v <= lim for _, v, lim in checks), checks
    assert run.failed > 0


def test_digest_sees_every_byte_wherever_it_lies():
    """The store check's digest: the same bytes give the same digest at
    any alignment; one byte changed, two rows or two columns swapped, or
    the tail changed give another."""
    rng = np.random.default_rng(3)
    n = 5 * store_reads.BLOCK + 123
    w = store_reads.digest_weights(n, "cpu")
    base = torch.from_numpy(rng.integers(0, 256, n + 3, dtype=np.uint8))
    x = base[:n].clone()
    d = int(store_reads.digest(x, w))
    for off in (1, 2, 3):
        shifted = torch.empty(n + off, dtype=torch.uint8)
        shifted[off:] = x
        assert int(store_reads.digest(shifted[off:], w)) == d
    B = store_reads.BLOCK
    for change in ("byte", "rows", "cols", "tail"):
        y = x.clone()
        if change == "byte":
            y[B + 7] ^= 1
        elif change == "rows":
            y[:B], y[B:2 * B] = x[B:2 * B].clone(), x[:B].clone()
        elif change == "cols":
            v = y[:5 * B].view(5, B)
            v[:, :4], v[:, 4:8] = x[:5 * B].view(5, B)[:, 4:8].clone(), \
                x[:5 * B].view(5, B)[:, :4].clone()
        else:
            y[-1] ^= 0x80
        assert not torch.equal(y, x)
        assert int(store_reads.digest(y, w)) != d, change
    assert int(store_reads.digest(x[:100], w)) != int(
        store_reads.digest(x[1:101], w))


@pytest.mark.cuda
def test_small_store_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, mix = small_store("store.ycsb-c.degraded")
    run = harness.Run(ALL, "store.ycsb-c.degraded", 3, 0.5, True,
                      torch.device("cuda", 0), config=cfg, mix=mix)
    res = harness.execute(run)
    assert res["correct"] and res["busy_s"] > 0
