"""The port's per-rank analyzer against the JAX package's HLO analyzer:
the same flops for the same loops (the port's Python loops unroll in the
trace where the reference scans), the same ring model for every
collective, an indexed read charged twice its result per trip, and the
live-bytes peak, the op memo and the call replay the dry-run relies on.
Each test runs both packages where the reference has a counterpart."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.analysis import hlo as ref_hlo
from repro_torch.analysis import hlo


def _ref_flops(fn, *shapes):
    args = [jnp.ones(s) for s in shapes]
    return ref_hlo.analyze_hlo(jax.jit(fn).lower(*args).compile().as_text())


def test_loop_flops_equal_the_reference_scan():
    def scanned(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        return lax.scan(body, x, None, length=10)[0]

    def looped(x, w):
        c = x
        for _ in range(10):
            c = torch.tanh(c @ w)
        return c

    ref = _ref_flops(scanned, (128, 128), (128, 128))
    got = hlo.analyze(looped, torch.ones(128, 128), torch.ones(128, 128))
    np.testing.assert_allclose(got.flops, ref.flops, rtol=0.01)
    np.testing.assert_allclose(got.flops, 10 * 2 * 128**3, rtol=0.01)
    assert ref.while_trips == [10] and got.while_trips == []


def test_nested_loop_flops_equal_the_reference_nested_scan():
    def scanned(x, w):
        def outer(c, _):
            def inner(ci, _):
                return ci @ w, None
            ci, _ = lax.scan(inner, c, None, length=3)
            return ci, None
        return lax.scan(outer, x, None, length=4)[0]

    def looped(x, w):
        c = x
        for _ in range(4):
            for _ in range(3):
                c = c @ w
        return c

    ref = _ref_flops(scanned, (64, 64), (64, 64))
    got = hlo.analyze(looped, torch.ones(64, 64), torch.ones(64, 64))
    np.testing.assert_allclose(got.flops, ref.flops, rtol=0.01)
    np.testing.assert_allclose(got.flops, 12 * 2 * 64**3, rtol=0.01)


_REF_OPCODES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute", "collective-broadcast")


def _ref_stat(opcode, ranks, mult, pod_stride):
    group = ",".join(str(r) for r in ranks)
    line = (f"%x.1 = bf16[16,1024]{{1,0}} {opcode}(%x), "
            f"replica_groups={{{{{group}}}}}, dimensions={{0}}")
    instr = ref_hlo.Instr(name="x.1", opcode=opcode,
                          shapes=[("bf16", (16, 1024))], operands=["x"],
                          attrs="", line=line)
    return ref_hlo._collective_stat(instr, mult, pod_stride)


def test_all_gather_stat_equals_the_reference():
    want = _ref_stat("all-gather", (0, 1, 2, 3), 2.0, 256)
    got = hlo._collective_stat("all-gather", 16 * 1024 * 2, [0, 1, 2, 3],
                               2.0, 256)
    assert got == hlo.CollectiveStat(**vars(want))
    assert got.group_size == 4 and got.count == 2.0 and not got.dcn
    assert got.result_bytes == 2 * 16 * 1024 * 2
    np.testing.assert_allclose(got.ring_bytes, 2 * (16 * 1024 * 2) * 3 / 4)


@pytest.mark.parametrize("ranks", [(0, 1, 2, 3), (0, 16, 32, 48),
                                   (0, 256), (3, 259, 7, 263)])
@pytest.mark.parametrize("opcode", _REF_OPCODES)
def test_collective_stat_equals_the_reference(opcode, ranks):
    """Every opcode's ring model, within a pod and across pods (a group
    whose ranks span pod_stride = 256 is DCN)."""
    want = _ref_stat(opcode, ranks, 3.0, 256)
    got = hlo._collective_stat(opcode, 16 * 1024 * 2, list(ranks), 3.0, 256)
    assert vars(got) == vars(want)
    assert got.dcn == (max(ranks) - min(ranks) >= 256)


def test_summary_keys_are_the_reference():
    assert set(hlo.HloAnalysis().summary()) == \
        set(ref_hlo.HloAnalysis().summary())


def test_indexed_read_in_a_loop_is_charged_twice_its_result_per_trip():
    def f(x, big):
        for i in range(5):
            x = x + big[(i * 3) % 8]
        return x

    got = hlo.analyze(f, torch.ones(16), torch.ones(8, 16))
    assert got.bytes_by_op["select"] == 5 * 2 * 16 * 4
    assert got.while_trips == []


def test_views_are_free_and_updates_charge_twice_the_update():
    def f(buf, x):
        y = x.reshape(4, 4).t().unsqueeze(0)         # views: free
        buf[2:6].copy_(x[:4])                        # a window write
        return y

    got = hlo.analyze(f, torch.zeros(16), torch.ones(16))
    assert set(got.bytes_by_op) == {"slice", "copy_"}
    assert got.bytes_by_op["copy_"] == 2 * 4 * 4
    assert got.bytes_by_op["slice"] == 2 * (4 * 4) * 2


def test_peak_bytes_is_the_live_maximum():
    """Arguments (two 64 KiB matrices) plus the loop's carry, the matmul's
    result and tanh's: five matrices live at once, no more."""
    def f(x, w):
        c = x
        for _ in range(10):
            c = torch.tanh(c @ w)
        return c

    got = hlo.analyze(f, torch.ones(128, 128), torch.ones(128, 128))
    assert got.peak_bytes == 5 * 128 * 128 * 4


@pytest.mark.parametrize("shape", [(64, 64), (32, 128)])
def test_meta_memo_counts_as_the_cpu_run(shape):
    """On meta tensors an op's meta kernel runs once per signature; the
    counts equal a CPU run's op for op."""
    def f(x, w):
        c = x
        for _ in range(6):
            c = torch.softmax(c @ w, dim=-1) * 2.0
        return c.sum()

    n, m = shape
    cpu = hlo.analyze(f, torch.ones(n, m), torch.ones(m, m))
    meta = hlo.analyze(f, torch.ones(n, m, device="meta"),
                       torch.ones(m, m, device="meta"))
    assert (meta.flops, meta.bytes_accessed, meta.peak_bytes,
            meta.transcendentals, meta.bytes_by_op) == \
        (cpu.flops, cpu.bytes_accessed, cpu.peak_bytes, cpu.transcendentals,
         cpu.bytes_by_op)


def test_replayed_calls_count_as_traced_calls():
    def block(q, k):
        s = torch.softmax(q @ k.T, dim=-1)
        return (s @ k).float()

    def traced(q, k):
        return sum(block(q, k).sum() for _ in range(4))

    def replays(q, k):
        return sum(hlo.replayed(block, q, k).sum() for _ in range(4))

    args = (torch.ones(32, 16, device="meta"),
            torch.ones(24, 16, device="meta"))
    want = hlo.analyze(traced, *args)
    got = hlo.analyze(replays, *args)
    assert (got.flops, got.bytes_accessed, got.peak_bytes,
            got.bytes_by_op) == (want.flops, want.bytes_accessed,
                                 want.peak_bytes, want.bytes_by_op)
    assert got.result.shape == want.result.shape


def test_analyze_installs_the_replay_hook_for_its_trace_only():
    from repro_torch.distributed import sharding
    outer = sharding.local_call
    seen = []

    def fn(x):
        seen.append(sharding.local_call)
        return x * 2

    hlo.analyze(fn, torch.ones(4))
    assert seen == [hlo.replayed] and sharding.local_call is outer

    def fails(x):
        raise RuntimeError("inside the trace")

    with pytest.raises(RuntimeError):
        hlo.analyze(fails, torch.ones(4))
    assert sharding.local_call is outer
