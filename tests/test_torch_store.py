"""One script run on both stores — the JAX package's InfiniStore and the
port's at device="cpu" — at the `tiny_store` geometry (RS(4+2), 4 MB
functions, 1 MB fragments) on a logical Clock: values, versions and the
deterministic StoreStats counters must match exactly. Then the
cross-package restart: a spill journal written by either store replays
in the other and serves every acked value."""
import numpy as np
import pytest
import torch

from repro.core import Clock as JClock
from repro.core import InfiniStore as JInfiniStore
from repro.core import StoreConfig as JStoreConfig
from repro.core.ec import ECConfig as JECConfig
from repro.core.gc_window import GCConfig as JGCConfig
from repro_torch.core import Clock, InfiniStore, StoreConfig
from repro_torch.core.ec import ECConfig
from repro_torch.core.gc_window import GCConfig

MB = 1024 * 1024

# Counters the script makes deterministic: the writer is flushed before
# every GET (no persistent-buffer races), keys form no sequential scan
# (no readahead), and the clock only moves when the script moves it.
COMPARED_COUNTERS = (
    "puts", "gets", "sms_chunk_hits", "sms_chunk_misses", "buffer_hits",
    "degraded_hits", "small_requests", "large_requests", "cas_rounds",
    "gather_invokes", "array_payload_puts", "cos_fallback_reads",
    "decode_batches", "migrations", "compactions")


def _tiny(cfg_cls, ec_cls, gc_cls, **kw):
    return cfg_cls(
        ec=ec_cls(k=4, p=2),
        function_capacity=4 * MB,
        fragment_bytes=1 * MB,
        gc=gc_cls(gc_interval=10.0, active_intervals=2,
                  degraded_intervals=2, active_warmup=5.0,
                  degraded_warmup=20.0),
        num_recovery_functions=4, **kw)


def ref_store(**kw):
    return JInfiniStore(_tiny(JStoreConfig, JECConfig, JGCConfig, **kw),
                        clock=JClock())


def port_store(**kw):
    return InfiniStore(_tiny(StoreConfig, ECConfig, GCConfig,
                             device="cpu", **kw), clock=Clock())


def as_bytes(v):
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        return v.numpy().tobytes()
    return np.asarray(v).tobytes()


def run_script(st, payloads):
    """The PUT/GET script; returns everything it observed."""
    seen = []
    flush = st.flush_writeback
    seen.append(("put", st.put("alpha", payloads["alpha"])))
    seen.append(("put", st.put("beta", payloads["beta"])))
    seen.append(("put_many", sorted(st.put_many(
        {"gamma": payloads["gamma"], "delta": payloads["delta"],
         "empty": b""}).items())))
    assert flush(timeout=30.0)
    seen.append(("get", st.get("alpha")))
    seen.append(("get_many", sorted(st.get_many(
        ["beta", "gamma", "missing", "empty"]).items())))
    assert flush(timeout=30.0)
    seen.append(("get_array", as_bytes(st.get_array("delta"))))
    # overwrite: versions advance, the old version's chunks are freed
    seen.append(("put", st.put("alpha", payloads["alpha2"])))
    seen.append(("put_many", sorted(st.put_many(
        [("beta", payloads["beta2"]), ("gamma", payloads["gamma"])]
    ).items())))
    assert flush(timeout=30.0)
    seen.append(("get_many", sorted(st.get_many(
        ["alpha", "beta", "gamma"]).items())))
    arrays = st.get_many_arrays(["alpha", "delta"])
    seen.append(("get_many_arrays",
                 sorted((k, as_bytes(v)) for k, v in arrays.items())))
    return seen


def make_payloads(seed=0):
    rng = np.random.default_rng(seed)
    return {"alpha": rng.bytes(200_000),
            "beta": rng.bytes(3),
            "gamma": rng.bytes(2_500_001),         # three 1 MB fragments
            "delta": rng.integers(0, 256, 777_777, dtype=np.uint8),
            "alpha2": rng.bytes(1_048_577),
            "beta2": rng.bytes(1)}


def test_script_values_versions_and_counters_match_reference():
    payloads = make_payloads()
    ref, ours = ref_store(), port_store()
    try:
        want = run_script(ref, payloads)
        got = run_script(ours, payloads)
        assert got == want
        assert dict(want[4][1])["missing"] is None
        r, o = ref.stats.as_dict(), ours.stats.as_dict()
        assert {c: o[c] for c in COMPARED_COUNTERS} == \
            {c: r[c] for c in COMPARED_COUNTERS}
        assert ours.codec.cache_info() == ref.codec.cache_info()
    finally:
        ref.close()
        ours.close()


def test_degraded_get_reads_parity_like_reference():
    """A reclaimed slab with recovery off: the GET widens to parity and
    decodes through the inverted survivor matrix (the non-identity
    GF(256) product) — same bytes and counters as the reference."""
    payloads = make_payloads(1)
    stores = [ref_store(enable_recovery=False),
              port_store(enable_recovery=False)]
    results = []
    try:
        for st in stores:
            vers = st.put_many({k: payloads[k] for k in
                                ("alpha", "gamma", "delta")})
            # drain the persistent buffer, else the GET is served from it
            # and no decode runs
            assert st.flush_writeback(timeout=30.0)
            fid = st.chunk_map["gamma|1/f0#0"]
            st.inject_failure(fid)
            vals = st.get_many(["alpha", "gamma", "delta"])
            arr = as_bytes(st.get_array("gamma"))
            results.append((sorted(vers.items()), sorted(vals.items()), arr,
                            fid, st.codec.cache_info(),
                            {c: st.stats.as_dict()[c]
                             for c in COMPARED_COUNTERS}))
        want, got = results
        assert got == want
        assert want[1] == sorted((k, as_bytes(payloads[k]))
                                 for k in ("alpha", "delta", "gamma"))
        assert want[4]["inversions"] >= 1
    finally:
        for st in stores:
            st.close()


def put_acked_unpersisted(st, n=4, nbytes=150_000, seed=0):
    """Acked writes held pre-persistence (tests/test_spill.py): pause the
    writer, PUT, and check that COS holds nothing."""
    st.pause_writeback()
    rng = np.random.default_rng(seed)
    objs = {f"obj{i}": rng.bytes(nbytes + i) for i in range(n)}
    objs["big"] = rng.bytes(int(2.5 * MB))     # multi-fragment record
    for k, v in objs.items():
        assert st.put(k, v) == 1
    assert st.cos.list_keys("chunk/") == []
    return objs


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_journal_replays_across_packages(tmp_path, direction):
    """A daemon killed between ack and COS persistence: the other
    package's store opens its spill_dir and serves every acked value,
    then persists it all."""
    spill = str(tmp_path / "spill")
    first, second = (ref_store, port_store) \
        if direction == "reference_to_port" else (port_store, ref_store)
    st = first(spill_dir=spill)
    objs = put_acked_unpersisted(st)
    spill_dir = st.simulate_crash()
    st2 = second(spill_dir=spill_dir)
    try:
        assert st2.stats.spill_replayed_metas == len(objs)
        assert st2.stats.spill_replayed_writes > 0
        for k, v in objs.items():
            assert st2.get(k) == v, f"lost {k} across the restart"
        assert st2.flush_writeback(timeout=30.0)
        assert len(st2.cos.list_keys("chunk/")) == \
            sum(st2.mt.load(k).num_fragments for k in objs) * 6
        for k, v in objs.items():
            assert st2.get(k) == v
    finally:
        st2.close()


def test_tensor_and_array_payloads_roundtrip_as_tensors():
    """The port's side of tests/test_async_api.py's array-payload tests:
    numpy arrays and tensors of any dtype go in; array GETs return flat
    uint8 tensors on the store's device, 16-byte aligned so they view
    back as the original dtype — from the persistent buffer, the slabs,
    and (every slab reclaimed, recovery off) COS."""
    st = port_store(enable_recovery=False)
    f32 = np.arange(40_000, dtype=np.float32)
    f64 = torch.arange(30_001, dtype=torch.float64)
    bf16 = torch.arange(4096, dtype=torch.float32).to(torch.bfloat16)
    big = torch.randint(0, 256, (2_300_000,), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(0))
    try:
        st.pause_writeback()                     # first reads: the buffer
        vers = st.put_many({"f32": f32, "f64": f64, "bf16": bf16,
                            "big": big})
        assert vers == {"f32": 1, "f64": 1, "bf16": 1, "big": 1}
        assert st.stats.array_payload_puts == 4

        def check():
            got = st.get_many_arrays(["f32", "f64", "bf16", "big"])
            for v in got.values():
                assert v.dtype == torch.uint8 and v.dim() == 1
                assert v.device == st.device
            assert torch.equal(got["f32"].view(torch.float32),
                               torch.from_numpy(f32))
            assert torch.equal(got["f64"].view(torch.float64), f64)
            assert torch.equal(got["bf16"].view(torch.bfloat16), bf16)
            assert torch.equal(got["big"], big)
            assert st.get("f32") == f32.tobytes()
            assert st.get("bf16") == bf16.view(torch.uint8).numpy().tobytes()

        check()
        st.resume_writeback()
        assert st.flush_writeback(timeout=30.0)
        check()                                  # slab reads + decode
        for fid in list(st.sms.slabs):
            st.inject_failure(fid)
        before = st.stats.cos_fallback_reads
        check()                                  # every chunk from COS
        assert st.stats.cos_fallback_reads > before
    finally:
        st.close()


def test_array_gets_are_private_copies():
    """torch has no read-only tensors, so an array GET never aliases the
    store's bytes: writing into a result leaves the stored object
    intact, whether the GET was served from the persistent buffer or
    decoded in ready-order batches."""
    st = port_store(decode_batch_fragments=2)
    rng = np.random.default_rng(1)
    objs = {f"k{i}": rng.bytes(120_000) for i in range(7)}
    try:
        st.pause_writeback()
        st.put_many(objs)
        first = st.get_many_arrays(list(objs))   # persistent-buffer hits
        assert st.stats.buffer_hits == len(objs)
        for v in first.values():
            v.fill_(0)
        st.resume_writeback()
        assert st.flush_writeback(timeout=30.0)
        before = st.stats.decode_batches
        got = st.get_many_arrays(list(objs))
        # 7 fragments, batch size 2 -> at least 4 ready-order decodes
        assert st.stats.decode_batches - before >= 4
        for k, v in objs.items():
            assert got[k].numpy().tobytes() == v
            got[k].fill_(1)
        assert st.get_many(list(objs)) == objs
    finally:
        st.close()
