"""The port's scale-out frontends held to the JAX package's `ShardedStore`
on the CPU: one seeded script (single-shard PUTs, cross-shard
`put_many` through the 2PC, overwrites, GETs, `get_many_arrays`) gives
the same versions, values, shard balance and commit tickets through
either package, whether the port's shards are threads or worker
processes; a sharded spill directory left by one package with a ticket
stranded before the leader's decision (roll back) or after it (roll
forward) is restarted by the other package's `ShardedStore` and
resolved the same way, with the same bytes."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import Clock as JClock
from repro.core import FaultPlan as JFaultPlan
from repro.core import FaultPoint as JFaultPoint
from repro.core import ProcessShardedStore as JProcessShardedStore
from repro.core import ShardedStore as JShardedStore
from repro.core import StoreConfig as JStoreConfig
from repro.core.ec import ECConfig as JECConfig
from repro.core.gc_window import GCConfig as JGCConfig
from repro.core.shard import HashRouter as JHashRouter
from repro.core.shard import RangeRouter as JRangeRouter
from repro_torch.core import (Clock, FaultPlan, FaultPoint,
                              ProcessShardedStore, ShardedStore,
                              StoreConfig)
from repro_torch.core.ec import ECConfig
from repro_torch.core.gc_window import GCConfig
from repro_torch.core.shard import HashRouter, RangeRouter

MB = 1024 * 1024
NUM_SHARDS = 3

# counters the script makes deterministic (writers flushed before every
# GET, no sequential scan, the clock only moves when the script moves it)
COMPARED_COUNTERS = ("puts", "gets", "cas_rounds", "commit_tickets",
                     "array_payload_puts", "buffer_hits",
                     "sms_chunk_hits", "small_requests",
                     "large_requests")


def _cfg(cls, ec_cls, gc_cls, **kw):
    return cls(ec=ec_cls(k=4, p=2), function_capacity=8 * MB,
               fragment_bytes=1 * MB, gc=gc_cls(gc_interval=1e9),
               num_recovery_functions=4, **kw)


def ref_process(transport):
    def build():
        return JProcessShardedStore(
            _cfg(JStoreConfig, JECConfig, JGCConfig),
            num_shards=NUM_SHARDS, clock=JClock(), seed=0,
            transport=transport)
    return build


def ref_sharded(spill_dir=None, cos_root=None, faults=None):
    return JShardedStore(
        _cfg(JStoreConfig, JECConfig, JGCConfig, spill_dir=spill_dir,
             faults=faults),
        num_shards=NUM_SHARDS, clock=JClock(), cos_root=cos_root, seed=0)


def port_sharded(spill_dir=None, cos_root=None, faults=None):
    return ShardedStore(
        _cfg(StoreConfig, ECConfig, GCConfig, spill_dir=spill_dir,
             faults=faults, device="cpu"),
        num_shards=NUM_SHARDS, clock=Clock(), cos_root=cos_root, seed=0)


def port_process(transport):
    def build(spill_dir=None, cos_root=None, faults=None):
        return ProcessShardedStore(
            _cfg(StoreConfig, ECConfig, GCConfig, spill_dir=spill_dir,
                 faults=faults, device="cpu"),
            num_shards=NUM_SHARDS, clock=Clock(), cos_root=cos_root,
            seed=0, transport=transport)
    return build


def as_bytes(v):
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        return v.cpu().numpy().tobytes()
    return np.asarray(v).tobytes()


def keys_on_every_shard(router, n_per_shard, tag):
    """Keys with `n_per_shard` on every shard of `router` (so a batch of
    them takes the cross-shard path)."""
    per = [0] * router.num_shards
    out, i = [], 0
    while min(per) < n_per_shard:
        k = f"{tag}{i}"
        i += 1
        sid = router.shard_of(k)
        if per[sid] < n_per_shard:
            per[sid] += 1
            out.append(k)
    return out


def make_payloads(seed):
    rng = np.random.default_rng(seed)
    router = HashRouter(NUM_SHARDS)
    batch = keys_on_every_shard(router, 2, "x")
    return {
        "single": {f"s{i}": rng.bytes(int(rng.integers(1, 300_000)))
                   for i in range(8)},
        "big": rng.bytes(2_500_001),                  # three fragments
        "array": rng.integers(0, 256, 777_777, dtype=np.uint8),
        "batch": {k: rng.bytes(12_000 + 7 * j)
                  for j, k in enumerate(batch)},
        "batch2": {k: rng.bytes(9_000 + j) for j, k in enumerate(batch)},
        "one_shard": {k: rng.bytes(5_000) for k in
                      [k for k in (f"o{i}" for i in range(64))
                       if router.shard_of(k) == 1][:3]},
    }


def run_script(st, p):
    seen = []
    flush = st.flush_writeback
    for k, v in p["single"].items():
        seen.append(("put", k, st.put(k, v)))
    seen.append(("put", "big", st.put("big", p["big"])))
    seen.append(("put", "array", st.put("array", p["array"])))
    seen.append(("put_many", sorted(st.put_many(p["batch"]).items())))
    seen.append(("put_many_one_shard",
                 sorted(st.put_many(p["one_shard"]).items())))
    assert flush(timeout=60.0)
    seen.append(("get_many", sorted(st.get_many(
        list(p["single"]) + ["big", "missing"]).items())))
    # overwrites: a single key, then the cross-shard batch again
    seen.append(("put", "s0", st.put("s0", p["batch2"][next(iter(
        p["batch2"]))])))
    seen.append(("put_many", sorted(st.put_many(p["batch2"]).items())))
    assert flush(timeout=60.0)
    seen.append(("get", st.get("s0")))
    seen.append(("get_many", sorted(st.get_many(list(p["batch2"])).items())))
    arrays = st.get_many_arrays(["array", "big", "missing"])
    seen.append(("get_many_arrays",
                 sorted((k, as_bytes(v)) for k, v in arrays.items())))
    seen.append(("get_array", as_bytes(st.get_array("x0"))))
    seen.append(("balance", st.shard_balance()))
    seen.append(("tickets", st.tickets_issued()))
    return seen


FRONTENDS = {"sharded": (ref_sharded, port_sharded),
             "process-shm": (ref_process("shm"), port_process("shm")),
             "process-tcp": (ref_process("tcp"), port_process("tcp"))}


@pytest.mark.parametrize("frontend", sorted(FRONTENDS))
def test_script_matches_reference_frontend(frontend):
    """The same frontend of each package: threads, or worker processes
    over shm rings or TCP."""
    payloads = make_payloads(7)
    build_ref, build_port = FRONTENDS[frontend]
    ref, ours = build_ref(), build_port()
    try:
        want = run_script(ref, payloads)
        got = run_script(ours, payloads)
        assert got == want
        # the cross-shard batches really took the 2PC, twice
        assert dict(want[-1:])["tickets"] == 2
        r, o = ref.stats.as_dict(), ours.stats.as_dict()
        assert {c: o[c] for c in COMPARED_COUNTERS} == \
            {c: r[c] for c in COMPARED_COUNTERS}
        assert o["commit_tickets"] == 2 * NUM_SHARDS
        assert ours.indoubt_tickets() == ref.indoubt_tickets() == []
    finally:
        ref.close()
        ours.close()


def test_routers_place_keys_like_reference():
    keys = [f"key-{i}" for i in range(500)] + ["", "é", "a" * 300]
    for n in (1, 2, 3, 4, 7):
        assert [HashRouter(n).shard_of(k) for k in keys] == \
            [JHashRouter(n).shard_of(k) for k in keys]
    bounds = ["g", "key-3", "p"]
    assert [RangeRouter(bounds).shard_of(k) for k in keys] == \
        [JRangeRouter(bounds).shard_of(k) for k in keys]
    assert RangeRouter(bounds).snapshot() == JRangeRouter(bounds).snapshot()


# ---------------------------------------------------------------------------
# a stranded 2PC ticket, restarted by the other package
# ---------------------------------------------------------------------------

PACKAGES = {"reference": (ref_sharded, JFaultPlan, JFaultPoint),
            "port": (port_sharded, FaultPlan, FaultPoint)}


def strand_after_decision(build, plan_cls, point_cls, spill, cosr, rng):
    """The leader's decision is durable, then one shard's commit
    submission is lost (`shard.commit_submit`): that shard holds the
    batch in doubt. Returns (old values, new values)."""
    plan = plan_cls(seed=11).add(point_cls(
        site="shard.commit_submit", action="transient",
        hits=(NUM_SHARDS + 2,)))        # the second batch's second shard
    st = build(spill_dir=spill, cos_root=cosr, faults=plan)
    keys = keys_on_every_shard(st.router, 2, "f")
    old = {k: rng.bytes(11_000 + i) for i, k in enumerate(keys)}
    assert all(v == 1 for v in st.put_many(old).values())
    new = {k: rng.bytes(13_000 + i) for i, k in enumerate(keys)}
    with pytest.raises(Exception, match="injected"):
        st.put_many(new)
    assert len(st.indoubt_tickets()) == 1
    assert st._decisions                  # the decision is durable
    st.simulate_crash()
    return old, new


def strand_before_decision(build, plan_cls, point_cls, spill, cosr, rng):
    """Every shard prepared the batch under a ticket and the leader died
    before its decision (`shard.decision`): no decision record exists.
    Returns (old values, new values)."""
    st = build(spill_dir=spill, cos_root=cosr)
    keys = keys_on_every_shard(st.router, 2, "b")
    old = {k: rng.bytes(11_000 + i) for i, k in enumerate(keys)}
    assert all(v == 1 for v in st.put_many(old).values())
    new = {k: rng.bytes(13_000 + i) for i, k in enumerate(keys)}
    ticket = 700
    for sid in range(st.num_shards):
        sub = [(k, new[k]) for k in keys if st.router.shard_of(k) == sid]
        assert st.shards[sid].prepare_put_many_async(
            sub, ticket=ticket).result() is not None
    assert st.indoubt_tickets() == [ticket]
    assert not st._decisions
    st.simulate_crash()
    return old, new


@pytest.mark.parametrize("outcome", ["roll_forward", "roll_back"])
@pytest.mark.parametrize("first,second", [("reference", "port"),
                                          ("port", "reference")])
def test_stranded_ticket_resolves_across_packages(tmp_path, first, second,
                                                  outcome):
    spill, cosr = str(tmp_path / "spill"), str(tmp_path / "cos")
    strand = strand_after_decision if outcome == "roll_forward" \
        else strand_before_decision
    old, new = strand(*PACKAGES[first], spill, cosr,
                      np.random.default_rng(5))
    st2 = PACKAGES[second][0](spill_dir=spill, cos_root=cosr)
    try:
        assert st2.indoubt_tickets() == []
        want = new if outcome == "roll_forward" else old
        for k, v in want.items():
            got = st2.get(k)
            assert got == v, f"{k}: {outcome} did not hold"
        arrays = st2.get_many_arrays(list(want))
        assert {k: as_bytes(v) for k, v in arrays.items()} == want
        # no PENDING head is left: the keys take new writes
        assert all(v >= 2 for v in st2.put_many(
            {k: b"w" * 9_000 for k in want}).values())
        assert st2.flush_writeback(timeout=60.0)
    finally:
        st2.close()


def test_kv_cache_pages_round_trip_through_sharded_store():
    """The paged KV cache's store tier over the port's `ShardedStore`
    (the port's version of tests/test_shard.py's KV test, whose body
    writes the pools with jax.numpy)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.serving.kv_cache import SMSPagedKV
    cfg = dataclasses.replace(reduced(get_config("qwen1.5-0.5b")),
                              dtype="float32")
    st = port_sharded()
    try:
        kv = SMSPagedKV(cfg, batch_slots=2, max_len=128, page_size=32,
                        store=st, device="cpu")
        phys = kv.alloc_page(0, "seq-a", 0)
        kv.k_pool[:, 0, phys] = 1.0
        key = kv._key("seq-a", 0)
        kv.evict_page_to_cos(key)
        assert kv.stats.pages_evicted_to_cos == 1
        assert st.stats.puts == 1                  # rode the store path
        kv.restore_pages(0, "seq-a", [0])
        assert kv.stats.pages_restored == 1
        assert bool((kv.k_pool[:, 0, kv.pages[key][2]] == 1.0).all())
    finally:
        st.close()


# ---------------------------------------------------------------------------
# shared-memory rings: a message never waits on its own unsent bytes
# ---------------------------------------------------------------------------

def _within(seconds, fn):
    """Run `fn` on a thread; fail (instead of hanging) past `seconds`."""
    import threading
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:                    # noqa: BLE001
            out["error"] = e
    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(seconds)
    assert not th.is_alive(), "blocked on the ring"
    if "error" in out:
        raise out["error"]
    return out.get("value")


def test_ring_smaller_than_a_message_goes_inline():
    """A ring of 1 MB: a one-shard batch of 4 x 400 KB (more than the
    ring, staged before the frame is sent), a 700 KB object whose slot
    would need a wrap pad larger than the free ring, and a batched GET
    reply of the 4 x 400 KB. The JAX package's ring would wait forever
    on each; the port sends what does not fit inline."""
    from repro_torch.core.ipc import ShmArena, pack_payload
    ring = ShmArena.create(1 * MB, tag="t")
    try:
        ring.alloc(400_000)
        ring.release_to(ring.head)                   # empty, offset 400 KB
        assert not ring.fits(700_000, ring.head)     # pad 624 KB + 700 KB
        assert pack_payload(ring, b"\0" * 700_000)[0] == "i"
        assert ring.fits(600_000, ring.head)
    finally:
        ring.close()
    st = ProcessShardedStore(
        _cfg(StoreConfig, ECConfig, GCConfig, device="cpu"),
        num_shards=2, clock=Clock(), seed=0, arena_bytes=1 * MB)
    try:
        rng = np.random.default_rng(3)
        keys = [k for k in (f"r{i}" for i in range(64))
                if st.router.shard_of(k) == 0][:4]
        batch = {k: rng.bytes(400_000) for k in keys}
        assert _within(60, lambda: st.put_many(batch)) == \
            dict.fromkeys(keys, 1)
        big = rng.bytes(700_000)
        assert _within(60, lambda: st.put(keys[0], big)) == 2
        arrays = _within(60, lambda: st.get_many_arrays(keys))
        assert {k: as_bytes(v) for k, v in arrays.items()} == \
            {**batch, keys[0]: big}
    finally:
        st.close()
