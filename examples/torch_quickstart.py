"""Quickstart on the PyTorch port: the InfiniStore public API in ~100 lines.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

`examples/quickstart.py` over `repro_torch`: the same steps, sizes,
seeds, printed lines and assertions. Covers: versioned PUT/GET, erasure
coding (on the card through the GF(256) kernel), the sliding GC window,
provider reclamation + parallel recovery, pay-per-access accounting —
and the sharded multi-daemon variant (`ShardedStore`): keyspace
partitioning, all-or-nothing cross-shard batches, and one-shard
crash/restart with zero acked loss.

The stores run on `--device` (the card by default; without one they
raise, they never fall back to the CPU).
"""
import argparse
import shutil
import tempfile

import numpy as np

from repro_torch.core import Clock, InfiniStore, ShardedStore, StoreConfig
from repro_torch.core.ec import ECConfig
from repro_torch.core.gc_window import GCConfig

MB = 1024 * 1024


def single(device: str) -> None:
    clock = Clock()
    store = InfiniStore(
        StoreConfig(
            ec=ECConfig(k=4, p=2),                 # RS(4+2) erasure coding
            function_capacity=8 * MB,              # slab ("function") size
            gc=GCConfig(gc_interval=10.0,          # GC every 10s
                        active_intervals=2,        # M
                        degraded_intervals=2),     # N  (H = 40s)
            device=device,
        ),
        clock=clock,
    )
    rng = np.random.default_rng(0)

    # 1. versioned writes
    payload_v1 = rng.bytes(500_000)
    payload_v2 = rng.bytes(300_000)
    assert store.put("model/embedding", payload_v1) == 1
    assert store.put("model/embedding", payload_v2) == 2
    assert store.get("model/embedding") == payload_v2
    print(f"PUT/GET ok; {store.num_functions()} functions provisioned "
          f"(chunks spread one-per-function)")

    # 2. provider reclaims an instance -> detected + recovered on access
    victim = store.chunk_map["model/embedding|2/f0#0"]
    store.inject_failure(victim)
    assert store.get("model/embedding") == payload_v2
    print(f"survived reclamation of function {victim}: "
          f"{store.recovery.stats.local_recoveries} local / "
          f"{store.recovery.stats.parallel_recoveries} parallel recoveries")

    # 3. the sliding window ages cold data out of memory...
    for _ in range(5):
        clock.advance(10.0)
        store.gc_tick()
    print(f"after 50s idle: {store.sms.alive_count()} live instances "
          f"(cold data released to COS)")

    # ...but everything stays durable
    assert store.get("model/embedding") == payload_v2
    print("cold read via COS on-demand migration ok")

    # 4. pay-per-access accounting
    dollars = store.ledger.dollars()
    print("cost breakdown:",
          {k: f"${v:.6f}" for k, v in dollars.items()})
    print(f"durability overhead vs ideal pay-per-access: "
          f"{store.ledger.pay_per_access_overhead() * 100:.2f}% "
          f"(paper: 26.00%)")
    store.close()


def sharded(device: str) -> None:
    """The multi-daemon variant: same StoreFrontend surface, N shards."""
    spill_root = tempfile.mkdtemp(prefix="quickstart-shards-")
    store = ShardedStore(
        StoreConfig(
            ec=ECConfig(k=4, p=2),
            function_capacity=8 * MB,
            gc=GCConfig(gc_interval=1e9),
            spill_dir=spill_root,              # per-shard journals live
            device=device,                     # under shard-<i>/
        ),
        num_shards=4,
        clock=Clock(),
    )
    rng = np.random.default_rng(1)

    # 1. the router partitions the keyspace; each shard's own daemon
    #    serves its slice — same API, N client daemons
    vals = {f"user/{i}": rng.bytes(100_000) for i in range(16)}
    for key, val in vals.items():
        assert store.put(key, val) == 1
    print(f"16 keys over 4 shards, balance={store.shard_balance()}")

    # 2. a cross-shard batch commits all-or-nothing via the leader-
    #    sequenced two-round protocol: if any shard fails to prepare,
    #    no key of the batch ever becomes visible anywhere
    batch = {f"batch/{i}": rng.bytes(50_000) for i in range(8)}
    assert all(v == 1 for v in store.put_many(batch).values())
    got = store.get_many(list(batch))
    assert all(got[k] == batch[k] for k in batch)
    print(f"cross-shard put_many ok "
          f"(commit tickets issued: {store.tickets_issued()})")

    # 3. one shard crashes mid-flight -> survivors keep serving ->
    #    restart replays its journal with zero acked loss
    store.pause_writeback()                    # hold writes pre-COS
    more = {f"late/{i}": rng.bytes(80_000) for i in range(8)}
    for key, val in more.items():
        store.put(key, val)
    store.simulate_crash(shard=2)
    store.restart_shard(2)
    assert all(store.get(k) == v for k, v in {**vals, **more}.items())
    store.resume_writeback()
    assert store.flush_writeback(timeout=60.0)
    print("crashed shard 2 mid-stream, restarted: zero acked loss")
    print("aggregate stats: puts={s.puts} gets={s.gets} "
          "hit_ratio={s.hit_ratio:.2f}".format(s=store.stats))
    store.close()
    shutil.rmtree(spill_root, ignore_errors=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    single(args.device)
    print("\n--- sharded multi-daemon variant ---")
    sharded(args.device)


if __name__ == "__main__":
    main()
