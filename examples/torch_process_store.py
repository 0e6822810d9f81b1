"""ProcessShardedStore on the PyTorch port: worker processes, shm IPC.

    PYTHONPATH=src python examples/torch_process_store.py [--device cpu]

`examples/process_store.py` over `repro_torch`: the same steps, sizes,
seeds, printed lines and assertions (see that file for the design:
threads vs processes, ring sizing, crash semantics). Every worker's
`InfiniStore` runs on `--device` (the card by default: the workers
encode and decode through the GF(256) kernel in their own processes).

Workers start from a forkserver that re-imports this file, so the
`if __name__ == "__main__"` guard is required; `close()` reaps every
worker and removes the rings' /dev/shm segments.
"""
import argparse
import shutil
import tempfile

import numpy as np

from repro_torch.core import (Clock, ProcessShardedStore, ShardWorkerDied,
                              StoreConfig)
from repro_torch.core.ec import ECConfig
from repro_torch.core.gc_window import GCConfig

MB = 1024 * 1024


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spill_root = tempfile.mkdtemp(prefix="process-store-")
    store = ProcessShardedStore(
        StoreConfig(
            ec=ECConfig(k=4, p=2),
            function_capacity=8 * MB,
            gc=GCConfig(gc_interval=1e9),
            spill_dir=spill_root,          # per-shard journals (durable
            device=args.device,            # ack path + crash replay)
        ),
        num_shards=4,
        clock=Clock(),
        arena_bytes=64 * MB,               # per-direction ring, per shard
    )
    rng = np.random.default_rng(0)

    # 1. same surface as ShardedStore — but each put is served by a
    #    separate worker process (one bulk memcpy into that shard's
    #    request ring; the worker snapshots out of the ring at
    #    submission, so the slot recycles immediately)
    vals = {f"user/{i}": rng.bytes(100_000) for i in range(16)}
    for key, val in vals.items():
        assert store.put(key, val) == 1
    print(f"16 keys over 4 worker processes "
          f"(pids={store.worker_pids()}), "
          f"balance={store.shard_balance()}")

    # 2. cross-shard batches keep the all-or-nothing contract: the
    #    parent sequences 2PC, prepare/commit run inside the workers,
    #    prepared tickets are journaled durable in each worker
    batch = {f"batch/{i}": rng.bytes(50_000) for i in range(8)}
    assert all(v == 1 for v in store.put_many(batch).values())
    got = store.get_many(list(batch))
    assert all(got[k] == batch[k] for k in batch)
    print("cross-process put_many ok (2PC spans worker boundaries)")

    # 3. a REAL crash: SIGKILL one worker with acked writes still
    #    pending, survivors keep serving, restart replays the journal
    store.pause_writeback()
    more = {f"late/{i}": rng.bytes(80_000) for i in range(8)}
    for key, val in more.items():
        store.put(key, val)
    store.simulate_crash(shard=2)          # kill -9, not a simulation
    try:
        victim_key = next(k for k in vals
                          if store.router.shard_of(k) == 2)
        store.get(victim_key)
    except ShardWorkerDied as e:
        print(f"dead worker fails fast: {type(e).__name__}: {e}")
    store.restart_shard(2)                 # respawn + journal replay
    assert all(store.get(k) == v for k, v in {**vals, **more}.items())
    assert store.indoubt_tickets() == []
    store.resume_writeback()
    assert store.flush_writeback(timeout=120.0)
    print("SIGKILLed worker 2 mid-stream, restarted: zero acked loss")

    # 4. aggregate stats fan in from every worker over the control pipe
    print("aggregate stats: puts={s.puts} gets={s.gets} "
          "hit_ratio={s.hit_ratio:.2f}".format(s=store.stats))
    assert store.close() is True           # joins + reaps every worker
    shutil.rmtree(spill_root, ignore_errors=True)


if __name__ == "__main__":                 # REQUIRED: workers respawn the
    main()                                 # interpreter and re-import this
