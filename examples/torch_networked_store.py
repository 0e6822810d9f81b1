"""Networked ProcessShardedStore on the PyTorch port: TCP transport,
heartbeats, epochs.

    PYTHONPATH=src python examples/torch_networked_store.py [--device cpu]

`examples/networked_store.py` over `repro_torch`: the same steps,
sizes, seeds, printed lines and assertions. Every worker's store runs
on `--device` (the card by default). The workers start from a
forkserver that re-imports this file, so the `__main__` guard is
required.

`ProcessShardedStore(transport="tcp")` swaps the shared-memory rings
for a socket control/data plane: each shard worker serves a framed RPC
protocol on a loopback port (length-prefixed header + out-of-band
payload section), and the parent keeps one connection per shard alive
with a heartbeat failure detector. Same `StoreFrontend` surface, same
2PC batch semantics — what changes is what the link can do to you:

  frames can be lost        per-RPC deadlines fail fast with
                            `ShardWorkerDied` instead of hanging
  the peer can go silent    heartbeats walk CONNECTED -> SUSPECT ->
                            DOWN on `HeartbeatConfig` timers; DOWN
                            fails every in-flight RPC and starts a
                            backoff reconnect loop
  the link can heal         each (re)connection carries a fresh
                            monotonically-increasing EPOCH; a zombie
                            worker from a prior incarnation cannot ack
                            into the new one (stale acks are counted
                            and suppressed, never delivered)

Durability is unchanged: acked writes live in the worker's spill
journal, so a worker lost mid-stream replays on restart, and the
inherited 2PC sweep (`resolve_indoubt`) settles any cross-shard batch
a partition stranded in doubt.

`HeartbeatConfig` defaults are lazy (0.5s pings, DOWN after 10s) to
stay quiet on loaded boxes; this demo runs a hot detector so the
failure story fits in seconds.

The demo also attaches an `ObsPlane` (`StoreConfig(obs=...)`): every
op is traced ACROSS the TCP frames into the worker processes, latency
histograms merge back into one `snapshot_metrics()` view, and the
SIGKILL'd worker's last spans come back as flight-recorder forensics.
See `docs/observability.md` for the site registry, the span taxonomy,
and the Prometheus export format.
"""
import argparse
import os
import shutil
import signal
import tempfile
import time

import numpy as np

from repro_torch.core import (Clock, HeartbeatConfig, ProcessShardedStore,
                              ShardWorkerDied, StoreConfig)
from repro_torch.core.ec import ECConfig
from repro_torch.core.gc_window import GCConfig
from repro_torch.obs import ObsPlane

MB = 1024 * 1024

HOT = HeartbeatConfig(interval_s=0.05, suspect_after_s=0.2,
                      dead_after_s=0.6, connect_timeout_s=2.0,
                      rpc_deadline_s=5.0, reconnect_max_attempts=60,
                      reconnect_backoff_base_s=0.05,
                      reconnect_backoff_cap_s=0.2)


def _wait(pred, timeout=15.0, what=""):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise TimeoutError(f"timed out waiting for {what}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="networked store on the port")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spill_root = tempfile.mkdtemp(prefix="networked-store-")
    store = ProcessShardedStore(
        StoreConfig(
            ec=ECConfig(k=4, p=2),
            function_capacity=8 * MB,
            gc=GCConfig(gc_interval=1e9),
            spill_dir=spill_root,
            obs=ObsPlane(name="demo"),     # tracing + histograms + flight
            device=args.device,
        ),
        num_shards=2,
        clock=Clock(),
        transport="tcp",                   # sockets instead of shm rings
        heartbeat=HOT,
    )
    rng = np.random.default_rng(0)

    # 1. the surface is identical — these puts are framed RPCs over
    #    loopback TCP, payload bytes in the frame's payload section
    vals = {f"user/{i}": rng.bytes(100_000) for i in range(8)}
    for key, val in vals.items():
        assert store.put(key, val) == 1
    health = store.shard_transport_health()
    print("shard links:", [(h["state"], f"epoch {h['epoch']}",
                            h["addr"]) for h in health])

    # 2. cross-shard batches still run 2PC, now with prepare/commit
    #    frames crossing sockets; epoch tags keep the rounds fenced
    batch = {f"batch/{i}": rng.bytes(50_000) for i in range(8)}
    assert all(v == 1 for v in store.put_many(batch).values())
    print("cross-shard put_many over TCP ok")

    # 3. a silent peer (SIGSTOP — the process is alive, the link is
    #    dead): the detector walks to DOWN, in-flight calls fail fast,
    #    and the health surface says so
    victim_pid = store.worker_pids()[0]
    os.kill(victim_pid, signal.SIGSTOP)
    _wait(lambda: store.shard_transport_health()[0]["state"]
          in ("DOWN", "RECONNECTING"),
          what="failure detection")
    print(f"worker 0 went silent -> detector state "
          f"{store.shard_transport_health()[0]['state']}")
    try:
        store.put(next(k for k in vals
                       if store.router.shard_of(k) == 0), b"x" * 1024)
    except ShardWorkerDied as e:
        print(f"RPC against a DOWN shard fails fast: shard={e.shard_id} "
              f"epoch={e.epoch} op={e.op!r}")

    # 4. the link heals on its own: SIGCONT the worker and the
    #    reconnect loop re-handshakes at a HIGHER epoch — anything the
    #    old incarnation still had buffered is fenced out
    os.kill(victim_pid, signal.SIGCONT)
    _wait(lambda: store.shard_transport_health()[0]["state"]
          == "CONNECTED"
          and store.shard_transport_health()[0]["epoch"] >= 2,
          what="reconnect")
    h0 = store.shard_transport_health()[0]
    print(f"link healed: state {h0['state']}, epoch {h0['epoch']}, "
          f"reconnects {h0['reconnects']}")
    assert all(store.get(k) == v for k, v in vals.items())
    assert all(store.get(k) == v for k, v in batch.items())
    assert store.indoubt_tickets() == []
    print("zero acked writes lost across the outage")

    # 5. real crashes work like the shm transport: SIGKILL + restart
    #    replays the journal; the new worker serves at epoch 1 of a
    #    fresh transport incarnation
    store.simulate_crash(shard=1)
    store.restart_shard(1)
    assert all(store.get(k) == v for k, v in vals.items())
    assert store.flush_writeback(timeout=120.0)
    print("SIGKILL + restart on shard 1: journal replayed, reads ok")

    # 6. one merged observability view (docs/observability.md): worker
    #    histograms sum into the frontend's, spans from both sides of
    #    the socket stitch by trace id, and the SIGKILL'd worker's last
    #    pre-kill spans came back as dead-epoch forensics
    snap = store.snapshot_metrics()
    rpc = snap["histograms"]["rpc.roundtrip_us"]
    print(f"rpc roundtrip: n={rpc['count']} p50={rpc['p50_us']}us "
          f"p99={rpc['p99_us']}us")
    traces = {s["trace_id"] for s in snap["spans"]}
    print(f"{len(snap['spans'])} spans across {len(traces)} traces, "
          f"transport totals {snap['transport']['totals']}")
    for f in snap["forensics"]:
        kinds = {r.get("kind") for r in f["records"]}
        print(f"forensics from dead {f['source']}: "
              f"{len(f['records'])} records, kinds {sorted(kinds)}")

    assert store.close() is True
    shutil.rmtree(spill_root, ignore_errors=True)


if __name__ == "__main__":                 # REQUIRED: workers respawn the
    main()                                 # interpreter and re-import this
