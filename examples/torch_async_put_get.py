"""The async futures-based store API of the PyTorch port in 50 lines.

    PYTHONPATH=src python examples/torch_async_put_get.py [--device cpu]

`examples/async_put_get.py` over `repro_torch`: the same steps, sizes,
seeds, printed lines and assertions. Covers: non-blocking
`put_async`/`get_async` with `StoreFuture`s, request pipelining, the
background COS writeback queue + `flush` barrier, durability before
persistence completes, and zero-copy device payloads via `get_array`
(a tensor on the store's device: the card by default).
"""
import argparse

import numpy as np
import torch

from repro_torch.core import Clock, InfiniStore, StoreConfig
from repro_torch.core.ec import ECConfig
from repro_torch.core.gc_window import GCConfig

MB = 1024 * 1024


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    store = InfiniStore(StoreConfig(
        ec=ECConfig(k=4, p=2),
        function_capacity=8 * MB,
        gc=GCConfig(gc_interval=10.0),
        device=args.device,
    ), clock=Clock())
    rng = np.random.default_rng(0)

    # 1. pipeline a burst of non-blocking PUTs: each acks once its
    # chunks sit in function memory + the persistent buffer — COS
    # persistence drains in the background
    futs = {f"obj/{i}": store.put_async(f"obj/{i}", rng.bytes(200_000))
            for i in range(8)}
    versions = {k: f.result() for k, f in futs.items()}
    print(f"8 PUTs acked (versions {sorted(set(versions.values()))}); "
          f"writeback queue depth: {store.writeback.depth}")

    # 2. reads are correct immediately — even if the provider reclaims
    # an instance before the writeback queue has persisted anything
    store.inject_failure(next(iter(store.sms.slabs)))
    got = store.get_async("obj/3").result()
    assert got is not None and len(got) == 200_000
    print("read-after-ack survived an instance failure pre-persistence")

    # 3. flush() is the durability barrier (checkpoint-style)
    store.flush_writeback(timeout=30.0)
    print(f"flushed: {store.writeback.stats.persisted} writes in COS, "
          f"persistent buffer holds {store.pb.size_bytes} bytes")

    # 4. tensor payloads skip the bytes round-trip entirely: the GET is
    # a writable uint8 tensor on the store's device
    weights = torch.arange(50_000, dtype=torch.float32, device=store.device)
    store.put("weights", weights)                  # uint8 views end-to-end
    back = store.get_array("weights").view(torch.float32)
    assert torch.equal(back, weights)             # on the store's device
    print(f"device-path roundtrip ok "
          f"(array payload puts: {store.stats.array_payload_puts})")

    # 5. close() flushes the queue and releases the store's threads
    store.close()


if __name__ == "__main__":
    main()
