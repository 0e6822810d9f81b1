#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of InfiniStore on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Builds the GF(256) CUDA kernel from the sources in the checkout (nvcc,
sm_90a, into build/repro_torch/), holds it against its plain PyTorch
version on the card, then drives the single-node store's main path at
deployment size through the user's entry points — RS(10+2), 1536 MB
functions, 200 MB fragments, spill journal on: PUT of >= 2 GB of seeded
payloads made on the device (1 MB, 10 MB and 100 MB objects and one
400 MB two-fragment object; a few as host bytes), GET of everything back,
a degraded GET through parity after a slab is reclaimed, and a daemon
kill + restart whose journal replay re-encodes through the kernel. Every
phase asserts; any failure exits non-zero. Prints timing lines, one
`kernels` JSON line and, last, `{"ok": true, "device": {...}}`.

Exits non-zero with no result where CUDA is unavailable or the package
is not beside this script.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MB = 1024 * 1024
SEED = 20221
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
# 32-bit integer ALU peak: 132 SMs x 64 INT32 lanes x 1.98 GHz boost
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def event_ms(fn, reps: int, warmup: int = 2, spin: bool = True) -> float:
    """Mean device time of `fn` over `reps` runs, by CUDA events. With
    `spin`, a spin kernel queued ahead of the start event lets the host
    enqueue every run before the device reaches them, so host overhead
    between launches does not show as device time (for an `fn` that
    never waits on the stream)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if spin:
        torch.cuda._sleep(200_000_000)      # ~0.1 s of device cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def lat(seconds) -> str:
    """Median and max of per-object latencies, in ms, with the count."""
    ms = sorted(x * 1e3 for x in seconds)
    return (f"median {ms[len(ms) // 2]:.3f} ms, max {ms[-1]:.3f} ms "
            f"over {len(ms)}")


def gf_ops(m: int, k: int, L: int) -> int:
    """32-bit integer ops of the bit-sliced (m,k) x (k,L) product: per
    4-byte word and input row, 8 byte masks `((x >> b) & 0x01010101) *
    0xFF` (23 ops: bit 0 needs no shift) and one fused and-xor (LOP3) per
    output row and bit (8m ops)."""
    return k * (23 + 8 * m) * (-(-L // 4))


def bound(nbytes: int, ops: int = 0, bytes_per_s: float = HBM_BYTES_PER_S):
    """Least time in ms for work that moves `nbytes` at `bytes_per_s` and
    does `ops` int32 ops at the card's peak, and which of the two binds."""
    t_bytes = nbytes / bytes_per_s * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "operations" if t_ops > t_bytes else "bytes"


def gf_bound_ms(m: int, k: int, L: int):
    """Least time for one (m,k) x (k,L) GF(256) product on the card: each
    input byte (X and the planes) read once, each output byte written
    once, against `gf_ops`."""
    nbytes = (k + m) * L + m * k * 8 * 4
    ops = gf_ops(m, k, L)
    return (*bound(nbytes, ops), nbytes, ops)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.core import InfiniStore, StoreConfig
    from repro_torch.core.payload import to_host
    from repro_torch.kernels.rs_gf256 import kernel
    from repro_torch.kernels.rs_gf256.ops import gf256_matmul
    from repro_torch.kernels.rs_gf256.ref import (cauchy_parity_matrix,
                                                  gf256_matmul_ref)
    from repro_torch.obs import ObsPlane

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    print(card)                     # the card's name and power limit
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {kind}")

    t0 = time.perf_counter()
    lib = kernel.build()
    print(f"build: {lib.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.3f} s")

    work = ROOT / "build" / "repro_torch" / "smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rng = np.random.default_rng(SEED)

    def rand_u8(n: int) -> torch.Tensor:
        return torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev,
                             generator=gen)

    # ---- phase 1: kernel against its plain version on the card --------
    k, p = 10, 2
    L_main = -(-(100 * MB + 4) // k)           # a 100 MB object's chunk
    max_err = 0
    checks = 0
    for m in (p, k):                           # encode and decode shapes
        for L in (1, 13, 1021, 65_539, L_main):
            G = rng.integers(0, 256, (m, k), dtype=np.uint8)
            base = rand_u8(k * (L + 7)).view(k, L + 7)
            for off in (0, 1, 3):              # column-slice views
                X = base[:, off:off + L]
                got = gf256_matmul(G, X)
                want = gf256_matmul_ref(G, X)
                torch.cuda.synchronize()
                err = int((got.int() - want.int()).abs().max())
                max_err = max(max_err, err)
                assert torch.equal(got, want), (m, L, off)
                checks += 1
    print(f"phase 1 kernel vs plain: {checks} checks bit-identical "
          f"(shapes (2,10),(10,10); L in 1,13,1021,65539,{L_main}; "
          f"column offsets 0,1,3), max_abs_err {max_err}")

    # ---- phase 2: main path at deployment size -------------------------
    cfg = StoreConfig(enable_recovery=False,
                      spill_dir=str(work / "spill-main"))
    assert (cfg.ec.k, cfg.ec.p, cfg.function_capacity,
            cfg.fragment_bytes) == (10, 2, 1536 * MB, 200 * MB)
    store = InfiniStore(cfg, seed=SEED)
    objects = {}
    for i in range(100):
        objects[f"small/{i}"] = rand_u8(1 * MB)
    for i in range(30):
        objects[f"medium/{i}"] = rand_u8(10 * MB)
    for i in range(16):
        objects[f"large/{i}"] = rand_u8(100 * MB)
    objects["huge/0"] = rand_u8(400 * MB)     # two 200 MB fragments
    host = {"small/0", "small/1", "small/2", "medium/0", "large/15"}
    values = {key: (t.cpu().numpy().tobytes() if key in host else t)
              for key, t in objects.items()}
    total = sum(t.numel() for t in objects.values())
    assert total >= 2 * 1000 ** 3
    torch.cuda.synchronize()

    counts = {}
    kernel.launches = 0
    put_s = {}
    for key, val in values.items():
        t = time.perf_counter()
        assert store.put(key, val) == 1
        put_s[key] = time.perf_counter() - t
    counts["put"] = kernel.launches
    assert counts["put"] >= len(values), counts
    assert store.flush_writeback(timeout=600.0)
    large = [f"large/{i}" for i in range(15)]   # device-tensor payloads
    put_large_mbs = 100 * len(large) / sum(put_s[k] for k in large)
    print(f"phase 2 PUT: {len(values)} objects, {total / MB:.0f} MB "
          f"({total} bytes) acked; kernel launches {counts['put']}")

    kernel.launches = 0
    get_s = {}
    for key, want in objects.items():
        t = time.perf_counter()
        arr = store.get_array(key)
        torch.cuda.synchronize()
        get_s[key] = time.perf_counter() - t
        assert arr.device.type == "cuda" and torch.equal(arr, want), key
    get_bytes_s = {}
    for key in large + ["huge/0", "small/0", "medium/3"]:
        t = time.perf_counter()
        got = store.get(key)
        get_bytes_s[key] = time.perf_counter() - t
        assert got == objects[key].cpu().numpy().tobytes(), key
    counts["get"] = kernel.launches
    get_large_mbs = 100 * len(large) / sum(get_s[k] for k in large)
    get_bytes_mbs = 100 * len(large) / sum(get_bytes_s[k] for k in large)
    print(f"phase 2 GET: {len(objects)} objects read back intact "
          f"(get_array on the device, get as bytes); kernel launches "
          f"{counts['get']}")

    # ---- phase 3: degraded GET through the kernel ----------------------
    assert store.flush_writeback(timeout=600.0)
    fid = store.chunk_map["large/0|1/f0#0"]
    store.inject_failure(fid)
    inv0 = store.codec.cache_info()["inversions"]
    kernel.launches = 0
    deg_s = {}
    for key in large:
        t = time.perf_counter()
        arr = store.get_array(key)
        torch.cuda.synchronize()
        deg_s[key] = time.perf_counter() - t
        assert torch.equal(arr, objects[key]), key
    counts["degraded_get"] = kernel.launches
    info = store.codec.cache_info()
    assert info["inversions"] >= 1 and info["inversions"] > inv0, info
    assert counts["degraded_get"] >= len(large), counts
    deg_mbs = 100 * len(large) / sum(deg_s.values())
    print(f"phase 3 degraded GET: slab {fid} reclaimed, {len(large)} x "
          f"100 MB read back intact through parity; codec {info}; kernel "
          f"launches {counts['degraded_get']}")

    # journal's device-to-host copy of one 100 MB fragment (ack path),
    # and the host link's rate for the same bytes into pinned memory: the
    # yardstick of every rate whose bytes must reach the host
    frag = objects["large/0"]
    d2h_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        to_host(frag)
        d2h_ms.append((time.perf_counter() - t) * 1e3)
    pinned = torch.empty(frag.numel(), dtype=torch.uint8, pin_memory=True)
    pinned_ms = min(event_ms(lambda: pinned.copy_(frag, non_blocking=True),
                             reps=1, warmup=0) for _ in range(6))
    link_bps = frag.numel() / (pinned_ms / 1e3)
    del pinned
    assert store.close()
    del store

    # where a 100 MB PUT's ack time goes: the store's own spans
    obs = ObsPlane(name="smoke")
    st = InfiniStore(StoreConfig(spill_dir=str(work / "spill-obs"),
                                 obs=obs), seed=SEED)
    n_obs = 4
    for i in range(n_obs):
        assert st.put(f"obs/{i}", objects[f"large/{i}"]) == 1
    assert st.close()
    span_ms = {}
    for sp in obs.snapshot()["spans"]:
        if sp["dur_us"] is not None:
            span_ms[sp["site"]] = span_ms.get(sp["site"], 0.0) \
                + sp["dur_us"] / 1e3 / n_obs
    breakdown = {site: round(span_ms.get(site, 0.0), 3) for site in
                 ("daemon.put_many", "ec.encode", "journal.append",
                  "journal.sync", "wb.persist")}

    # ---- phase 4: kill and restart (journal replay) --------------------
    spill = work / "spill-crash"
    cfg2 = StoreConfig(spill_dir=str(spill))
    st = InfiniStore(cfg2, seed=SEED)
    st.pause_writeback()
    acked = {f"crash/{i}": rand_u8(n) for i, n in
             enumerate([100 * MB, 100 * MB, 10 * MB, 1 * MB, 3])}
    acked["crash/host"] = rand_u8(5 * MB).cpu().numpy().tobytes()
    for key, val in acked.items():
        assert st.put(key, val) == 1
    assert st.cos.list_keys("chunk/") == []
    spill_dir = st.simulate_crash()
    kernel.launches = 0
    t = time.perf_counter()
    st2 = InfiniStore(StoreConfig(spill_dir=spill_dir), seed=SEED)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t
    counts["replay"] = kernel.launches
    assert counts["replay"] >= 1, counts
    assert st2.stats.spill_replayed_metas == len(acked)
    for key, val in acked.items():
        want = val if isinstance(val, bytes) else val.cpu().numpy().tobytes()
        assert st2.get(key) == want, key
    assert st2.flush_writeback(timeout=600.0)
    for key, val in acked.items():
        arr = st2.get_array(key)
        want = val if isinstance(val, torch.Tensor) else torch.frombuffer(
            bytearray(val), dtype=torch.uint8).to(dev)
        assert torch.equal(arr, want), key
    assert st2.close()
    replay_mb = sum(len(v) if isinstance(v, bytes) else v.numel()
                    for v in acked.values()) / MB
    print(f"phase 4 kill/restart: {len(acked)} acked objects "
          f"({replay_mb:.1f} MB) replayed in {replay_s:.3f} s and read "
          f"back intact; kernel launches {counts['replay']}")

    # ---- phase 5: timing -----------------------------------------------
    timing = {}
    for name, m in (("encode", p), ("decode", k)):
        G = cauchy_parity_matrix(k, p) if m == p else \
            rng.integers(0, 256, (m, k), dtype=np.uint8)
        X = rand_u8(k * L_main).view(k, L_main)
        ms = event_ms(lambda: kernel.gf256_matmul_cuda(G, X), reps=20)
        # the plain version copies its tables host-to-device, which waits
        # on the stream: no spin ahead of it
        plain = event_ms(lambda: gf256_matmul_ref(G, X), reps=3, warmup=1,
                         spin=False)
        b_ms, by, nbytes, ops = gf_bound_ms(m, k, L_main)
        timing[name] = dict(m=m, k=k, L=L_main, ms=ms, plain_ms=plain,
                            bound_ms=b_ms, bound_by=by, bytes=nbytes,
                            ops=ops)
        print(f"kernel {name} (m={m}, k={k}, L={L_main}): {ms * 1e3:.1f} us"
              f" | bound {b_ms * 1e3:.1f} us by {by} ({nbytes} bytes, "
              f"{ops} int32 ops) | plain {plain * 1e3:.1f} us | "
              f"{card}")
    # end-to-end byte bounds for one 100 MB object (chunk length L_main):
    # PUT and `get` must carry the payload across the host link (the
    # journal needs host bytes before the ack; `get` returns bytes) at
    # the pinned rate measured above; PUT also encodes (kernel bound);
    # `get_array` reads k chunks and writes the object on HBM; degraded
    # `get_array` does the same plus the decode product.
    obj = 100 * MB
    chunks = k * L_main
    get_b, _ = bound(obj, bytes_per_s=link_bps)
    put_b = max(get_b, timing["encode"]["bound_ms"])
    put_by = "host link" if put_b == get_b else "encode operations"
    arr_b, _ = bound(chunks + obj)
    deg_b, deg_by = bound(chunks + obj, gf_ops(k, k, L_main))
    deg_by = "decode operations" if deg_by == "operations" else "HBM bytes"
    mbs = obj / MB

    def vs(rate_mbs, bound_ms, how):
        return (f"bound {mbs / (bound_ms / 1e3):.1f} MB/s "
                f"({bound_ms:.3f} ms per object, by {how}; "
                f"{100 * rate_mbs * bound_ms / 1e3 / mbs:.2f}% of it)")

    print(f"host link: pinned device-to-host copy of 100 MB in "
          f"{pinned_ms:.3f} ms = {link_bps / 1e9:.2f} GB/s (best of 6) | "
          f"{card}")
    print(f"PUT 100 MB objects: {put_large_mbs:.1f} MB/s; ack "
          f"{lat(put_s[k] for k in large)}; "
          f"{vs(put_large_mbs, put_b, put_by)} | {card}")
    print(f"journal device-to-host copy of a 100 MB fragment: "
          f"{min(d2h_ms):.2f} ms min, {sum(d2h_ms) / len(d2h_ms):.2f} ms "
          f"mean over {len(d2h_ms)} (pageable); pinned {pinned_ms:.3f} ms"
          f" | {card}")
    print(f"PUT 100 MB span breakdown (ms per PUT, mean of {n_obs}; "
          f"wb.persist is the writer thread, off the ack path): "
          f"{json.dumps(breakdown)} | {card}")
    print(f"GET 100 MB objects: get_array {get_large_mbs:.1f} MB/s, "
          f"{lat(get_s[k] for k in large)}, "
          f"{vs(get_large_mbs, arr_b, 'HBM bytes')}; get (bytes) "
          f"{get_bytes_mbs:.1f} MB/s, {lat(get_bytes_s[k] for k in large)}"
          f", {vs(get_bytes_mbs, get_b, 'host link')} | {card}")
    print(f"degraded GET 100 MB objects: get_array {deg_mbs:.1f} MB/s, "
          f"{lat(deg_s.values())}, {vs(deg_mbs, deg_b, deg_by)}"
          f" | {card}")
    print(f"replay: {replay_s:.3f} s for {replay_mb:.1f} MB | {card}")
    print("launches per phase: " + json.dumps(counts))
    shutil.rmtree(work, ignore_errors=True)

    enc = timing["encode"]
    print(json.dumps({"kernels": [{
        "name": "gf256_matmul_bitsliced",
        "route": "cuda",
        "source": "src/repro_torch/kernels/rs_gf256/csrc/gf256_matmul.cu",
        "replaces": "src/repro/kernels/rs_gf256/kernel.py:58",
        "launches": counts["put"] + counts["get"]
        + counts["degraded_get"] + counts["replay"],
        "max_abs_err": max_err,
        "ms": enc["ms"],
        "plain_ms": enc["plain_ms"],
        "bound_ms": enc["bound_ms"],
        "bound_by": enc["bound_by"],
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
