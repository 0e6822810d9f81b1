#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of InfiniStore on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Builds the port's four CUDA kernels from the sources in the checkout
(one nvcc per source, all started together; sm_90a, into
build/repro_torch/) and drives its paths through the user's entry
points:

- the store (phases 1-5): the GF(256) kernel against its plain PyTorch
  version (random, Cauchy and the store's real decode matrices, column
  offsets 0-15), then the single-node store at deployment size — RS(10+2),
  1536 MB functions, 200 MB fragments, spill journal on: PUT of >= 2 GB
  of seeded payloads made on the device (1 MB, 10 MB and 100 MB objects
  and one 400 MB two-fragment object; a few as host bytes), GET of
  everything back, a degraded GET through parity after a slab is
  reclaimed, and a daemon kill + restart whose journal replay
  re-encodes through the kernel; then the kernel timed on the store's
  operands (phase 5: encode and the real decode matrices at a 100 MB
  object's chunk, a dense matrix on two layouts, the small products);
- serving (phases 6-8): the RMSNorm and paged decode-attention kernels
  against their plain versions; Qwen3-1.7B at its published widths in
  bf16 (weights from a seed) served by `ServeEngine` over the SMS-paged
  KV cache, 16 sequences of 2048 prompt tokens, 64 new tokens each, with
  the kernels' launch counts asserted; the kernel path held to the plain
  contiguous-cache path (f32 tokens identical, bf16 teacher-forced
  logits); and seq0's KV pages evicted through the store (RS-encoded by
  the GF(256) kernel) and restored bit for bit, decoding on to the same
  tokens as a run that never evicted;
- the GF(256) A/B entry point (phase 9): `gf256_matmul(...,
  backend="ladder")`, the xtime-ladder kernel, bit-identical to its plain
  version and to the codec's kernel over the reference's sweep, offset
  views, rows on the codec's 16-byte pitch and the timed operands, then
  timed on the 100 MB encode and a dense (10,10) product with rows back
  to back, the encode on the 16-byte pitch and the reference's A/B
  operand (RS(10+2) at L 104,858), beside its byte bound, a device copy
  of the same bytes and the codec's kernel;
- training (phase 10): the RMSNorm kernel's gradients against the plain
  version's; Qwen1.5-0.5B at its published widths and full depth trained
  by `train()` (8 x 1024 tokens a step in 2 microbatches, bf16 weights,
  f32 AdamW state), every parameter checked to have moved; then 2 steps
  with a checkpoint of the 6,495,827,972-byte train state through
  `make_store_for_checkpoints()` (RS(4+2) on the card), every other slab
  reclaimed, and `train(..., resume=True)` continuing to the straight
  run's losses from a bit-identical restored state;
- the scale-out frontends (phase 11), each on the store's default
  configuration: `ShardedStore` with 4 shards in this process (phase 2's
  mix read back bit for bit, a cross-shard `put_many` of 8 x 100 MB, its
  2PC rolled back by a crash before the leader's decision and forward
  by `restart_shard` + `resolve_indoubt` after a lost commit, and a
  degraded GET through parity), `ProcessShardedStore` with 4 worker
  processes over shared-memory rings (each worker on the card; the same
  mix and 2PC checks; one worker SIGKILLed and its journal replayed on
  the card by `restart_shard`) and with 2 workers over TCP;
- the MoE, RWKV6 and RG-LRU families (phase 12), each at published
  widths and full depth, bf16 weights from a seed:
  (a) Qwen1.5-MoE-A2.7B (14,315,784,192 parameters) served by
  `ServeEngine` over the SMS-paged KV cache, 16 x 2048-token prompts and
  32 greedy tokens at the published capacity factor 1.25 (capacity 172
  per expert and sequence), with 24 paged-attention and 49 RMSNorm
  launches asserted per decode step and the prefill's dropped (token,
  expert) pairs printed; the kernel path held to the plain contiguous
  path in bf16 (teacher-forced logits within 3e-2), the MoE FFN of one
  full-width layer held to `moe_ffn_dense` at drop-free capacity in f32
  (1e-4) and to itself (two runs bit-identical), and f32 tokens equal to
  the plain path at full width with 4 of the 24 layers (cut: 57 GB of
  f32 weights do not fit beside the bf16 model); paged attention timed
  at this shape (H = K = 16, a head group of 1);
  (b) RWKV6-3B: 8 x 2048 tokens prefilled through `wkv_chunked`, 32
  greedy steps through `wkv_scan`; the post-prefill state saved through
  `Checkpointer` on `StoreConfig(enable_recovery=False)`, the slab
  holding chunk #0 of its `wkv` leaf reclaimed, and the state restored
  through the RS decode bit-identical, decoding on to the uninterrupted
  run's tokens; chunked vs scan on layer 0's real inputs (2e-3) and f32
  decode vs teacher forcing (B 2, S 256; 5e-4);
  (c) RecurrentGemma-2B: 8 x 3000 tokens (past the 2048-token window,
  not a multiple of it), then 32 greedy steps over the wrapped ring; the
  torch scan against the sequential recurrence on the first block's
  real inputs (1e-5), f32 decode vs teacher forcing across the wrap (B
  2, S 2100, 4 steps; 5e-4), RMSNorm at d = 2560 against its plain
  version and timed.
  Each model prints prefill tokens/s beside its matrix-product flop
  bound at 989 TFLOP/s and the decode step's median and max beside the
  bytes a step reads at 3.35 TB/s;
- logical-axis sharding, the mesh and int8 gradient compression (phase
  13): (a) `build_cell`'s cells on a 1 x 1 `DeviceMesh` over the card
  (an NCCL world of one), bf16 at published widths and full depth, their
  arguments materialised from the cells' meta specs and `place`d as
  DTensors by their input shardings: Qwen1.5-0.5B's train step (8 x 1024
  tokens, `TRAIN_MICROBATCHES`' one microbatch, 3 steps), Qwen3-1.7B's
  prefill (16 x 2048) and its decode (16 sequences at seq_len 2112, pages
  of 256, 64 greedy steps, 28 paged-attention and 113 RMSNorm launches a
  step asserted), each held to the unsharded path (`make_train_step`,
  `model.prefill`, `model.decode_step`) run twice on the same inputs:
  losses, params and logits within the difference the two unsharded runs
  show, decode tokens equal; the paged kernel timed at pages of 256; (b)
  the compressed train step at pod = 2: two spawned processes on the one
  card, a gloo world on the mesh (pod=2, data=1, model=1), each pod
  Qwen1.5-0.5B at full size and its 4 x 1024 half of every batch, 3 steps
  of `build_cell(..., grad_compress=True)`'s fn: params and AdamW state
  bit-identical on both pods after every step (digests gathered), each
  pod's error == g + e - dequantize(q, s) exactly, step 1's exchanged
  mean within sum(s_i)/(2n) of the f32 mean of the pods' gradients, step
  1's loss equal to `make_train_step`'s on the whole batch split as the
  pods split it (within (a)'s margin); the step's median, the
  all-gather's wall time and bytes beside `dcn_bytes_per_step`; (c)
  execution over (data, model) = (2, 1) and (1, 2): two processes on
  the one card in a gloo world (this process rank 0; DTensor's
  collectives through buffers both map, `shared_card`), Qwen1.5-0.5B at
  full size trained 3 steps by `train(..., mesh=)` (8 x 1024 tokens in
  2 microbatches; losses and grad norms equal on both ranks, the losses
  within MESH_LOSS_REL's bound of the unsharded run's, one more step in
  f32 at 4 layers holding the grad norm to the unsharded one within
  MESH_GN_REL, each rank holding half the state), Qwen3-1.7B's prefill
  cell (16 x
  2048) and decode cell (16 at 2112, pages of 256, 32 greedy steps) in
  bf16 at full depth (logits within 3e-2) and in f32 at 4 of 28 layers
  (8 steps, tokens equal to the unsharded path's), every per-shard
  RMSNorm and paged-attention call held to its plain version on the
  same local tensors and the launches asserted per rank; the data = 2
  run's checkpoint (saved by rank 0, leaves whole) resumed on a 1 x 1
  mesh from a bit-identical state; the all-gather's rate, the time
  inside the collectives and one profiled decode step per mesh;
- the dry-run over the production meshes (phase 14): (a)
  `repro_torch.launch.dryrun` for Qwen3-1.7B's train_4k, prefill_32k
  and decode_32k cells on 16 x 16, Qwen1.5-0.5B's train_4k with
  `--grad-compress` on 2 x 16 x 16, Qwen1.5-MoE-A2.7B's train_4k on 2 x
  16 x 16, RWKV6-3B's long_500k, RecurrentGemma-2B's decode_32k,
  MusicGen-large's train_4k and Qwen3-14B's decode_32k (its 40 heads
  padded to 48 over 16 ranks) on 16 x 16, each over a fake world of 256
  / 512 ranks in a process of its own, printing each record's per-rank
  memory, flops, bytes, collectives and roofline terms under `HW`; (b)
  phase 13a's three cells and phase 12's three prefills and
  Qwen1.5-MoE's decode step (their phases' shapes) traced on a 1 x 1
  fake world on meta tensors and held to the card: argument bytes equal
  to the arguments the card built, train and prefill flops within 1% of
  `FlopCounterMode` over one more call of the same path, a decode's
  difference equal to the gathered attention's 4 B H hd len L (the
  paged kernel's work) within 1%; each cell's roofline bound beside its
  phase's measured time, and the train cell's traced peak beside the
  card's. (a)'s cells save their logs of counted ops (`--save-hlo`),
  which `scripts/torch_reanalyze.py` re-analyzes without tracing on a
  copy of their records: every analysis, collectives_by_op and
  f32_upcast_bytes equal to the traced ones within 1e-9 relative,
  collective counts exactly; the re-analysis's wall time beside the
  traces' and each log's size;
- the entry points outside the package (phase 15): the six
  `examples/torch_*.py` on the card at their defaults (quickstart,
  async_put_get, serve_kv and train_lm in this process through
  `main([])`, every RMSNorm, paged-attention and codec call held to its
  plain version and counted, each example's launches all held and the
  ones it must make nonzero; process_store and networked_store as
  subprocesses, their workers on the card), each held to its own
  `--device cpu` run (the store examples' printed lines, masked, the
  quickstart's GETs after its writer has drained in both runs; serve_kv's
  KV page lines; train_lm's restored step, slabs and recoveries), then
  `scripts/torch_check_metrics_dump.py` on the card; each entry point's
  wall time.

Every phase asserts; any failure exits non-zero. Prints timing lines,
one `kernels` JSON line and, last, `{"ok": true, "device": {...}}`.

With `--baseline DIR` (a checkout of an earlier commit, e.g. `git
archive <commit> | tar -x -C build/parent`), it also builds that
commit's GF(256) ladder and prints its time on every phase-9 operand
beside the current one's, in turns on the same card.

Exits non-zero with no result where CUDA is unavailable or the package
is not beside this script.
"""
from __future__ import annotations

import functools
import json
import os
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
F32_FLOPS_PER_S = 67e12          # fp32 outside the tensor cores (data sheet)
BF16_FLOPS_PER_S = 989e12        # dense bf16 tensor cores (data sheet)


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


def codec_launches() -> int:
    """The codec kernel's launches in this process since its counts were
    last set to 0: its products (`launches`) and its gathered, framed
    decodes (`gather_launches`)."""
    from repro_torch.kernels.rs_gf256 import kernel
    return kernel.launches + kernel.gather_launches


def lat(seconds) -> str:
    """Median and max of per-object latencies, in ms, with the count."""
    ms = sorted(x * 1e3 for x in seconds)
    return (f"median {ms[len(ms) // 2]:.3f} ms, max {ms[-1]:.3f} ms "
            f"over {len(ms)}")


def ops_ms(ops: int) -> float:
    """Time in ms of `ops` 32-bit integer operations at the ALU peak."""
    return ops / INT32_OPS_PER_S * 1e3


def bound(nbytes: int, ops: int = 0, bytes_per_s: float = HBM_BYTES_PER_S,
          ops_per_s: float = INT32_OPS_PER_S):
    """Least time in ms for work that moves `nbytes` at `bytes_per_s` and
    does `ops` operations at `ops_per_s` (int32 ALU peak by default), and
    which of the two binds."""
    t_bytes = nbytes / bytes_per_s * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), "operations" if t_ops > t_bytes else "bytes"


def cold_ms(fn, reps: int, scrub_bytes: int = 128 * MB) -> float:
    """Mean device time of `fn` with the L2 cache flushed before each
    run: a buffer larger than L2 (50 MB) is written between runs, and
    only the run itself lies between each pair of CUDA events. A spin
    kernel ahead of each flush lets the host enqueue the run before the
    device reaches its start event."""
    import torch
    scrub = torch.empty(scrub_bytes, dtype=torch.uint8, device="cuda")
    fn()
    marks = []
    for _ in range(reps):
        torch.cuda._sleep(200_000)          # ~0.1 ms of device cycles
        scrub.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in marks) / reps


class EarlierDesigns:
    """The GF(256) ladder of a baseline checkout (`--baseline DIR`): its
    `gf256_ladder.cu`, built from that checkout and called through its
    own C entry point (int32 coefficients, X, ldx, out, ldo, m, k, L,
    stream; before the Hopper redesign: one payload byte per int32
    lane, one 4-byte word per thread, misaligned rows read by bytes), so
    that one run times the earlier and the current design on one card.
    Nothing counts its launches; it is timed only."""
    LADDER = "src/repro_torch/kernels/rs_gf256/csrc/gf256_ladder.cu"

    def __init__(self, lib: Path):
        import ctypes as C
        self._fn = C.CDLL(str(lib)).gf256_matmul_ladder
        self._fn.argtypes = [C.c_void_p, C.c_void_p, C.c_longlong,
                             C.c_void_p, C.c_longlong, C.c_int, C.c_int,
                             C.c_longlong, C.c_void_p]
        self._fn.restype = C.c_int
        self._coeffs = {}

    def ladder(self, G, X):
        """OUT = G o X by the earlier ladder, into a 16-byte-pitched
        output; its operand, the (m,k) int32 coefficients, made once per
        matrix."""
        import numpy as np
        import torch
        key = G.tobytes() + bytes(G.shape)
        coeffs = self._coeffs.get(key)
        if coeffs is None:
            coeffs = torch.from_numpy(np.asarray(G, np.int32)).to(X.device)
            self._coeffs[key] = coeffs
        m, k = G.shape
        L = X.shape[1]
        out = torch.empty((m, -(-L // 16) * 16), dtype=torch.uint8,
                          device=X.device)[:, :L]
        rc = self._fn(coeffs.data_ptr(), X.data_ptr(), X.stride(0),
                      out.data_ptr(), out.stride(0), m, k, L,
                      torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return out


def gf_bound_ms(m: int, k: int, L: int):
    """Least time for one (m,k) x (k,L) GF(256) product on the card: the
    k input rows and G read once, the m output rows written once, at the
    HBM rate. No count of operations enters it: a design's own count is
    printed beside it, not used as the bound."""
    nbytes = (k + m) * L + m * k
    return (*bound(nbytes), nbytes)


def device_copy_ms(nbytes: int, reps: int, dev) -> float:
    """Device time of a device-to-device copy that reads and writes
    `nbytes` in all (`nbytes / 2` each way): the yardstick printed beside
    a GF(256) product that moves as many bytes."""
    import torch
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    return event_ms(lambda: dst.copy_(src), reps=reps)


def gf_loop_ops(lib: Path) -> dict:
    """Integer-datapath instructions per thread in each GF(256) kernel's
    loops, counted in the SASS of the library this run built
    (`scripts/sass_ops.py` over `cuobjdump -sass`; a static count, both
    sides of a branch in it): {kernel name: (grid-stride loop, largest
    inner loop, the IMADs of each)}. IMAD issues to the FMA pipe, the
    rest to the integer ALU. Empty where the toolkit has no cuobjdump."""
    import importlib.util
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(exe).exists():
        return {}
    spec = importlib.util.spec_from_file_location(
        "sass_ops", ROOT / "scripts" / "sass_ops.py")
    so = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(so)
    sass = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    out = {}
    for name, insns in so.kernels(sass).items():
        counts = [(sum(so.classify(op) == "integer" for addr, op, _ in insns
                       if start <= addr <= end),
                   sum(op == "IMAD" for addr, op, _ in insns
                       if start <= addr <= end))
                  for start, end in so.loops(insns)] or [(0, 0)]
        inner = max(counts[:-1], default=(0, 0))
        out[name] = (counts[-1][0], inner[0], counts[-1][1], inner[1])
    return out


def gf_design_ops(loop_ops: dict, G, X):
    """The integer instructions the codec kernel's SASS issues for
    G o X: (ops, per 16-byte chunk, which instantiation), from
    `gf_loop_ops`; None where the SASS was not counted. The small
    kernel runs its grid-stride loop once per chunk; the general one
    once per chunk and group of 8 output rows, its loop over input rows
    k times."""
    import re
    from repro_torch.kernels.rs_gf256 import kernel
    m, k = G.shape
    L = X.shape[1]
    plan = kernel.row_plan(G)
    if kernel.route(plan, m, k) == "small":
        aligned = X.data_ptr() % 16 == 0 and X.stride(0) % 16 == 0
        pat = (f"gf256_smallILi{k}ELi{len(plan.dense)}ELb"
               f"{int(aligned)}E")
        per = [outer for name, (outer, *_) in loop_ops.items()
               if re.search(pat, name)]
        groups = 1
    else:
        pat = "gf256_general"
        per = [outer - inner + k * inner
               for name, (outer, inner, *_) in loop_ops.items()
               if re.search(pat, name)]
        groups = -(-m // 8)
    if not per:
        return None
    return -(-L // 16) * groups * per[0], per[0] * groups, pat


def gf_operands(dev, gen, rng):
    """Phase 5's GF(256) operands, each (label, G, X): the main path's
    products at a 100 MB object's chunk (L = 10,485,761) on the store's
    layout (rows of an `ec._stacked` buffer, pitch rounded up to 16
    bytes), the real RS(10+2) decode matrices with one and two data
    chunks lost, a dense random (10,10) G on the store's layout and on
    the operand timed before (rows of L bytes back to back, 7 of 10 not
    4-byte aligned), and the small products of the main path: a 1 MB
    object's encode, a KV page's encode and the (2,4) checkpoint
    encode."""
    import numpy as np
    import torch
    from repro_torch.core import ec
    from repro_torch.kernels.rs_gf256.ref import cauchy_parity_matrix

    def store_x(k, L):
        X = ec._stacked(k, L, dev)
        X.copy_(torch.randint(0, 256, (k, L), dtype=torch.uint8,
                              device=dev, generator=gen))
        return X

    k, p = 10, 2
    codec = ec.RSCodec(ec.ECConfig(k, p), device=dev)
    L = codec.chunk_len(100 * MB)
    X = store_x(k, L)
    dense = rng.integers(0, 256, (k, k), dtype=np.uint8)
    back_to_back = torch.randint(0, 256, (k * L,), dtype=torch.uint8,
                                 device=dev, generator=gen).view(k, L)
    kv_page = 2 * 28 * 64 * 8 * 128 * 2     # Qwen3-1.7B, pages of 64, bf16
    return [
        ("encode (2,10)", cauchy_parity_matrix(k, p), X),
        ("decode, chunk 0 lost", codec._decode_matrix(tuple(range(1, 11))),
         X),
        ("decode, chunks 0-1 lost",
         codec._decode_matrix(tuple(range(2, 12))), X),
        ("dense random (10,10), store layout", dense, X),
        ("dense random (10,10), back-to-back rows", dense, back_to_back),
        ("encode (2,10), 1 MB object", cauchy_parity_matrix(k, p),
         store_x(k, codec.chunk_len(MB))),
        ("encode (2,10), KV page", cauchy_parity_matrix(k, p),
         store_x(k, codec.chunk_len(kv_page))),
        ("encode (2,4), checkpoint fragment", cauchy_parity_matrix(4, p),
         store_x(4, -(-(8 * MB + 4) // 4))),
    ]


def gf_timing(dev, gen, rng, card, loop_ops=None) -> dict:
    """Phase 5's kernel timings: each operand of `gf_operands` through
    the codec's kernel, beside its byte bound and a device copy moving
    the same bytes; the plain version at the 100 MB encode and chunk-0
    decode; the design's integer instructions from its SASS
    (`gf_design_ops`) beside the bound. Returns {label: timing}."""
    import torch
    from repro_torch.kernels.rs_gf256 import kernel
    from repro_torch.kernels.rs_gf256.ref import gf256_matmul_ref
    timing = {}
    for label, G, X in gf_operands(dev, gen, rng):
        m, k = G.shape
        L = X.shape[1]
        got = kernel.gf256_matmul_cuda(G, X)
        assert torch.equal(got, gf256_matmul_ref(G, X)), label
        del got

        def cur():
            return kernel.gf256_matmul_cuda(G, X)

        b_ms, by, nbytes = gf_bound_ms(m, k, L)
        reps = 20 if L > MB else 200
        copy_ms = device_copy_ms(nbytes, reps, dev)
        best = event_ms(cur, reps=reps)
        plain = None
        if label in ("encode (2,10)", "decode, chunk 0 lost"):
            # the plain version copies its tables host-to-device, which
            # waits on the stream: no spin ahead of it
            plain = event_ms(lambda: gf256_matmul_ref(G, X), reps=3,
                             warmup=1, spin=False)
        design = gf_design_ops(loop_ops or {}, G, X)
        timing[label] = dict(m=m, k=k, L=L, ms=best, plain_ms=plain,
                             bound_ms=b_ms, bound_by=by, bytes=nbytes,
                             copy_ms=copy_ms,
                             design_ops=design and design[0])
        ops = "SASS not counted" if design is None else (
            f"the design issues {design[0]} integer ops ({design[1]} per "
            f"16-byte chunk, {design[2]}), {ops_ms(design[0]) * 1e3:.2f} us "
            f"at the int32 peak")
        print(f"kernel gf256 {label} (m={m}, k={k}, L={L}, row stride "
              f"{X.stride(0)}, {kernel.row_plan(G)}): "
              f"{best * 1e3:.2f} us = {100 * b_ms / best:.1f}% of its "
              f"bound | bound {b_ms * 1e3:.2f} us by {by} ({nbytes} bytes;"
              f" {ops}) | device copy of the same bytes "
              f"{copy_ms * 1e3:.2f} us"
              + ("" if plain is None else f" | plain {plain * 1e3:.1f} us")
              + f" | {card}")
    return timing


def gather_timing(dev, gen, card) -> dict:
    """Phase 5's gathered decode: a 100 MB object's fragment (L 10,485,761)
    with chunk 0 lost and with chunks 0-1 lost, decoded by one
    `gf256_small_gather` launch from the encode's chunk tensors into the
    codec's framed buffer, beside its byte bound ((k + k) L + k k bytes)
    and the staged path it replaces, timed as a whole and by stage: the
    k survivor copies into a stacked buffer, the product, the copy of
    its rows into the framed buffer. The plain version (`ref.py`) is
    checked against and timed once. Returns {label: timing}."""
    import torch
    from repro_torch.core import ec
    from repro_torch.kernels.rs_gf256 import kernel
    from repro_torch.kernels.rs_gf256.ref import gf256_gather_framed_ref
    k = 10
    codec = ec.RSCodec(ec.ECConfig(k, 2), device=dev)
    payload = torch.randint(0, 256, (100 * MB,), dtype=torch.uint8,
                            device=dev, generator=gen)
    chunks = codec.encode_many([payload], as_arrays=True)[0]
    L = chunks[0].numel()
    flat = ec._framed(k * L, dev)
    surv = ec._stacked(k, L, dev)
    timing = {}
    for label, lost in (("gathered decode, chunk 0 lost", (0,)),
                        ("gathered decode, chunks 0-1 lost", (0, 1))):
        idx = tuple(i for i in range(k + 2) if i not in lost)[:k]
        G = codec._decode_matrix(idx)
        rows = [chunks[i] for i in idx]

        def gathered():
            kernel.gf256_gather_framed_cuda(G, [rows], [flat])

        def copies():
            for r, row in enumerate(rows):
                surv[r].copy_(row)

        def product():
            return kernel.gf256_matmul_cuda(G, surv)

        dec = product()

        def framed_copy():
            flat.view(k, L).copy_(dec)

        def staged():
            copies()
            flat.view(k, L).copy_(product())

        gathered()
        want = torch.empty_like(flat)
        t = time.perf_counter()
        gf256_gather_framed_ref(G, [rows], [want])
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t) * 1e3
        assert torch.equal(flat, want), label
        assert torch.equal(flat[4:4 + 100 * MB], payload), label
        del want
        b_ms, by, nbytes = gf_bound_ms(k, k, L)
        ms = event_ms(gathered, reps=20)
        parts = {name: event_ms(fn, reps=20) for name, fn in (
            ("copies", copies), ("product", product),
            ("framed_copy", framed_copy), ("staged", staged))}
        timing[label] = dict(m=k, k=k, L=L, ms=ms, plain_ms=plain,
                             bound_ms=b_ms, bound_by=by, bytes=nbytes,
                             staged_ms=parts)
        print(f"kernel gf256 {label} (k={k}, L={L}, {kernel.row_plan(G)}, "
              f"output at {flat.data_ptr() % 16} mod 16): {ms * 1e3:.2f} us"
              f" = {100 * b_ms / ms:.1f}% of its bound | bound "
              f"{b_ms * 1e3:.2f} us by {by} ({nbytes} bytes) | staged path "
              f"{parts['staged'] * 1e3:.2f} us: {k} survivor copies "
              f"{parts['copies'] * 1e3:.2f} + product "
              f"{parts['product'] * 1e3:.2f} + framed copy "
              f"{parts['framed_copy'] * 1e3:.2f} us | plain {plain:.1f} ms "
              f"(host clock) | {card}")
    return timing


# ---- serving: phases 6-8 ---------------------------------------------------

QWEN3 = "qwen3-1.7b"
SLOTS, PROMPT, NEW_TOKENS, PAGE = 16, 2048, 64, 64
MAX_LEN = 2176                   # 34 pages of 64: prompt + 64 new + slack
F32_SLOTS, F32_PROMPT, F32_STEPS = 4, 1024, 8
TF_STEPS = 16                    # teacher-forced bf16 steps
RESUME_STEPS = 4                 # decode steps after the evict/restore
PROFILE_STEPS = 3                # decode steps under torch.profiler
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
RMS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
PA_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
PA_256_DRAWS = 16                # phase 13a: draws of q for the paged check
# (B, P, ps, K, G, hd): the reference's sweep, the main path's shape,
# then G = 1, G = 8 and G = 12 (two head groups), pages of 16 and 128,
# hd 64 (f32 and bf16 alike) and hd 8
PA_CASES = [(1, 2, 4, 1, 1, 8), (2, 4, 8, 2, 2, 16), (3, 5, 8, 2, 3, 16),
            (2, 8, 16, 4, 1, 32), (SLOTS, MAX_LEN // PAGE, PAGE, 8, 2, 128),
            (3, 6, 64, 4, 1, 128), (2, 12, 16, 2, 8, 128),
            (2, 5, 128, 2, 2, 128), (2, 4, 16, 1, 12, 64),
            (2, 3, 128, 2, 2, 64), (2, 4, 8, 2, 2, 8)]
# the main path's shapes, then every layout of the kernel's planner:
# d_model 896 to 8192, a row beyond the register tile (20000), d = 64,
# rows of 24 bytes in bf16 (the scalar path) and an unaligned view
RMS_SHAPES = [(4, 128), (3, 7, 256), (1, 512), (300, 64),
              (SLOTS, 1, 2048), (SLOTS, 1, 16, 128), (SLOTS, 1, 8, 128),
              (SLOTS, PROMPT, 2048), (SLOTS, PROMPT, 16, 128),
              (SLOTS, PROMPT, 8, 128), (5, 896), (4096, 1024), (3, 5120),
              (2, 8192), (3, 20000), (3, 64), (4, 7, 12)]


def paged_case(dev, dtype, B, P, ps, K, G, hd, seed, lens=None):
    """Seeded inputs on the card: random page permutations, ragged lens
    (the first sequence at one token, the last at the full pool) unless
    `lens` is given."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    tbl = np.stack([rng.permutation(P) for _ in range(B)]).astype(np.int32)
    if lens is None:
        lens = rng.integers(1, P * ps + 1, B)
        lens[0] = 1
        lens[-1] = P * ps
    lens = np.asarray(lens, dtype=np.int32)
    return (randn(B, K * G, hd), randn(B, P, ps, K, hd),
            randn(B, P, ps, K, hd), torch.from_numpy(tbl).to(dev),
            torch.from_numpy(lens).to(dev))


def kernel_checks(dev) -> dict:
    """Phase 6: RMSNorm and paged decode attention against their plain
    versions on the card, over the reference tests' sweeps, the main
    path's shapes and every layout and split boundary of the two
    kernels' designs, f32 and bf16. Returns each kernel's max abs
    error."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    from repro_torch.kernels.paged_attention.ops import \
        paged_decode_attention
    from repro_torch.kernels.paged_attention.ref import \
        paged_decode_attention_ref
    from repro_torch.kernels.rmsnorm.ops import rms_norm_op
    from repro_torch.kernels.rmsnorm.ref import rms_norm_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    err = {}
    n_rms = n_pa = 0
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        worst = 0.0
        for i, shape in enumerate(RMS_SHAPES + [(9, 65)]):
            gen = torch.Generator(device=dev)
            gen.manual_seed(i)
            x = torch.randn(shape, generator=gen, device=dev).to(dtype)
            scale = (torch.randn(shape[-1:], generator=gen, device=dev)
                     * 0.1 + 1.0).to(dtype)
            if shape == (9, 65):      # rows not 16-byte aligned: scalar
                x, scale = x.flatten()[1:1 + 9 * 64].view(9, 64), scale[1:]
            n_rms += 1
            got, want = rms_norm_op(x, scale), rms_norm_ref(x, scale)
            torch.cuda.synchronize()
            assert got.dtype == dtype and got.shape == x.shape
            torch.testing.assert_close(got.float(), want.float(),
                                       atol=RMS_TOL[dname],
                                       rtol=RMS_TOL[dname])
            worst = max(worst, float((got.float() - want.float()).abs()
                                     .max()))
        err[("rmsnorm", dname)] = worst
        worst = 0.0
        for i, case in enumerate(PA_CASES):
            B, P, ps, K, G, hd = case
            # lens that end on a page boundary and where a split ends
            _, pps = pa_kernel.split_pages(
                B, K, G, P, _build.sm_count(dev), pa_kernel._blocks_per_sm(
                    dev, hd, G, pa_kernel.DTYPES[dtype], P))
            edges = [max(1, P // 2) * ps if j % 2 else min(P, pps) * ps
                     for j in range(B)]
            for lens in (None, edges):
                args = paged_case(dev, dtype, *case, seed=i, lens=lens)
                got = paged_decode_attention(*args)
                want = paged_decode_attention_ref(*args)
                torch.cuda.synchronize()
                assert got.dtype == dtype and \
                    torch.isfinite(got.float()).all()
                torch.testing.assert_close(got.float(), want,
                                           atol=PA_TOL[dname],
                                           rtol=PA_TOL[dname])
                worst = max(worst, float((got.float() - want).abs().max()))
                n_pa += 1
        err[("paged_decode_attention", dname)] = worst
    print(f"phase 6 kernels vs plain on the card: rmsnorm over "
          f"{n_rms} checks ({len(RMS_SHAPES)} shapes and an unaligned view "
          f"in f32 and bf16, the scale in x's type), max_abs_err f32 "
          f"{err[('rmsnorm', 'float32')]:.3e} (tol 1e-5), bf16 "
          f"{err[('rmsnorm', 'bfloat16')]:.3e} (tol 2e-2); paged decode "
          f"attention over {n_pa} checks ({len(PA_CASES)} shapes x "
          f"(ragged lens; lens ending on a page and on a split boundary) "
          f"in f32 and bf16, permuted tables), max_abs_err f32 "
          f"{err[('paged_decode_attention', 'float32')]:.3e} (tol 2e-5), "
          f"bf16 {err[('paged_decode_attention', 'bfloat16')]:.3e} "
          f"(tol 3e-2)")
    return {name: max(err[(name, "float32")], err[(name, "bfloat16")])
            for name in ("rmsnorm", "paged_decode_attention")}


def teacher_forced(model, params, prompts, tokens, max_len):
    """Prefill `prompts`, then decode feeding `tokens[:, i]` at step i;
    returns the (B, steps, V) f32 logits of the steps and the argmax of
    the prefill."""
    import torch
    logits, cache = model.prefill(params, {"tokens": prompts},
                                  max_len=max_len)
    first = logits[:, -1].argmax(-1).to(torch.int32)
    out = []
    tok = first[:, None]
    for i in range(tokens.shape[1]):
        lg, cache = model.decode_step(params, {"token": tok}, cache)
        out.append(lg[:, -1].float())
        tok = tokens[:, i:i + 1]
    del cache
    return torch.stack(out, 1), first


def greedy(model, params, prompts, steps, max_len):
    """Prefill + `steps` greedy decode steps: (tokens, f32 logits)."""
    import torch
    logits, cache = model.prefill(params, {"tokens": prompts},
                                  max_len=max_len)
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    toks, lgs = [], []
    for _ in range(steps):
        lg, cache = model.decode_step(params, {"token": tok}, cache)
        lgs.append(lg[:, -1].float())
        tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        toks.append(tok[:, 0])
    del cache
    return torch.stack(toks, 1), torch.stack(lgs, 1)


def prefill_flops(cfg, B: int, S: int) -> int:
    """Matrix-product flops of one prefill: every layer's projections and
    MLP for B*S tokens, causal attention (QK and PV over S(S+1)/2 pairs),
    and the logits of the last token."""
    d, H, K, hd, ff = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    per_tok = 2 * (d * H * hd + 2 * d * K * hd + H * hd * d + 3 * d * ff)
    attn = 2 * 2 * H * hd * (S * (S + 1) // 2)
    return cfg.num_layers * B * (S * per_tok + attn) \
        + 2 * B * cfg.vocab_size * d


def kv_bytes(cfg, B: int, tokens: int, elem: int = 2) -> int:
    """Bytes of the K and V rows of `tokens` positions of B sequences."""
    return 2 * B * tokens * cfg.num_layers * cfg.num_kv_heads \
        * cfg.head_dim * elem


def serve(dev, work, card) -> dict:
    """Phases 7 and 8: Qwen3-1.7B served at full width over the SMS-paged
    KV cache, the plain-path comparisons, KV eviction through the store,
    and the serving kernels' timings. Returns launches and timings."""
    import dataclasses

    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.core import InfiniStore, StoreConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    from repro_torch.kernels.paged_attention.ref import \
        paged_decode_attention_ref
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.kernels.rmsnorm.ref import rms_norm_ref
    from repro_torch.kernels.rs_gf256 import kernel as gf_kernel
    from repro_torch.models import build_model
    from repro_torch.models.transformer import _gather_pages, init_params
    from repro_torch.serving import ServeConfig, ServeEngine

    cfg = get_config(QWEN3)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.qk_norm,
            cfg.tie_embeddings, cfg.dtype) == (
        28, 2048, 16, 8, 128, 6144, 151936, True, True, "bfloat16")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t = time.perf_counter()
    params = init_params(cfg, gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.values())
    weight_bytes = sum(p.numel() * p.element_size() for p in params.values())
    print(f"phase 7 model: {QWEN3} at published widths, {n_params} params "
          f"({weight_bytes} bytes bf16) from seed {SEED} on the card in "
          f"{time.perf_counter() - t:.3f} s")

    store = InfiniStore(StoreConfig(spill_dir=str(work / "spill-kv")),
                        seed=SEED)
    scfg = ServeConfig(batch_slots=SLOTS, max_len=MAX_LEN, page_size=PAGE)
    eng = ServeEngine(cfg, scfg, params=params, device=dev, store=store)
    kv = eng.kv
    pool_bytes = kv.k_pool.numel() * kv.k_pool.element_size()
    assert kv.page_bytes == 28 * 64 * 8 * 128 * 2 * 2 == 7_340_032
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab_size, (SLOTS, PROMPT)).astype(
        np.int32)

    # ---- phase 7: the main path ----------------------------------------
    torch.cuda.synchronize()
    rms_kernel.launches = pa_kernel.launches = 0
    gf_kernel.launches = gf_kernel.gather_launches = 0
    t = time.perf_counter()
    out = eng.generate(prompts, NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {"rmsnorm": rms_kernel.launches,
                "paged_decode_attention": pa_kernel.launches,
                "gf256_matmul_bitsliced": codec_launches()}
    per_step_rms = 4 * cfg.num_layers + 1
    assert launches["paged_decode_attention"] == \
        cfg.num_layers * NEW_TOKENS, launches
    assert launches["rmsnorm"] == per_step_rms * (NEW_TOKENS + 1), launches
    assert launches["gf256_matmul_bitsliced"] == 0, launches
    assert out.shape == (SLOTS, NEW_TOKENS) and out.dtype == np.int32
    assert ((out >= 0) & (out < cfg.vocab_size)).all()
    length = PROMPT + NEW_TOKENS
    st = eng.stats
    print(f"phase 7 serve: {SLOTS} x {PROMPT}-token prompts, {NEW_TOKENS} "
          f"new tokens each in {wall:.3f} s (KV pools 2 x {pool_bytes} "
          f"bytes, {kv.stats.pages_allocated} pages of {kv.page_bytes} "
          f"bytes); launches {json.dumps(launches)} = {cfg.num_layers} paged "
          f"attention per decode step, {per_step_rms} RMSNorm per step and "
          f"in the prefill; first tokens {out[0, :8].tolist()}")

    # ---- phase 7: the kernel path against the plain contiguous path ----
    torch.backends.cuda.matmul.allow_tf32 = False
    paged_m = build_model(cfg, kv_layout="paged", page_size=PAGE)
    plain_m = build_model(cfg, kv_layout="contiguous")
    toks = torch.from_numpy(out[:, :TF_STEPS]).to(dev)
    dev_prompts = torch.from_numpy(prompts).to(dev)
    lg_k, first_k = teacher_forced(paged_m, params, dev_prompts, toks,
                                   MAX_LEN)
    lg_p, first_p = teacher_forced(plain_m, params, dev_prompts, toks,
                                   PROMPT + TF_STEPS)
    assert torch.isfinite(lg_k).all() and torch.isfinite(lg_p).all()
    # the kernel path re-run outside the engine gives the engine's tokens
    assert torch.equal(lg_k.argmax(-1).to(torch.int32).cpu(),
                       torch.from_numpy(out[:, :TF_STEPS]))
    bf16_diff = float((lg_k - lg_p).abs().max())
    agree = float((lg_k.argmax(-1) == lg_p.argmax(-1)).float().mean())
    print(f"phase 7 bf16 check: kernel path vs plain contiguous path "
          f"(decode_attention_grouped, no paged kernel), teacher-forced on "
          f"the engine's tokens, {SLOTS} x {TF_STEPS} steps: largest logit "
          f"difference {bf16_diff:.4e} (tol {LOGIT_TOL['bfloat16']}), "
          f"argmax agreement {agree:.4f}; logits std "
          f"{float(lg_p.std()):.4f}")
    assert bf16_diff <= LOGIT_TOL["bfloat16"], bf16_diff
    del lg_k, lg_p

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = {k: v.float() for k, v in params.items()}
    p32 = dev_prompts[:F32_SLOTS, :F32_PROMPT]
    eng32 = ServeEngine(cfg32, ServeConfig(
        batch_slots=F32_SLOTS, max_len=F32_PROMPT + 2 * PAGE,
        page_size=PAGE), params=params32, device=dev)
    out32 = eng32.generate(p32.cpu().numpy(), F32_STEPS)
    del eng32
    tok_k, lg32_k = greedy(build_model(cfg32, kv_layout="paged",
                                       page_size=PAGE), params32, p32,
                           F32_STEPS, F32_PROMPT + 2 * PAGE)
    tok_p, lg32_p = greedy(build_model(cfg32, kv_layout="contiguous"),
                           params32, p32, F32_STEPS, F32_PROMPT + F32_STEPS)
    f32_diff = float((lg32_k - lg32_p).abs().max())
    print(f"phase 7 f32 check: {QWEN3} at full width in f32, "
          f"{F32_SLOTS} x {F32_PROMPT}-token prompts, {F32_STEPS} greedy "
          f"steps: engine (paged kernel) tokens {out32[0].tolist()}..., "
          f"plain contiguous path equal: "
          f"{bool(torch.equal(tok_k, tok_p))}; largest logit difference "
          f"{f32_diff:.4e} (tol {LOGIT_TOL['float32']})")
    assert np.array_equal(out32, tok_k.cpu().numpy())
    assert torch.equal(tok_k, tok_p), (tok_k, tok_p)
    assert f32_diff <= LOGIT_TOL["float32"], f32_diff
    del params32, lg32_k, lg32_p
    torch.cuda.empty_cache()

    # ---- phase 8: KV eviction through the store ------------------------
    seq0 = sorted((j, key) for key, (b, j, _, _) in kv.pages.items()
                  if b == 0)
    before = {key: kv.page_payload(0, kv.pages[key][2]).clone()
              for _, key in seq0}
    k_ref, v_ref = kv.k_pool.clone(), kv.v_pool.clone()
    ref_cache = {"k": k_ref, "v": v_ref,
                 "block_table": torch.tensor(kv.table, device=dev),
                 "len": torch.tensor(length, dtype=torch.int32, device=dev)}
    last = torch.from_numpy(out[:, -1:]).to(dev)
    ref_toks, _ = decode_on(eng, ref_cache, last, RESUME_STEPS)
    del ref_cache, k_ref, v_ref
    gf_kernel.launches = gf_kernel.gather_launches = 0
    t = time.perf_counter()
    for _, key in seq0:
        kv.evict_page_to_cos(key)
    assert store.flush_writeback(timeout=600.0)
    torch.cuda.synchronize()
    evict_s = time.perf_counter() - t
    assert kv.stats.pages_evicted_to_cos == len(seq0) == -(-length // PAGE)
    assert not any(b == 0 for b, _, _, _ in kv.pages.values())
    t = time.perf_counter()
    restored = eng.resume("seq0", 0)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t
    gf_evict = codec_launches()
    assert restored == len(seq0) and gf_evict >= len(seq0), gf_evict
    for _, key in seq0:
        assert torch.equal(kv.page_payload(0, kv.pages[key][2]),
                           before[key]), key
    got_toks, _ = decode_on(eng, kv.device_cache(length), last,
                            RESUME_STEPS)
    assert torch.equal(got_toks, ref_toks), (got_toks, ref_toks)
    evicted = len(seq0) * kv.page_bytes
    print(f"phase 8 evict/resume: seq0's {len(seq0)} pages "
          f"({evicted} bytes, {kv.page_bytes} each) put into "
          f"InfiniStore(device='cuda') in {evict_s:.3f} s and restored in "
          f"{resume_s:.3f} s bit-identical; {RESUME_STEPS} decode steps on "
          f"from them == a run that never evicted; GF(256) launches "
          f"{gf_evict}")
    del before
    assert store.close()

    # ---- where a decode step's time goes (torch.profiler) --------------
    from torch.profiler import ProfilerActivity, profile
    decode_on(eng, kv.device_cache(length), last, 1)         # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        decode_on(eng, kv.device_cache(length), last, PROFILE_STEPS)
        torch.cuda.synchronize()
        window = time.perf_counter() - t
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) is not None
               and str(e.device_type).endswith("CUDA")]
    dev_us = sum(getattr(e, "self_device_time_total", 0.0) for e in kernels)
    n_kernels = sum(e.count for e in kernels)
    steps_ms = sorted(x * 1e3 for x in st.step_seconds)
    median = steps_ms[len(steps_ms) // 2]
    if dev_us > 0:
        per_step = dev_us / 1e3 / PROFILE_STEPS
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        top = "; ".join(
            f"{e.key[:60]} "
            f"{e.self_device_time_total / 1e3 / PROFILE_STEPS:.3f} ms "
            f"x{e.count // PROFILE_STEPS}" for e in top)
        print(f"decode step profile ({PROFILE_STEPS} steps under "
              f"torch.profiler, {window * 1e3 / PROFILE_STEPS:.3f} ms per "
              f"step there): device busy {per_step:.3f} ms per step over "
              f"{n_kernels // PROFILE_STEPS} device operations; against "
              f"the unprofiled median step {median:.3f} ms the device is "
              f"idle {100 * (1 - per_step / median):.2f}%; top: {top} | "
              f"{card}")
    else:
        print("decode step profile: torch.profiler saw no device time "
              "(device busy share not measured)")

    # ---- timing --------------------------------------------------------
    prefill_tps = SLOTS * PROMPT / st.prefill_seconds
    flops = prefill_flops(cfg, SLOTS, PROMPT)
    pre_b, pre_by = bound(weight_bytes + kv_bytes(cfg, SLOTS, PROMPT),
                          flops, ops_per_s=BF16_FLOPS_PER_S)
    print(f"prefill: {SLOTS} x {PROMPT} tokens in {st.prefill_seconds:.3f} "
          f"s = {prefill_tps:.1f} tokens/s | bound {pre_b:.3f} ms by "
          f"{pre_by} ({flops} flops at the bf16 peak) = "
          f"{SLOTS * PROMPT / (pre_b / 1e3):.1f} tokens/s; "
          f"{100 * pre_b / 1e3 / st.prefill_seconds:.2f}% of it | {card}")
    step_bounds = [bound(weight_bytes + kv_bytes(cfg, SLOTS, PROMPT + i + 1))
                   [0] for i in range(NEW_TOKENS)]
    decode_tps = SLOTS * NEW_TOKENS / st.decode_seconds
    bound_tps = SLOTS * NEW_TOKENS / (sum(step_bounds) / 1e3)
    print(f"decode: {SLOTS * NEW_TOKENS} tokens in {st.decode_seconds:.3f} "
          f"s = {decode_tps:.1f} tokens/s; step median "
          f"{steps_ms[len(steps_ms) // 2]:.3f} ms, max {steps_ms[-1]:.3f} "
          f"ms over {len(steps_ms)} | bound {bound_tps:.1f} tokens/s "
          f"(weights {weight_bytes} bytes + valid KV per step at 3.35 TB/s;"
          f" step bound {step_bounds[0]:.3f}-{step_bounds[-1]:.3f} ms); "
          f"{100 * decode_tps / bound_tps:.2f}% of it | {card}")

    timing = {}
    # paged attention at one layer's main-path shape, final length
    q = torch.randn((SLOTS, cfg.num_heads, cfg.head_dim), device=dev,
                    dtype=torch.bfloat16)
    kc, vc = kv.k_pool[0], kv.v_pool[0]
    table = torch.tensor(kv.table, device=dev)
    lens = torch.full((SLOTS,), length, dtype=torch.int32, device=dev)
    B, P, ps, K, hd = kc.shape
    pa_bytes = 2 * q.numel() * 2 + kv_bytes(cfg, SLOTS, length) \
        // cfg.num_layers + table.numel() * 4 + lens.numel() * 4
    pa_flops = 4 * SLOTS * cfg.num_heads * cfg.head_dim * length
    pos = torch.arange(P * ps, device=dev)
    mask = (pos[None, :] < lens[:, None])[:, None, None, :]

    def sdpa():
        kf = _gather_pages(kc, table).transpose(1, 2)      # (B, K, T, hd)
        vf = _gather_pages(vc, table).transpose(1, 2)
        return F.scaled_dot_product_attention(
            q[:, :, None], kf, vf, attn_mask=mask, enable_gqa=True)

    def paged():
        return pa_kernel.paged_decode_attention_cuda(q, kc, vc, table, lens)

    ms = event_ms(paged, reps=50)
    plain = event_ms(lambda: paged_decode_attention_ref(q, kc, vc, table,
                                                        lens), reps=5)
    lib_ms = event_ms(sdpa, reps=10)
    b_ms, by = bound(pa_bytes, pa_flops, ops_per_s=F32_FLOPS_PER_S)
    timing["paged_decode_attention"] = dict(ms=ms, plain_ms=plain,
                                            bound_ms=b_ms, bound_by=by,
                                            library_ms=lib_ms)
    occ = pa_kernel._blocks_per_sm(dev, hd, cfg.num_heads // K,
                                   pa_kernel.DTYPES[q.dtype], P)
    splits, pps = pa_kernel.split_pages(B, K, cfg.num_heads // K, P,
                                        _build.sm_count(dev), occ)
    print(f"kernel paged_decode_attention (B={B}, H={cfg.num_heads}, "
          f"K={K}, hd={hd}, {P} pages of {ps}, lens {length}, bf16; "
          f"{occ} blocks per SM, {splits} splits of {pps} pages): "
          f"{ms * 1e3:.1f} us = {100 * b_ms / ms:.1f}% of its bound | "
          f"bound {b_ms * 1e3:.1f} us by {by} ({pa_bytes} bytes, "
          f"{pa_flops} flops) | plain {plain * 1e3:.1f} us | _gather_pages "
          f"+ sdpa(enable_gqa) {lib_ms * 1e3:.1f} us | {card}")

    # RMSNorm at its three main-path shapes; the prefill's ln is the one
    # the kernels line carries
    for shape, label in (((SLOTS, PROMPT, cfg.d_model), "prefill ln"),
                         ((SLOTS, PROMPT, cfg.num_heads, cfg.head_dim),
                          "prefill q_norm"),
                         ((SLOTS, 1, cfg.d_model), "decode ln")):
        x = torch.randn(shape, device=dev, dtype=torch.bfloat16)
        w = params["final_norm"]
        if shape[-1] != cfg.d_model:
            w = params["layers/q_norm"][0]
        ms = event_ms(lambda: rms_kernel.rms_norm_cuda(x, w, cfg.rms_eps),
                      reps=50)
        plain = event_ms(lambda: rms_norm_ref(x, w, cfg.rms_eps), reps=10)
        lib_ms = event_ms(lambda: F.rms_norm(x, (shape[-1],), w,
                                             cfg.rms_eps), reps=50)
        dst = torch.empty_like(x)          # a copy moves the same bytes
        copy_ms = event_ms(lambda: dst.copy_(x), reps=50)
        nbytes = 2 * x.numel() * 2 + w.numel() * 2
        b_ms, by = bound(nbytes, 3 * x.numel(), ops_per_s=F32_FLOPS_PER_S)
        if label == "prefill ln":
            timing["rmsnorm"] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms,
                                     bound_by=by, library_ms=lib_ms)
        lay = rms_kernel.plan(shape[-1], 2, True, x.numel() // shape[-1],
                              _build.sm_count(dev))
        print(f"kernel rmsnorm {label} {shape} bf16 ({lay}): "
              f"{ms * 1e3:.2f} us = {100 * b_ms / ms:.1f}% of its bound | "
              f"bound {b_ms * 1e3:.2f} us by {by} ({nbytes} bytes) | plain "
              f"{plain * 1e3:.2f} us | F.rms_norm {lib_ms * 1e3:.2f} us | "
              f"device copy of x {copy_ms * 1e3:.2f} us | {card}")
    return {"launches": launches, "timing": timing,
            "gf_evict_launches": gf_evict}


def decode_on(eng, cache, tok, steps):
    """`steps` greedy decode steps of the engine's model from `cache`
    (updated in place); returns (tokens (B, steps), last cache)."""
    import torch
    toks = []
    for _ in range(steps):
        tok, cache = eng._decode_fn(eng.params, {"token": tok}, cache)
        toks.append(tok)
        tok = tok[:, None]
    return torch.stack(toks, 1), cache


# ---- the GF(256) A/B entry point: phase 9 --------------------------------

LADDER_SWEEP = [(2, 10), (4, 4), (1, 2), (6, 12), (10, 10)]
LADDER_L = [1, 15, 16, 17, 63, 64, 65, 100, 1024, 2125]
AB_L = 104_858                   # benchmarks/kernels.py: RS(10+2), ~1 MB


def ladder_ops(loop_ops: dict, m: int, k: int, L: int):
    """The integer instructions the ladder kernel's SASS issues for an
    (m,k) x (k,L) product, from `gf_loop_ops` of its library: its
    grid-stride loop once per 16-byte chunk and group of up to 16 output
    rows, its loop over input rows k times. (ops, of which IMAD, per
    chunk and input row, of which IMAD); None where the SASS was not
    counted."""
    import re
    rows = min(m, 16)
    per = [(outer - inner + k * inner, o_imad - i_imad + k * i_imad,
            inner, i_imad)
           for name, (outer, inner, o_imad, i_imad) in loop_ops.items()
           if re.search(f"gf256_ladderILi{rows}E", name)]
    if not per:
        return None
    chunk, chunk_imad, inner, i_imad = per[0]
    n = -(-L // 16) * -(-m // 16)
    return n * chunk, n * chunk_imad, inner, i_imad


def ladder_phase(dev, gen, rng, L_main: int, card: str, loop_ops=None,
                 earlier=None) -> dict:
    """Phase 9: the ladder kernel held bit for bit to its plain version and
    to the codec's kernel (rows back to back, offset views, rows on the
    codec's 16-byte pitch, lengths around a 16-byte chunk), driven through
    the A/B entry point on the operands it is timed on (its launches
    counted), then timed there beside its byte bound, a device copy of
    the same bytes, the codec's kernel, the plain ladder, its SASS count
    (`ladder_ops`) and, with `earlier`, the design before its redesign
    (in turns: earlier, current, current, earlier). Returns its
    launches, max error and timings."""
    import numpy as np
    import torch
    from repro_torch.core import ec
    from repro_torch.kernels.rs_gf256 import kernel
    from repro_torch.kernels.rs_gf256.ops import gf256_matmul
    from repro_torch.kernels.rs_gf256.ref import (cauchy_parity_matrix,
                                                  gf256_matmul_ladder_ref)

    def rand_x(k, L, pad=0):
        return torch.randint(0, 256, (k, L + pad), dtype=torch.uint8,
                             device=dev, generator=gen)

    def pitched_x(k, L):
        X = ec._stacked(k, L, dev)
        X.copy_(rand_x(k, L))
        return X

    k, p = 10, 2
    # (m, k, L, column offset into rows of L + offset bytes back to
    # back, or None for rows on the codec's 16-byte pitch)
    cases = [(m, kk, L, 0) for m, kk in LADDER_SWEEP for L in LADDER_L]
    cases += [(10, 10, 2125, 1), (10, 10, 65_539, 3), (2, 10, 65_539, 1),
              (2, 10, AB_L, 0)]
    cases += [(m, kk, L, None) for m, kk in ((2, 10), (10, 10))
              for L in LADDER_L + [65_539]]
    checks = max_err = 0
    for m, kk, L, off in cases:
        G = rng.integers(0, 256, (m, kk), dtype=np.uint8)
        X = pitched_x(kk, L) if off is None else rand_x(kk, L, off)[:, off:]
        got = gf256_matmul(G, X, backend="ladder")
        want = gf256_matmul_ladder_ref(G, X)
        other = gf256_matmul(G, X, backend="bitsliced")
        torch.cuda.synchronize()
        max_err = max(max_err, int((got.int() - want.int()).abs().max()))
        assert torch.equal(got, want), (m, kk, L, off)
        assert torch.equal(got, other), (m, kk, L, off)
        checks += 1
    cauchy = cauchy_parity_matrix(k, p)
    shapes = {
        "encode": (cauchy, rand_x(k, L_main)),
        "dense (10,10)": (rng.integers(0, 256, (k, k), dtype=np.uint8),
                          rand_x(k, L_main)),
        "encode, 16-byte pitch": (cauchy, pitched_x(k, L_main)),
        "A/B operand": (cauchy, rand_x(k, AB_L)),
    }
    for name, (G, X) in shapes.items():
        got = gf256_matmul(G, X, backend="ladder")
        want = gf256_matmul_ladder_ref(G, X)
        other = gf256_matmul(G, X, backend="bitsliced")
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(got, other), name
        checks += 1
        del got, want, other
    print(f"phase 9 ladder kernel: {checks} checks bit-identical to the "
          f"plain ladder and to the codec's kernel ((m,k) in "
          f"{LADDER_SWEEP} x L in {LADDER_L}, rows back to back; offset "
          f"views at L 2125 and 65539; (2,10) and (10,10) on the 16-byte "
          f"pitch at each L and 65539; the timed operands below), "
          f"max_abs_err {max_err}")

    # the A/B entry point on the timed operands, as a benchmark calls it
    torch.cuda.synchronize()
    kernel.ladder_launches = 0
    for G, X in shapes.values():
        gf256_matmul(G, X, backend="ladder")
    torch.cuda.synchronize()
    launches = kernel.ladder_launches
    assert launches == len(shapes), launches

    timing = {}
    for name, (G, X) in shapes.items():
        m = G.shape[0]
        L = X.shape[1]

        def cur():
            return kernel.gf256_matmul_ladder_cuda(G, X)

        reps = 20 if L > MB else 200
        b_ms, by, nbytes = gf_bound_ms(m, k, L)
        copy_ms = device_copy_ms(nbytes, reps, dev)
        if earlier is not None:
            assert torch.equal(earlier.ladder(G, X), cur()), name
            old = [event_ms(lambda: earlier.ladder(G, X), reps=reps)]
            ms = [event_ms(cur, reps=reps), event_ms(cur, reps=reps)]
            old.append(event_ms(lambda: earlier.ladder(G, X), reps=reps))
        else:
            old, ms = None, [event_ms(cur, reps=reps)]
        best = min(ms)
        bits_ms = event_ms(lambda: kernel.gf256_matmul_cuda(G, X),
                           reps=reps)
        plain = event_ms(lambda: gf256_matmul_ladder_ref(G, X), reps=3,
                         warmup=1, spin=False)
        design = ladder_ops(loop_ops or {}, m, k, L)
        timing[name] = dict(m=m, k=k, L=L, ms=best, plain_ms=plain,
                            bound_ms=b_ms, bound_by=by, bytes=nbytes,
                            copy_ms=copy_ms, bitsliced_ms=bits_ms,
                            earlier_ms=old, design_ops=design and design[0])
        ops = "SASS not counted" if design is None else (
            f"the design issues {design[0]} integer ops, {design[1]} of "
            f"them IMAD on the FMA pipe ({design[2]} per 16-byte chunk and "
            f"input row, {design[3]} IMAD), "
            f"{ops_ms(max(design[0] - design[1], design[1])) * 1e3:.2f} us "
            f"at the int32 peak of the busier pipe")
        side = "" if old is None else (
            f" | earlier design {old[0] * 1e3:.2f} / {old[1] * 1e3:.2f} us "
            f"in turns with {ms[0] * 1e3:.2f} / {ms[1] * 1e3:.2f} us")
        print(f"kernel gf256_matmul_ladder {name} (m={m}, k={k}, L={L}, "
              f"row stride {X.stride(0)}): {best * 1e3:.2f} us = "
              f"{100 * b_ms / best:.1f}% of its bound | bound "
              f"{b_ms * 1e3:.2f} us by {by} ({nbytes} bytes; {ops}) | "
              f"device copy of the same bytes {copy_ms * 1e3:.2f} us | "
              f"codec's kernel {bits_ms * 1e3:.2f} us | plain ladder "
              f"{plain * 1e3:.1f} us{side} | {card}")
    del shapes
    return {"launches": launches, "max_abs_err": max_err, "timing": timing}


# ---- training: phase 10 --------------------------------------------------

QWEN15 = "qwen1.5-0.5b"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO, TRAIN_STEPS = 1024, 8, 2, 4
CKPT_STEP = 2
STATE_BYTES = 6_495_827_972      # bf16 params + f32 mu, nu, master + count
LOSS_TOL = 2e-4                  # tests/test_checkpoint.py's tolerance


def train_flops(cfg, tokens: int, seq: int, n_params: int) -> int:
    """Matrix-product flops of one train step: 6 N per token (forward and
    backward, the tied head included), the remat recompute of every
    layer's forward (2 N_layer per token), and causal attention (QK and
    PV over S(S+1)/2 pairs per sequence and head) in the forward, the
    backward (twice) and the recompute."""
    layer_params = n_params - cfg.vocab_size * cfg.d_model - cfg.d_model
    attn_fwd = 2 * 2 * cfg.num_heads * cfg.head_dim \
        * (seq * (seq + 1) // 2) * (tokens // seq) * cfg.num_layers
    return 6 * n_params * tokens + 2 * layer_params * tokens + 4 * attn_fwd


# kinds of device kernel in a train step, by words in their names (first
# match wins): the repo's RMSNorm kernel, matrix products (cuBLAS and
# CUTLASS), reductions, indexing (the embedding's gather and its
# scatter-add backward), copies, then PyTorch's elementwise kernels
TRAIN_KERNEL_KINDS = [
    ("rmsnorm kernel", ("rmsnorm_tile", "rmsnorm_loop")),
    ("matrix products", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
    ("reductions", ("reduce_kernel", "softmax", "norm_kernel")),
    ("indexing", ("index", "scatter", "gather")),
    ("copies", ("memcpy", "memset", "copy")),
    ("elementwise", ("elementwise",)),
]


def profile_train_step(dev, cfg, shape, median: float, card: str) -> None:
    """Where a train step's device time goes: one step of `train()`'s own
    step function (after a warm one) under torch.profiler, against the
    unprofiled median step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    model = build_model(cfg)
    step_fn = make_train_step(model, adamw.AdamWConfig(lr=1e-3,
                                                       warmup_steps=10))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init_params(gen)
    opt = adamw.adamw_init(params)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
        cfg, shape, step=0, num_microbatches=TRAIN_MICRO).items()}
    params, opt, metrics = step_fn(params, opt, batch)        # warm
    float(metrics["loss"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        window = time.perf_counter() - t
    del params, opt, metrics, batch
    torch.cuda.empty_cache()
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) is not None
               and str(e.device_type).endswith("CUDA")]
    dev_ms = sum(getattr(e, "self_device_time_total", 0.0)
                 for e in kernels) / 1e3
    if dev_ms <= 0:
        print("train step profile: torch.profiler saw no device time "
              "(device busy share not measured)")
        return
    # device time by kind of kernel, from the kernel's name
    kinds = {}
    for e in kernels:
        name = e.key.lower()
        kind = next((k for k, words in TRAIN_KERNEL_KINDS
                     if any(w in name for w in words)), "other")
        ms, n = kinds.get(kind, (0.0, 0))
        kinds[kind] = (ms + e.self_device_time_total / 1e3, n + e.count)
    by_kind = "; ".join(f"{k} {ms:.3f} ms x{n}" for k, (ms, n) in sorted(
        kinds.items(), key=lambda kv: -kv[1][0]))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    top = "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} "
                    f"ms x{e.count}" for e in top)
    print(f"train step profile (1 step under torch.profiler, "
          f"{window * 1e3:.3f} ms there): device busy {dev_ms:.3f} ms over "
          f"{sum(e.count for e in kernels)} device operations; against the "
          f"unprofiled median step {median * 1e3:.3f} ms the device is idle "
          f"{100 * (1 - dev_ms / 1e3 / median):.2f}%; by kind: {by_kind}; "
          f"top: {top} | {card}")


def train_phase(dev, card: str, cfg) -> dict:
    """Phase 10: `cfg` (Qwen1.5-0.5B at full width and depth) trained on
    the card, with a checkpoint through the store and a resume after
    every other slab is reclaimed. Returns launches and timings."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.checkpoint.checkpointer import _leaf_paths
    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.kernels.rmsnorm.ops import (rms_norm_backward,
                                                 rms_norm_op)
    from repro_torch.kernels.rmsnorm.ref import rms_norm_ref
    from repro_torch.kernels.rs_gf256 import kernel as gf_kernel
    from repro_torch.launch.train import make_store_for_checkpoints, train
    from repro_torch.models.transformer import init_params, param_specs

    names = sorted(param_specs(cfg))
    assert len(names) == 14, names

    # ---- (a) the RMSNorm kernel's gradients, at the training shape ----
    rows = TRAIN_BATCH // TRAIN_MICRO * TRAIN_SEQ
    grad_err = {}
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        g = torch.Generator(device=dev)
        g.manual_seed(SEED)
        x = torch.randn((rows, cfg.d_model), generator=g, device=dev).to(
            dtype).requires_grad_(True)
        w = (torch.randn(cfg.d_model, generator=g, device=dev) * 0.1
             + 1.0).to(dtype).requires_grad_(True)
        dy = torch.randn((rows, cfg.d_model), generator=g, device=dev).to(
            dtype)
        y = rms_norm_op(x, w, cfg.rms_eps)
        assert y.grad_fn is not None
        got = torch.autograd.grad(y, (x, w), dy)
        want = torch.autograd.grad(rms_norm_ref(x, w, cfg.rms_eps), (x, w),
                                   dy)
        torch.cuda.synchronize()
        worst = 0.0
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == dtype
            torch.testing.assert_close(a.float(), b.float(),
                                       atol=RMS_TOL[dname],
                                       rtol=RMS_TOL[dname])
            worst = max(worst, float((a.float() - b.float()).abs().max()))
        grad_err[dname] = worst
    print(f"phase 10a RMSNorm gradients (the kernel's autograd Function vs "
          f"autograd of the plain version) at ({rows}, {cfg.d_model}): "
          f"max_abs_err f32 {grad_err['float32']:.3e} (tol 1e-5), bf16 "
          f"{grad_err['bfloat16']:.3e} (tol 2e-2)")

    # ---- (b) a straight run -------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    shape = ShapeConfig("chip_train", seq_len=TRAIN_SEQ,
                        global_batch=TRAIN_BATCH, kind="train")
    run = dict(seed=0, num_microbatches=TRAIN_MICRO, device=dev.type)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    init = init_params(cfg, gen)                  # train()'s own draw
    n_params = sum(t.numel() for t in init.values())
    torch.cuda.synchronize()
    rms_kernel.launches = 0
    one = train(cfg, shape, steps=1, **run)
    torch.cuda.synchronize()
    rms_one = rms_kernel.launches
    # per microbatch: 2 norms per layer + the final norm in the forward,
    # and the 2 per layer again in the remat recompute
    per_step_rms = TRAIN_MICRO * (4 * cfg.num_layers + 1)
    assert rms_one == per_step_rms, (rms_one, per_step_rms)
    p1, o1 = one.state["params"], one.state["opt"]
    # a step of lr 1e-4 moves a norm weight of 1.0 by less than bf16's
    # spacing there, so the check reads the f32 master weights, and the
    # first moment (weight decay alone would move master; only a
    # gradient makes mu nonzero). A cut graph leaves a tensor's mu all
    # zero; a live one can hold an exact zero where a bf16 gradient
    # cancels, so the check asks for most elements
    moved, live = {}, {}
    for name in names:
        assert torch.isfinite(o1["master"][name]).all(), name
        delta = float((o1["master"][name] - init[name].float()).abs().max())
        assert delta > 0, name
        live[name] = float((o1["mu"][name] != 0).float().mean())
        assert live[name] > 0.5, (name, live[name])
        moved[name] = int((p1[name] != init[name]).sum())
    del one, p1, o1, init
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rms_kernel.launches = 0
    straight = train(cfg, shape, steps=TRAIN_STEPS, **run)
    torch.cuda.synchronize()
    rms_straight = rms_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    assert rms_straight == per_step_rms * TRAIN_STEPS, rms_straight
    assert np.isfinite(straight.losses).all(), straight.losses
    assert len(straight.losses) == TRAIN_STEPS
    del straight.state
    torch.cuda.empty_cache()
    print(f"phase 10b train {QWEN15} at published widths and depth "
          f"({n_params} params, bf16, AdamW f32 state), {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens per step in {TRAIN_MICRO} microbatches: "
          f"losses {straight.losses}; after step 1 every one of the "
          f"{len(names)} parameter tensors has moved master weights and a "
          f"nonzero first moment (share of nonzero elements, least "
          f"{min(live.values()):.6f}: final_norm {live['final_norm']:.6f},"
          f" ln1 {live['layers/ln1']:.6f}, ln2 {live['layers/ln2']:.6f}; "
          f"bf16 elements changed: {json.dumps(moved)}); RMSNorm launches "
          f"{rms_straight} "
          f"({per_step_rms} per step, remat recompute included); peak "
          f"device memory {peak} bytes")

    # ---- (c) checkpoint, reclaim every other slab, resume -------------
    class TimedCheckpointer(Checkpointer):
        """`Checkpointer` with each save's wall time (synchronised)."""

        def __init__(self, store):
            super().__init__(store)
            self.save_s = []

        def save(self, step, state):
            torch.cuda.synchronize()
            t = time.perf_counter()
            super().save(step, state)
            torch.cuda.synchronize()
            self.save_s.append(time.perf_counter() - t)

    store = make_store_for_checkpoints(device=dev.type)
    ck = TimedCheckpointer(store)
    torch.cuda.synchronize()
    gf_kernel.launches = gf_kernel.gather_launches = 0
    first = train(cfg, shape, steps=CKPT_STEP, checkpointer=ck,
                  checkpoint_every=CKPT_STEP, **run)
    torch.cuda.synchronize()
    gf_save = codec_launches()
    assert gf_save > 0, gf_save
    assert len(ck.save_s) == 1 and ck.latest_step() == CKPT_STEP
    saved = first.state
    state_bytes = sum(t.numel() * t.element_size()
                      for _, t in _leaf_paths(saved))
    assert state_bytes == STATE_BYTES, state_bytes
    # the embedding's backward accumulates with atomics: two runs agree
    # to rounding, not bit for bit
    np.testing.assert_allclose(first.losses, straight.losses[:CKPT_STEP],
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    t = time.perf_counter()
    assert store.flush_writeback(timeout=900.0)
    flush_s = time.perf_counter() - t
    slabs = list(store.sms.slabs)
    for fid in slabs[::2]:
        store.inject_failure(fid)
    rec = store.recovery.stats
    rec0 = rec.local_recoveries + rec.parallel_recoveries
    gf_kernel.launches = gf_kernel.gather_launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    resumed = train(cfg, shape, steps=TRAIN_STEPS, resume=True,
                    checkpointer=ck, **run)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t
    gf_restore = codec_launches()
    recoveries = rec.local_recoveries + rec.parallel_recoveries - rec0
    assert resumed.restored_from == CKPT_STEP, resumed.restored_from
    assert gf_restore + recoveries > 0, (gf_restore, recoveries)
    np.testing.assert_allclose(resumed.losses,
                               straight.losses[CKPT_STEP:],
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    del resumed.state
    torch.cuda.empty_cache()
    gf_kernel.launches = gf_kernel.gather_launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    back = ck.restore(CKPT_STEP, like=saved)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    gf_restore2 = codec_launches()
    for (name, a), (_, b) in zip(_leaf_paths(saved), _leaf_paths(back)):
        assert b.device == a.device and b.dtype == a.dtype, name
        assert torch.equal(a, b), name
    print(f"phase 10c checkpoint: step {CKPT_STEP}'s train state "
          f"({state_bytes} bytes, {len(_leaf_paths(saved))} leaves) saved "
          f"through InfiniStore(device='cuda', RS(4+2)) in "
          f"{ck.save_s[0]:.3f} s with {gf_save} GF(256) launches; "
          f"writeback flushed in {flush_s:.3f} s; {len(slabs[::2])} of "
          f"{len(slabs)} slabs reclaimed; train(resume=True) restored from "
          f"step {resumed.restored_from} and trained steps "
          f"{CKPT_STEP + 1}-{TRAIN_STEPS} in {resume_s:.3f} s (GF(256) "
          f"launches {gf_restore}, recoveries {recoveries}): losses "
          f"{resumed.losses} == straight run's {straight.losses[CKPT_STEP:]}"
          f" within {LOSS_TOL}; the state restored again in "
          f"{restore_s:.3f} s (GF(256) launches {gf_restore2}) is "
          f"bit-identical to the saved one")
    del back, saved, first
    assert store.close()
    del store
    torch.cuda.empty_cache()

    # ---- (d) numbers --------------------------------------------------
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s = sorted(straight.step_seconds[1:])
    median = step_s[len(step_s) // 2]
    profile_train_step(dev, cfg, shape, median, card)
    flops = train_flops(cfg, tokens, TRAIN_SEQ, n_params)
    # bytes: the train state read once and written once
    b_ms, by = bound(2 * STATE_BYTES, flops, ops_per_s=BF16_FLOPS_PER_S)
    print(f"train step: median {median * 1e3:.3f} ms over steps 2-"
          f"{TRAIN_STEPS} (first step {straight.step_seconds[0] * 1e3:.3f}"
          f" ms) = {tokens / median:.1f} tokens/s | bound {b_ms:.3f} ms by "
          f"{by} ({flops} flops at the bf16 peak) = "
          f"{tokens / (b_ms / 1e3):.1f} tokens/s; "
          f"{100 * b_ms / 1e3 / median:.2f}% of it | {card}")
    mbs = STATE_BYTES / MB
    print(f"checkpoint save: {STATE_BYTES} bytes in {ck.save_s[0]:.3f} s = "
          f"{mbs / ck.save_s[0]:.1f} MB/s; restore after the slab failures "
          f"(train's resume, restore + {TRAIN_STEPS - CKPT_STEP} steps) "
          f"{resume_s:.3f} s; restore alone {restore_s:.3f} s = "
          f"{mbs / restore_s:.1f} MB/s | {card}")
    x = torch.randn((rows, cfg.d_model), device=dev, dtype=torch.bfloat16)
    dy = torch.randn_like(x)
    w = torch.ones(cfg.d_model, device=dev, dtype=torch.bfloat16)

    def kern():
        return rms_kernel.rms_norm_cuda(x, w, cfg.rms_eps)

    def lib():
        return F.rms_norm(x, (cfg.d_model,), w, cfg.rms_eps)

    # the input (8 MB) fits in L2: timed as it is (hot, the run before
    # leaves it there) and with L2 flushed before each run (cold)
    dst = torch.empty_like(x)              # a copy moves the same bytes
    ms, lib_ms = event_ms(kern, reps=50), event_ms(lib, reps=50)
    copy_ms = event_ms(lambda: dst.copy_(x), reps=50)
    # cold times drift within a run: the kernel's is taken first and
    # again last, around the others
    cold = [cold_ms(kern, reps=50)]
    lib_cold = cold_ms(lib, reps=50)
    copy_cold = cold_ms(lambda: dst.copy_(x), reps=50)
    cold.append(cold_ms(kern, reps=50))
    plain = event_ms(lambda: rms_norm_ref(x, w, cfg.rms_eps), reps=20)
    bwd = event_ms(lambda: rms_norm_backward(x, w, cfg.rms_eps, dy),
                   reps=20)
    nbytes = 2 * x.numel() * 2 + w.numel() * 2
    rb_ms, rby = bound(nbytes, 3 * x.numel(), ops_per_s=F32_FLOPS_PER_S)
    print(f"kernel rmsnorm train ln ({rows}, {cfg.d_model}) bf16: hot "
          f"{ms * 1e3:.2f} us, L2 flushed {cold[0] * 1e3:.2f} / "
          f"{cold[1] * 1e3:.2f} us (first / last) | bound "
          f"{rb_ms * 1e3:.2f} us by {rby} | plain {plain * 1e3:.2f} us | "
          f"F.rms_norm hot {lib_ms * 1e3:.2f} us, L2 flushed "
          f"{lib_cold * 1e3:.2f} us | device copy of x hot "
          f"{copy_ms * 1e3:.2f} us, L2 flushed {copy_cold * 1e3:.2f} us | "
          f"backward (plain torch, dx and "
          f"dscale) {bwd * 1e3:.2f} us | {card}")
    launches = {"rmsnorm_step1": rms_one, "rmsnorm_straight": rms_straight,
                "gf256_save": gf_save, "gf256_resume": gf_restore,
                "recoveries_resume": recoveries,
                "gf256_restore_again": gf_restore2}
    print("phase 10 launches: " + json.dumps(launches))
    return {"rmsnorm_launches": rms_one + rms_straight,
            "gf_launches": gf_save + gf_restore + gf_restore2,
            "grad_err": max(grad_err.values())}


# ---- scale-out: phase 11 -------------------------------------------------

SHARDS, TCP_SHARDS = 4, 2
BATCH_OBJECTS = 8                # the cross-shard put_many: 8 x 100 MB
TCP_OBJECTS = 4                  # (c): 4 x 100 MB
RING_CAP = 1024 * MB             # largest ring: a 400 MB object always fits


def store_mix(rand_u8, unit: int = MB):
    """Phase 2's mix, made on the device from the seed: 100 x 1, 30 x 10,
    16 x 100 and one 400 (in `unit`s, MB on the card), five of them
    passed as host bytes. Returns (objects, values to PUT)."""
    objects = {}
    for n, size, tag in ((100, 1, "small"), (30, 10, "medium"),
                         (16, 100, "large"), (1, 400, "huge")):
        for i in range(n):
            objects[f"{tag}/{i}"] = rand_u8(size * unit)
    host = {"small/0", "small/1", "small/2", "medium/0", "large/15"}
    values = {key: (t.cpu().numpy().tobytes() if key in host else t)
              for key, t in objects.items()}
    return objects, values


def keys_on(router, per_shard: int, tag: str, shards=None):
    """`per_shard` fresh keys on each of `shards` (all by default)."""
    want = dict.fromkeys(range(router.num_shards) if shards is None
                         else shards, per_shard)
    out, i = [], 0
    while any(want.values()):
        key = f"{tag}/{i}"
        i += 1
        sid = router.shard_of(key)
        if want.get(sid):
            want[sid] -= 1
            out.append(key)
    return out


def ring_bytes(rings: int):
    """Ring size for `rings` shared-memory rings: the largest that fits
    in 80% of /dev/shm's free space, up to `RING_CAP`. A write into an
    over-committed segment is a SIGBUS, so never more than is free.
    Returns (ring bytes, free bytes)."""
    import os
    st = os.statvfs("/dev/shm")
    free = st.f_bavail * st.f_frsize
    ring = min(RING_CAP, int(free * 0.8) // rings) // 4096 * 4096
    assert ring >= 1 * MB, f"/dev/shm has {free} bytes free"
    return ring, free


def ring_use(st) -> list:
    """Records (bytes, "a" ring or "i" inline) for every payload the
    process store's transports pack from here on."""
    seen = []
    for shard in st.shards:
        pack = shard._t.pack

        def counted(value, pack=pack):
            desc = pack(value)
            seen.append((desc[2] if desc[0] == "a" else len(desc[1]),
                         desc[0]))
            return desc
        shard._t.pack = counted
    return seen


def put_all(st, values) -> dict:
    """Every value PUT one at a time (each call returns at its ack);
    returns per-key seconds."""
    put_s = {}
    for key, val in values.items():
        t = time.perf_counter()
        assert st.put(key, val) == 1, key
        put_s[key] = time.perf_counter() - t
    return put_s


def get_all(st, objects, sync) -> dict:
    """Every object read back with `get_array`, bit for bit, on the
    device it was made on; returns per-key seconds."""
    import torch
    get_s = {}
    for key, want in objects.items():
        t = time.perf_counter()
        arr = st.get_array(key)
        sync()
        get_s[key] = time.perf_counter() - t
        assert arr.device == want.device and torch.equal(arr, want), key
    return get_s


def rate(objects, seconds, keys=None) -> float:
    """MB/s over `keys` (every timed key by default)."""
    keys = list(seconds) if keys is None else keys
    return (sum(objects[k].numel() for k in keys) / MB
            / sum(seconds[k] for k in keys))


def read_back(st, want, sync) -> None:
    import torch
    for key, val in want.items():
        arr = st.get_array(key)
        sync()
        assert torch.equal(arr, val), key


def two_pc(st, rand_u8, sync, unit: int, tag: str) -> dict:
    """The cross-shard checks on any `ShardedStore` frontend:
    - a `put_many` of 8 x 100 MB spanning every shard commits, timed
      beside a one-shard batch of the same bytes (no 2PC);
    - the leader crashing before its decision (`shard.decision`) rolls
      every prepared shard back: the old versions are read everywhere;
    - a commit submission lost after the decision (`shard.commit_submit`)
      leaves one shard in doubt; it is killed, and `restart_shard` (its
      journal replay and the `resolve_indoubt` sweep) rolls the batch
      forward: the new versions are read everywhere, nothing pending.
    Returns the timings."""
    from repro_torch.core import FaultPlan, FaultPoint, InjectedCrash
    keys = keys_on(st.router, BATCH_OBJECTS // st.num_shards, f"{tag}/2pc")

    def batch():
        return {key: rand_u8(100 * unit) for key in keys}

    def crash_at(site, values):
        st.faults = FaultPlan(seed=SEED).add(
            FaultPoint(site=site, action="crash", hits=(1,)))
        try:
            st.put_many(values)
        except InjectedCrash:
            return
        finally:
            st.faults = None
        raise AssertionError(f"no crash at {site}")

    out = {}
    old = batch()
    sync()
    t0 = st.tickets_issued()
    t = time.perf_counter()
    assert st.put_many(old) == dict.fromkeys(keys, 1)
    out["put_many_s"] = time.perf_counter() - t
    assert st.tickets_issued() == t0 + 1
    read_back(st, old, sync)
    one = keys_on(st.router, BATCH_OBJECTS, f"{tag}/one", shards=[0])
    t = time.perf_counter()
    assert st.put_many(dict(zip(one, old.values()))) == dict.fromkeys(one, 1)
    out["one_shard_s"] = time.perf_counter() - t
    assert st.tickets_issued() == t0 + 1       # no ticket: no 2PC

    crash_at("shard.decision", batch())
    assert st.indoubt_tickets() == []
    read_back(st, old, sync)

    new = batch()
    crash_at("shard.commit_submit", new)
    (ticket,) = st.indoubt_tickets()
    (sid,) = [i for i, s in enumerate(st.shards) if s.indoubt_tickets()]
    st.simulate_crash(shard=sid)
    sweeps = []
    sweep = st.resolve_indoubt

    def timed_sweep():
        t = time.perf_counter()
        res = sweep()
        sweeps.append((time.perf_counter() - t, res))
        return res
    st.resolve_indoubt = timed_sweep          # restart_shard's sweep
    try:
        t = time.perf_counter()
        st.restart_shard(sid)
        out["restart_s"] = time.perf_counter() - t
    finally:
        del st.resolve_indoubt
    out["resolve_s"], resolved = sweeps[-1]
    assert resolved == {ticket: "commit"}, resolved
    assert st.resolve_indoubt() == {} and st.indoubt_tickets() == []
    read_back(st, new, sync)
    out["in_doubt_shard"] = sid
    return out


def scale_out_phase(dev, work: Path, card: str, rand_u8, single: dict,
                    *, unit: int = MB, sync=None, cfg_kw=None) -> dict:
    """Phase 11: the three scale-out frontends at deployment size, each
    on the store's default configuration (RS(10+2), 1536 MB functions,
    200 MB fragments, spill journal on, recovery off):
    (a) `ShardedStore`, 4 shards in this process; (b) `ProcessShardedStore`,
    4 worker processes over shared-memory rings, each with its own CUDA
    context on the card; (c) `ProcessShardedStore`, 2 workers over TCP.
    `single` holds phase 2's rates; `unit`, `sync` and `cfg_kw` shrink it
    for a rehearsal on the CPU. Returns the codec kernel's launches in
    (a), where they are counted (the workers count their own)."""
    import os
    from multiprocessing import forkserver, resource_tracker

    import torch

    from repro_torch.core import ProcessShardedStore, ShardedStore
    from repro_torch.core import StoreConfig
    from repro_torch.core.ipc import SEGMENT_PREFIX
    from repro_torch.kernels.rs_gf256 import kernel
    sync = sync or torch.cuda.synchronize
    cfg_kw = dict(cfg_kw or {})

    def cfg(name):
        return StoreConfig(enable_recovery=False,
                           spill_dir=str(work / f"spill-{name}"), **cfg_kw)

    objects, values = store_mix(rand_u8, unit)
    total = sum(t.numel() for t in objects.values())
    large = [f"large/{i}" for i in range(15)]
    rows, two, wall = {"phase 2 single InfiniStore": single}, {}, {}

    def report(name, st, put_s, get_s, objs=objects):
        big = [k for k in large if k in objs] or list(objs)
        rows[name] = {"put": rate(objs, put_s),
                      "put_large": rate(objs, put_s, big),
                      "get": rate(objs, get_s),
                      "get_large": rate(objs, get_s, big)}
        print(f"phase 11{name[0]} {name}: {len(objs)} objects, "
              f"{sum(t.numel() for t in objs.values())} bytes PUT and read "
              f"back bit for bit; shard balance {st.shard_balance()}")

    # ---- (a) ShardedStore, 4 shards in this process ----------------------
    t_a = time.perf_counter()
    st = ShardedStore(cfg("a"), num_shards=SHARDS, seed=SEED)
    assert (st.cfg.ec.k, st.cfg.ec.p) == (10, 2) and st.device == dev
    kernel.launches = kernel.gather_launches = 0
    put_s = put_all(st, values)
    report("a ShardedStore", st, put_s, get_all(st, objects, sync))
    two["a"] = two_pc(st, rand_u8, sync, unit, "a")
    # a degraded GET on one shard: a reclaimed slab is read through parity
    assert st.flush_writeback(timeout=600.0)
    key = next(k for k in large if st.router.shard_of(k) == 1)
    shard = st.shards[1]
    fid = shard.chunk_map[f"{key}|1/f0#0"]
    shard.inject_failure(fid)
    inv0 = shard.codec.cache_info()["inversions"]
    read_back(st, {key: objects[key]}, sync)
    assert shard.codec.cache_info()["inversions"] > inv0
    launches = codec_launches()
    assert launches >= len(values), launches
    assert st.close()
    del st, shard
    print(f"phase 11a 2PC: 8 x 100 MB over {SHARDS} shards committed; "
          f"decision crash rolled back; commit_submit crash on shard "
          f"{two['a']['in_doubt_shard']} rolled forward by restart_shard "
          f"+ resolve_indoubt; degraded GET of {key} on shard 1 through "
          f"parity (slab {fid}); codec kernel launches {launches}")
    shutil.rmtree(work / "spill-a", ignore_errors=True)
    wall["a"] = time.perf_counter() - t_a

    # ---- (b) ProcessShardedStore, 4 workers over shm rings ---------------
    t_b = time.perf_counter()
    ring, shm_free = ring_bytes(2 * SHARDS)
    st = ProcessShardedStore(cfg("b"), num_shards=SHARDS, seed=SEED,
                             cos_root=str(work / "cos-b"), arena_bytes=ring)
    boot_s = time.perf_counter() - t_b
    assert st.worker_devices() == [dev.type] * SHARDS, st.worker_devices()
    print(f"phase 11b workers: pids {st.worker_pids()} on "
          f"{st.worker_devices()}, booted in {boot_s:.3f} s; rings {ring} "
          f"bytes x {2 * SHARDS} (/dev/shm {shm_free} bytes free)")
    packed = ring_use(st)
    put_s = put_all(st, values)
    by_path = {}
    for n, how in packed:
        path = f"{n} bytes {'ring' if how == 'a' else 'inline'}"
        by_path[path] = by_path.get(path, 0) + 1
    print(f"phase 11b PUT payloads by size and path: {json.dumps(by_path)}")
    # SIGKILL one worker holding acked, unpersisted writes: the others
    # keep serving; its restart replays its journal on the card; then
    # every acked object is read back (the timed GET of the mix)
    st.pause_writeback()
    victim = 2
    acked = {k: rand_u8(n * unit) for k, n in zip(
        keys_on(st.router, 4, "b/kill", shards=[victim]), (100, 100, 10, 1))}
    put_all(st, acked)
    st.simulate_crash(shard=victim)
    others = [k for k in objects if st.router.shard_of(k) != victim]
    read_back(st, {k: objects[k] for k in others[::8]}, sync)
    t = time.perf_counter()
    st.restart_shard(victim)
    restart_s = time.perf_counter() - t
    st.resume_writeback()
    assert st.worker_devices()[victim] == dev.type
    get_s = get_all(st, objects, sync)
    read_back(st, acked, sync)
    report("b ProcessShardedStore shm", st, put_s, get_s)
    print(f"phase 11b kill/restart: worker {victim} SIGKILLed holding "
          f"{len(acked)} acked unpersisted objects; the other shards served "
          f"{len(others[::8])} reads meanwhile; restart_shard (journal "
          f"replay on the card) {restart_s:.3f} s; every acked object read "
          f"back after it")
    two["b"] = two_pc(st, rand_u8, sync, unit, "b")
    assert st.flush_writeback(timeout=600.0)
    assert st.close()
    del st
    mine = f"{SEGMENT_PREFIX}{os.getpid()}-"
    assert not [n for n in os.listdir("/dev/shm") if n.startswith(mine)]
    shutil.rmtree(work / "spill-b", ignore_errors=True)
    shutil.rmtree(work / "cos-b", ignore_errors=True)
    wall["b"] = time.perf_counter() - t_b

    # ---- (c) ProcessShardedStore, 2 workers over TCP ---------------------
    t_c = time.perf_counter()
    st = ProcessShardedStore(cfg("c"), num_shards=TCP_SHARDS, seed=SEED,
                             cos_root=str(work / "cos-c"), transport="tcp")
    assert st.worker_devices() == [dev.type] * TCP_SHARDS
    keys = keys_on(st.router, TCP_OBJECTS // TCP_SHARDS, "c")
    tcp_obj = {k: rand_u8(100 * unit) for k in keys}
    put_s = put_all(st, tcp_obj)
    report("c ProcessShardedStore tcp", st, put_s,
           get_all(st, tcp_obj, sync), tcp_obj)
    newer = {k: rand_u8(100 * unit) for k in keys}
    t = time.perf_counter()
    assert st.put_many(newer) == dict.fromkeys(keys, 2)
    tcp_2pc_s = time.perf_counter() - t
    read_back(st, newer, sync)
    st.pause_writeback()
    acked = {keys_on(st.router, 1, "c/kill", shards=[0])[0]:
             rand_u8(100 * unit)}
    put_all(st, acked)
    st.simulate_crash(shard=0)
    t = time.perf_counter()
    st.restart_shard(0)
    tcp_restart_s = time.perf_counter() - t
    st.resume_writeback()
    read_back(st, {**newer, **acked}, sync)
    assert st.flush_writeback(timeout=600.0)
    print(f"phase 11c tcp: {TCP_SHARDS} workers on {st.worker_devices()}; "
          f"a cross-shard put_many of the {len(keys)} x 100 MB in "
          f"{tcp_2pc_s:.3f} s; worker 0 SIGKILLed holding 1 acked "
          f"unpersisted object and restarted in {tcp_restart_s:.3f} s; all "
          f"read back bit for bit")
    assert st.close()
    del st
    shutil.rmtree(work / "spill-c", ignore_errors=True)
    shutil.rmtree(work / "cos-c", ignore_errors=True)
    wall["c"] = time.perf_counter() - t_c
    # the workers are gone; so go the forkserver they were forked from
    # and the shared-memory resource tracker
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()

    for name, r in rows.items():
        print(f"scale-out {name}: PUT-ack {r['put']:.1f} MB/s (100 MB "
              f"objects {r['put_large']:.1f}), GET get_array "
              f"{r['get']:.1f} MB/s (100 MB objects {r['get_large']:.1f}) "
              f"| {card}")
    for name, tp in two.items():
        print(f"scale-out 2PC ({name}): put_many of 8 x 100 MB over "
              f"{SHARDS} shards {tp['put_many_s']:.3f} s beside "
              f"{tp['one_shard_s']:.3f} s for the same bytes on one shard; "
              f"restart_shard {tp['restart_s']:.3f} s, its resolve_indoubt "
              f"sweep {tp['resolve_s']:.3f} s | {card}")
    print(f"scale-out restart_shard after a SIGKILL (journal replay on the "
          f"card): shm {restart_s:.3f} s, tcp {tcp_restart_s:.3f} s; wall "
          f"time (a) {wall['a']:.1f} s, (b) {wall['b']:.1f} s, (c) "
          f"{wall['c']:.1f} s; os.cpu_count() {os.cpu_count()} | {card}")
    return {"launches": launches}


# ---- the MoE, RWKV6 and RG-LRU families: phase 12 -------------------------

QWEN_MOE, RWKV6, RGEMMA = "qwen2-moe-a2.7b", "rwkv6-3b", "recurrentgemma-2b"
MOE_NEW_TOKENS = 32
MOE_MAX_LEN = 2112               # 33 pages of 64: prompt + 32 new tokens
MOE_F32_LAYERS = 4               # of 24: the f32 copy beside the bf16 model
MOE_DENSE_SHAPE = (2, 128)       # (B, S) of the MoE-vs-dense check
REC_BATCH, REC_STEPS = 8, 32
RWKV_PROMPT = 2048
RGEMMA_PROMPT = 3000             # past the 2048-token window, not a multiple
RWKV_TF, RGEMMA_TF = (2, 256), (2, 2100)    # f32 teacher forcing: (B, S)
RGEMMA_TF_STEPS = 4
TF_DECODE_TOL = 5e-4             # tests/test_models_smoke.py's
# at full width the forward differs from itself by ~2e-4 between two
# sequence lengths (RG-LRU's attention scores spread by ~256 under the
# reference's init): the decode path is held within 4x that floor
TF_FLOOR_FACTOR = 4
WKV_TOL = 2e-3                   # tests/test_rwkv.py's chunked vs scan
SCAN_TOL = 1e-5
MOE_DENSE_TOL = 1e-4             # tests/test_moe.py's


class DispatchRecorder:
    """While installed, wraps `moe.dispatch_indices`: per call, the
    tokens per group, the (token, expert) pairs that capacity dropped and
    the experts that got a pair, kept as device tensors (no host
    sync)."""

    def __init__(self, moe_mod):
        self.mod, self.orig = moe_mod, moe_mod.dispatch_indices
        self.calls = []

    def __enter__(self):
        import torch

        def wrapped(expert_ids, gate_vals, num_experts, cap):
            disp, gate_slot = self.orig(expert_ids, gate_vals, num_experts,
                                        cap)
            T = expert_ids.shape[-2]
            dropped = expert_ids.numel() - (disp < T).sum()
            used = (torch.bincount(expert_ids.reshape(-1),
                                   minlength=num_experts) > 0).sum()
            self.calls.append((T, expert_ids.numel(), dropped, used))
            return disp, gate_slot

        self.mod.dispatch_indices = wrapped
        return self

    def __exit__(self, *exc):
        self.mod.dispatch_indices = self.orig


def paged_attention_f64(q, k_pool, v_pool, block_table, lens):
    """The plain paged decode attention (`paged_attention.ref`) computed
    in float64 throughout: the exact answer the f32 versions round."""
    import math

    import torch
    B, H, hd = q.shape
    _, P, ps, K, _ = k_pool.shape
    rows = torch.arange(B, device=q.device)[:, None]
    idx = block_table.long()
    k = k_pool[rows, idx].reshape(B, P * ps, K, hd).double()
    v = v_pool[rows, idx].reshape(B, P * ps, K, hd).double()
    s = torch.einsum("bkgd,btkd->bkgt",
                     q.reshape(B, K, H // K, hd).double(), k) / math.sqrt(hd)
    pos = torch.arange(P * ps, device=q.device)
    s = torch.where((pos[None, :] < lens[:, None])[:, None, None, :], s,
                    -1e300)
    return torch.einsum("bkgt,btkd->bkgd", torch.softmax(s, dim=-1),
                        v).reshape(B, H, hd)


class DecodeAttentionProbe:
    """While installed, wraps the decode attention the transformer calls:
    the paged kernel (`transformer.paged_decode_attention`) or the plain
    path's `layers.decode_attention_grouped`, and keeps every call's
    output in f32. Each kernel call is checked on its own inputs: in
    bf16 against the plain version within phase 6's tolerance; in f32
    against the exact (float64) answer, no farther from it than the f32
    plain version is, or than phase 6's f32 tolerance times the output's
    largest magnitude (it raises otherwise). On the plain path it takes
    the attention scores' spread and the gap between each query's two
    largest scores at call `probe`."""

    def __init__(self, transformer_mod, layers_mod, probe: int = 1):
        self.t, self.l = transformer_mod, layers_mod
        self.paged = transformer_mod.paged_decode_attention
        self.grouped = layers_mod.decode_attention_grouped
        self.outs, self.errs, self.plain_errs = [], [], []
        self.probe, self.scores = probe, None

    def __enter__(self):
        import math

        import torch
        from repro_torch.kernels.paged_attention.ref import \
            paged_decode_attention_ref

        def paged(q, kc, vc, table, lens):
            out = self.paged(q, kc, vc, table, lens)
            want = paged_decode_attention_ref(q, kc, vc, table, lens)
            if q.dtype == torch.bfloat16:
                torch.testing.assert_close(out.float(), want,
                                           atol=PA_TOL["bfloat16"],
                                           rtol=PA_TOL["bfloat16"])
                self.errs.append(float((out.float() - want).abs().max()))
            else:
                exact = paged_attention_f64(q, kc, vc, table, lens)
                err = float((out.double() - exact).abs().max())
                plain = float((want.double() - exact).abs().max())
                limit = max(plain, PA_TOL["float32"]
                            * float(exact.abs().max()))
                assert err <= limit, (err, plain, limit)
                self.errs.append(err)
                self.plain_errs.append(plain)
            self.outs.append(out.float()[:, None])
            return out

        def grouped(q, kc, vc, cache_len, **kw):
            out = self.grouped(q, kc, vc, cache_len, **kw)
            if len(self.outs) == self.probe:
                n = int(cache_len)
                G = q.shape[2] // kc.shape[2]
                k = kc[:, :n].float().repeat_interleave(G, dim=2)
                s = torch.einsum("bhd,bthd->bht", q[:, 0].float(), k) \
                    / math.sqrt(q.shape[-1])
                top = s.topk(2, dim=-1).values
                self.scores = (float(s.std()),
                               float((top[..., 0] - top[..., 1]).median()))
            self.outs.append(out.float())
            return out

        self.t.paged_decode_attention = paged
        self.l.decode_attention_grouped = grouped
        return self

    def __exit__(self, *exc):
        self.t.paged_decode_attention = self.paged
        self.l.decode_attention_grouped = self.grouped


def param_bytes(params, skip=()) -> int:
    return sum(p.numel() * p.element_size() for k, p in params.items()
               if not k.startswith(skip))


def step_times(seconds) -> str:
    ms = sorted(x * 1e3 for x in seconds)
    return f"median {ms[len(ms) // 2]:.3f} ms, max {ms[-1]:.3f} ms"


def greedy_steps(model, params, tok, state, steps):
    """`steps` greedy decode steps of a recurrent model, each timed up to
    its tokens reaching the host: (tokens (B, steps), seconds, state)."""
    import torch
    toks, secs = [], []
    for _ in range(steps):
        t = time.perf_counter()
        lg, state = model.decode_step(params, {"token": tok}, state)
        tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        toks.append(tok[:, 0].cpu())
        secs.append(time.perf_counter() - t)
    return torch.stack(toks, 1), secs, state


def teacher_forcing_check(model, params, toks, S, steps):
    """Largest |logit| difference between prefill(toks[:, :S]) + `steps`
    decode steps fed toks[:, S + i] and one forward over all S + steps
    tokens (tests/test_models_smoke.py's check, extended over steps),
    and the f32 floor of that comparison: the largest difference of the
    forward with itself at the same positions, run over S + i + 1
    tokens instead (the same function, blocked and summed otherwise)."""
    full, _ = model.forward(params, {"tokens": toks})
    _, state = model.prefill(params, {"tokens": toks[:, :S]})
    worst = floor = 0.0
    for i in range(steps):
        lg, state = model.decode_step(params, {"token": toks[:, S + i:
                                                             S + i + 1]},
                                      state)
        worst = max(worst, float((lg[:, 0] - full[:, S + i]).abs().max()))
        if steps > 1:
            part, _ = model.forward(params, {"tokens": toks[:, :S + i + 1]})
            floor = max(floor, float((part[:, -1] - full[:, S + i]).abs()
                                     .max()))
            del part
    del full, state
    return worst, floor


def rms_at(dev, shapes, card, label) -> dict:
    """RMSNorm kernel vs its plain version at `shapes` in f32 and bf16
    (max abs error), then timed in bf16 at the first shape (the prefill
    ln) and the last (the decode ln) beside its bound, the plain version,
    `F.rms_norm` and a device copy of x."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.kernels.rmsnorm.ops import rms_norm_op
    from repro_torch.kernels.rmsnorm.ref import rms_norm_ref
    worst = 0.0
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        for i, shape in enumerate(shapes):
            gen = torch.Generator(device=dev)
            gen.manual_seed(i)
            x = torch.randn(shape, generator=gen, device=dev).to(dtype)
            w = (torch.randn(shape[-1:], generator=gen, device=dev) * 0.1
                 + 1.0).to(dtype)
            got, want = rms_norm_op(x, w), rms_norm_ref(x, w)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(),
                                       atol=RMS_TOL[dname],
                                       rtol=RMS_TOL[dname])
            worst = max(worst, float((got.float() - want.float()).abs()
                                     .max()))
    out = {"max_abs_err": worst}
    for shape, which in ((shapes[0], "prefill ln"), (shapes[-1],
                                                     "decode ln")):
        x = torch.randn(shape, device=dev, dtype=torch.bfloat16)
        w = torch.ones(shape[-1], device=dev, dtype=torch.bfloat16)
        ms = event_ms(lambda: rms_kernel.rms_norm_cuda(x, w, 1e-6), reps=50)
        plain = event_ms(lambda: rms_norm_ref(x, w, 1e-6), reps=10)
        lib_ms = event_ms(lambda: F.rms_norm(x, (shape[-1],), w, 1e-6),
                          reps=50)
        dst = torch.empty_like(x)
        copy_ms = event_ms(lambda: dst.copy_(x), reps=50)
        nbytes = 2 * x.numel() * 2 + w.numel() * 2
        b_ms, by = bound(nbytes, 3 * x.numel(), ops_per_s=F32_FLOPS_PER_S)
        lay = rms_kernel.plan(shape[-1], 2, True, x.numel() // shape[-1],
                              _build.sm_count(dev))
        out[which] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=by,
                          library_ms=lib_ms)
        print(f"kernel rmsnorm {label} {which} {shape} bf16 ({lay}): "
              f"{ms * 1e3:.2f} us = {100 * b_ms / ms:.1f}% of its bound | "
              f"bound {b_ms * 1e3:.2f} us by {by} ({nbytes} bytes) | plain "
              f"{plain * 1e3:.2f} us | F.rms_norm {lib_ms * 1e3:.2f} us | "
              f"device copy of x {copy_ms * 1e3:.2f} us | {card}")
    return out


def moe_prefill_flops(cfg, B: int, S: int, kept_pairs: int) -> int:
    """Matrix-product flops of an MoE prefill: per token the attention
    projections, the router and the shared expert; causal attention; the
    routed experts for the (token, expert) pairs kept (summed over
    layers), and the last token's logits."""
    d, H, K, hd, m = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.head_dim, cfg.moe)
    per_tok = 2 * (d * H * hd + 2 * d * K * hd + H * hd * d
                   + d * m.num_experts + 3 * d * m.d_shared + d)
    attn = 2 * 2 * H * hd * (S * (S + 1) // 2)
    return cfg.num_layers * B * (S * per_tok + attn) \
        + kept_pairs * 2 * 3 * d * m.d_expert + 2 * B * cfg.vocab_size * d


def moe_serve(dev, card, cfg) -> dict:
    """Phase 12 (a): Qwen1.5-MoE-A2.7B served at published widths and
    full depth by `ServeEngine` over the SMS-paged KV cache, the kernel
    path held to the plain contiguous path, the MoE FFN to its dense
    oracle and to itself, f32 tokens at 4 of 24 layers, and paged
    attention timed at G = 1."""
    import dataclasses

    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    from repro_torch.kernels.paged_attention.ref import \
        paged_decode_attention_ref
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.kernels.rs_gf256 import kernel as gf_kernel
    from repro_torch.models import build_model, layers, moe, transformer
    from repro_torch.models.transformer import (_gather_pages, _split_layers,
                                                init_params)
    from repro_torch.serving import ServeConfig, ServeEngine

    m = cfg.moe
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t = time.perf_counter()
    params = init_params(cfg, gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.values())
    weight_bytes = param_bytes(params)
    print(f"phase 12a model: {QWEN_MOE} at published widths and depth, "
          f"{n_params} params ({weight_bytes} bytes bf16) from seed {SEED} "
          f"on the card in {time.perf_counter() - t:.3f} s")

    eng = ServeEngine(cfg, ServeConfig(batch_slots=SLOTS, max_len=MOE_MAX_LEN,
                                       page_size=PAGE),
                      params=params, device=dev)
    kv = eng.kv
    rng = np.random.default_rng(SEED + 12)
    prompts = rng.integers(0, cfg.vocab_size, (SLOTS, PROMPT)).astype(
        np.int32)
    torch.cuda.synchronize()
    rms_kernel.launches = pa_kernel.launches = 0
    gf_kernel.launches = gf_kernel.gather_launches = 0
    t = time.perf_counter()
    out = eng.generate(prompts, MOE_NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {"rmsnorm": rms_kernel.launches,
                "paged_decode_attention": pa_kernel.launches,
                "gf256_matmul_bitsliced": codec_launches()}
    per_step_rms = 2 * cfg.num_layers + 1
    assert launches["paged_decode_attention"] == \
        cfg.num_layers * MOE_NEW_TOKENS, launches
    assert launches["rmsnorm"] == per_step_rms * (MOE_NEW_TOKENS + 1), \
        launches
    assert launches["gf256_matmul_bitsliced"] == 0, launches
    assert out.shape == (SLOTS, MOE_NEW_TOKENS) and out.dtype == np.int32
    assert ((out >= 0) & (out < cfg.vocab_size)).all()
    st = eng.stats
    print(f"phase 12a serve: {SLOTS} x {PROMPT}-token prompts, "
          f"{MOE_NEW_TOKENS} new tokens each in {wall:.3f} s (capacity "
          f"{moe.capacity(cfg, PROMPT)} per expert and sequence in the "
          f"prefill); launches {json.dumps(launches)} = {cfg.num_layers} "
          f"paged attention and {per_step_rms} RMSNorm per decode step, "
          f"{per_step_rms} RMSNorm in the prefill; first tokens "
          f"{out[0, :8].tolist()}")

    # paged attention at this shape (G = 1), the final length
    length = PROMPT + MOE_NEW_TOKENS
    q = torch.randn((SLOTS, cfg.num_heads, cfg.head_dim), device=dev,
                    dtype=torch.bfloat16)
    kc, vc = kv.k_pool[0], kv.v_pool[0]
    table = torch.tensor(kv.table, device=dev)
    lens = torch.full((SLOTS,), length, dtype=torch.int32, device=dev)
    B, P, ps, K, hd = kc.shape
    pa_bytes = 2 * q.numel() * 2 + kv_bytes(cfg, SLOTS, length) \
        // cfg.num_layers + table.numel() * 4 + lens.numel() * 4
    pa_flops = 4 * SLOTS * cfg.num_heads * cfg.head_dim * length
    pos = torch.arange(P * ps, device=dev)
    mask = (pos[None, :] < lens[:, None])[:, None, None, :]
    got = pa_kernel.paged_decode_attention_cuda(q, kc, vc, table, lens)
    want = paged_decode_attention_ref(q, kc, vc, table, lens)
    torch.cuda.synchronize()
    pa_err = float((got.float() - want).abs().max())
    torch.testing.assert_close(got.float(), want, atol=PA_TOL["bfloat16"],
                               rtol=PA_TOL["bfloat16"])

    def sdpa():
        kf = _gather_pages(kc, table).transpose(1, 2)      # (B, K, T, hd)
        vf = _gather_pages(vc, table).transpose(1, 2)
        return F.scaled_dot_product_attention(q[:, :, None], kf, vf,
                                              attn_mask=mask)

    ms = event_ms(lambda: pa_kernel.paged_decode_attention_cuda(
        q, kc, vc, table, lens), reps=50)
    plain = event_ms(lambda: paged_decode_attention_ref(q, kc, vc, table,
                                                        lens), reps=5)
    lib_ms = event_ms(sdpa, reps=10)
    b_ms, by = bound(pa_bytes, pa_flops, ops_per_s=F32_FLOPS_PER_S)
    occ = pa_kernel._blocks_per_sm(dev, hd, 1, pa_kernel.DTYPES[q.dtype], P)
    splits, pps = pa_kernel.split_pages(B, K, 1, P, _build.sm_count(dev),
                                        occ)
    pa_timing = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=by,
                     library_ms=lib_ms)
    print(f"kernel paged_decode_attention {QWEN_MOE} (B={B}, H=K={K}, G=1, "
          f"hd={hd}, {P} pages of {ps}, lens {length}, bf16; {occ} blocks "
          f"per SM, {splits} splits of {pps} pages): {ms * 1e3:.1f} us = "
          f"{100 * b_ms / ms:.1f}% of its bound | bound {b_ms * 1e3:.1f} us "
          f"by {by} ({pa_bytes} bytes, {pa_flops} flops) | plain "
          f"{plain * 1e3:.1f} us | _gather_pages + sdpa {lib_ms * 1e3:.1f} "
          f"us | max_abs_err vs plain {pa_err:.3e} (largest |output| "
          f"{float(want.abs().max()):.3e}) | {card}")
    del eng, kv, kc, vc, q
    torch.cuda.empty_cache()

    # ---- the kernel path against the plain contiguous path (bf16) -----
    torch.backends.cuda.matmul.allow_tf32 = False
    paged_m = build_model(cfg, kv_layout="paged", page_size=PAGE)
    plain_m = build_model(cfg, kv_layout="contiguous")
    toks = torch.from_numpy(out).to(dev)
    dev_prompts = torch.from_numpy(prompts).to(dev)
    with DispatchRecorder(moe) as rec, \
            DecodeAttentionProbe(transformer, layers) as probe_k:
        lg_k, _ = teacher_forced(paged_m, params, dev_prompts, toks,
                                 MOE_MAX_LEN)
    with DecodeAttentionProbe(transformer, layers) as probe_p:
        lg_p, _ = teacher_forced(plain_m, params, dev_prompts, toks,
                                 PROMPT + MOE_NEW_TOKENS)
    assert torch.isfinite(lg_k).all() and torch.isfinite(lg_p).all()
    # the kernel path re-run outside the engine gives the engine's tokens
    assert torch.equal(lg_k.argmax(-1).to(torch.int32).cpu(),
                       torch.from_numpy(out))
    nl = cfg.num_layers
    assert len(probe_k.errs) == len(probe_p.outs) == nl * MOE_NEW_TOKENS
    call_err = max(probe_k.errs)
    # where the two paths part at the first decode step: each layer's
    # attention output, as a share of the plain path's largest
    part = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(probe_k.outs[:nl], probe_p.outs[:nl])]
    bf16_diff = float((lg_k - lg_p).abs().max())
    step0 = float((lg_k[:, 0] - lg_p[:, 0]).abs().max())
    agree = float((lg_k.argmax(-1) == lg_p.argmax(-1)).float().mean())
    spread, gap = probe_p.scores
    del probe_k, probe_p
    calls = [(T, n, int(d), int(u)) for T, n, d, u in rec.calls]
    pre = [c for c in calls if c[0] == PROMPT]
    dec = [c for c in calls if c[0] == 1]
    assert len(pre) == cfg.num_layers and \
        len(dec) == cfg.num_layers * MOE_NEW_TOKENS, (len(pre), len(dec))
    dropped = sum(c[2] for c in pre)
    kept = sum(c[1] for c in pre) - dropped
    assert sum(c[2] for c in dec) == 0
    print(f"phase 12a bf16 check: the paged kernel at every one of the "
          f"{nl * MOE_NEW_TOKENS} (step, layer) calls of the teacher-forced "
          f"kernel path against the plain version on the same inputs: "
          f"max_abs_err {call_err:.3e} (tol {PA_TOL['bfloat16']} abs + "
          f"rel); the whole model against the plain contiguous path "
          f"(decode_attention_grouped, no paged kernel), teacher-forced on "
          f"the engine's tokens, {SLOTS} x {MOE_NEW_TOKENS} steps: largest "
          f"logit difference {bf16_diff:.4e} (first step {step0:.4e}; "
          f"phase 7's tol {LOGIT_TOL['bfloat16']} is not held here), argmax"
          f" agreement {agree:.4f}, logits std {float(lg_p.std()):.4f}; at "
          f"the first step each layer's attention output differs by "
          f"{', '.join(f'{x:.3g}' for x in part)} of its largest value: "
          f"without qk_norm and with wq, wk drawn at 1/sqrt({cfg.num_heads})"
          f" (the reference's fan_in), layer 1's scores spread by "
          f"{spread:.1f} with a median gap of {gap:.1f} between each "
          f"query's two largest, so its softmax is nearly one-hot and a "
          f"bf16 rounding difference from layer 0 moves it")
    print(f"phase 12a prefill (token, expert) pairs dropped by capacity: "
          f"{dropped} of {dropped + kept} "
          f"({100 * dropped / (dropped + kept):.2f}%), per layer "
          f"{[c[2] for c in pre]}")
    del lg_k, lg_p

    # ---- the MoE FFN against its dense oracle, and against itself -----
    _, lyr = _split_layers(params)
    lp32 = {k: v[0].float() for k, v in lyr.items()}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    free = dataclasses.replace(cfg32, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))   # capacity = S
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    x = torch.randn(MOE_DENSE_SHAPE + (cfg.d_model,), generator=g,
                    device=dev)
    y_moe, a_moe = moe.moe_ffn(free, lp32, x)
    y_dense, a_dense = moe.moe_ffn_dense(free, lp32, x)
    torch.cuda.synchronize()
    dense_err = float((y_moe - y_dense).abs().max())
    torch.testing.assert_close(y_moe, y_dense, atol=MOE_DENSE_TOL,
                               rtol=MOE_DENSE_TOL)
    assert abs(float(a_moe) - float(a_dense)) < 1e-6
    xs = torch.randn((4, PROMPT, cfg.d_model), generator=g, device=dev)
    runs = [moe.moe_ffn(cfg32, lp32, xs)[0] for _ in range(2)]
    torch.cuda.synchronize()
    same = torch.equal(runs[0], runs[1])
    print(f"phase 12a MoE FFN (layer 0 at full width, f32): moe_ffn at "
          f"drop-free capacity vs moe_ffn_dense on {MOE_DENSE_SHAPE} tokens"
          f": max_abs_err {dense_err:.3e} (tol {MOE_DENSE_TOL}), aux "
          f"{float(a_moe):.6f} vs {float(a_dense):.6f}; two runs at the "
          f"published capacity on 4 x {PROMPT} tokens (combine by "
          f"index_put_(accumulate=True)) bit-identical: {same}")
    assert same
    del lp32, x, xs, runs, y_moe, y_dense

    # ---- f32 tokens at full width, 4 of 24 layers ----------------------
    cfg4 = dataclasses.replace(cfg32, num_layers=MOE_F32_LAYERS)
    params32 = {k: (v[:MOE_F32_LAYERS] if k.startswith("layers/") else v)
                .float() for k, v in params.items()}
    p32 = dev_prompts[:F32_SLOTS, :F32_PROMPT]
    eng32 = ServeEngine(cfg4, ServeConfig(
        batch_slots=F32_SLOTS, max_len=F32_PROMPT + 2 * PAGE,
        page_size=PAGE), params=params32, device=dev)
    out32 = eng32.generate(p32.cpu().numpy(), F32_STEPS)
    del eng32
    with DecodeAttentionProbe(transformer, layers) as probe32:
        tok_k, lg32_k = greedy(build_model(cfg4, kv_layout="paged",
                                           page_size=PAGE), params32, p32,
                               F32_STEPS, F32_PROMPT + 2 * PAGE)
    f32_call, f32_plain = max(probe32.errs), max(probe32.plain_errs)
    tok_p, lg32_p = greedy(build_model(cfg4, kv_layout="contiguous"),
                           params32, p32, F32_STEPS, F32_PROMPT + F32_STEPS)
    f32_diff = float((lg32_k - lg32_p).abs().max())
    print(f"phase 12a f32 check: {QWEN_MOE} at full width, "
          f"{MOE_F32_LAYERS} of {cfg.num_layers} layers in f32 (reduced: "
          f"57 GB of f32 weights do not fit beside the bf16 model), "
          f"{F32_SLOTS} x {F32_PROMPT}-token prompts, {F32_STEPS} greedy "
          f"steps: engine (paged kernel) tokens {out32[0].tolist()}..., "
          f"plain contiguous path equal: {bool(torch.equal(tok_k, tok_p))};"
          f" the paged kernel at each of its {len(probe32.errs)} calls "
          f"against the exact (float64) answer on the same inputs: "
          f"max_abs_err {f32_call:.3e}, the f32 plain version's "
          f"{f32_plain:.3e} (each call held to the larger of the plain "
          f"version's error and {PA_TOL['float32']} x its largest output);"
          f" largest logit difference {f32_diff:.4e} (phase 7's tol "
          f"{LOGIT_TOL['float32']} is not held here: the nearly one-hot "
          f"softmax of the bf16 check)")
    assert np.array_equal(out32, tok_k.cpu().numpy())
    assert torch.equal(tok_k, tok_p), (tok_k, tok_p)
    del params32, lg32_k, lg32_p, probe32

    # ---- numbers --------------------------------------------------------
    flops = moe_prefill_flops(cfg, SLOTS, PROMPT, kept)
    pre_b, pre_by = bound(weight_bytes + kv_bytes(cfg, SLOTS, PROMPT),
                          flops, ops_per_s=BF16_FLOPS_PER_S)
    print(f"phase 12a prefill: {SLOTS} x {PROMPT} tokens in "
          f"{st.prefill_seconds:.3f} s = "
          f"{SLOTS * PROMPT / st.prefill_seconds:.1f} tokens/s | bound "
          f"{pre_b:.3f} ms by {pre_by} ({flops} flops at the bf16 peak, "
          f"{kept} routed pairs) = {SLOTS * PROMPT / (pre_b / 1e3):.1f} "
          f"tokens/s; {100 * pre_b / 1e3 / st.prefill_seconds:.2f}% of it "
          f"| {card}")
    # each step reads every weight but the experts, the experts its
    # tokens were routed to (per layer), and the valid KV
    expert_bytes = 3 * cfg.d_model * m.d_expert * 2
    fixed = param_bytes(params, skip=("layers/we_", "embed")) \
        + SLOTS * cfg.d_model * 2
    used = [sum(c[3] for c in dec[i * cfg.num_layers:
                                  (i + 1) * cfg.num_layers])
            for i in range(MOE_NEW_TOKENS)]
    step_b = [bound(fixed + used[i] * expert_bytes
                    + kv_bytes(cfg, SLOTS, PROMPT + i + 1))[0]
              for i in range(MOE_NEW_TOKENS)]
    secs = st.step_seconds
    med = sorted(secs)[len(secs) // 2]
    med_b = sorted(step_b)[len(step_b) // 2]
    print(f"phase 12a decode: {SLOTS * MOE_NEW_TOKENS} tokens in "
          f"{st.decode_seconds:.3f} s = "
          f"{SLOTS * MOE_NEW_TOKENS / st.decode_seconds:.1f} tokens/s; step "
          f"{step_times(secs)} over {len(secs)} | bytes each step reads at "
          f"3.35 TB/s: {min(step_b):.3f}-{max(step_b):.3f} ms (weights but "
          f"the experts {fixed} bytes, {min(used)}-{max(used)} routed "
          f"experts of {cfg.num_layers * m.num_experts} at {expert_bytes} "
          f"bytes, valid KV); median at {100 * med_b / (med * 1e3):.2f}% "
          f"of it | {card}")
    # phase 14(b)'s card side: one more prefill and one decode step of
    # the dry-run's own path (pages of 256), counted
    model = build_model(cfg)
    dry = {"moe_prefill": _counted(
        dev, lambda: model.prefill(params, {"tokens": dev_prompts},
                                   max_len=PROMPT),
        (params, {"tokens": dev_prompts}), [st.prefill_seconds])}
    cache = model.init_cache(SLOTS, MOE_MAX_LEN, device=dev)
    tok = dev_prompts[:, :1]
    dry["moe_decode"] = _counted(
        dev, lambda: model.decode_step(params, {"token": tok}, cache),
        (params, {"token": tok}, cache), secs)
    dry["moe_decode"]["gathered_flops"] = (
        4 * SLOTS * cfg.num_heads * cfg.head_dim * cfg.num_layers
        * cache["k"].shape[2] * cache["k"].shape[3])
    del params, cache
    torch.cuda.empty_cache()
    return {"launches": launches, "paged": pa_timing, "pa_err": pa_err,
            "dropped": dropped, "dry": dry}


def rwkv_prefill_flops(cfg, B: int, S: int, chunk: int = 32) -> int:
    """Matrix-product flops of an RWKV6 prefill: per token and layer the
    token-shift and decay LoRAs, the five d x d projections and the
    channel mix; the chunked WKV's contractions per head (the chunk's
    pair matrix, its product with v, the state read and update); the
    last token's logits."""
    d, ff, rw = cfg.d_model, cfg.d_ff, cfg.rwkv
    H, hs = d // rw.head_size, rw.head_size
    per_tok = 2 * (2 * 5 * d * rw.mix_lora + 5 * d * d
                   + 2 * d * rw.decay_lora + 2 * d * ff + d * d)
    wkv = H * 2 * (2 * chunk * hs + 2 * hs * hs)
    return cfg.num_layers * B * S * (per_tok + wkv) \
        + 2 * B * cfg.vocab_size * d


def rwkv_phase(dev, work, card, cfg) -> dict:
    """Phase 12 (b): RWKV6-3B at published widths and full depth: prefill
    through `wkv_chunked`, greedy decode through `wkv_scan`, the
    recurrent state snapshotted through the store and restored through
    the RS decode after a slab is reclaimed; chunked vs scan on one
    layer's real inputs, f32 decode vs teacher forcing."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.checkpoint.checkpointer import _leaf_paths
    from repro_torch.core import InfiniStore, StoreConfig
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.kernels.rs_gf256 import kernel as gf_kernel
    from repro_torch.models import build_model, rwkv6

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = rwkv6.init_params(cfg, gen)
    n_params = sum(p.numel() for p in params.values())
    model = build_model(cfg)                        # wkv_impl="chunked"
    rng = np.random.default_rng(SEED + 13)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (REC_BATCH, RWKV_PROMPT)).astype(np.int32)).to(dev)
    seen = []
    chunked = rwkv6.wkv_chunked

    def capture(*args, **kw):             # the last layer's inputs stay
        seen[:] = [args]
        return chunked(*args, **kw)

    rwkv6.wkv_chunked = capture
    try:
        torch.cuda.synchronize()
        rms_kernel.launches = 0
        gf_kernel.launches = gf_kernel.gather_launches = 0
        t = time.perf_counter()
        logits, state = model.prefill(params, {"tokens": prompts})
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
    finally:
        rwkv6.wkv_chunked = chunked
    toks, secs, _ = greedy_steps(model, params, tok, state, REC_STEPS)
    torch.cuda.synchronize()
    rms = rms_kernel.launches
    per_fwd = 2 * cfg.num_layers + 2
    assert rms == per_fwd * (REC_STEPS + 1), rms
    assert int(state["len"]) == RWKV_PROMPT
    state_bytes = sum(t.numel() * t.element_size()
                      for _, t in _leaf_paths(state))
    print(f"phase 12b {RWKV6}: {n_params} params (bf16) from seed {SEED}; "
          f"prefill {REC_BATCH} x {RWKV_PROMPT} tokens (wkv_chunked, chunk "
          f"32) in {prefill_s:.3f} s, {REC_STEPS} greedy steps (wkv_scan); "
          f"RMSNorm launches {rms} = {per_fwd} per forward; state "
          f"{state_bytes} bytes; first tokens {toks[0, :8].tolist()}")

    # ---- the state snapshotted through the store -----------------------
    store = InfiniStore(StoreConfig(enable_recovery=False,
                                    spill_dir=str(work / "spill-state")),
                        seed=SEED)
    ck = Checkpointer(store)
    gf_kernel.launches = gf_kernel.gather_launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    ck.save(0, state)
    torch.cuda.synchronize()
    save_s = time.perf_counter() - t
    gf_save = codec_launches()
    assert store.flush_writeback(timeout=600.0)
    fid = store.chunk_map["ckpt/00000000/wkv/s0|1/f0#0"]
    store.inject_failure(fid)
    inv0 = store.codec.cache_info()["inversions"]
    gf_kernel.launches = gf_kernel.gather_launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    back = ck.restore(0, like=state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    gf_restore = codec_launches()
    inv = store.codec.cache_info()["inversions"]
    assert gf_save > 0 and gf_restore > 0 and inv > inv0, (gf_save,
                                                           gf_restore, inv)
    for (name, a), (_, b) in zip(_leaf_paths(state), _leaf_paths(back)):
        assert b.device == a.device and b.dtype == a.dtype, name
        assert torch.equal(a, b), name
    again, _, _ = greedy_steps(model, params, tok, back, REC_STEPS)
    assert torch.equal(again, toks), (again, toks)
    assert store.close()
    del store, ck, back
    print(f"phase 12b snapshot: the post-prefill state ({state_bytes} "
          f"bytes, {len(_leaf_paths(state))} leaves) saved through "
          f"InfiniStore(device='cuda', RS(10+2)) in {save_s:.3f} s (GF(256) "
          f"launches {gf_save}); slab {fid} holding chunk #0 of the wkv "
          f"leaf reclaimed; restored through the RS decode in "
          f"{restore_s:.3f} s (GF(256) launches {gf_restore}, inversions "
          f"{inv0} -> {inv}) bit-identical; {REC_STEPS} greedy steps from "
          f"it == the uninterrupted run's tokens")

    # ---- chunked vs scan on the last layer's real inputs ---------------
    # (the reference's init gives the last layer the heaviest decay)
    r, k, v, w, u, s0 = seen[0]
    y_c, st_c = rwkv6.wkv_chunked(r, k, v, w, u, s0)
    y_s, st_s = rwkv6.wkv_scan(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    wkv_err = max(float((y_c - y_s).abs().max()),
                  float((st_c - st_s).abs().max()))
    torch.testing.assert_close(y_c, y_s, atol=WKV_TOL, rtol=WKV_TOL)
    torch.testing.assert_close(st_c, st_s, atol=WKV_TOL, rtol=WKV_TOL)
    B, S, H, hs = w.shape
    nats = float(-torch.log(w.float()).reshape(B, S // 32, 32, H, hs)
                 .sum(2).max())
    del seen, r, k, v, w, y_c, y_s
    # ---- f32 decode vs teacher forcing ---------------------------------
    params32 = {k: v.float() for k, v in params.items()}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    B, S = RWKV_TF
    tf_toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + 1))
                               .astype(np.int32)).to(dev)
    tf_err, _ = teacher_forcing_check(build_model(cfg32, wkv_impl="scan"),
                                      params32, tf_toks, S, 1)
    print(f"phase 12b checks: wkv_chunked vs wkv_scan on the last layer's "
          f"real r, k, v, w ({REC_BATCH} x {RWKV_PROMPT} tokens, "
          f"{cfg.d_model // cfg.rwkv.head_size} heads, f32, "
          f"decay up to {nats:.1f} nats over a chunk of 32): max_abs_err "
          f"{wkv_err:.3e} (tol {WKV_TOL}); f32 decode of token {S + 1} vs "
          f"teacher forcing at full width (B={B}, S={S}): {tf_err:.3e} "
          f"(tol {TF_DECODE_TOL})")
    assert tf_err <= TF_DECODE_TOL, tf_err
    del params32

    # ---- numbers --------------------------------------------------------
    flops = rwkv_prefill_flops(cfg, REC_BATCH, RWKV_PROMPT)
    wbytes = param_bytes(params)
    pre_b, pre_by = bound(wbytes + state_bytes, flops,
                          ops_per_s=BF16_FLOPS_PER_S)
    tokens = REC_BATCH * RWKV_PROMPT
    print(f"phase 12b prefill: {tokens} tokens in {prefill_s:.3f} s = "
          f"{tokens / prefill_s:.1f} tokens/s | bound {pre_b:.3f} ms by "
          f"{pre_by} ({flops} flops at the bf16 peak) = "
          f"{tokens / (pre_b / 1e3):.1f} tokens/s; "
          f"{100 * pre_b / 1e3 / prefill_s:.2f}% of it | {card}")
    # a step reads every weight but the embedding table (its B rows),
    # and reads and writes the state
    step_bytes = param_bytes(params, skip=("embed",)) \
        + REC_BATCH * cfg.d_model * 2 + 2 * state_bytes
    s_b, _ = bound(step_bytes)
    med = sorted(secs)[len(secs) // 2]
    print(f"phase 12b decode: {REC_BATCH * REC_STEPS} tokens, step "
          f"{step_times(secs)} over {len(secs)} | bytes each step reads "
          f"and writes at 3.35 TB/s: {step_bytes} = {s_b:.3f} ms; median "
          f"at {100 * s_b / (med * 1e3):.2f}% of it | {card}")
    del state
    dry = {"rwkv_prefill": _counted(
        dev, lambda: model.prefill(params, {"tokens": prompts}),
        (params, {"tokens": prompts}), [prefill_s])}
    del params
    torch.cuda.empty_cache()
    return {"rmsnorm": rms, "gf": gf_save + gf_restore, "dry": dry}


def rgemma_prefill_flops(cfg, B: int, S: int) -> int:
    """Matrix-product flops of a RecurrentGemma prefill: per token every
    block's MLP, each recurrent block's projections and block-diagonal
    gates, each attention block's projections and its local attention
    (QK and PV over min(t + 1, window) keys); the last token's logits."""
    from repro_torch.models import rglru
    d, ff, H, K, hd = (cfg.d_model, cfg.d_ff, cfg.num_heads,
                       cfg.num_kv_heads, cfg.head_dim)
    rg = cfg.rglru
    W, bw = rg.lru_width, rg.lru_width // cfg.num_heads
    n_super, tail = rglru.layer_plan(cfg)
    kinds = list(rg.block_pattern) * n_super + list(tail)
    win = rg.attention_window
    keys = sum(min(t + 1, win) for t in range(S))
    total = 0
    for kind in kinds:
        total += B * S * 2 * 3 * d * ff
        if kind == "recurrent":
            total += B * S * 2 * (3 * d * W + 2 * W * bw)
        else:
            total += B * S * 2 * (d * H * hd + 2 * d * K * hd + H * hd * d) \
                + B * 2 * 2 * H * hd * keys
    return total + 2 * B * cfg.vocab_size * d


def rgemma_phase(dev, card, cfg) -> dict:
    """Phase 12 (c): RecurrentGemma-2B at published widths and full
    depth: a prefill past its attention window, greedy decode over the
    wrapped ring; the torch scan against a sequential recurrence, f32
    decode vs teacher forcing across the wrap, RMSNorm at d = 2560."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.models import build_model, rglru

    rg = cfg.rglru
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = rglru.init_params(cfg, gen)
    n_params = sum(p.numel() for p in params.values())
    assert all(v.dtype == (torch.float32 if k.endswith("a_param")
                           else torch.bfloat16) for k, v in params.items())
    model = build_model(cfg)
    rng = np.random.default_rng(SEED + 14)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (REC_BATCH, RGEMMA_PROMPT)).astype(np.int32)).to(
        dev)
    seen = []
    scan = rglru.linear_scan

    def capture(a, b):                               # the first block's
        if not seen:
            seen.append((a, b))
        return scan(a, b)

    rglru.linear_scan = capture
    try:
        torch.cuda.synchronize()
        rms_kernel.launches = 0
        t = time.perf_counter()
        logits, state = model.prefill(params, {"tokens": prompts})
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
    finally:
        rglru.linear_scan = scan
    toks, secs, last = greedy_steps(model, params, tok, state, REC_STEPS)
    torch.cuda.synchronize()
    rms = rms_kernel.launches
    per_fwd = 2 * cfg.num_layers + 1
    assert rms == per_fwd * (REC_STEPS + 1), rms
    assert int(last["len"]) == RGEMMA_PROMPT + REC_STEPS
    print(f"phase 12c {RGEMMA}: {n_params} params (bf16, a_param f32) from "
          f"seed {SEED}; prefill {REC_BATCH} x {RGEMMA_PROMPT} tokens (past "
          f"the {rg.attention_window}-token window, ring rolled by "
          f"{RGEMMA_PROMPT % rg.attention_window}) in {prefill_s:.3f} s, "
          f"{REC_STEPS} greedy steps over the ring (slots "
          f"{RGEMMA_PROMPT % rg.attention_window}-"
          f"{(RGEMMA_PROMPT + REC_STEPS - 1) % rg.attention_window}); "
          f"RMSNorm launches {rms} = {per_fwd} per forward; first tokens "
          f"{toks[0, :8].tolist()}")
    del last

    # ---- the torch scan against a sequential recurrence ----------------
    a, b = seen[0]
    _, h = rglru.linear_scan(a, b)
    hh, seq = torch.zeros_like(b[:, 0]), []
    for t in range(a.shape[1]):
        hh = a[:, t] * hh + b[:, t]
        seq.append(hh)
    seq = torch.stack(seq, 1)
    scan_err = float((h - seq).abs().max())
    torch.testing.assert_close(h, seq, atol=SCAN_TOL, rtol=SCAN_TOL)
    del seen, a, b, h, seq, hh
    # ---- f32 decode vs teacher forcing across the wrap -----------------
    params32 = {k: v.float() for k, v in params.items()}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    B, S = RGEMMA_TF
    tf_toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S + RGEMMA_TF_STEPS)).astype(np.int32)).to(dev)
    tf_err, floor = teacher_forcing_check(build_model(cfg32), params32,
                                          tf_toks, S, RGEMMA_TF_STEPS)
    tf_tol = max(TF_DECODE_TOL, TF_FLOOR_FACTOR * floor)
    print(f"phase 12c checks: linear_scan (Hillis-Steele) vs the "
          f"sequential recurrence on the first block's real a, b "
          f"({REC_BATCH} x {RGEMMA_PROMPT} x {rg.lru_width}, f32): max_abs_err"
          f" {scan_err:.3e} (tol {SCAN_TOL}); "
          f"f32 decode vs teacher forcing at full width (B={B}, S={S}: the "
          f"ring wrapped at slot {S % rg.attention_window}), "
          f"{RGEMMA_TF_STEPS} steps: {tf_err:.3e} (tol {tf_tol:.3e}: the "
          f"larger of {TF_DECODE_TOL} and {TF_FLOOR_FACTOR} x the forward's "
          f"own f32 floor at those positions, {floor:.3e})")
    assert tf_err <= tf_tol, (tf_err, floor)
    del params32

    # ---- numbers --------------------------------------------------------
    flops = rgemma_prefill_flops(cfg, REC_BATCH, RGEMMA_PROMPT)
    wbytes = param_bytes(params)
    pre_b, pre_by = bound(wbytes, flops, ops_per_s=BF16_FLOPS_PER_S)
    tokens = REC_BATCH * RGEMMA_PROMPT
    print(f"phase 12c prefill: {tokens} tokens in {prefill_s:.3f} s = "
          f"{tokens / prefill_s:.1f} tokens/s | bound {pre_b:.3f} ms by "
          f"{pre_by} ({flops} flops at the bf16 peak) = "
          f"{tokens / (pre_b / 1e3):.1f} tokens/s; "
          f"{100 * pre_b / 1e3 / prefill_s:.2f}% of it | {card}")
    # a step reads every weight (the tied table too, for the logits), the
    # rings' valid rows and the recurrent states
    win = rg.attention_window
    n_super, tail = rglru.layer_plan(cfg)
    n_attn = (list(rg.block_pattern) * n_super + list(tail)).count(
        "attention")
    ring = 2 * REC_BATCH * win * cfg.num_kv_heads * cfg.head_dim * 2 * n_attn
    rec_state = sum(t.numel() * t.element_size() for k, blk in state.items()
                    if k != "len" and "h" in blk for t in blk.values())
    step_bytes = wbytes + ring + 2 * rec_state
    s_b, _ = bound(step_bytes)
    med = sorted(secs)[len(secs) // 2]
    print(f"phase 12c decode: {REC_BATCH * REC_STEPS} tokens, step "
          f"{step_times(secs)} over {len(secs)} | bytes each step reads at "
          f"3.35 TB/s: {step_bytes} = {s_b:.3f} ms (weights, the full rings,"
          f" recurrent state read and written); median at "
          f"{100 * s_b / (med * 1e3):.2f}% of it | {card}")
    del state
    dry = {"rgemma_prefill": _counted(
        dev, lambda: model.prefill(params, {"tokens": prompts}),
        (params, {"tokens": prompts}), [prefill_s])}
    del params
    torch.cuda.empty_cache()
    rms_d = rms_at(dev, [(REC_BATCH, RGEMMA_PROMPT, cfg.d_model),
                         (REC_BATCH, RWKV_PROMPT, cfg.d_model),
                         (REC_BATCH, 1, cfg.d_model)], card,
                   f"d={cfg.d_model}")
    return {"rmsnorm": rms, "rms_d2560": rms_d, "dry": dry}


def published_model_configs() -> dict:
    """Phase 12's three configurations at published widths and full
    depth, each checked against its source's numbers."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, moe, rglru
    cfgs = {name: get_config(name) for name in (QWEN_MOE, RWKV6, RGEMMA)}
    c, m = cfgs[QWEN_MOE], cfgs[QWEN_MOE].moe
    assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads,
            c.head_dim, c.vocab_size, c.qkv_bias, c.tie_embeddings, c.dtype,
            m.num_experts, m.top_k, m.d_expert, m.d_shared,
            m.capacity_factor) == (24, 2048, 16, 16, 128, 151936, True,
                                   False, "bfloat16", 60, 4, 1408, 5632,
                                   1.25)
    assert moe.capacity(c, PROMPT) == 172
    c, rw = cfgs[RWKV6], cfgs[RWKV6].rwkv
    assert (c.num_layers, c.d_model, c.d_ff, c.vocab_size, rw.head_size,
            rw.decay_lora, rw.mix_lora, c.dtype) == (
        32, 2560, 8960, 65536, 64, 64, 32, "bfloat16")
    c, rg = cfgs[RGEMMA], cfgs[RGEMMA].rglru
    assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads,
            c.head_dim, c.d_ff, c.vocab_size, rg.lru_width,
            rg.attention_window, c.logit_softcap, c.scale_embed,
            c.dtype) == (26, 2560, 10, 1, 256, 7680, 256000, 2560, 2048,
                         30.0, True, "bfloat16")
    assert rglru.layer_plan(c) == (8, ("recurrent", "recurrent"))
    counts = {name: build_model(c).param_count() for name, c in cfgs.items()}
    assert counts == {QWEN_MOE: 14_315_784_192, RWKV6: 3_099_694_080,
                      RGEMMA: 2_682_237_440}, counts
    return cfgs


def models_phase(dev, work, card, cfgs=None) -> dict:
    """Phase 12: the MoE, RWKV6 and RG-LRU families, at published widths
    and full depth unless `cfgs` ({name: config}) says otherwise (a CPU
    rehearsal passes reduced ones). Returns each path's kernel launches
    and timings."""
    import gc

    import torch
    cfgs = cfgs or published_model_configs()
    # earlier phases' stores and engines can linger in reference cycles
    # until the collector runs: collect them before 28.6 GB of weights
    # are drawn
    held = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 12 start: device memory allocated {held} bytes, "
          f"{torch.cuda.memory_allocated()} after gc.collect()")
    t = time.perf_counter()
    a = moe_serve(dev, card, cfgs[QWEN_MOE])
    torch.cuda.empty_cache()
    b = rwkv_phase(dev, work, card, cfgs[RWKV6])
    torch.cuda.empty_cache()
    c = rgemma_phase(dev, card, cfgs[RGEMMA])
    wall = time.perf_counter() - t
    launches = {"rmsnorm": a["launches"]["rmsnorm"] + b["rmsnorm"]
                + c["rmsnorm"],
                "paged_decode_attention":
                    a["launches"]["paged_decode_attention"],
                "gf256_matmul_bitsliced": b["gf"]}
    print(f"phase 12 launches: {json.dumps(launches)} (rmsnorm: (a) "
          f"{a['launches']['rmsnorm']}, (b) {b['rmsnorm']}, (c) "
          f"{c['rmsnorm']}); wall time {wall:.3f} s")
    return {"launches": launches, "paged": a["paged"],
            "pa_err": a["pa_err"], "rms_d2560": c["rms_d2560"],
            "dry": {**a["dry"], **b["dry"], **c["dry"]}}


# ---- slice G, the mesh and the compressed step: phase 13 -----------------

CELL_STEPS = 3                   # train steps of each 13a / 13b run
CELL_DECODE_STEPS = 64           # greedy steps of the decode cell
POD = 2                          # pods of the compressed step (13b)


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _meta_like(specs, tree) -> None:
    """Every leaf of `tree` has the shape and dtype of its meta spec."""
    from repro_torch.distributed.sharding import tree_leaves
    got, want = tree_leaves(tree), tree_leaves(specs)
    assert len(got) == len(want), (len(got), len(want))
    for s, t in zip(want, got):
        assert s.device.type == "meta", s.device
        assert (tuple(s.shape), s.dtype) == (tuple(t.shape), t.dtype), \
            (tuple(s.shape), s.dtype, tuple(t.shape), t.dtype)


def _max_diff(a, b) -> float:
    """Largest elementwise |a - b| over two trees of tensors, in f32."""
    from repro_torch.distributed.sharding import tree_leaves
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def cells_phase(dev, card: str, cfg15, cfg3) -> dict:
    """Phase 13a: `build_cell`'s train (`cfg15`), prefill and decode
    (`cfg3`) cells on a 1 x 1 `DeviceMesh` over `dev`, their arguments
    materialised from the cells' meta specs and `place`d by their input
    shardings, each held to the unsharded path run twice on the same
    inputs. Returns the kernels' launches in the cells, the margins the
    unsharded runs showed and the paged kernel's timing at pages of 256,
    and the reference loss of 13b's first step."""
    import math

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed.sharding import local, place, tree_leaves
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    from repro_torch.kernels.paged_attention.ref import \
        paged_decode_attention_ref
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.specs import num_microbatches
    from repro_torch.launch.steps import build_cell, make_train_step
    from repro_torch.models.transformer import _gather_pages
    from repro_torch.optim import adamw

    mesh = make_test_mesh(1, 1, device=dev.type)
    on_card = dev.type == "cuda"
    print(f"phase 13a mesh: {mesh!r} as {mesh.device_mesh} over a "
          f"{dist.get_backend()} world of {dist.get_world_size()}")

    # ---- train: Qwen1.5-0.5B, 8 x 1024 -------------------------------
    shape = ShapeConfig("cell_train", seq_len=TRAIN_SEQ,
                        global_batch=TRAIN_BATCH, kind="train")
    cell = build_cell(cfg15, shape, mesh)
    model = cell["model"]
    ap, aopt, bspec = cell["args"]
    n = bspec["tokens"].shape[0]
    assert n == num_microbatches(cfg15, shape), n
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init_params(gen)
    opt = adamw.adamw_init(params)
    pipe = TokenPipeline(cfg15, shape, num_microbatches=n, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in next(pipe).items()}
               for _ in range(CELL_STEPS)]
    _meta_like((ap, aopt, bspec), (params, opt, batches[0]))
    _sync(dev)

    def unsharded():
        step = make_train_step(model, adamw.AdamWConfig())
        p, o, losses, seconds = params, opt, [], []
        for b in batches:
            _sync(dev)
            t = time.perf_counter()
            p, o, m = step(p, o, b)
            losses.append(float(m["loss"]))
            seconds.append(time.perf_counter() - t)
        return p, losses, seconds

    p_a, loss_a, plain_s = unsharded()
    p_b, loss_b, _ = unsharded()
    in_sh = cell["in_shardings"]
    p_d, o_d = place(params, in_sh[0]), place(opt, in_sh[1])
    rms_kernel.launches = 0
    loss_c, step_s = [], []
    for b in batches:
        _sync(dev)
        t = time.perf_counter()
        p_d, o_d, m = cell["fn"](p_d, o_d, place(b, in_sh[2]))
        loss_c.append(float(local(m["loss"])))
        step_s.append(time.perf_counter() - t)
    rms_train = rms_kernel.launches
    per_step = n * (4 * cfg15.num_layers + 1)
    assert rms_train == (CELL_STEPS * per_step if on_card else 0), rms_train
    assert type(p_d["embed"]).__name__ == "DTensor"
    p_c = local(p_d)
    del o_d
    loss_margin = max(abs(x - y) for x, y in zip(loss_a, loss_b))
    param_margin = _max_diff(p_a, p_b)
    loss_diff = max(abs(x - y) for x, y in zip(loss_c, loss_a))
    param_diff = _max_diff(p_c, p_a)
    print(f"phase 13a train cell: {cfg15.name} at published widths and "
          f"depth, {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step in {n} "
          f"microbatch(es) (specs.TRAIN_MICROBATCHES), {CELL_STEPS} steps of "
          f"build_cell's fn over DTensors: losses {loss_c}; unsharded "
          f"make_train_step twice: {loss_a} / {loss_b}; run-to-run "
          f"difference of the unsharded path: losses {loss_margin:.6e}, "
          f"params {param_margin:.6e}; cell vs unsharded: losses "
          f"{loss_diff:.6e}, params {param_diff:.6e}; RMSNorm launches "
          f"{rms_train} ({per_step} per step); step wall times "
          f"{step_times(step_s)} (unsharded {step_times(plain_s)}) | {card}")
    assert loss_diff <= loss_margin and param_diff <= param_margin, \
        (loss_diff, loss_margin, param_diff, param_margin)
    # 13b's first step: the whole step-0 batch split as the pods split it
    halves = TokenPipeline(cfg15, shape, num_microbatches=POD, seed=0)
    b2 = {k: torch.from_numpy(v).to(dev) for k, v in next(halves).items()}
    assert torch.equal(b2["tokens"].reshape(batches[0]["tokens"].shape),
                       batches[0]["tokens"])
    _, _, m = make_train_step(model, adamw.AdamWConfig())(params, opt, b2)
    pod_loss_ref = float(m["loss"])
    # phase 14(b)'s card side: one more step of the cell's work, counted
    dry = {"train": _counted(
        dev, lambda: make_train_step(model, adamw.AdamWConfig())(
            params, opt, batches[0]), (params, opt, batches[0]), step_s)}
    del params, opt, p_a, p_b, p_c, p_d, batches, b2, m, cell
    if on_card:
        torch.cuda.empty_cache()

    # ---- prefill: Qwen3-1.7B, 16 x 2048 ------------------------------
    rng = np.random.default_rng(SEED)
    prompts = torch.from_numpy(rng.integers(0, cfg3.vocab_size,
                                            (SLOTS, PROMPT)).astype(
        np.int32)).to(dev)
    shape = ShapeConfig("cell_prefill", seq_len=PROMPT, global_batch=SLOTS,
                        kind="prefill")
    cell = build_cell(cfg3, shape, mesh)
    model = cell["model"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = model.init_params(gen)
    _meta_like(cell["args"], (params, {"tokens": prompts}))
    _sync(dev)
    t = time.perf_counter()
    lg_a, cache_a = model.prefill(params, {"tokens": prompts},
                                  max_len=PROMPT)
    _sync(dev)
    plain_prefill_s = time.perf_counter() - t
    lg_b, _ = model.prefill(params, {"tokens": prompts}, max_len=PROMPT)
    _sync(dev)
    rms_kernel.launches = 0
    t = time.perf_counter()
    lg_c, cache_c = cell["fn"](*place((params, {"tokens": prompts}),
                                      cell["in_shardings"]))
    _sync(dev)
    prefill_s = time.perf_counter() - t
    rms_prefill = rms_kernel.launches
    per_fwd = 4 * cfg3.num_layers + 1
    assert rms_prefill == (per_fwd if on_card else 0), rms_prefill
    lg_c, cache_c = local(lg_c), local(cache_c)
    pre_margin = float((lg_a.float() - lg_b.float()).abs().max())
    pre_diff = float((lg_c.float() - lg_a.float()).abs().max())
    cache_diff = _max_diff(cache_c, cache_a)
    assert torch.isfinite(lg_c.float()).all()
    print(f"phase 13a prefill cell: {cfg3.name}, {SLOTS} x {PROMPT} tokens "
          f"in {prefill_s:.3f} s through build_cell's fn (unsharded "
          f"{plain_prefill_s:.3f} s), paged cache of "
          f"{cache_c['k'].shape[2]} pages of {cache_c['k'].shape[3]}; "
          f"last-token logits vs unsharded prefill {pre_diff:.6e} (two "
          f"unsharded runs {pre_margin:.6e}), cache {cache_diff:.6e}; "
          f"RMSNorm launches {rms_prefill} | {card}")
    assert pre_diff <= pre_margin and cache_diff <= pre_margin, \
        (pre_diff, cache_diff, pre_margin)
    dry["prefill"] = _counted(
        dev, lambda: model.prefill(params, {"tokens": prompts},
                                   max_len=PROMPT),
        (params, {"tokens": prompts}), [prefill_s])
    del lg_a, lg_b, lg_c, cache_a, cache_c

    # ---- decode: 16 sequences at seq_len 2112, 64 greedy steps -------
    seq = PROMPT + CELL_DECODE_STEPS
    shape = ShapeConfig("cell_decode", seq_len=seq, global_batch=SLOTS,
                        kind="decode")
    cell = build_cell(cfg3, shape, mesh)
    model = cell["model"]
    lg, cache = model.prefill(params, {"tokens": prompts}, max_len=seq)
    tok0 = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
    _meta_like(cell["args"], (params, {"token": tok0}, cache))
    P, ps = cache["k"].shape[2:4]
    assert ps == min(256, seq) and P * ps >= seq, (P, ps)  # build_model's
    plain_cache = {k: v.clone() for k, v in cache.items()}
    in_sh = cell["in_shardings"]
    p_d = place(params, in_sh[0])
    c_d = place(cache, in_sh[2])
    tok = tok0
    toks_c, dec_s = [], []
    _sync(dev)
    rms_kernel.launches = pa_kernel.launches = 0
    for _ in range(CELL_DECODE_STEPS):
        t = time.perf_counter()
        tok_d, c_d = cell["fn"](p_d, place({"token": tok}, in_sh[1]), c_d)
        tok = local(tok_d)
        toks_c.append(tok[:, 0].cpu())
        dec_s.append(time.perf_counter() - t)
    launches = {"rmsnorm": rms_kernel.launches,
                "paged_decode_attention": pa_kernel.launches}
    want = {"rmsnorm": per_fwd * CELL_DECODE_STEPS,
            "paged_decode_attention": cfg3.num_layers * CELL_DECODE_STEPS}
    assert launches == (want if on_card else {k: 0 for k in want}), launches
    tok = tok0
    toks_p, plain_dec_s = [], []
    cache = plain_cache
    for _ in range(CELL_DECODE_STEPS):
        t = time.perf_counter()
        lg, cache = model.decode_step(params, {"token": tok}, cache)
        tok = lg.argmax(-1).to(torch.int32)
        toks_p.append(tok[:, 0].cpu())
        plain_dec_s.append(time.perf_counter() - t)
    toks_c, toks_p = torch.stack(toks_c, 1), torch.stack(toks_p, 1)
    print(f"phase 13a decode cell: {SLOTS} sequences at seq_len {seq} "
          f"({P} pages of {ps}), {CELL_DECODE_STEPS} greedy steps of "
          f"build_cell's fn: tokens == unsharded decode_step's: "
          f"{bool(torch.equal(toks_c, toks_p))} (first {toks_c[0, :8].tolist()}"
          f"); step {step_times(dec_s)} (unsharded decode_step "
          f"{step_times(plain_dec_s)}); launches {json.dumps(launches)} = "
          f"{cfg3.num_layers} paged attention and {per_fwd} RMSNorm per "
          f"step | {card}")
    assert torch.equal(toks_c, toks_p)
    # one more step over the last position (a full cache has no next)
    last = dict(cache, len=cache["len"] - 1)
    dry["decode"] = _counted(
        dev, lambda: model.decode_step(params, {"token": tok}, last),
        (params, {"token": tok}, last), dec_s)
    dry["decode"]["gathered_flops"] = (4 * SLOTS * cfg3.num_heads
                                       * cfg3.head_dim * int(P * ps)
                                       * cfg3.num_layers)
    # the cell's DTensor edge alone (host work, no device op): what a
    # step of fn adds around decode_step, `place` of its token and its
    # results and `local` of its arguments and its token
    edge_s = []
    for _ in range(CELL_DECODE_STEPS):
        t = time.perf_counter()
        _, _, c_l = local((p_d, place({"token": tok}, in_sh[1]), c_d))
        local(place((tok, c_l), cell["out_shardings"])[0])
        edge_s.append(time.perf_counter() - t)
    print(f"phase 13a decode cell's DTensor edge per step "
          f"({len(tree_leaves((p_d, tok, c_d)))} argument and "
          f"{len(tree_leaves((tok, c_d)))} result leaves): "
          f"{step_times(edge_s)} | {card}")

    timing = None
    if on_card:
        kc, vc = local(c_d)["k"][0], local(c_d)["v"][0]
        table = local(c_d)["block_table"]
        lens = torch.full((SLOTS,), seq, dtype=torch.int32, device=dev)
        # q from the script's seed (SEED + i for draw i), as every other
        # kernel check draws its inputs; held as phase 6 holds the paged
        # kernel (atol and rtol PA_TOL: the kernel's output is bf16, the
        # plain version's f32, and rounding to bf16 alone costs up to
        # half an ulp, 0.031 at |out| >= 8); the worst element's error
        # also in bf16 ulps of the plain answer there
        err, ulps, pairs = 0.0, [], []
        for i in range(PA_256_DRAWS):
            g = torch.Generator(device=dev)
            g.manual_seed(SEED + i)
            q = torch.randn((SLOTS, cfg3.num_heads, cfg3.head_dim),
                            device=dev, generator=g).to(torch.bfloat16)
            got = pa_kernel.paged_decode_attention_cuda(q, kc, vc, table,
                                                        lens).float()
            want_o = paged_decode_attention_ref(q, kc, vc, table, lens)
            pairs.append((got, want_o))
            diff = (got - want_o).abs()
            at = int(diff.argmax())
            e, w = float(diff.flatten()[at]), float(want_o.flatten()[at])
            ulp = 2.0 ** (math.floor(math.log2(abs(w))) - 7) if w else 0.0
            rounding = abs(float(torch.tensor(w).bfloat16()) - w)
            ulps.append((e, w, e / ulp if ulp else math.inf, rounding))
            err = max(err, e)
        e, w, u, r = max(ulps)
        over = [(round(x[0], 4), round(abs(x[1]), 3), round(x[2], 3))
                for x in ulps if x[0] > PA_TOL["bfloat16"]]
        print(f"phase 13a paged kernel at pages of {ps} vs plain over "
              f"{PA_256_DRAWS} draws of q (seeds {SEED}.."
              f"{SEED + PA_256_DRAWS - 1}): max_abs_err {e:.4e} at |out| "
              f"{abs(w):.4f} = {u:.3f} bf16 ulps there (rounding the plain "
              f"answer to bf16 alone costs {r:.4e}); each draw's worst "
              f"element at most {max(x[2] for x in ulps):.3f} ulps; "
              f"{len(over)} draws above {PA_TOL['bfloat16']} abs (error, "
              f"|out|, ulps: {over}) | {card}")
        for got, want_o in pairs:
            torch.testing.assert_close(got, want_o,
                                       atol=PA_TOL["bfloat16"],
                                       rtol=PA_TOL["bfloat16"])
        del pairs
        pa_bytes = 2 * q.numel() * 2 + kv_bytes(cfg3, SLOTS, seq) \
            // cfg3.num_layers + table.numel() * 4 + lens.numel() * 4
        pa_flops = 4 * SLOTS * cfg3.num_heads * cfg3.head_dim * seq
        mask = (torch.arange(P * ps, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]

        def sdpa():
            kf = _gather_pages(kc, table).transpose(1, 2)
            vf = _gather_pages(vc, table).transpose(1, 2)
            return F.scaled_dot_product_attention(
                q[:, :, None], kf, vf, attn_mask=mask, enable_gqa=True)

        ms = event_ms(lambda: pa_kernel.paged_decode_attention_cuda(
            q, kc, vc, table, lens), reps=50)
        plain = event_ms(lambda: paged_decode_attention_ref(
            q, kc, vc, table, lens), reps=5)
        lib_ms = event_ms(sdpa, reps=10)
        b_ms, by = bound(pa_bytes, pa_flops, ops_per_s=F32_FLOPS_PER_S)
        timing = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=by,
                      library_ms=lib_ms, max_abs_err=err)
        print(f"kernel paged_decode_attention at pages of {ps} (B={SLOTS}, "
              f"H={cfg3.num_heads}, K={cfg3.num_kv_heads}, hd="
              f"{cfg3.head_dim}, {P} pages, lens {seq}, bf16): "
              f"{ms * 1e3:.1f} us = {100 * b_ms / ms:.1f}% of its bound | "
              f"bound {b_ms * 1e3:.1f} us by {by} ({pa_bytes} bytes) | "
              f"plain {plain * 1e3:.1f} us | _gather_pages + sdpa "
              f"{lib_ms * 1e3:.1f} us | max_abs_err vs plain {err:.3e} | "
              f"{card}")
    del params, cache, plain_cache, p_d, c_d, cell, lg
    dist.destroy_process_group()
    return {"rmsnorm": rms_train + rms_prefill + launches["rmsnorm"],
            "paged_decode_attention": launches["paged_decode_attention"],
            "loss_margin": loss_margin, "pod_loss_ref": pod_loss_ref,
            "paged_256": timing, "dry": dry}


def _tree_bytes(tree) -> int:
    from repro_torch.distributed.sharding import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _counted(dev, fn, args, seconds) -> dict:
    """One run of `fn` (the work of a phase 13a cell) under
    `FlopCounterMode`: its matrix-product flops, the bytes of its
    arguments, the device memory it held at most (the arguments' bytes
    plus its rise over what was allocated before it) and the median of
    the cell's measured `seconds`."""
    import statistics

    import torch
    from torch.utils.flop_counter import FlopCounterMode
    on_card = dev.type == "cuda"
    _sync(dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    with FlopCounterMode(display=False) as counter:
        out = fn()
    _sync(dev)
    nbytes = _tree_bytes(args)
    peak = (torch.cuda.max_memory_allocated() - before + nbytes
            if on_card else None)
    del out
    return {"arg_bytes": nbytes, "flops": counter.get_total_flops(),
            "peak_bytes": peak, "median_s": statistics.median(seconds)}


def _digest(t) -> tuple:
    """Two sums over a tensor's bytes (as 16- or 32-bit words, the second
    weighted by position): equal tensors give equal digests, and a
    change of any word changes the first."""
    import torch
    words = t.detach().contiguous().reshape(-1)
    words = words.view(torch.int16 if t.element_size() == 2
                       else torch.int32)
    first = second = 0
    step = 1 << 26                  # in parts: a large leaf's int64 copy
    for i in range(0, words.numel(), step):
        w = words[i:i + step].to(torch.int64)
        pos = torch.arange(i, i + w.numel(), device=w.device) % 65521 + 1
        first += int(w.sum())
        second += int((w * pos).sum())
    return first, second


def pod_worker(rank: int, world: int, init_file: str, device: str,
               results, steps: int, cfg, seq_len: int, batch: int) -> None:
    """One pod of phase 13b: `cfg` (Qwen1.5-0.5B at full width and
    depth), this pod's part of each `batch` x `seq_len` batch, `steps`
    steps of
    `build_cell(..., grad_compress=True)`'s fn on the mesh (pod=world,
    data=1, model=1) over a gloo world; puts its measurements on
    `results`. Every check that needs both pods is made here on
    gathered digests and tensors; a failed one raises and the process
    exits non-zero."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=600))
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed.sharding import local, place, tree_leaves
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.optim import adamw, compression

    mesh = make_test_mesh(1, 1, pod=world, device=device)
    group = mesh.group("pod")
    shape = ShapeConfig("cell_pod", seq_len=seq_len, global_batch=batch,
                        kind="train")
    cell = build_cell(cfg, shape, mesh, grad_compress=True)
    model = cell["model"]
    n = cell["args"][2]["tokens"].shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init_params(gen)
    opt = adamw.adamw_init(params)
    opt["err"] = {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                  for k, p in params.items()}
    _meta_like(cell["args"][:2], (params, opt))
    pipe = TokenPipeline(cfg, shape, num_microbatches=n, seed=0)

    # record each exchange's inputs and outputs, and time its gathers
    seen = {}
    psum = compression.psum_compressed
    gather = dist.all_gather

    def recording_psum(grads, grp, errors):
        mean, new_err = psum(grads, grp, errors)
        seen.update(g=grads, e=errors, mean=mean, new_err=new_err)
        return mean, new_err

    def timed_gather(out, t, group=None):
        _sync(dev)
        t0 = time.perf_counter()
        work = gather(out, t, group=group)
        _sync(dev)
        seen["gather_s"] = seen.get("gather_s", 0.0) \
            + time.perf_counter() - t0
        seen["gathered"] = seen.get("gathered", 0) \
            + sum(o.numel() * o.element_size() for o in out)
        return work

    compression.psum_compressed = recording_psum
    dist.all_gather = timed_gather
    in_sh = cell["in_shardings"]
    p_d, o_d = place(params, in_sh[0]), place(opt, in_sh[1])
    del params, opt
    out = {"rank": rank, "losses": [], "step_s": [], "gather_s": [],
           "gathered": [], "err_leaves_differing": []}
    rms_kernel.launches = 0
    try:
        for step in range(steps):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in next(pipe).items()}
            seen.clear()
            _sync(dev)
            t = time.perf_counter()
            p_d, o_d, m = cell["fn"](p_d, o_d, place(batch, in_sh[2]))
            loss = float(local(m["loss"]))
            out["step_s"].append(time.perf_counter() - t)
            out["losses"].append(loss)
            out["gather_s"].append(seen["gather_s"])
            out["gathered"].append(seen["gathered"])
            launches = rms_kernel.launches
            # (iii) this pod's new error is its g + e minus what it sent
            for k in sorted(seen["g"]):
                g = seen["g"][k].float() + seen["e"][k]
                q, s = compression.quantize_int8(g)
                assert torch.equal(seen["new_err"][k],
                                   g - compression.dequantize(q, s)), k
            if step == 0:
                # (ii) the exchanged mean against the f32 mean of the two
                # pods' gradients (an all-reduce for the check only)
                worst = 0.0
                for k in sorted(seen["g"]):
                    ref = seen["g"][k].float().clone()
                    dist.all_reduce(ref, group=group)
                    ref = ref / world
                    _, s = compression.quantize_int8(seen["g"][k].float())
                    scales = [torch.empty_like(s.reshape(1))
                              for _ in range(world)]
                    gather(scales, s.reshape(1), group=group)
                    lim = float(torch.cat(scales).sum()) / (2 * world)
                    # plus the f32 rounding of the two sums
                    lim += 2.0 ** -21 * float(ref.abs().max())
                    diff = float((seen["mean"][k] - ref).abs().max())
                    assert diff <= lim, (k, diff, lim)
                    worst = max(worst, diff / lim)
                out["mean_vs_bound"] = worst
            # (i) params and the AdamW state bit-identical on both pods;
            # `err` is each pod's own residual
            dg = {}
            for name, tree in (("params", local(p_d)),
                               ("opt", {k: v for k, v in local(o_d).items()
                                        if k != "err"}),
                               ("err", local(o_d)["err"])):
                dg[name] = [_digest(t) for t in tree_leaves(tree)]
            every = [None] * world
            dist.all_gather_object(every, dg, group=group)
            assert all(d["params"] == every[0]["params"]
                       and d["opt"] == every[0]["opt"] for d in every), step
            out["err_leaves_differing"].append(sum(
                a != b for a, b in zip(every[0]["err"], every[1]["err"])))
            del batch
        out["rmsnorm"] = launches
    finally:
        compression.psum_compressed = psum
        dist.all_gather = gather
    out["dcn_int8"] = compression.dcn_bytes_per_step(local(p_d),
                                                     compressed=True)
    out["dcn_f32"] = compression.dcn_bytes_per_step(local(p_d),
                                                    compressed=False)
    out["n_params"] = sum(t.numel() for t in tree_leaves(local(p_d)))
    out["leaf_norms"] = _leaf_norms(local(p_d))      # for phase 13d (e)
    out["microbatches"] = n
    results.put(out)
    dist.destroy_process_group()


def pod_phase(dev, card: str, work: Path, cfg15, ref: dict) -> dict:
    """Phase 13b: the compressed train step at pod = 2, two processes on
    the one device (spawned), each one pod. Returns the rank results."""
    import queue

    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_file = work / "pods.init"
    init_file.unlink(missing_ok=True)
    t = time.perf_counter()
    procs = [ctx.Process(target=pod_worker,
                         args=(r, POD, str(init_file), dev.type, results,
                               CELL_STEPS, cfg15, TRAIN_SEQ, TRAIN_BATCH))
             for r in range(POD)]
    for p in procs:
        p.start()
    got = []
    try:
        while len(got) < POD:
            try:
                got.append(results.get(timeout=5))
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                assert not dead, f"a pod process failed: exit codes {dead}"
                assert time.perf_counter() - t < 900, "pods timed out"
        for p in procs:
            p.join(timeout=120)
        assert [p.exitcode for p in procs] == [0] * POD, \
            [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
    wall = time.perf_counter() - t
    got.sort(key=lambda r: r["rank"])
    r0 = got[0]
    assert all(r["losses"] == r0["losses"] for r in got), \
        [r["losses"] for r in got]
    loss_diff = abs(r0["losses"][0] - ref["pod_loss_ref"])
    assert loss_diff <= ref["loss_margin"], (loss_diff, ref)
    per_step = r0["microbatches"] * (4 * cfg15.num_layers + 1)
    want = CELL_STEPS * per_step if dev.type == "cuda" else 0
    assert all(r["rmsnorm"] == want for r in got), \
        [r["rmsnorm"] for r in got]
    steps = sorted(r0["step_s"])
    gathers = sorted(r0["gather_s"])
    print(f"phase 13b compressed train step: {POD} pod processes on one "
          f"device (spawned; gloo pod group), {cfg15.name} at published "
          f"widths and depth ({r0['n_params']} params), each pod "
          f"{TRAIN_BATCH // POD} x {TRAIN_SEQ} of every {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} batch, {CELL_STEPS} steps of build_cell(..., "
          f"grad_compress=True)'s fn in {wall:.3f} s (spawn included): "
          f"losses {r0['losses']} equal on both pods; params and AdamW "
          f"state bit-identical on both pods after every step (digests "
          f"gathered), err per pod (leaves differing "
          f"{r0['err_leaves_differing']} of 14) and == g + e - "
          f"dequantize(q, s) exactly on every step; step 1's exchanged "
          f"mean within {r0['mean_vs_bound']:.4f} of its bound "
          f"sum(s_i)/(2n); step 1's loss vs make_train_step's on the "
          f"whole batch {loss_diff:.6e} (margin {ref['loss_margin']:.6e}); "
          f"RMSNorm launches {[r['rmsnorm'] for r in got]} | {card}")
    print(f"compressed step: median {steps[len(steps) // 2] * 1e3:.3f} ms "
          f"(steps {[round(s * 1e3, 3) for s in r0['step_s']]} ms); "
          f"all-gather wall time per step median "
          f"{gathers[len(gathers) // 2] * 1e3:.3f} ms "
          f"({[round(s * 1e3, 3) for s in r0['gather_s']]}); "
          f"dcn_bytes_per_step int8 {r0['dcn_int8']} against f32 "
          f"{r0['dcn_f32']} ({r0['dcn_f32'] / r0['dcn_int8']:.3f}x); "
          f"gathered bytes seen per step and rank {r0['gathered']} "
          f"({POD} x the int8 payloads and scales) | {card}")
    return {"rmsnorm": sum(r["rmsnorm"] for r in got), "ranks": got,
            "loss_margin": ref["loss_margin"]}


# ---- slices J and K, cells over data and model: phases 13c and 13d -----

MESH_SHAPES = [(2, 1), (1, 2)]   # (data, model) of phase 13c's runs
MESH_RANKS = 2                   # processes on the one card
# greedy steps of 13c's bf16 decode cells and of the f32 ones (cut to
# these from 32 and 8 for the script's time, beside phase 13d)
MESH_DECODE_STEPS = 16
MESH_F32_STEPS = 4
MESH_DECODE_SEQ = 2112           # the decode cells' seq_len (pages of 256)
MESH_F32_LAYERS = 4              # depth of the f32 serving run (of 28)
MESH_CKPT = CELL_STEPS           # the (2, 1) run's checkpoint step
MESH_LOGIT_TOL = 3e-2            # bf16 logits, as phase 12's
# bf16 losses and grad norms: the mesh reorders and re-rounds bf16 sums
# (the FSDP gradients' reduce-scatter, the Megatron projections'
# all-reduces), so they equal the unsharded path's to bf16's precision,
# not bit for bit: within the larger of bf16's unit roundoff (8
# significant bits) times the value and the distance bf16 itself puts
# between the unsharded run and an f32 run on the same seed and data
MESH_LOSS_REL = 2.0 ** -8
# AdamW's grad norm (the global one, the same on every rank) is held in
# f32 at MESH_F32_LAYERS layers: at this init it is dominated by the tied
# embedding's gradient, a sum of large cancelling terms over the batch's
# tokens, which bf16 moves by percents (phase 13c prints both), and
# another f32 reduction order by up to ~3e-4 of it; a rank's own norm
# in place of the global one would sit ~29% low at data = 2
MESH_GN_REL = 1e-3


def profiled(dev, fn) -> dict:
    """One call of `fn` under torch.profiler: its wall time, the device
    time this process's kernels took and the host time inside the
    collectives (`shared_card.moved`)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.distributed import shared_card
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(dev)
    before = dict(shared_card.moved)
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        fn()
        _sync(dev)
        wall = time.perf_counter() - t
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy = sum(getattr(e, "self_device_time_total", 0.0)
               for e in kernels) / 1e6
    return {"wall_s": wall, "device_s": busy if dev.type == "cuda" else None,
            "coll_s": shared_card.moved["seconds"] - before["seconds"],
            "coll_bytes": shared_card.moved["bytes"] - before["bytes"]}


class ShardKernelCheck:
    """For the `with` block, every call the model layer makes to the
    RMSNorm op (`layers.rms_norm_op`) and the paged kernel
    (`transformer.paged_decode_attention`), on this rank's local tensors,
    is held to the plain version on the same tensors at phase 6's
    tolerances (atol = rtol = RMS_TOL, PA_TOL of the dtype); an f32 paged
    call, as phase 12 holds it (`DecodeAttentionProbe`), to the exact
    (float64) answer, no farther from it than the f32 plain version or
    PA_TOL's f32 tolerance times the output's largest magnitude (under a
    nearly one-hot softmax the f32 plain version itself is off by ~1e-3).
    The worst error and the worst excess over the bound accumulate on the
    device, with no sync per call; `report()` reads them."""

    def __init__(self):
        from repro_torch.models import layers, transformer
        self.layers, self.t = layers, transformer
        self.calls, self.err, self.over = {}, {}, {}

    def note(self, name, got, want, tol) -> None:
        key = (name, str(got.dtype).split(".")[-1])
        d = (got.detach().float() - want.float()).abs()
        self.accumulate(key, d.max(),
                        (d - tol[key[1]] * (1 + want.float().abs())).max())

    def accumulate(self, key, err, over) -> None:
        import torch
        self.calls[key] = self.calls.get(key, 0) + 1
        if key in self.err:
            err = torch.maximum(self.err[key], err)
            over = torch.maximum(self.over[key], over)
        self.err[key], self.over[key] = err, over

    def __enter__(self):
        import torch
        from repro_torch.kernels.paged_attention.ref import \
            paged_decode_attention_ref
        from repro_torch.kernels.rmsnorm.ref import rms_norm_ref
        self.rms, self.paged = (self.layers.rms_norm_op,
                                self.t.paged_decode_attention)

        def rms(x, scale, eps=1e-6):
            y = self.rms(x, scale, eps)
            with torch.no_grad():
                self.note("rmsnorm", y, rms_norm_ref(
                    x.detach(), scale.detach(), eps), RMS_TOL)
            return y

        def paged(q, kc, vc, table, lens):
            out = self.paged(q, kc, vc, table, lens)
            want = paged_decode_attention_ref(q, kc, vc, table, lens)
            if q.dtype != torch.float32:
                self.note("paged_decode_attention", out, want, PA_TOL)
                return out
            exact = paged_attention_f64(q, kc, vc, table, lens)
            err = (out.double() - exact).abs().max()
            limit = torch.maximum((want.double() - exact).abs().max(),
                                  PA_TOL["float32"] * exact.abs().max())
            self.accumulate(("paged_decode_attention", "float32"),
                            err.float(), (err - limit).float())
            return out

        self.layers.rms_norm_op, self.t.paged_decode_attention = rms, paged
        return self

    def __exit__(self, *exc):
        self.layers.rms_norm_op, self.t.paged_decode_attention = \
            self.rms, self.paged

    def report(self) -> dict:
        """{"kernel/dtype": (calls, max_abs_err, within tolerance)}."""
        return {f"{k[0]}/{k[1]}": (n, float(self.err[k]),
                                   float(self.over[k]) <= 0.0)
                for k, n in self.calls.items()}


def _digests(tree) -> list:
    from repro_torch.distributed.sharding import tree_leaves
    return [_digest(t) for t in tree_leaves(tree)]


def _same_on_every_rank(mine: list, what: str) -> None:
    """Every rank holds the same whole tensors: this rank's `_digests`
    gathered and compared with every other's (the ranks draw from the
    same seed, each on its own device generator)."""
    import torch.distributed as dist
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    assert all(d == mine for d in every), f"{what} differ between ranks"


def _cfg(cfg, layers=None, dtype=None):
    """`cfg` (a config or its published name) at `layers` and in `dtype`
    where given."""
    import dataclasses
    from repro_torch.configs import get_config
    if isinstance(cfg, str):
        cfg = get_config(cfg)
    kw = {}
    if layers is not None:
        kw["num_layers"] = layers
    if dtype is not None:
        kw["dtype"] = dtype
    return dataclasses.replace(cfg, **kw) if kw else cfg


def serve_runs(label, cfg, meshes, slots, prompt, steps, f32_layers,
               f32_steps, seq=None, ground=False) -> list:
    """A serving config's runs on each of `meshes`: as given, and in f32
    at `f32_layers` layers. A run is its prefill cell (`slots` x
    `prompt`, params from SEED) and greedy steps of its decode cell at
    seq_len `seq` (default: just long enough, one more step for the
    profile); `ground`: its unsharded path also runs an f32 prefill,
    the ground of the bf16 logits' bound. Runs with the same "ref" share
    one unsharded path."""
    runs = []
    for d, m in meshes:
        tag = f"{label}" if len(meshes) == 1 else f"{label} {d}x{m}"
        for dt, c, n in (("bf16", cfg, steps),
                         ("f32", _cfg(cfg, f32_layers, "float32"),
                          f32_steps)):
            runs.append({"key": f"{tag}/{dt}", "ref": f"{label}/{dt}",
                         "cfg": c, "mesh": (d, m), "slots": slots,
                         "prompt": prompt, "steps": n,
                         "seq": seq or prompt + n + 1,
                         "ground": ground and dt == "bf16"})
    return runs


def _serve_inputs(dev, cfg, slots: int, prompt: int, steps: int):
    """Seeded prompts and, for an audio config, each decode step's frame:
    (prefill batch, list of decode batches or None for greedy tokens)."""
    import numpy as np
    import torch
    from repro_torch.models.transformer import DTYPES
    rng = np.random.default_rng(SEED)
    if cfg.frontend.kind == "audio":
        frames = torch.from_numpy((0.02 * rng.standard_normal(
            (slots, prompt + steps, cfg.d_model))).astype(np.float32))
        frames = frames.to(dev, DTYPES[cfg.dtype])
        return ({"frame_embeds": frames[:, :prompt]},
                [{"frame_embed": frames[:, prompt + i:prompt + i + 1]}
                 for i in range(steps)])
    toks = rng.integers(0, cfg.vocab_size, (slots, prompt)).astype(np.int32)
    return {"tokens": torch.from_numpy(toks).to(dev)}, None


def _greedy_tok(logits):
    import torch
    return logits[:, -1:].argmax(-1).to(torch.int32)


def _drawn(dev, model, seed: int):
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return model.init_params(gen)


def _one_at_a_time(fn):
    """fn() on each rank in turn (the others wait at barriers): whole
    params are drawn on one rank at a time, so two ranks' copies of a
    large model never share the card at once."""
    import torch
    import torch.distributed as dist
    out = None
    for r in range(dist.get_world_size()):
        if dist.get_rank() == r:
            out = fn()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
        dist.barrier()
    return out


def _peak(dev):
    import torch
    return torch.cuda.max_memory_allocated() if dev.type == "cuda" else None


def _reset_peak(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def serve_plain(dev, run) -> dict:
    """The unsharded path on a serving run's inputs: the plain prefill's
    last logits and RMSNorm launches, the greedy steps' tokens and their
    times; with run["ground"] also the last logits and tokens of an f32
    run from the same seed and inputs (how far bf16 itself moves them)."""
    import torch
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.models import build_model
    cfg, steps = run["cfg"], run["steps"]
    ground = (serve_plain(dev, dict(run, cfg=_cfg(cfg, dtype="float32"),
                                    steps=1, ground=False))
              if run["ground"] else None)
    model = build_model(cfg)
    params = _drawn(dev, model, SEED)
    batch, frames = _serve_inputs(dev, cfg, run["slots"], run["prompt"],
                                  steps)
    _sync(dev)
    rms_kernel.launches = 0
    t = time.perf_counter()
    lg, cache = model.prefill(params, batch, max_len=run["seq"])
    tok = _greedy_tok(lg)
    _sync(dev)
    prefill_s = time.perf_counter() - t
    prefill_rms = rms_kernel.launches
    toks, step_s = [tok.cpu()], []
    for i in range(steps):
        t = time.perf_counter()
        lg2, cache = model.decode_step(
            params, frames[i] if frames else {"token": tok}, cache)
        tok = _greedy_tok(lg2)
        toks.append(tok.cpu())
        step_s.append(time.perf_counter() - t)
    out = {"logits": lg[:, -1:].float().cpu().numpy(),
           "tokens": torch.cat(toks, 1).numpy(), "prefill_s": prefill_s,
           "prefill_rms": prefill_rms, "decode_s": step_s,
           "logits_f32": None if ground is None else ground["logits"],
           "tokens_f32": None if ground is None else ground["tokens"]}
    del params, cache, lg
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def serve_on_mesh(dev, mesh, run) -> dict:
    """A serving run's prefill cell and greedy steps of its decode cell
    on `mesh` (params from SEED, drawn and laid out one rank at a time,
    the same on every rank; the decode cell's cache the plain prefill's),
    one more decode step profiled: the whole last logits, the tokens,
    times, launches and peak memory."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.distributed.sharding import full, place
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.launch.steps import build_cell
    cfg, slots, seq = run["cfg"], run["slots"], run["seq"]
    pre = build_cell(cfg, ShapeConfig("mesh_prefill", seq_len=run["prompt"],
                                      global_batch=slots, kind="prefill"),
                     mesh)
    dec = build_cell(cfg, ShapeConfig("mesh_decode", seq_len=seq,
                                      global_batch=slots, kind="decode"),
                     mesh)
    batch, frames = _serve_inputs(dev, cfg, slots, run["prompt"],
                                  run["steps"])
    _reset_peak(dev)

    def draw():
        params = _drawn(dev, pre["model"], SEED)
        lg, cache = dec["model"].prefill(params, batch, max_len=seq)
        got = (_digests(params), place(params, pre["in_shardings"][0]),
               place(cache, dec["in_shardings"][2]), _greedy_tok(lg))
        del params, cache, lg
        return got

    digests, p_d, c_d, tok = _one_at_a_time(draw)
    _same_on_every_rank(digests, f"{cfg.name} params")
    out = {}
    _sync(dev)
    rms_kernel.launches = 0
    t = time.perf_counter()
    logits, pre_cache = pre["fn"](p_d, place(batch, pre["in_shardings"][1]))
    logits = full(logits)
    _sync(dev)
    out["prefill_s"] = time.perf_counter() - t
    out["prefill_rms"] = rms_kernel.launches
    out["logits"] = logits.float().cpu().numpy()   # numpy: it pickles
    del pre_cache, logits
    toks, step_s = [tok.cpu()], []
    rms_kernel.launches = pa_kernel.launches = 0
    for i in range(run["steps"]):
        t = time.perf_counter()
        b = frames[i] if frames else {"token": tok}
        tok_d, c_d = dec["fn"](p_d, place(b, dec["in_shardings"][1]), c_d)
        tok = full(tok_d)
        toks.append(tok.cpu())
        step_s.append(time.perf_counter() - t)
    out["decode_rms"] = rms_kernel.launches
    out["decode_paged"] = pa_kernel.launches
    out["tokens"] = torch.cat(toks, 1).numpy()
    out["decode_s"] = step_s
    b = frames[-1] if frames else {"token": tok}
    out["decode_profile"] = profiled(dev, lambda: full(dec["fn"](
        p_d, place(b, dec["in_shardings"][1]), c_d)[0]))
    out["peak_bytes"] = _peak(dev)
    return out


def cell_plain(dev, run) -> dict:
    """The unsharded train step on a train cell's inputs: losses, grad
    norms and step times."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    cfg = run["cfg"]
    model = build_model(cfg)
    params = _drawn(dev, model, SEED)
    opt = adamw.adamw_init(params)
    shape = ShapeConfig("mesh_cell", seq_len=run["seq"],
                        global_batch=run["batch"], kind="train")
    step = make_train_step(model, adamw.AdamWConfig())
    out = {"losses": [], "grad_norms": [], "step_s": []}
    for i in range(run["steps"]):
        b = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
            cfg, shape, step=i, num_microbatches=TRAIN_MICRO).items()}
        _sync(dev)
        t = time.perf_counter()
        params, opt, m = step(params, opt, b)
        out["losses"].append(float(m["loss"]))
        out["step_s"].append(time.perf_counter() - t)
        out["grad_norms"].append(float(m["grad_norm"]))
    del params, opt
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def cell_on_mesh(dev, mesh, run) -> dict:
    """`build_cell`'s train cell on `mesh`: params drawn and laid out one
    rank at a time, the AdamW state made from the placed params (each
    rank's shards only), the steps on make_batch's batches."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.distributed.sharding import full, place, tree_leaves
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.launch.steps import build_cell
    from repro_torch.optim import adamw
    cfg = run["cfg"]
    shape = ShapeConfig("mesh_cell", seq_len=run["seq"],
                        global_batch=run["batch"], kind="train")
    cell = build_cell(cfg, shape, mesh)
    in_sh = cell["in_shardings"]
    _reset_peak(dev)

    def draw():
        params = _drawn(dev, cell["model"], SEED)
        return _digests(params), place(params, in_sh[0])

    digests, p_d = _one_at_a_time(draw)
    _same_on_every_rank(digests, f"{cfg.name} params")
    o_d = adamw.adamw_init(p_d)
    n = next(iter(cell["args"][2].values())).shape[0]
    out = {"losses": [], "grad_norms": [], "step_s": []}
    rms_kernel.launches = 0
    for i in range(run["steps"]):
        b = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
            cfg, shape, step=i, num_microbatches=n).items()}
        _sync(dev)
        t = time.perf_counter()
        p_d, o_d, m = cell["fn"](p_d, o_d, place(b, in_sh[2]))
        m = full(m)
        out["losses"].append(float(m["loss"]))
        out["step_s"].append(time.perf_counter() - t)
        out["grad_norms"].append(float(m["grad_norm"]))
    out["rms"] = rms_kernel.launches
    leaves = tree_leaves((p_d, o_d))
    out["state_local"] = sum(x.to_local().numel() * x.element_size()
                             for x in leaves)
    out["state_whole"] = sum(x.numel() * x.element_size() for x in leaves)
    out["microbatches"] = n
    out["peak_bytes"] = _peak(dev)
    return out


def _train_shape(run):
    from repro_torch.configs import ShapeConfig
    return ShapeConfig("mesh_train", seq_len=run["seq"],
                       global_batch=run["batch"], kind="train")


def train_on_mesh(dev, mesh, run, checkpointer) -> tuple:
    """`train(..., mesh=)` of a train run (the params it draws checked
    equal on every rank first); with run["ckpt"] the run checkpoints at
    its last step through `checkpointer` (rank 0's; None elsewhere) and
    every rank gathers the whole state. Returns (measurements, the whole
    state on rank 0 of a checkpointed run, else None)."""
    import torch.distributed as dist
    from repro_torch.distributed import shared_card
    from repro_torch.distributed.sharding import full, tree_leaves
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.kernels.rs_gf256 import kernel as gf_kernel
    from repro_torch.launch.train import train
    from repro_torch.models import build_model
    # train() draws these on every rank: the same everywhere
    _same_on_every_rank(_digests(_drawn(dev, build_model(run["cfg"]), 0)),
                        "the train params")
    ck = run["ckpt"]
    _sync(dev)
    _reset_peak(dev)
    rms_kernel.launches = gf_kernel.launches = gf_kernel.gather_launches = 0
    before = dict(shared_card.moved)
    t = time.perf_counter()
    res = train(run["cfg"], _train_shape(run), steps=run["steps"],
                num_microbatches=run["micro"], mesh=mesh,
                checkpointer=checkpointer if ck else None,
                checkpoint_every=run["steps"] if ck else 0,
                device=dev.type)
    _sync(dev)
    leaves = tree_leaves(res.state)
    out = {"losses": res.losses, "grad_norms": res.grad_norms,
           "step_s": res.step_seconds, "wall": time.perf_counter() - t,
           "rms": rms_kernel.launches, "gf": codec_launches(),
           "coll": {k: shared_card.moved[k] - before[k]
                    for k in ("seconds", "bytes")},
           "peak_bytes": _peak(dev),
           "state_local": sum(x.to_local().numel() * x.element_size()
                              for x in leaves),
           "state_whole": sum(x.numel() * x.element_size() for x in leaves)}
    saved = None
    if ck:
        state = full(res.state)           # every rank takes part
        saved = state if dist.get_rank() == 0 else None
        del state
    return out, saved


def _pods_agree(mesh, tree) -> None:
    """Every leaf's local shard digested and gathered: the ranks at one
    place of the mesh without the pod axis hold the same bits in every
    pod (so the pods' whole tensors are equal, with no gather of
    them)."""
    import torch.distributed as dist
    from repro_torch.distributed.sharding import tree_leaves
    coord = tuple(mesh.device_mesh.get_coordinate()[1:])   # pod is dim 0
    mine = (coord, [_digest(x.to_local()) for x in tree_leaves(tree)])
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    for c, d in every:
        assert c != coord or d == mine[1], \
            "the pods' params or AdamW state differ"


def _leaf_norms(tree) -> list:
    """Each leaf's f32 norm: a fingerprint of a state to hold two runs'
    params within a relative bound without moving them."""
    from repro_torch.distributed.sharding import tree_leaves
    return [float(t.float().norm()) for t in tree_leaves(tree)]


def pods_on_mesh(dev, run) -> dict:
    """The compressed step on (pod = POD, data = world / POD, model = 1),
    phase 13b's cell: params from seed 0, the batches `TokenPipeline`'s.
    Checks on gathered digests that both pods hold bit-identical params
    and AdamW state (the whole tensors) after every step; returns the
    losses, times and the whole params' leaf norms."""
    import torch
    import torch.distributed as dist
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed.sharding import full, place
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.optim import adamw
    cfg, shape = run["cfg"], _train_shape(run)
    mesh = make_test_mesh(dist.get_world_size() // POD, 1, pod=POD,
                          device=dev.type)
    cell = build_cell(cfg, shape, mesh, grad_compress=True)
    in_sh = cell["in_shardings"]
    n = cell["args"][2]["tokens"].shape[0]
    _reset_peak(dev)

    def draw():
        params = _drawn(dev, cell["model"], 0)
        opt = adamw.adamw_init(params)
        opt["err"] = {k: torch.zeros(p.shape, dtype=torch.float32,
                                     device=dev) for k, p in params.items()}
        return place(params, in_sh[0]), place(opt, in_sh[1])

    p_d, o_d = _one_at_a_time(draw)
    init_norms = _leaf_norms(full(p_d))
    pipe = TokenPipeline(cfg, shape, num_microbatches=n, seed=0)
    out = {"losses": [], "step_s": [], "grad_norms": []}
    rms_kernel.launches = 0
    for _ in range(run["steps"]):
        b = {k: torch.from_numpy(v).to(dev) for k, v in next(pipe).items()}
        _sync(dev)
        t = time.perf_counter()
        p_d, o_d, m = cell["fn"](p_d, o_d, place(b, in_sh[2]))
        m = full(m)
        out["losses"].append(float(m["loss"]))
        out["step_s"].append(time.perf_counter() - t)
        out["grad_norms"].append(float(m["grad_norm"]))
        # both pods' params and AdamW state, bit for bit: each rank's
        # shards against those of the rank at its place in the other pod
        _pods_agree(mesh, {"p": p_d, **{k: v for k, v in o_d.items()
                                        if k != "err"}})
    out["rms"] = rms_kernel.launches
    out["leaf_norms"] = _leaf_norms(full(p_d))
    out["init_norms"] = init_norms
    out["microbatches"] = n
    out["peak_bytes"] = _peak(dev)
    return out


def _elastic(dev, run, ck, saved) -> dict:
    """Rank 0 after the world: a checkpointed train run's state restored
    bit for bit against the run's `full_tensor()`s, then one more step of
    `train(..., resume=True)` on a 1 x 1 mesh."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.sharding import tree_leaves
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.kernels.rs_gf256 import kernel as gf_kernel
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.train import train
    steps = run["steps"]
    assert ck.latest_step() == steps, ck.latest_step()
    back = tree_leaves(ck.restore(steps, like=saved))
    out = {"leaves": len(back), "same": all(
        torch.equal(a, b) for a, b in zip(back, tree_leaves(saved)))}
    del back, saved
    gf_kernel.launches = gf_kernel.gather_launches = rms_kernel.launches = 0
    res = train(run["cfg"], _train_shape(run), steps=steps + 1,
                num_microbatches=run["micro"], checkpointer=ck, resume=True,
                mesh=make_test_mesh(1, 1, device=dev.type), device=dev.type)
    out.update(restored_from=res.restored_from, loss=res.losses[0],
               gf_restore=codec_launches(), rms=rms_kernel.launches)
    dist.destroy_process_group()
    assert ck.store.close()
    return out


def _host_available() -> int:
    """MemAvailable of /proc/meminfo, in bytes (0 where there is none)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def _gather_rate(dev, world: int) -> float:
    """The collectives' rate on this device: one all-gather of 256 MB per
    rank (2 MB on the CPU) through the shared buffers, after a warm one
    (bytes of results a second)."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import shared_card
    x = torch.zeros((128 if dev.type == "cuda" else 1) * MB,
                    dtype=torch.bfloat16, device=dev)
    name = dist.group.WORLD.group_name
    shared_card.all_gather_into_tensor(x, world, name)
    _sync(dev)
    t = time.perf_counter()
    shared_card.all_gather_into_tensor(x, world, name)
    _sync(dev)
    return world * x.numel() * 2 / (time.perf_counter() - t)


def mesh_rank(rank: int, world: int, init_file: str, device: str,
              job: dict) -> dict:
    """One rank of phase 13c or 13d (`job["phase"]`) on a gloo world of
    `world` over `init_file`: the collectives' rate, then the runs of
    `job` whose mesh has `world` ranks (`serve_on_mesh`, `cell_on_mesh`,
    `train_on_mesh`; at FAM_FOUR ranks also `pods_on_mesh`), every per-shard
    kernel call held to its plain version (`ShardKernelCheck`). Rank 0
    holds the checkpoint store of a checkpointed train run and, once the
    world is gone, resumes its state on a 1 x 1 mesh (`_elastic`).
    Returns this rank's measurements."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=600))
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed import shared_card
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.train import make_store_for_checkpoints
    out = {"rank": rank, "trains": {}, "cells": {}, "serve": {}}
    ck = ck_run = saved = None
    check = ShardKernelCheck()

    def runs(kind):
        for run in job[kind]:
            d, m = run["mesh"]
            if d * m == world:
                t = time.perf_counter()
                before = dict(shared_card.moved)
                yield run, make_test_mesh(d, m, device=device)
                out[kind][run["key"]]["coll"] = {
                    k: shared_card.moved[k] - before[k]
                    for k in ("seconds", "bytes")}
                if rank == 0:
                    print(f"phase {job['phase']} rank 0 of {world}: "
                          f"{kind} {run['key']} on {d}x{m} in "
                          f"{time.perf_counter() - t:.3f} s (host memory "
                          f"available {_host_available()} bytes)",
                          flush=True)
                if dev.type == "cuda":
                    torch.cuda.empty_cache()

    try:
        out["gather_rate"] = _gather_rate(dev, world)
        with check:
            for run, mesh in runs("serve"):
                out["serve"][run["key"]] = serve_on_mesh(dev, mesh, run)
            for run, mesh in runs("cells"):
                out["cells"][run["key"]] = cell_on_mesh(dev, mesh, run)
            # last: rank 0 then holds a checkpointed run's whole state
            for run, mesh in runs("trains"):
                if run["ckpt"] and rank == 0:
                    ck, ck_run = Checkpointer(
                        make_store_for_checkpoints(device=device)), run
                out["trains"][run["key"]], state = train_on_mesh(
                    dev, mesh, run, ck)
                saved = state if state is not None else saved
                del state
            if job["pods"] is not None and world == FAM_FOUR:
                out["pods"] = pods_on_mesh(dev, job["pods"])
        out["kernels"] = check.report()
    finally:
        shared_card.release()
        dist.destroy_process_group()
    if ck is not None:
        out["elastic"] = _elastic(dev, ck_run, ck, saved)
    return out


def mesh_worker(rank, world, init_file, device, job, results) -> None:
    """A spawned rank of phase 13c or 13d: `mesh_rank`, its measurements
    put on `results`."""
    results.put(mesh_rank(rank, world, init_file, device, job))


def spawn_world(dev, work: Path, world: int, job: dict) -> list:
    """`mesh_rank` on a world of `world` spawned processes (this one only
    waits, at most FAM_DEADLINE seconds, then stops them all); returns every
    rank's results in rank order."""
    import queue

    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_file = work / f"{job['phase']}_{world}.init"
    init_file.unlink(missing_ok=True)
    procs = [ctx.Process(target=mesh_worker,
                         args=(r, world, str(init_file), dev.type, job,
                               results)) for r in range(world)]
    for p in procs:
        p.start()
    t = time.perf_counter()
    got = []
    try:
        while len(got) < world:
            try:
                got.append(results.get(timeout=5))
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                assert not dead, f"a rank process failed: {dead}"
                assert time.perf_counter() - t < FAM_DEADLINE, \
                    f"{world} ranks still running after {FAM_DEADLINE} s"
        for p in procs:
            p.join(timeout=120)
        assert [p.exitcode for p in procs] == [0] * world, \
            [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
    got.sort(key=lambda r: r["rank"])
    return got


def _rows_equal(a, b) -> int:
    """How many sequences (rows; all codebooks of an audio token) agree."""
    return int((a == b).reshape(a.shape[0], -1).all(axis=1).sum())


def check_serve(phase: str, run: dict, ref: dict, ranks: list, card: str,
                on_card: bool, launches: dict) -> None:
    """A serving run's checks against its unsharded path, and its line:
    the ranks' tokens equal; f32: the last logits within LOGIT_TOL's
    1e-4 x (1 + their largest magnitude) of the unsharded f32 run's and
    the tokens equal; bf16: every last logit within the larger of MESH_LOGIT_TOL
    and twice the distance bf16 itself puts between the unsharded run
    and an f32 one (where the run has that ground; both bf16 runs sit
    about that far from the f32 answer, so from each other up to twice
    it: an MoE's router turns a rounding into another expert); on the
    card each rank's prefill launching the unsharded prefill's RMSNorms,
    each decode step as many, and the paged kernel once a layer and
    step where the family has a paged cache. Adds the launches."""
    import numpy as np
    cfg, steps, (d, m) = run["cfg"], run["steps"], run["mesh"]
    srv = [r["serve"][run["key"]] for r in ranks]
    s0 = srv[0]
    key = f"{run['key']} ({d}, {m})"
    assert all((s["tokens"] == s0["tokens"]).all() for s in srv), key
    assert np.isfinite(s0["logits"]).all(), key
    gap = np.abs(s0["logits"] - ref["logits"])
    lg_diff = float(gap.max())
    same = float((s0["tokens"] == ref["tokens"]).mean())
    # the first greedy step's tokens (a miss there is then fed on)
    first = _rows_equal(s0["tokens"][:, 1], ref["tokens"][:, 1])
    f32_dist, vs_f32 = 0.0, ""
    if cfg.dtype == "float32":
        limit = LOGIT_TOL["float32"] * (1 + float(np.abs(ref["logits"]).max()))
        assert lg_diff <= limit and (s0["tokens"] == ref["tokens"]).all(), \
            (key, lg_diff, limit)
        bound = (f"<= {limit:.4e}, {LOGIT_TOL['float32']:g} x (1 + the "
                 f"largest |logit|)")
    else:
        if ref["logits_f32"] is not None:
            f32_dist = float(np.abs(ref["logits"]
                                    - ref["logits_f32"]).max())
            vs_f32 = (f" (the unsharded bf16 run vs f32 on it: "
                      f"{_rows_equal(ref['tokens_f32'][:, 1], ref['tokens'][:, 1])}"
                      f" of {run['slots']})")
        limit = max(MESH_LOGIT_TOL, 2 * f32_dist)
        assert lg_diff <= limit, (key, lg_diff, f32_dist)
        bound = (f"<= {limit:.4e}, the larger of {MESH_LOGIT_TOL:g} and "
                 f"twice the unsharded bf16 run vs f32, 2 x "
                 f"{f32_dist:.4e}")
    paged = cfg.family not in ("ssm", "hybrid")
    want = ((ref["prefill_rms"], ref["prefill_rms"] * steps,
             cfg.num_layers * steps * paged) if on_card else (0, 0, 0))
    assert ref["prefill_rms"] > 0 or not on_card, key
    for s in srv:
        have = (s["prefill_rms"], s["decode_rms"], s["decode_paged"])
        assert have == want, (key, have, want)
        launches["rmsnorm"] += s["prefill_rms"] + s["decode_rms"]
        launches["paged_decode_attention"] += s["decode_paged"]
    dp = s0["decode_profile"]
    busy = (f"{100 * dp['device_s'] / dp['wall_s']:.2f}%"
            if dp["device_s"] is not None else "not measured")
    print(
        f"phase {phase} serve {run['key']} ({cfg.name}, {cfg.num_layers} "
        f"layers, mesh ({d}, {m}), {d * m} processes): prefill cell "
        f"{run['slots']} x {run['prompt']} in "
        f"{[round(s['prefill_s'], 3) for s in srv]} s per rank (unsharded "
        f"{ref['prefill_s']:.3f} s); last logits vs unsharded max diff "
        f"{lg_diff:.4e} ({bound}); decode cell at {run['seq']}, {steps} "
        f"greedy steps: tokens equal on every rank, {100 * same:.2f}% "
        f"equal to the unsharded path's"
        f"{' (asserted)' if cfg.dtype == 'float32' else ''}, the first "
        f"step's {first} of {run['slots']}{vs_f32}; step "
        f"{step_times(s0['decode_s'])} (unsharded "
        f"{step_times(ref['decode_s'])}); launches per rank prefill "
        f"{s0['prefill_rms']} RMSNorm, decode {s0['decode_rms']} RMSNorm "
        f"+ {s0['decode_paged']} paged; rank 0 inside the collectives "
        f"{s0['coll']['seconds']:.3f} s ({s0['coll']['bytes']} bytes); one "
        f"decode step profiled on rank 0: {dp['wall_s'] * 1e3:.3f} ms, "
        f"device busy {busy}, inside the collectives "
        f"{100 * dp['coll_s'] / dp['wall_s']:.2f}%; max_memory_allocated "
        f"per rank {[s['peak_bytes'] for s in srv]} | {card}")


def check_kernels(phase: str, worlds: list, card: str) -> dict:
    """Every rank's per-shard kernel calls within their tolerances
    (`ShardKernelCheck`), and their line; returns the worst errors."""
    errs = {"rmsnorm": 0.0, "paged_decode_attention": 0.0}
    calls = {}
    for ranks in worlds:
        for r in ranks:
            for key, (n, err, ok) in r["kernels"].items():
                assert ok, (len(ranks), r["rank"], key, err)
                name = key.split("/")[0]
                errs[name] = max(errs[name], err)
                calls.setdefault(f"{key} ({len(ranks)} processes)",
                                 []).append(n)
    rates = [[round(r["gather_rate"] / 1e9, 3) for r in ranks]
             for ranks in worlds]
    print(
        f"phase {phase} per-shard kernel calls held to the plain version on "
        f"the same local tensors (RMSNorm atol=rtol {RMS_TOL}, paged "
        f"{PA_TOL}), calls per rank {json.dumps(calls)}; max_abs_err "
        f"{json.dumps({k: '%.3e' % v for k, v in errs.items()})}; "
        f"all-gather through the shared buffers (256 MB per rank on the "
        f"card) {rates} GB/s of results per rank | {card}")
    return errs


def mesh_job(cfg15, cfg3) -> dict:
    """What the ranks of phase 13c run (the spawned ones import this
    module afresh, so configs and sizes travel here): per mesh of
    MESH_SHAPES, `train(..., mesh=)` of `cfg15` for MESH_CKPT steps
    (checkpointed on the first mesh) and one step in f32 at
    MESH_F32_LAYERS layers; `cfg3`'s serving runs."""
    trains = []
    for d, m in MESH_SHAPES:
        base = {"mesh": (d, m), "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                "micro": TRAIN_MICRO}
        trains += [dict(base, key=f"{d}x{m}", cfg=cfg15, steps=MESH_CKPT,
                        ckpt=(d, m) == MESH_SHAPES[0]),
                   dict(base, key=f"{d}x{m}/f32", steps=1, ckpt=False,
                        cfg=_cfg(cfg15, MESH_F32_LAYERS, "float32"))]
    return {"phase": "13c", "trains": trains, "cells": [], "pods": None,
            "serve": serve_runs("qwen3", cfg3, MESH_SHAPES, SLOTS, PROMPT,
                                MESH_DECODE_STEPS, MESH_F32_LAYERS,
                                MESH_F32_STEPS, seq=MESH_DECODE_SEQ)}


def mesh_phase(dev, card: str, work: Path, cfg15, cfg3,
               cells: dict) -> dict:
    """Phase 13c: `build_cell`'s cells and `train(..., mesh=)` over data
    = 2 and model = 2, MESH_RANKS spawned processes on the one device in
    a gloo world, held to the unsharded path in this process; then the
    (2, 1) run's checkpoint, saved by rank 0, resumed there on a 1 x 1
    mesh. Returns the kernels' launches and errors."""
    import torch
    from repro_torch.launch.train import train
    on_card = dev.type == "cuda"
    job = mesh_job(cfg15, cfg3)
    t0 = time.perf_counter()
    # ---- the unsharded path on the same inputs ------------------------
    shape = _train_shape(job["trains"][0])
    res = train(cfg15, shape, steps=MESH_CKPT + 1,
                num_microbatches=TRAIN_MICRO, device=dev.type)
    refs = {"losses": res.losses, "step_s": res.step_seconds,
            "grad_norms": res.grad_norms}
    res = train(_cfg(cfg15, dtype="float32"), shape, steps=MESH_CKPT,
                num_microbatches=TRAIN_MICRO, device=dev.type)
    refs["losses_f32"], refs["grad_norms_f32"] = res.losses, res.grad_norms
    res = train(job["trains"][1]["cfg"], shape, steps=1,
                num_microbatches=TRAIN_MICRO, device=dev.type)
    f32_ref = {"loss": res.losses[0], "grad_norm": res.grad_norms[0]}
    del res
    serve = {}
    for run in job["serve"]:
        if run["ref"] not in serve:
            serve[run["ref"]] = serve_plain(dev, run)
    if on_card:
        torch.cuda.empty_cache()
    t_refs = time.perf_counter() - t0
    got = spawn_world(dev, work, MESH_RANKS, job)
    t_mesh = time.perf_counter() - t0 - t_refs
    L15 = cfg15.num_layers

    # ---- the checks, every rank's -------------------------------------
    # bf16 losses: the mesh run's distance from the unsharded one within
    # the unsharded bf16 run's own distance from f32 on the same seed and
    # data (the rounding bf16 already has; the mesh reorders bf16 sums)
    f32_dist = max(abs(a - b) for a, b in zip(refs["losses"],
                                              refs["losses_f32"]))
    ground = max(MESH_LOSS_REL * max(abs(x) for x in refs["losses"]),
                 f32_dist)
    per_train = TRAIN_MICRO * (4 * L15 + 1)
    per_f32 = TRAIN_MICRO * (4 * MESH_F32_LAYERS + 1)
    launches = {"rmsnorm": 0, "paged_decode_attention": 0}
    for d, m in MESH_SHAPES:
        tag = f"{d}x{m}"
        runs = [r["trains"][tag] for r in got]
        ft = [r["trains"][f"{tag}/f32"] for r in got]
        r0 = runs[0]
        assert all(r["losses"] == r0["losses"]
                   and r["grad_norms"] == r0["grad_norms"] for r in runs), tag
        diff = max(abs(a - b) for a, b in zip(r0["losses"],
                                              refs["losses"]))
        assert diff <= ground, (tag, diff, ground, r0["losses"],
                                refs["losses"])
        # AdamW's norm is the global one: in f32 at reduced depth within
        # MESH_GN_REL of the unsharded run's, the loss within LOSS_TOL
        assert all((f["losses"], f["grad_norms"])
                   == (ft[0]["losses"], ft[0]["grad_norms"]) for f in ft), ft
        gn = abs(ft[0]["grad_norms"][0] / f32_ref["grad_norm"] - 1)
        f32_loss = abs(ft[0]["losses"][0] - f32_ref["loss"])
        assert gn <= MESH_GN_REL and f32_loss <= LOSS_TOL, \
            (tag, ft[0]["losses"], ft[0]["grad_norms"], f32_ref)
        want = (MESH_CKPT * per_train, per_f32) if on_card else (0, 0)
        assert all((r["rms"], f["rms"]) == want for r, f in zip(runs, ft)), \
            [(r["rms"], f["rms"]) for r, f in zip(runs, ft)]
        launches["rmsnorm"] += sum(r["rms"] + f["rms"]
                                   for r, f in zip(runs, ft))
        half = [r["state_local"] / r["state_whole"] for r in runs]
        gl = r0["coll"]
        print(
            f"phase 13c train {tag}: {cfg15.name} at published widths and "
            f"depth, {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step in "
            f"{TRAIN_MICRO} microbatches, {MESH_CKPT} steps of train(..., "
            f"mesh=make_test_mesh({d}, {m})): losses "
            f"{r0['losses']} (equal on every rank); unsharded train() "
            f"{refs['losses'][:MESH_CKPT]}, diff {diff:.6e} <= {ground:.6e} "
            f"(the larger of 2^-8 of the loss and the unsharded bf16 run's "
            f"distance from f32 {f32_dist:.6e}; f32 losses "
            f"{refs['losses_f32']}); grad norms {r0['grad_norms']} on every "
            f"rank (unsharded {refs['grad_norms'][:MESH_CKPT]}, f32 "
            f"{refs['grad_norms_f32']}: not held in bf16, see "
            f"MESH_GN_REL); one f32 step at {MESH_F32_LAYERS} layers: grad "
            f"norm {ft[0]['grad_norms'][0]:.6f} vs unsharded "
            f"{f32_ref['grad_norm']:.6f} (relative {gn:.3e} <= "
            f"{MESH_GN_REL:g}), loss diff {f32_loss:.3e} (<= {LOSS_TOL:g}); "
            f"params drawn equal on every rank (digests); step "
            f"{step_times(r0['step_s'])} (unsharded "
            f"{step_times(refs['step_s'])}; phase 13a's cell "
            f"{cells['dry']['train']['median_s'] * 1e3:.3f} ms); each "
            f"rank's state {[round(h, 4) for h in half]} of the whole "
            f"{r0['state_whole']} bytes; max_memory_allocated per rank "
            f"{[r['peak_bytes'] for r in runs]}; RMSNorm launches per "
            f"rank {[r['rms'] for r in runs]} ({per_train} per step)"
            f"; rank 0 inside the collectives {gl['seconds']:.3f} s of the "
            f"run's {r0['wall']:.3f} s "
            f"({100 * gl['seconds'] / r0['wall']:.2f}%; "
            f"{gl['bytes']} bytes in the collectives' results) | {card}")
    for run in job["serve"]:
        check_serve("13c", run, serve[run["ref"]], got, card, on_card,
                    launches)
    errs = check_kernels("13c", [got], card)

    # ---- elastic restart: the (2, 1) run's checkpoint at 1 x 1 --------
    el = got[0]["elastic"]
    assert el["same"], "restored state differs"
    assert el["restored_from"] == MESH_CKPT, el["restored_from"]
    resume_diff = abs(el["loss"] - refs["losses"][MESH_CKPT])
    assert resume_diff <= ground, (resume_diff, ground)
    launches["rmsnorm"] += el["rms"]
    gf_save = got[0]["trains"][job["trains"][0]["key"]]["gf"]
    print(
        f"phase 13c elastic restart: rank 0 of the data = 2 run saved step "
        f"{MESH_CKPT} ({el['leaves']} leaves, stored whole; GF(256) "
        f"launches {gf_save}); restored bit-identical to the run's "
        f"full_tensor()s; train(..., resume=True) on a 1 x 1 mesh: "
        f"restored_from {MESH_CKPT}, step {MESH_CKPT + 1}'s loss vs the "
        f"straight run's {resume_diff:.6e} (<= {ground:.6e}, the train "
        f"runs' bound: the state is the data = 2 run's); GF(256) launches "
        f"in the resume {el['gf_restore']} | {card}")
    print(f"phase 13c wall time: {time.perf_counter() - t0:.3f} s "
          f"(unsharded path {t_refs:.3f} s, {MESH_RANKS} ranks "
          f"{t_mesh:.3f} s); phase 13a's cells for the serving runs: "
          f"prefill {cells['dry']['prefill']['median_s']:.3f} s, decode "
          f"step {cells['dry']['decode']['median_s'] * 1e3:.3f} ms")
    if on_card:
        torch.cuda.empty_cache()
    return {**launches, "gf256": gf_save + el["gf_restore"], "errs": errs}


GRANITE, MUSICGEN = "granite-moe-1b-a400m", "musicgen-large"
# phase 13d's serving configs: (label, config, meshes, slots, prompt,
# steps); RecurrentGemma's prompt + steps cross its 2048-token window
# (the script's 1200 s: 4 greedy steps where 16 are not asked for)
FAM_SERVE = [("moe", QWEN_MOE, [(1, 2)], 4, 256, 16),
             ("rwkv", RWKV6, [(1, 2)], 4, 128, 4),
             ("rgemma", RGEMMA, [(1, 2), (1, 4)], 2, 2045, 4),
             ("musicgen", MUSICGEN, [(1, 2)], 4, 128, 4)]
# the train cells: (label, config, (data, model), layers, batch, seq),
# each cut in depth for the script's time (RecurrentGemma's 3 layers one
# recurrent, recurrent, attention unit)
FAM_TRAIN = [("granite", GRANITE, (1, 2), 8, 4, 1024),
             ("rwkv", RWKV6, (2, 1), 2, 4, 1024),
             ("rgemma", RGEMMA, (2, 1), 3, 4, 1024),
             ("musicgen", MUSICGEN, (2, 1), 4, 4, 1024)]
FAM_TRAIN_STEPS = 1              # steps of each train cell
FAM_F32_LAYERS = 2               # depth of the f32 serving runs
FAM_F32_STEPS = 4                # and their greedy steps
# Granite's train(..., mesh=(2, 1)) with a checkpoint on rank 0: depth
FAM_CKPT_LAYERS = 4
FAM_CKPT_STEPS = 3
FAM_FOUR = 4                     # processes of the (1, 4) and 2 x 2 runs
FAM_DEADLINE = 420               # seconds a world may run before it is stopped


def fam_job() -> dict:
    """What the ranks of phase 13d run, at published widths: the serving
    runs of FAM_SERVE (bf16 at full depth, grounded in an f32 prefill,
    and f32 at FAM_F32_LAYERS layers), the train cells of FAM_TRAIN,
    Granite's checkpointed `train(..., mesh=(2, 1))` and the compressed
    step on pod = 2 x data = 2 (phase 13b's cell)."""
    serve = []
    for label, name, meshes, slots, prompt, steps in FAM_SERVE:
        serve += serve_runs(label, _cfg(name), meshes, slots, prompt, steps,
                            FAM_F32_LAYERS, FAM_F32_STEPS, ground=True)
    cells = [{"key": label, "cfg": _cfg(name, layers), "mesh": mesh,
              "batch": batch, "seq": seq, "steps": FAM_TRAIN_STEPS,
              "depth": _cfg(name).num_layers}
             for label, name, mesh, layers, batch, seq in FAM_TRAIN]
    trains = [{"key": "granite", "cfg": _cfg(GRANITE, FAM_CKPT_LAYERS),
               "mesh": (2, 1), "batch": TRAIN_BATCH // 2, "seq": TRAIN_SEQ,
               "micro": TRAIN_MICRO, "steps": FAM_CKPT_STEPS, "ckpt": True}]
    pods = {"cfg": _cfg(QWEN15), "seq": TRAIN_SEQ, "batch": TRAIN_BATCH,
            "steps": CELL_STEPS}
    return {"phase": "13d", "serve": serve, "cells": cells,
            "trains": trains, "pods": pods}


def family_phase(dev, card: str, work: Path, job: dict,
                 pods13b=None) -> dict:
    """Phase 13d, `job` (`fam_job()`'s): the MoE, RWKV6, RG-LRU and
    MusicGen cells over data or model = 2 (two spawned processes on the
    one device), RecurrentGemma over model = 4 and the compressed step on
    pod = 2 x data = 2 (four), each held to the unsharded path on the
    same inputs (in this process first); Granite-MoE's `train(...,
    mesh=(2, 1))` checkpoint, saved by rank 0, resumed there on 1 x 1.
    `pods13b`: phase 13b's result and bound (its losses and leaf norms
    at data = 1). Returns the kernels' launches and errors."""
    import gc

    import torch
    from repro_torch.launch.train import train
    on_card = dev.type == "cuda"
    # earlier phases' objects can linger in reference cycles (as phase 12
    # found): collect them before the ranks share the card
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        print(f"phase 13d start: device memory allocated "
              f"{torch.cuda.memory_allocated()} bytes, reserved "
              f"{torch.cuda.memory_reserved()}; host memory available "
              f"{_host_available()} bytes", flush=True)
    t0 = time.perf_counter()
    # ---- the unsharded path on the same inputs ------------------------
    serve = {}
    for run in job["serve"]:
        if run["ref"] not in serve:
            serve[run["ref"]] = serve_plain(dev, run)
    cell_refs = {run["key"]: cell_plain(dev, run) for run in job["cells"]}
    ck_run = job["trains"][0]
    straight = train(ck_run["cfg"], _train_shape(ck_run),
                     steps=ck_run["steps"] + 1,
                     num_microbatches=ck_run["micro"], device=dev.type)
    if on_card:
        torch.cuda.empty_cache()
    t_refs = time.perf_counter() - t0
    print(f"phase 13d unsharded path in {t_refs:.3f} s", flush=True)
    # ---- two processes, then four ---------------------------------------
    t = time.perf_counter()
    two = spawn_world(dev, work, 2, job)
    t_two = time.perf_counter() - t
    t = time.perf_counter()
    four = spawn_world(dev, work, FAM_FOUR, job)
    t_four = time.perf_counter() - t

    # ---- the checks and what they print ---------------------------------
    launches = {"rmsnorm": 0, "paged_decode_attention": 0}
    for run in job["serve"]:
        d, m = run["mesh"]
        check_serve("13d", run, serve[run["ref"]],
                    two if d * m == 2 else four, card, on_card, launches)
    for run in job["cells"]:
        d, m = run["mesh"]
        ref = cell_refs[run["key"]]
        runs = [r["cells"][run["key"]] for r in (two if d * m == 2
                                                 else four)]
        r0 = runs[0]
        assert all(r["losses"] == r0["losses"]
                   and r["grad_norms"] == r0["grad_norms"] for r in runs), \
            run["key"]
        cfg = run["cfg"]
        diffs = [abs(a - b) for a, b in zip(r0["losses"], ref["losses"])]
        bound = [MESH_LOSS_REL * abs(b) for b in ref["losses"]]
        assert all(x <= y for x, y in zip(diffs, bound)), (run["key"], diffs,
                                                           bound)
        assert not on_card or all(r["rms"] > 0 for r in runs), run["key"]
        launches["rmsnorm"] += sum(r["rms"] for r in runs)
        share = [round(r["state_local"] / r["state_whole"], 4) for r in runs]
        print(
            f"phase 13d train cell {run['key']} ({cfg.name}, "
            f"{cfg.num_layers} of {run['depth']} layers, cut "
            f"for the script's time, mesh ({d}, {m})): {run['batch']} x "
            f"{run['seq']} tokens a step in {r0['microbatches']} "
            f"microbatches, {run['steps']} step(s): losses {r0['losses']} "
            f"(equal on every rank) vs unsharded {ref['losses']}, diffs "
            f"{[f'{x:.3e}' for x in diffs]} <= 2^-8 of the loss; grad norms "
            f"{r0['grad_norms']} (unsharded {ref['grad_norms']}; bf16, not "
            f"held); params drawn equal on every rank (digests); step "
            f"{step_times(r0['step_s'])} (unsharded "
            f"{step_times(ref['step_s'])}); each rank's state {share} of "
            f"the whole {r0['state_whole']} bytes; rank 0 inside the "
            f"collectives {r0['coll']['seconds']:.3f} s; RMSNorm launches "
            f"per rank {[r['rms'] for r in runs]}; max_memory_allocated per "
            f"rank {[r['peak_bytes'] for r in runs]} | {card}")
    # Granite's train(..., mesh=(2, 1)) and its elastic restart
    ckr = [r["trains"][ck_run["key"]] for r in two]
    el = two[0]["elastic"]
    assert el["same"], "restored state differs"
    assert el["restored_from"] == ck_run["steps"], el["restored_from"]
    assert all(c["losses"] == ckr[0]["losses"] for c in ckr)
    ground = [MESH_LOSS_REL * abs(x) for x in straight.losses]
    diffs = [abs(a - b) for a, b in zip(ckr[0]["losses"], straight.losses)]
    assert all(x <= y for x, y in zip(diffs, ground)), (diffs, ground)
    resume_diff = abs(el["loss"] - straight.losses[ck_run["steps"]])
    assert resume_diff <= ground[ck_run["steps"]], resume_diff
    gf_save = ckr[0]["gf"]
    assert not on_card or (gf_save > 0 and all(c["rms"] > 0 for c in ckr))
    launches["rmsnorm"] += sum(c["rms"] for c in ckr) + el["rms"]
    ck_cfg = ck_run["cfg"]
    print(
        f"phase 13d Granite train(..., mesh=make_test_mesh(2, 1)) "
        f"({ck_cfg.name}, {ck_cfg.num_layers} of "
        f"{_cfg(GRANITE).num_layers} layers: {_state_note(ck_cfg)}), "
        f"{ck_run['batch']} x {ck_run['seq']} tokens a step, "
        f"{ck_run['steps']} steps: losses {ckr[0]['losses']} (equal on "
        f"both ranks) vs train() straight "
        f"{straight.losses[:ck_run['steps']]}, diffs "
        f"{[f'{x:.3e}' for x in diffs]} <= 2^-8 of the loss; step "
        f"{step_times(ckr[0]['step_s'])}; rank 0 saved step "
        f"{ck_run['steps']} ({el['leaves']} leaves, whole; GF(256) "
        f"launches {gf_save}), restored bit-identical to the run's "
        f"full_tensor()s; train(..., resume=True) on 1 x 1: step "
        f"{ck_run['steps'] + 1}'s loss vs the straight run's "
        f"{resume_diff:.6e} (GF(256) launches {el['gf_restore']}); "
        f"max_memory_allocated per rank {[c['peak_bytes'] for c in ckr]} "
        f"| {card}")
    # the compressed step on pod = 2 x data = 2
    pods = [r["pods"] for r in four]
    p0, pc = pods[0], job["pods"]["cfg"]
    assert all(p["losses"] == p0["losses"] for p in pods)
    assert not on_card or all(p["rms"] > 0 for p in pods)
    launches["rmsnorm"] += sum(p["rms"] for p in pods)
    vs13b = ""
    if pods13b is not None:
        base = pods13b["ranks"][0]
        margin = pods13b["loss_margin"]
        ldiff = [abs(a - b) for a, b in zip(p0["losses"], base["losses"])]
        lbound = [max(margin, MESH_LOSS_REL * abs(b))
                  for b in base["losses"]]
        assert all(x <= y for x, y in zip(ldiff, lbound)), (ldiff, lbound)
        # each param leaf's norm: held at 2^-8 where the init gave it
        # one; a zero-initialised leaf (the q, k, v biases) is its three
        # AdamW updates alone, which bf16 reorderings move by percents
        rel = [(abs(a / b - 1), i) for a, b, i in zip(
            p0["leaf_norms"], base["leaf_norms"], p0["init_norms"]) if b]
        held = max(r for r, i in rel if i > 0)
        free = max((r for r, i in rel if i == 0), default=0.0)
        assert held <= MESH_LOSS_REL, held
        vs13b = (f"; vs phase 13b's data = 1 run on the same seed and data: "
                 f"losses {base['losses']}, diffs "
                 f"{[f'{x:.3e}' for x in ldiff]} (<= the larger of 13b's "
                 f"margin {margin:.3e} and 2^-8 of the loss), each param "
                 f"leaf's norm within {held:.3e} relative (<= 2^-8; the "
                 f"zero-initialised leaves', their updates alone, within "
                 f"{free:.3e}, not held)")
    print(
        f"phase 13d compressed step on (pod {POD}, data "
        f"{FAM_FOUR // POD}, model 1), {FAM_FOUR} processes, "
        f"{pc.name} at {pc.num_layers} layers, {job['pods']['batch']} x "
        f"{job['pods']['seq']} tokens a step: losses {p0['losses']} (equal "
        f"on every rank); both pods' params and AdamW state bit-identical "
        f"after every step (each rank's shards' digests against the other "
        f"pod's); grad norms {p0['grad_norms']}; step "
        f"{step_times(p0['step_s'])}{vs13b}; RMSNorm launches per rank "
        f"{[p['rms'] for p in pods]}; max_memory_allocated per rank "
        f"{[p['peak_bytes'] for p in pods]} | {card}")
    errs = check_kernels("13d", [two, four], card)
    print(f"phase 13d wall time: {time.perf_counter() - t0:.3f} s "
          f"(unsharded path {t_refs:.3f} s, 2 processes {t_two:.3f} s, "
          f"{FAM_FOUR} processes {t_four:.3f} s); launches "
          f"{json.dumps(launches)}")
    if on_card:
        torch.cuda.empty_cache()
    return {**launches, "gf256": gf_save + el["gf_restore"], "errs": errs}


def _state_note(cfg) -> str:
    """The train state's bytes at `cfg`'s depth and at the published one
    (bf16 params, f32 moments and master copy: 14 bytes a param): why the
    checkpointed run is cut. Rank 0 holds its half, the whole gathered
    state and the store's RS(4+2) chunks of it (1.5x) on the card, beside
    the other rank's half."""
    from repro_torch.models import build_model
    n = build_model(cfg).param_count()
    whole = build_model(_cfg(GRANITE)).param_count()
    return (f"{n} params, a {14 * n}-byte train state; at the published "
            f"depth {whole} params, {14 * whole} bytes, so rank 0 would hold "
            f"{int(3 * 14 * whole)} bytes of state and chunks beside rank "
            f"1's {7 * whole}, and its save alone would outlast the phase: "
            f"cut for time and memory")


# ---- slice H, the dry-run over the production meshes: phase 14 ----------

DRY_TOL = 0.01                   # flops: analyzer vs FlopCounterMode
# phase 14(a)'s cells: Qwen3-1.7B's three shapes on 16 x 16, the
# compressed Qwen1.5-0.5B train step on 2 x 16 x 16 and a cell of each
# other family (Qwen3-14B's padded heads among them), each in a process
# of its own (one fake world per process), all at once
DRY_CELLS = [("qwen3-1.7b", "train_4k", "single", ()),
             ("qwen3-1.7b", "prefill_32k", "single", ()),
             ("qwen3-1.7b", "decode_32k", "single", ()),
             ("qwen1.5-0.5b", "train_4k", "multi",
              ("--grad-compress", "--tag", "grad-compress")),
             ("qwen2-moe-a2.7b", "train_4k", "multi", ()),
             ("rwkv6-3b", "long_500k", "single", ()),
             ("recurrentgemma-2b", "decode_32k", "single", ()),
             ("musicgen-large", "train_4k", "single", ()),
             ("qwen3-14b", "decode_32k", "single", ())]


def dry_cells() -> None:
    """Phase 14(b)'s trace, in a process of its own: phase 13a's three
    cells and phase 12's three prefills and Qwen1.5-MoE's decode step
    (published configs, those phases' shapes) on a 1 x 1 mesh over a
    fake world of one, on meta tensors. Prints their dry-run records as
    one JSON line."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import init_fake_world, make_test_mesh
    init_fake_world(1)
    mesh = make_test_mesh(1, 1, device="cpu")
    cells = {
        "train": (QWEN15, ShapeConfig("cell_train", seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH,
                                      kind="train")),
        "prefill": (QWEN3, ShapeConfig("cell_prefill", seq_len=PROMPT,
                                       global_batch=SLOTS, kind="prefill")),
        "decode": (QWEN3, ShapeConfig(
            "cell_decode", seq_len=PROMPT + CELL_DECODE_STEPS,
            global_batch=SLOTS, kind="decode")),
        "moe_prefill": (QWEN_MOE, ShapeConfig(
            "moe_prefill", seq_len=PROMPT, global_batch=SLOTS,
            kind="prefill")),
        "moe_decode": (QWEN_MOE, ShapeConfig(
            "moe_decode", seq_len=MOE_MAX_LEN, global_batch=SLOTS,
            kind="decode")),
        "rwkv_prefill": (RWKV6, ShapeConfig(
            "rwkv_prefill", seq_len=RWKV_PROMPT, global_batch=REC_BATCH,
            kind="prefill")),
        "rgemma_prefill": (RGEMMA, ShapeConfig(
            "rgemma_prefill", seq_len=RGEMMA_PROMPT, global_batch=REC_BATCH,
            kind="prefill"))}
    print(json.dumps({k: dryrun.record_cell(get_config(arch), shape, mesh,
                                            pod_stride=10**9)
                      for k, (arch, shape) in cells.items()}))


def start_dryrun(work: Path) -> dict:
    """Phase 14(a)'s and (b)'s subprocesses, started early at the lowest
    CPU priority (`nice` 19): they trace on the host's idle cores while
    phases 13c-13d hold the card, and `dryrun_phase` collects them. Their
    records go to `work`, which no phase before 14 removes, and (a)'s
    logs of counted ops (`--save-hlo`) to `work`/experiments/torch_hlo/.
    They are collected after phase 15."""
    work.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    low = functools.partial(os.nice, 19)
    procs = []
    for i, (arch, shape, mesh, extra) in enumerate(DRY_CELLS):
        out = work / f"dryrun_{i}.jsonl"
        procs.append((out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, *extra, "--save-hlo",
             "--out", str(out)], env=env, cwd=work, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, preexec_fn=low)))
    cells_proc = subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.dry_cells()"],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, preexec_fn=low)
    return {"procs": procs, "cells": cells_proc, "t": time.perf_counter()}


def _within(got: float, want: float, rel: float) -> bool:
    return abs(got - want) <= rel * abs(want)


def reanalysis_phase(work: Path, recs: list) -> None:
    """Phase 14(a)'s saved logs re-analyzed: `scripts/torch_reanalyze.py`
    over a copy of the records (no trace); every refreshed `analysis`,
    `collectives_by_op` and `f32_upcast_bytes` equals the traced one
    within 1e-9 relative, the collective counts exactly."""
    logs = sorted((work / "experiments" / "torch_hlo").glob("*.txt"))
    assert len(logs) == len(recs), [p.name for p in logs]
    copy = work / "reanalyzed.jsonl"
    copy.write_text("".join(json.dumps(r) + "\n" for r in recs))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t = time.perf_counter()
    res = subprocess.run([sys.executable, str(ROOT / "scripts" /
                                              "torch_reanalyze.py"),
                          str(copy)], env=env, cwd=work, capture_output=True,
                         text=True, timeout=600)
    wall = time.perf_counter() - t
    assert res.returncode == 0, res.stderr[-3000:]
    assert f"re-analyzed {len(recs)}/{len(recs)} records" in res.stdout, \
        res.stdout
    for r, new in zip(recs, (json.loads(line) for line in
                             copy.read_text().splitlines())):
        cell = (r["arch"], r["shape"], r["mesh"])
        a, b = r["analysis"], new["analysis"]
        assert a.keys() == b.keys() and all(
            _within(b[k], a[k], 1e-9) for k in a), (cell, a, b)
        c, d = r["collectives_by_op"], new["collectives_by_op"]
        assert c.keys() == d.keys(), (cell, c, d)
        for op in c:
            assert d[op]["count"] == c[op]["count"], (cell, op, c, d)
            assert all(_within(d[op][k], c[op][k], 1e-9)
                       for k in ("result_bytes", "ring_bytes")), (cell, op)
        assert new["memory"] == r["memory"], (cell, r["memory"],
                                              new["memory"])
    sizes = {p.name: p.stat().st_size for p in logs}
    print(f"phase 14a re-analysis: scripts/torch_reanalyze.py over the "
          f"{len(logs)} saved logs in {wall:.3f} s without tracing (the "
          f"traces took {', '.join(str(r['trace_s']) for r in recs)} s): "
          f"every analysis, collectives_by_op and f32_upcast_bytes equal "
          f"the traced ones within 1e-9 relative, collective counts "
          f"exactly; log bytes {json.dumps(sizes)}; f32_upcast_bytes "
          f"{json.dumps({r['arch'] + ' ' + r['shape']: r['memory']['f32_upcast_bytes'] for r in recs})}")


def dryrun_phase(card: str, work: Path, dry: dict, started=None) -> None:
    """Phase 14: (a) `repro_torch.launch.dryrun` over `DRY_CELLS`, each
    record's per-rank memory, flops, bytes and its roofline terms under
    `HW`; (b) phase 13a's cells and phase 12's prefills and MoE decode
    step traced on a 1 x 1 fake world held to what the card measured
    (`dry`): argument bytes exactly, train and prefill flops within
    `DRY_TOL` of `FlopCounterMode`, a decode's difference equal to the
    gathered attention's 4 B H hd len L (the paged kernel's work, which
    `FlopCounterMode` cannot see; `gathered_flops`) within `DRY_TOL`;
    each cell's roofline bound beside its phase's measured time, and the
    train cell's peak beside the card's."""
    import torch
    from repro_torch.launch.dryrun import roofline_terms
    from repro_torch.launch.mesh import HW
    started = started or start_dryrun(work)
    procs, cells_proc, t = started["procs"], started["cells"], started["t"]
    waited = time.perf_counter()
    recs = []
    for out, proc in procs:
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, log[-3000:]
        recs += [json.loads(line) for line in out.read_text().splitlines()]
    traced, err = cells_proc.communicate(timeout=600)
    assert cells_proc.returncode == 0, err[-3000:]
    wall = time.perf_counter() - t
    print(f"phase 14 HW (repro_torch.launch.mesh): {json.dumps(HW)}; "
          f"the card's total_memory "
          f"{torch.cuda.get_device_properties(0).total_memory} | {card}")
    for r in recs:
        assert r["ok"], r.get("traceback")
        m, a = r["memory"], r["analysis"]
        terms = roofline_terms(a)
        print(f"phase 14a dry-run {r['arch']} {r['shape']} {r['mesh']} "
              f"({r['chips']} ranks{', ' + r['tag'] if r['tag'] else ''}):"
              f" per rank memory {m['total_bytes']} bytes (arguments "
              f"{m['argument_bytes']}, outputs {m['output_bytes']}, temp "
              f"{m['temp_bytes']}, aliased {m['alias_bytes']}), flops "
              f"{a['flops']:.6e}, bytes {a['bytes_accessed']:.6e}, "
              f"collective bytes {a['collective_bytes']:.6e} (ICI ring "
              f"{a['ici_ring_bytes']:.6e}, DCN ring "
              f"{a['dcn_ring_bytes']:.6e}); under HW compute "
              f"{terms['compute_s'] * 1e3:.3f} ms, memory "
              f"{terms['memory_s'] * 1e3:.3f} ms, collective "
              f"{terms['collective_s'] * 1e3:.3f} ms; traced in "
              f"{r['trace_s']} s")
        if "pod_gather_bytes" in r:
            print(f"phase 14a pod all-gather (DCN): "
                  f"{r['collectives_by_op']['all-gather_dcn']} == "
                  f"{r['pod_gather_bytes']} bytes by the placements")
    reanalysis_phase(work, recs)
    traced = json.loads(traced.strip().splitlines()[-1])
    assert set(traced) == set(dry), (sorted(traced), sorted(dry))
    for kind in traced:
        r, c = traced[kind], dry[kind]
        assert r["ok"], r.get("traceback")
        a = r["analysis"]
        assert r["memory"]["argument_bytes"] == c["arg_bytes"], \
            (kind, r["memory"]["argument_bytes"], c["arg_bytes"])
        if "gathered_flops" in c:
            want = c["gathered_flops"]
            diff = a["flops"] - c["flops"]
            ok = abs(diff - want) <= DRY_TOL * want
            check = (f"analyzer - card {diff:.6e} vs the gathered "
                     f"attention's {want:.6e}")
        else:
            ok = abs(a["flops"] - c["flops"]) <= DRY_TOL * c["flops"]
            check = f"analyzer {a['flops']:.6e} vs card {c['flops']:.6e}"
        terms = roofline_terms(a)
        bound_s = max(terms["compute_s"], terms["memory_s"])
        peak = (f"; peak {r['memory']['peak_bytes']} bytes traced vs "
                f"{c['peak_bytes']} on the card" if kind == "train" else "")
        print(f"phase 14b {kind}: argument bytes "
              f"{r['memory']['argument_bytes']} == {c['arg_bytes']}; flops "
              f"{check}; roofline bound {bound_s * 1e3:.3f} ms (compute "
              f"{terms['compute_s'] * 1e3:.3f}, memory "
              f"{terms['memory_s'] * 1e3:.3f}) vs its phase's median "
              f"{c['median_s'] * 1e3:.3f} ms = {bound_s / c['median_s']:.4f}"
              f"{peak} | {card}")
        assert ok, (kind, check)
    print(f"phase 14 wall time {time.perf_counter() - waited:.3f} s after "
          f"phase 15 (the dry-runs and the 1 x 1 trace, started at nice "
          f"19 before phase 13c, in {wall:.3f} s, in parallel)")


# ---- slice L, the entry points outside the package: phase 15 ----------

# examples/torch_<name>.py: run in this process through `main([])`, or
# as a subprocess where the example spawns store workers
EXAMPLES_IN_PROCESS = ("quickstart", "async_put_get", "serve_kv",
                       "train_lm")
EXAMPLES_SPAWNING = ("process_store", "networked_store")
# the kernels each in-process example must launch on the card
EXAMPLE_KERNELS = {"quickstart": ("gf256",), "async_put_get": ("gf256",),
                   "serve_kv": ("rmsnorm", "paged_decode_attention"),
                   "train_lm": ("gf256", "rmsnorm")}
EXAMPLE_TIMEOUT = 600            # seconds an example's subprocess may run
# what varies from run to run in the store examples' lines (pids, TCP
# ports, the writeback queue's depth, times and latencies, span and trace
# counts, which of DOWN or RECONNECTING a 50 ms poll caught first)
EXAMPLE_MASKS = [(r"pids=\[[\d, ]*\]", "pids=[*]"),
                 (r"\('127\.0\.0\.1', \d+\)", "('127.0.0.1', *)"),
                 (r"writeback queue depth: \d+", "writeback queue depth: *"),
                 (r"\b\d+(\.\d+)?(us|s)\b", r"*\2"),
                 (r"\d+ spans across \d+ traces", "* spans across * traces"),
                 (r"detector state (DOWN|RECONNECTING)",
                  "detector state DOWN or RECONNECTING")]


def masked(text: str) -> list:
    """`text`'s lines with what varies from run to run masked."""
    import re
    out = []
    for line in text.splitlines():
        for pattern, repl in EXAMPLE_MASKS:
            line = re.sub(pattern, repl, line)
        out.append(line)
    return out


def example_path(name: str) -> Path:
    return ROOT / "examples" / f"torch_{name}.py"


def drain_before_get(store_cls):
    """Make `store_cls.get` (either package's `InfiniStore`) wait for the
    store's writeback thread to drain, unless it is paused, before it
    reads; returns the original. The quickstart's GETs follow its PUTs
    with no barrier, so whether they read the slabs or the persistent
    buffer (and so its recovery count and its bill) depends on how soon
    the writer thread runs; two runs that are compared both drain."""
    get = store_cls.get

    def drained(self, key):
        if not self.writeback._paused:
            self.writeback.flush()
        return get(self, key)

    store_cls.get = drained
    return get


# runs the script at argv[2] under `drain_before_get` of package argv[1]
_DRAINED = f"""
import importlib, runpy, sys
sys.path.insert(0, {str(ROOT)!r})
from chip_smoke import drain_before_get
drain_before_get(importlib.import_module(sys.argv[1] + ".core").InfiniStore)
sys.argv = sys.argv[2:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""


def start_example(name: str, *args: str, threads: int = 0,
                  path: Path = None, low: bool = False,
                  drained: str = None):
    """examples/torch_<name>.py (or the script at `path`) as a subprocess
    (`threads` > 0: that many intra-op threads; `low`: at the lowest CPU
    priority; `drained`: a package whose store's GETs `drain_before_get`),
    its start time beside it."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
    cmd = [str(path or example_path(name)), *args]
    if drained:
        cmd = ["-c", _DRAINED, drained, *cmd]
    return subprocess.Popen([sys.executable, *cmd], env=env,
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            preexec_fn=functools.partial(os.nice, 19)
                            if low else None), time.perf_counter()


def start_cpu_examples() -> dict:
    """Phase 15's two long `--device cpu` runs (train_lm's 200 steps,
    serve_kv), started early at the lowest CPU priority with two
    intra-op threads each, as phase 14's traces are: they run on the
    host's idle cores while phases 13c-13d hold the card."""
    return {name: start_example(name, "--device", "cpu", threads=2,
                                low=True)
            for name in ("train_lm", "serve_kv")}


def finish_example(name: str, started,
                   timeout: float = EXAMPLE_TIMEOUT) -> tuple:
    """(stdout, wall seconds) of a subprocess from `start_example`; it
    must exit 0 within `timeout` seconds."""
    proc, t = started
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    wall = time.perf_counter() - t
    assert proc.returncode == 0, (name, out[-2000:], err[-3000:])
    return out, wall


class CodecCheck:
    """While installed, every GF(256) product the codec makes
    (`core.ec.gf256_matmul`) and every gathered, framed decode
    (`core.ec.gf256_gather_framed`) is held bit for bit to the plain
    version on the same operands."""

    def __init__(self):
        from repro_torch.core import ec
        self.ec, self.calls = ec, 0

    def __enter__(self):
        import torch
        from repro_torch.kernels.rs_gf256.kernel import GATHER_FRAGS
        from repro_torch.kernels.rs_gf256.ref import (
            gf256_gather_framed_ref, gf256_matmul_ref)
        self.orig = self.ec.gf256_matmul
        self.orig_gather = self.ec.gf256_gather_framed

        def checked(G, X, *args, **kw):
            out = self.orig(G, X, *args, **kw)
            assert torch.equal(out, gf256_matmul_ref(G, X)), \
                (tuple(X.shape), X.device)
            self.calls += 1
            return out

        def checked_gather(G, chunks, outs, **kw):
            self.orig_gather(G, chunks, outs, **kw)
            want = [torch.empty_like(out) for out in outs]
            gf256_gather_framed_ref(G, chunks, want)
            for out, w in zip(outs, want):
                assert torch.equal(out, w), (out.numel(), out.device)
            self.calls += -(-len(outs) // GATHER_FRAGS)   # its launches

        self.ec.gf256_matmul = checked
        self.ec.gf256_gather_framed = checked_gather
        return self

    def __exit__(self, *exc):
        self.ec.gf256_matmul = self.orig
        self.ec.gf256_gather_framed = self.orig_gather


def example_in_process(name: str) -> tuple:
    """examples/torch_<name>.py's `main([])` (the card) in this process,
    every kernel call held to its plain version (`ShardKernelCheck`,
    `CodecCheck`; the quickstart's GETs drained, `drain_before_get`):
    (its printed text, wall seconds, launches per kernel, the checks'
    report, codec calls checked). The launch counts are set to 0 just
    before and read just after."""
    import contextlib
    import importlib.util
    import io

    from repro_torch.core import InfiniStore
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.kernels.rs_gf256 import kernel
    spec = importlib.util.spec_from_file_location(f"torch_{name}",
                                                  example_path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    get = drain_before_get(InfiniStore) if name == "quickstart" else None
    try:
        with ShardKernelCheck() as check, CodecCheck() as codec, \
                contextlib.redirect_stdout(buf):
            kernel.launches = kernel.gather_launches = 0
            rms_kernel.launches = pa_kernel.launches = 0
            t = time.perf_counter()
            mod.main([])
            wall = time.perf_counter() - t
            launches = {"gf256": codec_launches(),
                        "rmsnorm": rms_kernel.launches,
                        "paged_decode_attention": pa_kernel.launches}
    finally:
        if get is not None:
            InfiniStore.get = get
    return buf.getvalue(), wall, launches, check.report(), codec.calls


def kv_lines(out: str) -> list:
    """serve_kv's KV page lines: its `KVStats` and the restored pages."""
    return [line for line in out.splitlines()
            if "KVStats(" in line or line.startswith("resumed seq0:")]


def train_facts(out: str) -> dict:
    """train_lm's restored step, reclaimed slabs, recoveries and its
    closing line."""
    import re
    return {"restored": re.search(r"restored from step (\d+);", out)[1],
            "slabs": re.search(r"reclaimed all (\d+) slabs", out)[1],
            "recoveries": re.search(r"recoveries: (\d+) local, (\d+) "
                                    r"parallel", out).groups(),
            "ok": "restart-after-failure ok" in out}


def examples_phase(card: str, cpu: dict) -> dict:
    """Phase 15: the port's six examples on the card at their defaults,
    each beside its own `--device cpu` run (subprocesses: train_lm's and
    serve_kv's `cpu`, from `start_cpu_examples` before phase 13c; the
    others with the phase). In this process through `main([])`:
    quickstart, async_put_get, serve_kv (the paged and RMSNorm kernels),
    train_lm (the codec on its checkpoints, RMSNorm forward and
    backward), every kernel call held to its plain version at phase 6's
    tolerances and every codec product bit for bit, their launches
    counted: as many calls held as launches of each kernel, and the
    kernels of `EXAMPLE_KERNELS` launched;
    process_store and networked_store as subprocesses (their workers on
    the card count their own launches), the first beside
    `scripts/torch_check_metrics_dump.py` on the card, which must exit 0.
    The store examples' lines equal the CPU run's, masked
    (`EXAMPLE_MASKS`); serve_kv's KV page lines and train_lm's restored
    step, slabs and recoveries equal the CPU run's. Returns the launches
    and worst errors per kernel."""
    t0 = time.perf_counter()
    cpu = dict(cpu)
    cpu.update({name: start_example(name, "--device", "cpu",
                                    drained="repro_torch"
                                    if name == "quickstart" else None)
                for name in ("quickstart", "async_put_get", "process_store",
                             "networked_store")})
    launches = {"gf256": 0, "rmsnorm": 0, "paged_decode_attention": 0}
    errs = {"rmsnorm": 0.0, "paged_decode_attention": 0.0}
    card_out, walls = {}, {}
    for name in EXAMPLES_IN_PROCESS:
        out, wall, got, report, codec_calls = example_in_process(name)
        card_out[name], walls[name] = out, wall
        held = {"gf256": codec_calls}
        for key, (n, err, ok) in report.items():
            assert ok, (name, key, n, err)
            kern = key.split("/")[0]
            errs[kern] = max(errs[kern], err)
            held[kern] = held.get(kern, 0) + n
        assert all(held.get(k, 0) == n for k, n in got.items()), \
            (name, "launches not all held to the plain version", got, held)
        assert all(got[k] > 0 for k in EXAMPLE_KERNELS[name]), \
            (name, "a kernel of its path not launched", got)
        for key, n in got.items():
            launches[key] += n
        print(f"phase 15 torch_{name}.py on the card in {wall:.3f} s: "
              f"launches {json.dumps(got)}; kernel calls held to the plain "
              f"version {json.dumps({k: [v[0], '%.3e' % v[1]] for k, v in report.items()})}"
              f", {codec_calls} codec launches bit for bit | {card}")
    gate = start_example("gate", path=ROOT / "scripts" /
                         "torch_check_metrics_dump.py")
    for name in EXAMPLES_SPAWNING:
        card_out[name], walls[name] = finish_example(
            name, start_example(name))
        print(f"phase 15 torch_{name}.py on the card (a subprocess, its "
              f"workers on the card) in {walls[name]:.3f} s | {card}")
    out, walls["metrics gate"] = finish_example("metrics gate", gate)
    print(f"phase 15 scripts/torch_check_metrics_dump.py on the card "
          f"(beside torch_process_store.py): {out.strip().splitlines()[-1]}"
          f" in {walls['metrics gate']:.3f} s | {card}")
    for name in ("quickstart", "async_put_get") + EXAMPLES_SPAWNING:
        out, wall = finish_example(name, cpu[name])
        want, got = masked(out), masked(card_out[name])
        assert got == want, (name, got, want)
        print(f"phase 15 torch_{name}.py: the card's {len(got)} lines equal "
              f"the --device cpu run's (masked; {wall:.3f} s from the "
              f"phase's start)")
    out, wall = finish_example("serve_kv", cpu["serve_kv"])
    assert kv_lines(card_out["serve_kv"]) == kv_lines(out) \
        and len(kv_lines(out)) == 3, (card_out["serve_kv"], out)
    print(f"phase 15 torch_serve_kv.py: KV page lines equal the --device "
          f"cpu run's (done {wall:.3f} s after its start): "
          f"{kv_lines(out)}")
    out, wall = finish_example("train_lm", cpu["train_lm"])
    facts = train_facts(card_out["train_lm"])
    assert facts == train_facts(out) and facts["ok"], \
        (card_out["train_lm"], out)
    lines = card_out["train_lm"].splitlines()
    print(f"phase 15 torch_train_lm.py: restored step, slabs and recoveries "
          f"equal the --device cpu run's (done {wall:.3f} s after its "
          f"start): {json.dumps(facts)}; the card's run: "
          f"{' /'.join(lines[1:2] + lines[4:5])}")
    print(f"phase 15 wall time {time.perf_counter() - t0:.3f} s; launches "
          f"{json.dumps(launches)}; per entry point on the card "
          f"{json.dumps({k: round(v, 3) for k, v in walls.items()})} s | "
          f"{card}")
    return {**launches, "errs": errs}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Drive the port on one GPU.")
    ap.add_argument("--baseline", type=Path, default=None, metavar="DIR",
                    help="a checkout of an earlier commit: its GF(256) "
                    "ladder is built too and timed beside the current "
                    "one in phase 9")
    args = ap.parse_args(argv)
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

    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    t0 = time.perf_counter()
    sources = [kernel.SOURCE, kernel.LADDER_SOURCE, rms_kernel.SOURCE,
               pa_kernel.SOURCE]
    if args.baseline is not None:
        sources.append(args.baseline.resolve() / EarlierDesigns.LADDER)
    libs = _build.build_many(sources)
    print(f"build: {', '.join(str(lib.relative_to(ROOT)) for lib in libs)}"
          f" in {time.perf_counter() - t0:.3f} s (in parallel)")
    earlier = EarlierDesigns(libs[4]) if args.baseline is not None \
        else None

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
    from repro_torch.core import ec
    k, p = 10, 2
    L_main = -(-(100 * MB + 4) // k)           # a 100 MB object's chunk
    codec = ec.RSCodec(ec.ECConfig(k, p), device=dev)
    codec4 = ec.RSCodec(ec.ECConfig(4, p), device=dev)
    mats = {"random (2,10)": rng.integers(0, 256, (p, k), dtype=np.uint8),
            "random (10,10)": rng.integers(0, 256, (k, k), dtype=np.uint8),
            "encode (2,10)": cauchy_parity_matrix(k, p),
            "decode, chunk 0 lost": codec._decode_matrix(tuple(range(1, 11))),
            "decode, chunks 0-1 lost": codec._decode_matrix(
                tuple(range(2, 12))),
            "RS(4+2) decode, chunk 0 lost": codec4._decode_matrix(
                (1, 2, 3, 4)),
            "RS(4+2) encode": cauchy_parity_matrix(4, p)}
    max_err = 0
    checks = 0
    for G in mats.values():
        for L in (1, 13, 1021, 65_539, L_main):
            kk = G.shape[1]
            base = rand_u8(kk * (L + 16)).view(kk, L + 16)
            for off in range(16):              # column-slice views
                X = base[:, off:off + L]
                got = gf256_matmul(G, X)
                want = gf256_matmul_ref(G, X)
                torch.cuda.synchronize()
                err = int((got.int() - want.int()).abs().max())
                max_err = max(max_err, err)
                assert torch.equal(got, want), (G.shape, L, off)
                checks += 1
            del base, X, got, want
    print(f"phase 1 kernel vs plain: {checks} checks bit-identical "
          f"({', '.join(mats)}; L in 1,13,1021,65539,{L_main}; column "
          f"offsets 0-15), max_abs_err {max_err}")

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
    kernel.launches = kernel.gather_launches = 0
    put_s = {}
    for key, val in values.items():
        t = time.perf_counter()
        assert store.put(key, val) == 1
        put_s[key] = time.perf_counter() - t
    counts["put"] = codec_launches()
    assert counts["put"] >= len(values), counts
    assert store.flush_writeback(timeout=600.0)
    large = [f"large/{i}" for i in range(15)]   # device-tensor payloads
    put_large_mbs = 100 * len(large) / sum(put_s[k] for k in large)
    print(f"phase 2 PUT: {len(values)} objects, {total / MB:.0f} MB "
          f"({total} bytes) acked; kernel launches {counts['put']}")

    kernel.launches = kernel.gather_launches = 0
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
    counts["get"] = codec_launches()
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
    kernel.launches = kernel.gather_launches = 0
    deg_s = {}
    for key in large:
        t = time.perf_counter()
        arr = store.get_array(key)
        torch.cuda.synchronize()
        deg_s[key] = time.perf_counter() - t
        assert torch.equal(arr, objects[key]), key
    counts["degraded_get"] = codec_launches()
    info = store.codec.cache_info()
    assert info["inversions"] >= 1 and info["inversions"] > inv0, info
    # every degraded fragment decodes in a gathered launch, none staged
    assert kernel.launches == 0 and store.codec.staged_decodes == 0
    assert counts["degraded_get"] >= len(large), counts
    deg_mbs = 100 * len(large) / sum(deg_s.values())
    print(f"phase 3 degraded GET: slab {fid} reclaimed, {len(large)} x "
          f"100 MB read back intact through parity; codec {info}; gathered "
          f"decode launches {counts['degraded_get']}, products 0")

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
    kernel.launches = kernel.gather_launches = 0
    t = time.perf_counter()
    st2 = InfiniStore(StoreConfig(spill_dir=spill_dir), seed=SEED)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t
    counts["replay"] = codec_launches()
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
    loop_ops = gf_loop_ops(libs[0])
    timing = gf_timing(dev, gen, rng, card, loop_ops)
    timing.update(gather_timing(dev, gen, card))
    # end-to-end byte bounds for one 100 MB object (chunk length L_main):
    # PUT and `get` must carry the payload across the host link (the
    # journal needs host bytes before the ack; `get` returns bytes) at
    # the pinned rate measured above; PUT also encodes (kernel bound);
    # `get_array` reads k chunks and writes the object on HBM; degraded
    # `get_array` need move no more bytes (k surviving chunks in, the
    # object out: its decode product could ride on that pass), so its
    # bound is the same bytes and the decode's op count is only printed.
    obj = 100 * MB
    chunks = k * L_main
    get_b, _ = bound(obj, bytes_per_s=link_bps)
    put_b = max(get_b, timing["encode (2,10)"]["bound_ms"])
    put_by = "host link" if put_b == get_b else "encode bytes"
    arr_b, _ = bound(chunks + obj)
    deg_b, deg_by = arr_b, "HBM bytes"
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
    deg_med = sorted(deg_s.values())[len(deg_s) // 2] * 1e3
    dec = timing["gathered decode, chunk 0 lost"]
    print(f"degraded GET 100 MB objects: get_array {deg_mbs:.1f} MB/s, "
          f"{lat(deg_s.values())}, {vs(deg_mbs, deg_b, deg_by)}; its "
          f"gathered decode (chunk 0 lost) {dec['ms'] * 1e3:.2f} us = "
          f"{100 * dec['ms'] / deg_med:.1f}% of the median | {card}")
    print(f"replay: {replay_s:.3f} s for {replay_mb:.1f} MB | {card}")
    print("launches per phase: " + json.dumps(counts))
    single = {"put": rate(objects, put_s), "put_large": put_large_mbs,
              "get": rate(objects, get_s), "get_large": get_large_mbs}
    del objects, values, frag
    torch.cuda.empty_cache()

    # ---- phases 6-8: serving -------------------------------------------
    checks = kernel_checks(dev)
    serving = serve(dev, work, card)
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- phase 9: the GF(256) A/B entry point --------------------------
    ladder = ladder_phase(dev, gen, rng, L_main, card,
                          gf_loop_ops(libs[1]), earlier)
    torch.cuda.empty_cache()

    # ---- phase 10: training with checkpoints through the store ---------
    from repro_torch.configs import get_config
    cfg15 = get_config(QWEN15)
    assert (cfg15.num_layers, cfg15.d_model, cfg15.num_heads,
            cfg15.num_kv_heads, cfg15.head_dim, cfg15.d_ff,
            cfg15.vocab_size, cfg15.qkv_bias, cfg15.tie_embeddings,
            cfg15.dtype) == (24, 1024, 16, 16, 64, 2816, 151936, True,
                             True, "bfloat16")
    training = train_phase(dev, card, cfg15)
    torch.cuda.empty_cache()

    # ---- phase 11: the sharded, process and TCP frontends --------------
    work.mkdir(parents=True, exist_ok=True)
    scale_out = scale_out_phase(dev, work, card, rand_u8, single)
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- phase 12: the MoE, RWKV6 and RG-LRU families ------------------
    work.mkdir(parents=True, exist_ok=True)
    models = models_phase(dev, work, card)
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- phase 13: build_cell on a mesh, the compressed step ----------
    t = time.perf_counter()
    cells = cells_phase(dev, card, cfg15, get_config(QWEN3))
    torch.cuda.empty_cache()
    t_cells = time.perf_counter() - t
    work.mkdir(parents=True, exist_ok=True)
    pods = pod_phase(dev, card, work, cfg15, cells)
    shutil.rmtree(work, ignore_errors=True)
    print(f"phase 13 wall time {time.perf_counter() - t:.3f} s (13a "
          f"{t_cells:.3f} s)")

    # phase 14's traces and phase 15's long CPU runs start here, on the
    # host's idle cores
    dry_work = ROOT / "build" / "repro_torch" / "dryrun"
    shutil.rmtree(dry_work, ignore_errors=True)
    dry_started = start_dryrun(dry_work)
    cpu_examples = start_cpu_examples()
    try:
        # ---- phase 13c: the cells and train(..., mesh=) over data, model
        work.mkdir(parents=True, exist_ok=True)
        meshes = mesh_phase(dev, card, work, cfg15, get_config(QWEN3), cells)
        shutil.rmtree(work, ignore_errors=True)

        # ---- phase 13d: the other families over data, model; pods x data
        work.mkdir(parents=True, exist_ok=True)
        families = family_phase(dev, card, work, fam_job(), pods)
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()

        # ---- phase 15: the examples and the metrics gate on the card ---
        # (before phase 14 is collected: its traces finish meanwhile)
        examples = examples_phase(card, cpu=cpu_examples)
        torch.cuda.empty_cache()

        # ---- phase 14: the dry-run over the production meshes ---------
        dryrun_phase(card, dry_work, {**cells["dry"], **models["dry"]},
                     dry_started)
    finally:
        for proc in [p for _, p in dry_started["procs"]] \
                + [dry_started["cells"]] \
                + [p for p, _ in cpu_examples.values()]:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    shutil.rmtree(dry_work, ignore_errors=True)

    enc = timing["encode (2,10)"]
    print(json.dumps({"kernels": [{
        "name": "gf256_matmul_bitsliced",
        "route": "cuda",
        "source": "src/repro_torch/kernels/rs_gf256/csrc/gf256_matmul.cu",
        "replaces": "src/repro/kernels/rs_gf256/kernel.py:58",
        "launches": counts["put"] + counts["get"]
        + counts["degraded_get"] + counts["replay"]
        + serving["gf_evict_launches"] + training["gf_launches"]
        + scale_out["launches"]
        + models["launches"]["gf256_matmul_bitsliced"] + meshes["gf256"]
        + families["gf256"] + examples["gf256"],
        "max_abs_err": max_err,
        "ms": enc["ms"],
        "plain_ms": enc["plain_ms"],
        "bound_ms": enc["bound_ms"],
        "bound_by": enc["bound_by"],
        "library_ms": None,
    }, {
        "name": "gf256_matmul_ladder",
        "route": "cuda",
        "source": "src/repro_torch/kernels/rs_gf256/csrc/gf256_ladder.cu",
        "replaces": "src/repro/kernels/rs_gf256/kernel.py:131",
        "launches": ladder["launches"],
        "max_abs_err": ladder["max_abs_err"],
        **{key: ladder["timing"]["encode"][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
    }] + [dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=serving["launches"][name] + models["launches"][name]
        + cells[name] + meshes[name] + families[name] + examples[name]
        + (training["rmsnorm_launches"] + pods["rmsnorm"]
           if name == "rmsnorm" else 0),
        max_abs_err=max(checks[name], meshes["errs"][name],
                        families["errs"][name], examples["errs"][name],
                        training["grad_err"] if name == "rmsnorm" else 0.0,
                        models["rms_d2560"]["max_abs_err"]
                        if name == "rmsnorm" else max(
                            models["pa_err"],
                            cells["paged_256"]["max_abs_err"])),
        **{key: serving["timing"][name][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
        for name, source, replaces in (
            ("rmsnorm", "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
             "src/repro/kernels/rmsnorm/kernel.py:18"),
            ("paged_decode_attention",
             "src/repro_torch/kernels/paged_attention/csrc/"
             "paged_attention.cu",
             "src/repro/kernels/paged_attention/kernel.py:26"))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
