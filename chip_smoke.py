#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of InfiniStore on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Builds the port's four CUDA kernels from the sources in the checkout
(one nvcc per source, all started together; sm_90a, into
build/repro_torch/) and drives its three paths through the user's entry
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
  run's losses from a bit-identical restored state.

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
    rms_kernel.launches = pa_kernel.launches = gf_kernel.launches = 0
    t = time.perf_counter()
    out = eng.generate(prompts, NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {"rmsnorm": rms_kernel.launches,
                "paged_decode_attention": pa_kernel.launches,
                "gf256_matmul_bitsliced": gf_kernel.launches}
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
    gf_kernel.launches = 0
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
    gf_evict = gf_kernel.launches
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
    gf_kernel.launches = 0
    first = train(cfg, shape, steps=CKPT_STEP, checkpointer=ck,
                  checkpoint_every=CKPT_STEP, **run)
    torch.cuda.synchronize()
    gf_save = gf_kernel.launches
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
    gf_kernel.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    resumed = train(cfg, shape, steps=TRAIN_STEPS, resume=True,
                    checkpointer=ck, **run)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t
    gf_restore = gf_kernel.launches
    recoveries = rec.local_recoveries + rec.parallel_recoveries - rec0
    assert resumed.restored_from == CKPT_STEP, resumed.restored_from
    assert gf_restore + recoveries > 0, (gf_restore, recoveries)
    np.testing.assert_allclose(resumed.losses,
                               straight.losses[CKPT_STEP:],
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    del resumed.state
    torch.cuda.empty_cache()
    gf_kernel.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    back = ck.restore(CKPT_STEP, like=saved)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    gf_restore2 = gf_kernel.launches
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
    loop_ops = gf_loop_ops(libs[0])
    timing = gf_timing(dev, gen, rng, card, loop_ops)
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
    dec = timing["decode, chunk 0 lost"]
    print(f"degraded GET 100 MB objects: get_array {deg_mbs:.1f} MB/s, "
          f"{lat(deg_s.values())}, {vs(deg_mbs, deg_b, deg_by)}; its "
          f"decode product (chunk 0 lost) {dec['ms'] * 1e3:.2f} us = "
          f"{100 * dec['ms'] / deg_med:.1f}% of the median (design: "
          f"{dec['design_ops']} integer ops) | {card}")
    print(f"replay: {replay_s:.3f} s for {replay_mb:.1f} MB | {card}")
    print("launches per phase: " + json.dumps(counts))
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

    enc = timing["encode (2,10)"]
    print(json.dumps({"kernels": [{
        "name": "gf256_matmul_bitsliced",
        "route": "cuda",
        "source": "src/repro_torch/kernels/rs_gf256/csrc/gf256_matmul.cu",
        "replaces": "src/repro/kernels/rs_gf256/kernel.py:58",
        "launches": counts["put"] + counts["get"]
        + counts["degraded_get"] + counts["replay"]
        + serving["gf_evict_launches"] + training["gf_launches"],
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
        launches=serving["launches"][name] + (
            training["rmsnorm_launches"] if name == "rmsnorm" else 0),
        max_abs_err=max(checks[name], training["grad_err"]
                        if name == "rmsnorm" else 0.0),
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
