"""Hopper CUDA kernel: single-token GQA decode attention over a paged KV
pool (flash-decoding: a partial kernel per split of the page walk, then
a combine kernel when there is more than one split).

Replaces the JAX package's `paged_attention/kernel.py::_kernel`; the
design and its bound are described at the top of
`csrc/paged_attention.cu`.

The source is compiled with `nvcc` for `sm_90a` into a shared library
with a plain C entry point (built at first use by `kernels/_build.py`
under `build/repro_torch/`, keyed by a hash of the source) and called
through `ctypes` on PyTorch's current stream. Importing this module
builds nothing; a failed build or launch raises — there is no fallback
to the plain version. `launches` counts the calls that launched the
kernel pair.
"""
from __future__ import annotations

import ctypes
import math
import threading
from pathlib import Path

import torch

from repro_torch.kernels import _build, require_plain

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # the kernel's type codes
HEAD_DIMS = (8, 16, 32, 64, 128)
HEAD_GROUPS = (1, 2, 4, 8)       # query heads one block takes (templated)

launches = 0                     # calls that launched the kernels
_lock = threading.Lock()         # guards the library, `launches`, caches
_lib = None
_occupancy: dict = {}            # (device, hd, G, dtype, P) -> blocks/SM


def build() -> Path:
    """Compile the kernel's shared library if this source's build is
    missing; returns its path."""
    return _build.build(SOURCE)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.paged_attention_forward
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            occ = lib.paged_attention_blocks_per_sm
            occ.argtypes = [ctypes.c_int] * 4 + [
                ctypes.POINTER(ctypes.c_int)]
            occ.restype = ctypes.c_int
            _lib = lib
        return _lib


def _blocks_per_sm(device: torch.device, hd: int, G: int, dtype: int,
                   P: int) -> int:
    """Blocks of the partial kernel that fit on one SM: the split rule's
    occupancy, asked of CUDA's occupancy calculator once per device and
    shape."""
    key = (device.index, hd, G, dtype, P)
    with _lock:
        n = _occupancy.get(key)
    if n is None:
        lib = _load()
        got = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = lib.paged_attention_blocks_per_sm(hd, head_group(G), dtype,
                                                   P, ctypes.byref(got))
        if rc != 0:
            raise RuntimeError(f"paged_attention_blocks_per_sm failed: CUDA "
                               f"error {rc}")
        n = got.value
        if n < 1:
            raise RuntimeError(f"the paged attention kernel does not fit on "
                               f"an SM (hd {hd}, G {G}, {P} pages)")
        with _lock:
            _occupancy[key] = n
    return n


def head_group(G: int) -> int:
    """Query heads per block: G rounded up to 1, 2, 4 or 8 (larger G
    takes several head groups); the kernel is instantiated for each."""
    return next(g for g in HEAD_GROUPS if g >= min(G, HEAD_GROUPS[-1]))


def split_pages(B: int, K: int, G: int, P: int, sms: int,
                blocks_per_sm: int):
    """(splits, pages_per_split): split each sequence's page walk into
    as many runs of whole pages as keep every (b, kv head, head group,
    split) block in one wave of `blocks_per_sm` x `sms` blocks, with no
    empty trailing split. One split when the pairs alone fill a wave."""
    pairs = B * K * -(-G // head_group(G))
    splits = max(1, min(P, sms * max(1, blocks_per_sm) // pairs))
    pps = -(-P // splits)
    return -(-P // pps), pps


def _check(q, k_pool, v_pool, block_table, lens):
    require_plain("paged_decode_attention_cuda", q, k_pool, v_pool,
                  block_table, lens)
    if not isinstance(q, torch.Tensor) or q.device.type != "cuda":
        raise ValueError("paged_decode_attention_cuda needs CUDA tensors")
    if q.dim() != 3 or k_pool.dim() != 5 or k_pool.shape != v_pool.shape:
        raise ValueError(f"need q (B,H,hd) and pools (B,P,ps,K,hd), got "
                         f"{tuple(q.shape)}, {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)}")
    B, H, hd = q.shape
    Bp, P, ps, K, hd2 = k_pool.shape
    if Bp != B or hd2 != hd or H % K:
        raise ValueError(f"pools {tuple(k_pool.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if q.dtype not in DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise ValueError(f"need float32 or bfloat16 throughout, got q "
                         f"{q.dtype}, pools {k_pool.dtype}/{v_pool.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if tuple(block_table.shape) != (B, P) or tuple(lens.shape) != (B,) \
            or block_table.dtype != torch.int32 or lens.dtype != torch.int32:
        raise ValueError(f"need block_table (B,P) and lens (B,) int32, got "
                         f"{tuple(block_table.shape)} {block_table.dtype}, "
                         f"{tuple(lens.shape)} {lens.dtype}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_table", block_table), ("lens", lens)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def paged_decode_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor,
                                block_table: torch.Tensor,
                                lens: torch.Tensor) -> torch.Tensor:
    """Launch the kernels: q (B, H, hd); k/v pools (B, P, ps, K, hd);
    block_table (B, P) int32; lens (B,) int32 valid tokens (>= 1), all
    contiguous on one card, f32 or bf16. Returns (B, H, hd) in q's
    dtype."""
    global launches
    _check(q, k_pool, v_pool, block_table, lens)
    B, H, hd = q.shape
    _, P, ps, K, _ = k_pool.shape
    G = H // K
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _load()
    occupancy = _blocks_per_sm(q.device, hd, G, DTYPES[q.dtype], P)
    splits, pps = split_pages(B, K, G, P, _build.sm_count(q.device),
                              occupancy)
    # partial softmaxes of the splits; one split writes `out` itself
    n = splits if splits > 1 else 0
    part_acc = torch.empty((B, K, n, G, hd), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((B, K, n, G, 2), dtype=torch.float32,
                          device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_attention_forward(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_table.data_ptr(), lens.data_ptr(), part_acc.data_ptr(),
            part_ml.data_ptr(), out.data_ptr(), B, P, ps, K, G,
            head_group(G), hd, splits, pps, 1.0 / math.sqrt(hd),
            DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention_forward launch failed: CUDA "
                           f"error {rc}")
    with _lock:
        launches += 1
    return out
