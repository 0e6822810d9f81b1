"""Hopper CUDA kernel: single-token GQA decode attention over a paged KV
pool (flash-decoding: a partial kernel per split of the page walk, then
a combine kernel).

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

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # the kernel's type codes
HEAD_DIMS = (8, 16, 32, 64, 128)
G_PER_BLOCK = 4                  # query heads per kv head in one block
BLOCKS_PER_SM = 4                # splits are chosen to reach this many

launches = 0                     # calls that launched the kernels
_lock = threading.Lock()         # guards the library, `launches`, SM counts
_lib = None
_sm_count: dict = {}


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
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _sms(device: torch.device) -> int:
    with _lock:
        n = _sm_count.get(device.index)
        if n is None:
            n = torch.cuda.get_device_properties(device).multi_processor_count
            _sm_count[device.index] = n
        return n


def split_pages(B: int, K: int, G: int, P: int, sms: int):
    """(splits, pages_per_split): split each sequence's page walk until
    the (b, kv head, head group, split) blocks reach BLOCKS_PER_SM per
    SM, with whole pages per split and no empty trailing split."""
    pairs = B * K * -(-G // G_PER_BLOCK)
    splits = max(1, min(P, -(-BLOCKS_PER_SM * sms // pairs)))
    pps = -(-P // splits)
    return -(-P // pps), pps


def _check(q, k_pool, v_pool, block_table, lens):
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
    splits, pps = split_pages(B, K, G, P, _sms(q.device))
    part_acc = torch.empty((B, K, splits, G, hd), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((B, K, splits, G, 2), dtype=torch.float32,
                          device=q.device)
    lib = _load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_attention_forward(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_table.data_ptr(), lens.data_ptr(), part_acc.data_ptr(),
            part_ml.data_ptr(), out.data_ptr(), B, P, ps, K, G, hd, splits,
            pps, 1.0 / math.sqrt(hd), DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention_forward launch failed: CUDA "
                           f"error {rc}")
    with _lock:
        launches += 1
    return out
