"""Reed-Solomon erasure-coding codec facade (paper: RS(10+2) by default).

Splits a byte payload into k data chunks + p parity chunks; any k of the
k+p chunks reconstruct the payload. The codec lives on one device
(`device="cuda"` by default): its stacked buffers are uint8 tensors
there, and every GF(256) product goes through `ops.gf256_matmul` — the
hand-written Hopper kernel on a CUDA codec, the plain PyTorch version on
a CPU codec. Host-side matrix math (Cauchy rows, Gauss-Jordan inverses)
stays numpy. Chunks are byte-identical to the JAX package's `RSCodec`.

Batched data path: `encode_many` stacks every fragment of a request
column-wise into ONE (k, sum L) GF(256) matmul instead of one dispatch
per fragment, and decode matrices are LRU-cached by survivor index
tuple so repeated degraded reads with the same survivor set pay for
exactly one O(k^3) Gauss-Jordan inversion (`cache_info()` exposes hit
accounting). Encode writes the framed payload straight into one
preallocated stacked buffer — a host payload crosses to the device
exactly once, into that buffer. Stacked buffers get a row pitch rounded
up to 16 bytes, so the kernel reads aligned rows.

A degraded decode whose matrix `gathers` (every RS(10+2) and RS(4+2)
survivor set) is one `gf256_gather_framed` per survivor group: each
fragment's survivors are read where they lie (slab-resident tensors in
place; host chunks cross to the device once) and its rows land straight
in its framed buffer, with no survivor buffer and no unframing copy.
Other matrices stage as the JAX package does: survivors copied into one
stacked buffer, one product, rows copied into each framed buffer
(`staged_decodes` counts a CUDA codec's fragments decoded so).
"""
from __future__ import annotations

import struct
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.payload import (as_u8, payload_nbytes,
                                      require_device, to_bytes, to_device)
from repro_torch.kernels.rs_gf256.ops import (gathers, gf256_gather_framed,
                                              gf256_matmul)
from repro_torch.kernels.rs_gf256.ref import (cauchy_parity_matrix,
                                              gf_inv_matrix_np)

_HEADER = struct.Struct("<I")    # original length prefix
_PITCH = 16                      # stacked-buffer row alignment (bytes)
_BODY_ALIGN = 16                 # decoded payload alignment (bytes)


@dataclass(frozen=True)
class ECConfig:
    k: int = 10
    p: int = 2

    @property
    def n(self) -> int:
        return self.k + self.p


def _stacked(rows: int, cols: int, device) -> torch.Tensor:
    """(rows, cols) uint8 view of an uninitialised buffer whose row
    pitch is `cols` rounded up to 16 bytes."""
    pitch = -(-cols // _PITCH) * _PITCH
    return torch.empty((rows, pitch), dtype=torch.uint8,
                       device=device)[:, :cols]


def _framed(nbytes: int, device) -> torch.Tensor:
    """A flat uint8 buffer for one framed fragment, placed 12 bytes into
    its allocation so the payload after the 4-byte header starts 16-byte
    aligned: a decoded array then views as any dtype (`.view(float64)`
    needs an aligned storage offset)."""
    pad = _BODY_ALIGN - _HEADER.size
    return torch.empty(pad + nbytes, dtype=torch.uint8,
                       device=device)[pad:]


class RSCodec:
    def __init__(self, cfg: ECConfig = ECConfig(), *, device="cuda",
                 inv_cache_size: int = 64):
        self.cfg = cfg
        self.device = require_device(device)
        # the device as a tensor there reports it (index included): a
        # flat uint8 chunk already on it is read where it lies
        self._on = torch.empty(0, dtype=torch.uint8,
                               device=self.device).device
        self._parity = cauchy_parity_matrix(cfg.k, cfg.p)
        self._gen = np.concatenate(
            [np.eye(cfg.k, dtype=np.uint8), self._parity], axis=0)
        # decode-matrix LRU: survivor index tuple -> inverted (k, k) matrix
        self._inv_cache: "OrderedDict[Tuple[int, ...], np.ndarray]" = \
            OrderedDict()
        self._inv_cache_size = inv_cache_size
        self._inv_lock = threading.Lock()    # store serves concurrent GETs
        self._cache_hits = 0
        self._cache_misses = 0
        self._inversions = 0
        # fragments a CUDA codec decoded through staging (no gathered
        # decode for their matrix); guarded by _inv_lock
        self.staged_decodes = 0

    # ---- encode -------------------------------------------------------------

    def encode(self, payload) -> List[bytes]:
        """payload -> k+p chunk payloads (equal length)."""
        return self.encode_many([payload])[0]

    def encode_many(self, payloads: Sequence, *,
                    as_arrays: bool = False) -> List[List]:
        """Batch encode: all payloads' data blocks are stacked column-wise
        into one (k, sum clen) device buffer and the parity rows come
        from a single GF(256) matmul.

        Payloads may be bytes, numpy arrays or tensors on any device
        (Payload protocol). With `as_arrays=True` chunks come back as
        uint8 tensor views into the stacked encode buffer and the parity
        output (zero-copy) instead of materialized `bytes`."""
        if not payloads:
            return []
        k, p = self.cfg.k, self.cfg.p
        clens = [self.chunk_len(payload_nbytes(pl)) for pl in payloads]
        data = _stacked(k, int(sum(clens)), self.device)
        off = 0
        for pl, clen in zip(payloads, clens):
            self._fill_framed(data[:, off:off + clen], as_u8(pl))
            off += clen
        parity = gf256_matmul(self._parity, data)
        out: List[List] = []
        off = 0
        for clen in clens:
            sl = slice(off, off + clen)
            rows = [data[i, sl] for i in range(k)] + \
                [parity[i, sl] for i in range(p)]
            out.append(rows if as_arrays else [to_bytes(r) for r in rows])
            off += clen
        return out

    @staticmethod
    def _fill_framed(block: torch.Tensor, flat: torch.Tensor) -> None:
        """Write the framed payload (length header + flat uint8 payload,
        zero-padded) row-major into `block` — a (k, clen) column-slice
        view of the stacked buffer — via direct per-row copies."""
        k, clen = block.shape
        hdr = torch.frombuffer(bytearray(_HEADER.pack(flat.numel())),
                               dtype=torch.uint8)
        H, end = hdr.numel(), hdr.numel() + flat.numel()
        for i in range(k):
            s = i * clen
            if s >= end:
                block[i:].zero_()
                break
            e = min(s + clen, end)
            dst = block[i]
            if s < H:                          # row overlaps the header
                hn = min(H, e) - s
                dst[:hn].copy_(hdr[s:s + hn])
                if e > H:
                    dst[hn:e - s].copy_(flat[:e - H])
            else:
                dst[:e - s].copy_(flat[s - H:e - H])
            if e - s < clen:
                dst[e - s:].zero_()

    # ---- decode -------------------------------------------------------------

    def decode(self, chunks: Dict[int, bytes]) -> bytes:
        """chunks: {chunk_index: payload} with >= k entries. Returns the
        original payload (any k of the k+p indices suffice)."""
        return self.decode_many([chunks])[0]

    def decode_many(self, chunk_maps: Sequence[Dict[int, object]], *,
                    as_arrays: bool = False) -> List:
        """Batch decode: fragments sharing a survivor set are
        reconstructed together by their cached inverse, in one gathered
        decode straight into their framed buffers where the matrix
        `gathers`, else stacked column-wise into one device buffer for
        one matmul.

        Chunks may be bytes, numpy arrays (COS reads) or tensors
        (slab-resident); host chunks cross to the device once. With
        `as_arrays=True` results are flat uint8 tensors on the codec's
        device (the GET-side zero-copy path)."""
        k = self.cfg.k
        ident = tuple(range(k))
        results: List = [b""] * len(chunk_maps)
        groups: Dict[Tuple[int, ...], List[int]] = {}
        for pos, chunks in enumerate(chunk_maps):
            if len(chunks) < k:
                raise ValueError(
                    f"need >= {k} chunks to decode, got {len(chunks)}")
            idx = tuple(sorted(chunks)[:k])
            if idx == ident:                   # all data rows survive
                if not as_arrays and all(isinstance(chunks[i], bytes)
                                         for i in ident):
                    results[pos] = self._unframe(
                        b"".join(chunks[i] for i in ident))
                else:
                    clen = payload_nbytes(chunks[0])
                    flat = _framed(k * clen, self.device)
                    for i in ident:
                        flat[i * clen:(i + 1) * clen].copy_(as_u8(chunks[i]))
                    results[pos] = self._unframe_t(flat, as_arrays)
            else:
                groups.setdefault(idx, []).append(pos)
        for idx, positions in groups.items():
            inv = self._decode_matrix(idx)
            if gathers(inv):
                chunks = [[self._in_place(chunk_maps[pos][i]) for i in idx]
                          for pos in positions]
                flats = [_framed(k * rows[0].numel(), self.device)
                         for rows in chunks]
                # a CPU codec's plain version stages into our product
                gf256_gather_framed(inv, chunks, flats, matmul=gf256_matmul)
                for pos, flat in zip(positions, flats):
                    results[pos] = self._unframe_t(flat, as_arrays)
                continue
            if self.device.type == "cuda":
                with self._inv_lock:
                    self.staged_decodes += len(positions)
            clens = [payload_nbytes(chunk_maps[pos][idx[0]])
                     for pos in positions]
            surv = _stacked(k, int(sum(clens)), self.device)
            off = 0
            for pos, clen in zip(positions, clens):
                cm = chunk_maps[pos]
                for r, i in enumerate(idx):
                    surv[r, off:off + clen].copy_(as_u8(cm[i]))
                off += clen
            dec = gf256_matmul(inv, surv)
            off = 0
            for pos, clen in zip(positions, clens):
                flat = _framed(k * clen, self.device)
                flat.view(k, clen).copy_(dec[:, off:off + clen])
                results[pos] = self._unframe_t(flat, as_arrays)
                off += clen
        return results

    def _in_place(self, chunk) -> torch.Tensor:
        """A chunk as a flat uint8 tensor on the codec's device: a
        slab-resident one as it lies, anything else through `to_device`
        (a host chunk crosses once)."""
        if type(chunk) is torch.Tensor and chunk.dtype == torch.uint8 \
                and chunk.dim() == 1 and chunk.is_contiguous() \
                and chunk.device == self._on:
            return chunk
        return to_device(chunk, self.device)

    def _decode_matrix(self, idx: Tuple[int, ...]) -> np.ndarray:
        with self._inv_lock:
            hit = self._inv_cache.get(idx)
            if hit is not None:
                self._inv_cache.move_to_end(idx)
                self._cache_hits += 1
                return hit
            self._cache_misses += 1
            self._inversions += 1
        inv = gf_inv_matrix_np(self._gen[list(idx)])   # outside the lock
        with self._inv_lock:
            self._inv_cache[idx] = inv
            if len(self._inv_cache) > self._inv_cache_size:
                self._inv_cache.popitem(last=False)
        return inv

    @staticmethod
    def _unframe(framed: bytes) -> bytes:
        (orig_len,) = _HEADER.unpack_from(framed)
        return framed[_HEADER.size:_HEADER.size + orig_len]

    @staticmethod
    def _unframe_t(flat: torch.Tensor, as_arrays: bool):
        """Unframe a flat uint8 tensor; returns a view (as_arrays) or
        bytes. Reading the length header is a 4-byte device-to-host
        copy."""
        (orig_len,) = _HEADER.unpack(to_bytes(flat[:_HEADER.size]))
        body = flat[_HEADER.size:_HEADER.size + orig_len]
        return body if as_arrays else to_bytes(body)

    def cache_info(self) -> Dict[str, int]:
        """Decode-matrix LRU accounting (hits/misses/inversions/size)."""
        return {"hits": self._cache_hits, "misses": self._cache_misses,
                "inversions": self._inversions,
                "size": len(self._inv_cache)}

    def chunk_len(self, payload_len: int) -> int:
        return -(-(payload_len + _HEADER.size) // self.cfg.k)
