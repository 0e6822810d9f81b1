"""Plain NumPy Reed-Solomon RS(k+p) over GF(256): the benchmark's own
reference for the store's codec, frozen here.

Field GF(2^8) with the polynomial x^8+x^4+x^3+x^2+1 (0x11D). The code
is systematic: chunks 0..k-1 are the framed payload's rows, chunks
k..k+p-1 its parity rows C @ data, with the Cauchy rows C[i, j] =
1 / ((k + i) XOR j). A payload is framed as a 4-byte little-endian
length, the payload, and zeros up to k rows of ceil((n + 4) / k) bytes.
Any k of the k+p chunks give the payload back.

Nothing here imports the program under test.
"""
from __future__ import annotations

import struct
from typing import Dict

import numpy as np

POLY = 0x11D
_HEADER = struct.Struct("<I")


def _tables():
    exp = np.zeros(512, np.int64)
    log = np.zeros(256, np.int64)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    exp[255:510] = exp[:255]
    return exp, log


EXP, LOG = _tables()


def gf_mul(a, b) -> np.ndarray:
    """Element-wise product in GF(256)."""
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    out = EXP[(LOG[a] + LOG[b]) % 255]
    return np.where((a == 0) | (b == 0), 0, out).astype(np.uint8)


def gf_inv(a) -> np.ndarray:
    a = np.asarray(a, np.int64)
    if np.any(a == 0):
        raise ZeroDivisionError("0 has no inverse in GF(256)")
    return EXP[255 - LOG[a]].astype(np.uint8)


MUL = gf_mul(np.arange(256)[:, None], np.arange(256)[None, :])


def matmul(A: np.ndarray, X: np.ndarray) -> np.ndarray:
    """(m, k) x (k, L) over GF(256): each output row XORs the table rows
    of its coefficients gathered by the input bytes."""
    A = np.asarray(A, np.uint8)
    X = np.asarray(X, np.uint8)
    out = np.zeros((A.shape[0], X.shape[1]), np.uint8)
    for i in range(A.shape[0]):
        for j in range(A.shape[1]):
            if A[i, j]:
                out[i] ^= MUL[A[i, j]][X[j]]
    return out


def invert(M: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse over GF(256)."""
    M = np.asarray(M, np.uint8)
    n = M.shape[0]
    aug = np.concatenate([M, np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        piv = next((r for r in range(col, n) if aug[r, col]), None)
        if piv is None:
            raise ValueError("singular matrix over GF(256)")
        aug[[col, piv]] = aug[[piv, col]]
        aug[col] = gf_mul(aug[col], gf_inv(aug[col, col]))
        for r in range(n):
            if r != col and aug[r, col]:
                aug[r] ^= gf_mul(aug[r, col], aug[col])
    return aug[:, n:]


def parity_matrix(k: int, p: int) -> np.ndarray:
    x = np.arange(k, k + p)
    y = np.arange(k)
    return gf_inv(x[:, None] ^ y[None, :])


def chunk_len(nbytes: int, k: int) -> int:
    return -(-(nbytes + _HEADER.size) // k)


def frame(payload: np.ndarray, k: int) -> np.ndarray:
    """The (k, L) data rows of a framed payload."""
    payload = np.asarray(payload, np.uint8).reshape(-1)
    L = chunk_len(payload.size, k)
    flat = np.zeros(k * L, np.uint8)
    flat[:_HEADER.size] = np.frombuffer(_HEADER.pack(payload.size), np.uint8)
    flat[_HEADER.size:_HEADER.size + payload.size] = payload
    return flat.reshape(k, L)


def encode(payload: np.ndarray, k: int, p: int) -> np.ndarray:
    """The (k + p, L) chunks of a payload."""
    data = frame(payload, k)
    return np.concatenate([data, matmul(parity_matrix(k, p), data)])


def decode(chunks: Dict[int, np.ndarray], k: int, p: int) -> np.ndarray:
    """The payload from any k of its chunks, {index: (L,) bytes}."""
    idx = sorted(chunks)[:k]
    if len(idx) < k:
        raise ValueError(f"need {k} chunks, got {len(idx)}")
    gen = np.concatenate([np.eye(k, dtype=np.uint8), parity_matrix(k, p)])
    surv = np.stack([np.asarray(chunks[i], np.uint8) for i in idx])
    flat = matmul(invert(gen[idx]), surv).reshape(-1)
    (n,) = _HEADER.unpack(flat[:_HEADER.size].tobytes())
    return flat[_HEADER.size:_HEADER.size + n]
