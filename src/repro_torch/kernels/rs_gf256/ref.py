"""GF(256) arithmetic + the plain PyTorch version of the RS kernel.

Field: GF(2^8) with the AES/RS polynomial x^8+x^4+x^3+x^2+1 (0x11D),
generator 2. Host-side codec math (encode matrices, Gauss-Jordan
inversion) uses numpy tables, exactly as the JAX package's `ref.py`
does; `gf256_matmul_ref` is the plain PyTorch product the CUDA kernel
is held against (and the CPU tensors' path through `ops.gf256_matmul`).
"""
from __future__ import annotations

import numpy as np
import torch

POLY = 0x11D


def _build_tables():
    exp = np.zeros(512, np.int32)
    log = np.zeros(256, np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    exp[255:510] = exp[:255]
    return exp, log


EXP_TABLE, LOG_TABLE = _build_tables()


def gf_mul_np(a, b):
    """Element-wise GF(256) multiply (numpy, table-based)."""
    a = np.asarray(a, np.int32)
    b = np.asarray(b, np.int32)
    out = EXP_TABLE[(LOG_TABLE[a] + LOG_TABLE[b]) % 255]
    return np.where((a == 0) | (b == 0), 0, out).astype(np.uint8)


def gf_inv_np(a):
    a = np.asarray(a, np.int32)
    if np.any(a == 0):
        raise ZeroDivisionError("GF(256) inverse of 0")
    return EXP_TABLE[255 - LOG_TABLE[a]].astype(np.uint8)


def gf_matmul_np(A: np.ndarray, X: np.ndarray) -> np.ndarray:
    """(m,k) @ (k,L) over GF(256): XOR-accumulated products."""
    A = np.asarray(A, np.uint8)
    X = np.asarray(X, np.uint8)
    m, k = A.shape
    out = np.zeros((m, X.shape[1]), np.uint8)
    for j in range(k):
        out ^= gf_mul_np(A[:, j:j + 1], X[j:j + 1, :])
    return out


def _build_mul_table() -> np.ndarray:
    """Full 256x256 GF(256) product table (64 KB): MUL[a, b] = a*b."""
    a = np.arange(256, dtype=np.uint8)
    return gf_mul_np(a[:, None], a[None, :])


GF_MUL_TABLE = _build_mul_table()


def gf_matmul_table(A: np.ndarray, X: np.ndarray) -> np.ndarray:
    """(m,k) @ (k,L) over GF(256) on the host: one gather + one XOR per
    coefficient via the full product table."""
    A = np.asarray(A, np.uint8)
    X = np.asarray(X, np.uint8)
    m, k = A.shape
    out = np.zeros((m, X.shape[1]), np.uint8)
    for i in range(m):
        row = out[i]
        for j in range(k):
            c = A[i, j]
            if c:
                row ^= GF_MUL_TABLE[c, X[j]]
    return out


def gf_coeff_planes(A: np.ndarray) -> np.ndarray:
    """(m,k) uint8 -> (m,k,8) uint8 companion-matrix bit-planes.

    plane[..., b] = A * 2^b over GF(256) — the image of input bit b under
    multiplication by each coefficient. With these, a GF(256) constant
    multiply is 8 mask-and-XOR steps with no per-bit selects:
    out = XOR_b spread(bit_b(x)) & plane[b]."""
    planes = [np.asarray(A, np.uint8)]
    for _ in range(7):
        planes.append(gf_mul_np(planes[-1], np.uint8(2)))
    return np.stack(planes, axis=-1)


def gf_inv_matrix_np(M: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inversion over GF(256)."""
    M = np.asarray(M, np.uint8)
    n = M.shape[0]
    aug = np.concatenate([M, np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        piv = next((r for r in range(col, n) if aug[r, col] != 0), None)
        if piv is None:
            raise ValueError("singular GF(256) matrix")
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        aug[col] = gf_mul_np(aug[col], gf_inv_np(aug[col, col]))
        for r in range(n):
            if r != col and aug[r, col]:
                aug[r] ^= gf_mul_np(aug[r, col], aug[col])
    return aug[:, n:]


def cauchy_parity_matrix(k: int, p: int) -> np.ndarray:
    """Parity rows of a systematic RS code: Cauchy matrix
    C[i,j] = 1/(x_i ^ y_j) with x_i = k+i, y_j = j — every square
    submatrix of [I; C] is invertible, so any k of the k+p chunks
    reconstruct the data."""
    if k + p > 256:
        raise ValueError("k+p must be <= 256 for GF(256)")
    x = np.arange(k, k + p, dtype=np.int32)
    y = np.arange(k, dtype=np.int32)
    return gf_inv_np(x[:, None] ^ y[None, :])


# ---- plain PyTorch version -------------------------------------------------

def gf256_matmul_ref(G, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch (m,k) @ (k,L) over GF(256) on X's device.

    G: (m,k) uint8 (numpy or tensor); X: (k,L) uint8 tensor, any strides.
    Each coefficient's row of the 256x256 product table is gathered by
    the data bytes and XOR-accumulated — byte arithmetic only (torch has
    no CPU shifts for uint32). Bit-identical to `gf_matmul_np`."""
    dev = X.device
    if not isinstance(G, torch.Tensor):
        G = torch.from_numpy(np.ascontiguousarray(G, np.uint8))
    G = G.to(device=dev, dtype=torch.uint8)
    m, k = G.shape
    if X.dtype != torch.uint8 or X.dim() != 2 or X.shape[0] != k:
        raise ValueError(f"X must be ({k}, L) uint8, got "
                         f"{tuple(X.shape)} {X.dtype}")
    table = torch.from_numpy(GF_MUL_TABLE).to(dev)
    rows = table[G.long()]                       # (m, k, 256)
    out = torch.zeros((m, X.shape[1]), dtype=torch.uint8, device=dev)
    for j in range(k):
        out ^= torch.index_select(rows[:, j], 1, X[j].long())
    return out


def gf256_gather_framed_ref(G, chunks, outs, matmul=None) -> None:
    """Plain PyTorch version of the gathered, framed decode: for each
    fragment f, its k survivor chunks `chunks[f]` (flat uint8 tensors of
    one length L) staged into one (k, L) tensor, multiplied by G, and the
    (m, L) product written row after row into `outs[f]` (flat uint8,
    m * L bytes): output row i at byte i * L. The product is `matmul`
    (G, X), `gf256_matmul_ref` unless the caller names its own (the
    codec names its `gf256_matmul`, which takes this plain product on
    CPU tensors)."""
    matmul = gf256_matmul_ref if matmul is None else matmul
    if len(chunks) != len(outs):
        raise ValueError(f"{len(chunks)} fragments, {len(outs)} outputs")
    m, k = np.shape(G)
    for f, (rows, out) in enumerate(zip(chunks, outs)):
        L = rows[0].numel() if rows else 0
        if len(rows) != k or any(r.numel() != L for r in rows) or \
                out.numel() != m * L:
            raise ValueError(f"fragment {f}: need {k} chunks of one length "
                             f"and an output of {m} rows of it")
        X = torch.stack([r.reshape(-1) for r in rows])
        out.view(m, L).copy_(matmul(G, X))


def gf256_matmul_ladder_ref(G, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch xtime ladder, the ladder kernel's plain version: the
    same (m,k) @ (k,L) product on X's device, one byte per int32 lane.
    For each input row j the running multiple a = X[j] * 2^bit is built
    by xtime (shift, mask to a byte, 0x1D when bit 7 carried out), and
    each output row takes it where its coefficient has that bit — the
    arithmetic of the JAX package's `_gf_mul_const`, rows vectorised.
    Bit-identical to `gf_matmul_np`."""
    dev = X.device
    if not isinstance(G, torch.Tensor):
        G = torch.from_numpy(np.ascontiguousarray(G, np.uint8))
    G = G.to(device=dev, dtype=torch.int32)
    m, k = G.shape
    if X.dtype != torch.uint8 or X.dim() != 2 or X.shape[0] != k:
        raise ValueError(f"X must be ({k}, L) uint8, got "
                         f"{tuple(X.shape)} {X.dtype}")
    out = torch.zeros((m, X.shape[1]), dtype=torch.int32, device=dev)
    for j in range(k):
        a = X[j].to(torch.int32)[None, :]                  # (1, L)
        for bit in range(8):
            take = -((G[:, j:j + 1] >> bit) & 1)             # (m, 1): 0 / -1
            out ^= a & take
            a = ((a << 1) & 0xFF) ^ (((a >> 7) & 1) * 0x1D)
    return out.to(torch.uint8)
