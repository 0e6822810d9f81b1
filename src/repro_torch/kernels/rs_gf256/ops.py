"""Public op: gf256_matmul, dispatched on the data tensor's device.

A CUDA tensor launches the hand-written Hopper kernel (`kernel.py`); a
CPU tensor takes the plain PyTorch version (`ref.py`). Any other input
raises — a CUDA tensor never silently falls back to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rs_gf256.kernel import gf256_matmul_cuda
from repro_torch.kernels.rs_gf256.ref import gf256_matmul_ref


def gf256_matmul(G, X: torch.Tensor) -> torch.Tensor:
    """OUT = G @ X over GF(256). G: (m,k) uint8 (numpy or tensor), X:
    (k,L) uint8 tensor."""
    if not isinstance(X, torch.Tensor):
        raise TypeError(f"X must be a torch.Tensor, got {type(X).__name__}")
    if X.device.type == "cuda":
        return gf256_matmul_cuda(G, X)
    if X.device.type == "cpu":
        return gf256_matmul_ref(G, X)
    raise ValueError(f"no GF(256) matmul for device {X.device}")
