"""Public op: gf256_matmul, dispatched on the data tensor's device and
the `backend` chosen, mirroring the JAX package's
`rs_gf256/ops.py::gf256_matmul`.

A CUDA tensor launches a hand-written Hopper kernel (`kernel.py`); a
CPU tensor takes that kernel's plain PyTorch version (`ref.py`). Any
other input (a DTensor included) raises — a CUDA tensor never silently falls back to a plain
version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import require_plain
from repro_torch.kernels.rs_gf256.kernel import (gf256_matmul_cuda,
                                                 gf256_matmul_ladder_cuda)
from repro_torch.kernels.rs_gf256.ref import (gf256_matmul_ladder_ref,
                                              gf256_matmul_ref)

# backend -> (CUDA tensor, CPU tensor)
_BACKENDS = {
    "auto": (gf256_matmul_cuda, gf256_matmul_ref),
    "bitsliced": (gf256_matmul_cuda, gf256_matmul_ref),
    "ladder": (gf256_matmul_ladder_cuda, gf256_matmul_ladder_ref),
    "ref": (gf256_matmul_ref, gf256_matmul_ref),
}


def gf256_matmul(G, X: torch.Tensor, *, backend: str = "auto"
                 ) -> torch.Tensor:
    """OUT = G @ X over GF(256). G: (m,k) uint8 (numpy or tensor), X:
    (k,L) uint8 tensor.

    backend: "auto" (the codec's: the codec kernel on a CUDA tensor,
             plain version on a CPU one), "bitsliced" (the same; the
             reference's "pallas", whose TPU kernel it replaces), "ladder" (the xtime-ladder kernel,
             or its plain version on a CPU tensor; the A/B baseline),
             "ref" (the plain version on either device). The
             reference's "interpret" has no counterpart and raises, as
             any unknown name does.
    """
    if backend not in _BACKENDS:
        raise ValueError(f"unknown GF(256) backend {backend!r}; known: "
                         f"{sorted(_BACKENDS)}")
    if not isinstance(X, torch.Tensor):
        raise TypeError(f"X must be a torch.Tensor, got {type(X).__name__}")
    require_plain("gf256_matmul", G, X)
    on_cuda, on_cpu = _BACKENDS[backend]
    if X.device.type == "cuda":
        return on_cuda(G, X)
    if X.device.type == "cpu":
        return on_cpu(G, X)
    raise ValueError(f"no GF(256) matmul for device {X.device}")
