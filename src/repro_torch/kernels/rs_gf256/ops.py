"""Public ops: gf256_matmul, dispatched on the data tensor's device and
the `backend` chosen, mirroring the JAX package's
`rs_gf256/ops.py::gf256_matmul`; and gf256_gather_framed, the codec's
gathered, framed decode (no counterpart in the JAX package, which
stacks and unframes in host arrays).

A CUDA tensor launches a hand-written Hopper kernel (`kernel.py`); a
CPU tensor takes that kernel's plain PyTorch version (`ref.py`). Any
other input (a DTensor included) raises — a CUDA tensor never silently falls back to a plain
version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import require_plain
from repro_torch.kernels.rs_gf256.kernel import (gf256_gather_framed_cuda,
                                                 gf256_matmul_cuda,
                                                 gf256_matmul_ladder_cuda,
                                                 plan_for)
from repro_torch.kernels.rs_gf256.ref import (gf256_gather_framed_ref,
                                              gf256_matmul_ladder_ref,
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


def gathers(G) -> bool:
    """Whether `gf256_gather_framed` takes G: its row plan routes "small"
    (k in {4, 10}, at most 16 rows, at most 2 dense: every RS(10+2) and
    RS(4+2) decode matrix)."""
    return plan_for(G, "cpu").route == "small"


def gf256_gather_framed(G, chunks, outs, *, matmul=None) -> None:
    """The gathered, framed decode: for each fragment f, G @ chunks[f]
    over GF(256) written row after row into outs[f] (output row i at
    byte i * L). G: (m, k) uint8 that `gathers`; chunks[f]: k flat uint8
    tensors of one length L; outs[f]: a flat uint8 tensor of m * L bytes.
    CUDA outputs launch `gf256_small_gather` on the chunks where they lie;
    CPU ones take the plain version, which stages into `matmul` (the
    plain product unless the caller names its own)."""
    if not outs:
        return
    tensors = [t for rows in chunks for t in rows] + list(outs)
    require_plain("gf256_gather_framed", *tensors)
    device = outs[0].device
    if device.type == "cuda":
        return gf256_gather_framed_cuda(G, chunks, outs)
    if device.type == "cpu" and all(t.device.type == "cpu"
                                    for t in tensors):
        return gf256_gather_framed_ref(G, chunks, outs, matmul)
    raise ValueError(f"no gathered GF(256) decode for {device} (every "
                     f"chunk and output on one CPU or CUDA device)")
