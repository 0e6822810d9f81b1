"""GF(256) Reed-Solomon matmul: Hopper CUDA kernels (the codec's, and the
xtime-ladder A/B baseline) + their plain PyTorch versions."""
from repro_torch.kernels.rs_gf256.ops import gf256_matmul  # noqa: F401
from repro_torch.kernels.rs_gf256.ref import (  # noqa: F401
    gf256_matmul_ladder_ref, gf256_matmul_ref)
