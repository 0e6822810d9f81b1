"""GF(256) Reed-Solomon matmul: Hopper CUDA kernel + plain PyTorch version."""
from repro_torch.kernels.rs_gf256.ops import gf256_matmul  # noqa: F401
from repro_torch.kernels.rs_gf256.ref import gf256_matmul_ref  # noqa: F401
