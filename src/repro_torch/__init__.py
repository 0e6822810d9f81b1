"""InfiniStore on PyTorch + CUDA: the port of the `repro` package.

Imports torch and numpy only — never jax, never `repro`.
"""
