"""Deterministic synthetic training data (numpy)."""
from repro_torch.data.pipeline import TokenPipeline, make_batch  # noqa: F401
