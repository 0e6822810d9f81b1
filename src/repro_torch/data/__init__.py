"""Deterministic synthetic training data and workload traces (numpy)."""
from repro_torch.data.pipeline import TokenPipeline, make_batch  # noqa: F401
from repro_torch.data.traces import (azure_blob_trace,  # noqa: F401
                                     ibm_registry_trace, TraceEvent)
