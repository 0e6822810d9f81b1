"""Serving over the SMS-paged KV cache: the engine and the cache."""
from repro_torch.serving.engine import (ServeConfig, ServeEngine,  # noqa: F401
                                        ServeStats)
from repro_torch.serving.kv_cache import SMSPagedKV  # noqa: F401
