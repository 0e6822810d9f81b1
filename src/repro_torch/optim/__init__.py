"""Optimizers on torch tensors: AdamW with f32 master weights."""
from repro_torch.optim.adamw import (AdamWConfig,  # noqa: F401
                                     abstract_opt_state, adamw_init,
                                     adamw_update)
