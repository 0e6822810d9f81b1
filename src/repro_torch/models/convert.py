"""Carry weights and train state across from the JAX package's layout.

The reference keeps a model's parameters as one flat dict
(`{"embed", "final_norm", "layers/wq", ...}`) whose layouts the port
keeps unchanged, so a dict of numpy arrays made from the reference's
params runs through the port's model as it is. Its train state is
`{"params": params, "opt": {"mu", "nu", "master": dicts like params,
"count": 0-d int32}}`, which the port's optimizer keeps too.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def _to_tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (JAX's arrays come out with an
        # extension dtype that torch.from_numpy refuses): same bits via
        # uint16
        bits = np.ascontiguousarray(arr).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def params_from_numpy(params: Dict[str, np.ndarray], *, device,
                      dtype: Optional[torch.dtype] = None
                      ) -> Dict[str, torch.Tensor]:
    """{name: array} -> {name: tensor on `device`}, same keys and layouts;
    `dtype` casts every tensor (None keeps each array's own type)."""
    out = {}
    for name, arr in params.items():
        t = _to_tensor(arr)
        out[name] = t.to(device=device, dtype=dtype or t.dtype)
    return out


def train_state_from_numpy(state, *, device):
    """The reference's train state (any nested dict of arrays, e.g.
    `{"params", "opt"}`, as numpy) -> the same dicts of tensors on
    `device`, each array keeping its dtype and shape (0-d `count`
    included)."""
    if isinstance(state, dict):
        return {k: train_state_from_numpy(v, device=device)
                for k, v in state.items()}
    return _to_tensor(state).to(device)


def train_state_to_numpy(state):
    """The inverse, for comparisons: nested dicts of tensors -> numpy on
    the host; bfloat16 comes back widened to float32 (exact), since
    numpy has no bfloat16 of its own."""
    if isinstance(state, dict):
        return {k: train_state_to_numpy(v) for k, v in state.items()}
    t = state.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
