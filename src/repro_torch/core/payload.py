"""Payload protocol: what the store needs from a value — a byte length
and a flat uint8 view — over torch tensors, bytes and numpy arrays.

- `bytes` / `bytearray` / `memoryview`, `np.ndarray` -> a CPU uint8
  tensor view (no copy; `torch.frombuffer` over immutable `bytes` is a
  view the store never writes through)
- `torch.Tensor` (any dtype, any device) -> `.contiguous().view(uint8)`
  flattened, on the tensor's own device (no copy when contiguous)

Crossings between host and device are explicit: `to_device` (one
host-to-device copy, into wherever the caller needs the bytes) and
`to_host` (one device-to-host copy, for the spill journal and COS,
which hold host bytes only). `host_u8` is the no-copy host view the
journal takes; it refuses device tensors instead of copying them.

Unlike `jax.Array`, a torch tensor is mutable, so `needs_snapshot` is
true for every tensor: the store clones it on the caller's thread at
submission (device to device for a CUDA tensor).
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

# What the store accepts as a value: anything bytes-like or array-like.
Payload = Union[bytes, bytearray, memoryview, np.ndarray, torch.Tensor]

_BYTES_LIKE = (bytes, bytearray, memoryview)


def is_array_payload(p) -> bool:
    """True for tensor / ndarray-like payloads."""
    return isinstance(p, torch.Tensor) or (
        not isinstance(p, _BYTES_LIKE) and hasattr(p, "__array__"))


def payload_nbytes(p) -> int:
    if isinstance(p, torch.Tensor):
        return p.numel() * p.element_size()
    if isinstance(p, (bytes, bytearray)):
        return len(p)
    if isinstance(p, (memoryview, np.ndarray)):
        return p.nbytes
    return len(p)


def as_u8(p) -> torch.Tensor:
    """Flat uint8 tensor view of the payload on its own device (host
    buffers become CPU tensors); copies only for non-contiguous input."""
    if isinstance(p, torch.Tensor):
        # flattened first: torch refuses a dtype view of a 0-d tensor
        return p.contiguous().reshape(-1).view(torch.uint8)
    if isinstance(p, _BYTES_LIKE):
        if payload_nbytes(p) == 0:
            return torch.empty(0, dtype=torch.uint8)
        return torch.frombuffer(p, dtype=torch.uint8)
    arr = np.ascontiguousarray(p).reshape(-1).view(np.uint8)
    if arr.size == 0:
        return torch.empty(0, dtype=torch.uint8)
    return torch.from_numpy(arr)


def to_device(p, device) -> torch.Tensor:
    """Flat uint8 tensor on `device`: no copy when already there, else
    exactly one transfer."""
    return as_u8(p).to(device)


def host_u8(p) -> np.ndarray:
    """Flat uint8 numpy view of a HOST payload (no copy). A device
    tensor raises: callers that mean to pay the device-to-host copy
    say so with `to_host`."""
    if isinstance(p, torch.Tensor):
        if p.device.type != "cpu":
            raise TypeError(f"host buffer expected, got a tensor on "
                            f"{p.device}")
        return as_u8(p).numpy()
    if isinstance(p, _BYTES_LIKE):
        return np.frombuffer(p, np.uint8)
    return np.ascontiguousarray(p).reshape(-1).view(np.uint8)


def to_host(p):
    """Host bytes-like view of the payload: bytes-likes pass through,
    arrays and tensors become flat uint8 numpy (one device-to-host copy
    for a device tensor)."""
    if isinstance(p, _BYTES_LIKE):
        return p
    if isinstance(p, torch.Tensor):
        return as_u8(p).cpu().numpy()
    return host_u8(p)


def require_device(device) -> torch.device:
    """`device` as a `torch.device`. Raises when it names CUDA on a
    machine without a card: an entry point configured for the card never
    carries on silently on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but CUDA is "
                           f"not available; pass device='cpu' to run on "
                           f"the CPU")
    return dev


def needs_snapshot(p) -> bool:
    """True when the payload aliases caller-MUTABLE memory and the store
    must take a private copy at the ack boundary (the persistent buffer
    owns its data). Every tensor qualifies; bytes and read-only numpy
    arrays do not."""
    if isinstance(p, torch.Tensor):
        return True
    if isinstance(p, np.ndarray):
        return bool(p.flags.writeable)
    if isinstance(p, bytearray):
        return True
    if isinstance(p, memoryview):
        return not p.readonly
    return False


def to_bytes(p) -> bytes:
    """Materialize a payload as bytes (the GET return type)."""
    if isinstance(p, bytes):
        return p
    if isinstance(p, (bytearray, memoryview)):
        return bytes(p)
    return to_host(p).tobytes()
