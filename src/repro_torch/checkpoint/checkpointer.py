"""InfiniStore-backed checkpointing of a train state.

The JAX package's `checkpoint/checkpointer.py` on torch tensors. Each
leaf of a nested dict (a `torch.Tensor` on any device, a numpy array or
a Python scalar) is split into shards of at most `leaf_shard_bytes` and
PUT through the store's payload path as a flat uint8 view: a CUDA leaf
goes to the store as a device view, with no host round trip (the store
snapshots it on the device, RS-encodes it with the GF(256) kernel and
keeps its chunks in device slabs). Shard batches ride `put_many_async`
with at most `max_inflight_batches` outstanding, and `save()` returns
once the store accepted every shard; COS writes drain in the background.

Restore reads the shards back with `get_many_arrays_async` (tensors on
the store's device), concatenates each leaf's shards with `torch.cat`
and views them as the leaf's dtype and shape. Leaf names, their order
and the manifest JSON are the reference's (leaves in
`jax.tree_util.tree_flatten_with_path` order: sorted dict keys joined by
`/`), so both packages write the same keys and manifest for the same
state.
"""
from __future__ import annotations

import json
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.payload import as_u8
from repro_torch.core.store import StoreFrontend

PyTree = Any


@dataclass
class CheckpointConfig:
    prefix: str = "ckpt"
    keep: int = 3                     # retained checkpoints
    leaf_shard_bytes: int = 64 * 1024 * 1024   # split huge leaves
    max_inflight_batches: int = 2     # pipelined async PUT batches


def _leaf_paths(tree: PyTree) -> List[Tuple[str, Any]]:
    """(name, leaf) pairs in JAX's flatten order: dict keys sorted, list
    and tuple items by index, names joined by "/"; None is an empty
    subtree."""
    out: List[Tuple[str, Any]] = []

    def walk(path, node):
        if node is None:
            return
        if isinstance(node, dict):
            for key in sorted(node):
                walk(path + (str(key),), node[key])
        elif isinstance(node, (list, tuple)):
            for i, item in enumerate(node):
                walk(path + (str(i),), item)
        else:
            out.append(("/".join(path), node))

    walk((), tree)
    return out


def _unflatten_like(like: PyTree, leaves: Dict[str, Any],
                    path: Tuple[str, ...] = ()) -> PyTree:
    """`like`'s structure with each leaf replaced by `leaves[name]`."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {key: _unflatten_like(like[key], leaves, path + (str(key),))
                for key in like}
    if isinstance(like, (list, tuple)):
        items = [_unflatten_like(item, leaves, path + (str(i),))
                 for i, item in enumerate(like)]
        return type(like)(items)
    return leaves["/".join(path)]


def _dtype_and_shape(leaf) -> Tuple[str, List[int]]:
    """The manifest's dtype string (numpy's names: "bfloat16",
    "float32", "int32", ...) and shape of a leaf."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch."), list(leaf.shape)
    arr = np.asarray(leaf)
    return str(arr.dtype), list(arr.shape)


def _restore_dtype(name: str) -> torch.dtype:
    """A manifest dtype string as a torch dtype."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"checkpoint leaf dtype {name!r} has no torch "
                         f"counterpart")
    return dtype


class Checkpointer:
    """Works over any `StoreFrontend` (the port has the single-node
    `InfiniStore`)."""

    def __init__(self, store: StoreFrontend,
                 cfg: CheckpointConfig = CheckpointConfig()):
        self.store = store
        self.cfg = cfg
        self._saved_steps: List[int] = []
        self._lock = threading.Lock()

    # ---- save -------------------------------------------------------------

    def _manifest_key(self, step: int) -> str:
        return f"{self.cfg.prefix}/manifest/{step:08d}"

    def _leaf_key(self, step: int, name: str, shard: int) -> str:
        return f"{self.cfg.prefix}/{step:08d}/{name}/s{shard}"

    def save(self, step: int, state: PyTree) -> None:
        manifest = {"step": step, "leaves": []}
        # shards ride pipelined async batched PUTs in sub-batches of at
        # least `limit` bytes, at most max_inflight_batches outstanding
        limit = max(4 * self.cfg.leaf_shard_bytes, 64 * 1024 * 1024)
        sub, sub_bytes = [], 0
        inflight: List[Any] = []
        for name, leaf in _leaf_paths(state):
            u8 = as_u8(leaf if isinstance(leaf, torch.Tensor)
                       else np.asarray(leaf))
            size = u8.numel()
            nshards = max(1, -(-size // self.cfg.leaf_shard_bytes))
            for si in range(nshards):
                lo = si * self.cfg.leaf_shard_bytes
                hi = min(size, lo + self.cfg.leaf_shard_bytes)
                sub.append((self._leaf_key(step, name, si), u8[lo:hi]))
                sub_bytes += hi - lo
                if sub_bytes >= limit:
                    inflight.append(self.store.put_many_async(sub))
                    sub, sub_bytes = [], 0
                    while len(inflight) >= self.cfg.max_inflight_batches:
                        inflight.pop(0).result()
            dtype, shape = _dtype_and_shape(leaf)
            manifest["leaves"].append(
                {"name": name, "dtype": dtype, "shape": shape,
                 "nshards": nshards, "nbytes": int(size)})
        if sub:
            inflight.append(self.store.put_many_async(sub))
        for fut in inflight:
            fut.result()                         # SMS-accept barrier
        self.store.put(self._manifest_key(step),
                       json.dumps(manifest).encode())
        with self._lock:
            self._saved_steps.append(step)
            while len(self._saved_steps) > self.cfg.keep:
                # slabs age out via the GC window; COS retains durably
                self._saved_steps.pop(0)

    # ---- restore -----------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        steps = []
        # cos_keys includes acked-but-not-yet-persisted manifests (the
        # pending writeback map), so a fresh save is always discoverable;
        # chunk keys look like "chunk/<prefix>/manifest/<step>|<ver>/f0#N"
        for key in self.store.cos_keys(
                f"chunk/{self.cfg.prefix}/manifest/"):
            try:
                steps.append(int(key.split("/")[-2].split("|")[0]))
            except (ValueError, IndexError):
                pass
        with self._lock:
            steps.extend(self._saved_steps)
        return max(steps) if steps else None

    def restore(self, step: int, like: Optional[PyTree] = None) -> PyTree:
        """The state saved at `step`: a flat {name: tensor} dict, or
        `like`'s structure. Leaves are tensors on the store's device."""
        mb = self.store.get(self._manifest_key(step))
        if mb is None:
            raise FileNotFoundError(f"no checkpoint manifest for {step}")
        manifest = json.loads(bytes(mb).decode())
        shard_keys = [self._leaf_key(step, entry["name"], si)
                      for entry in manifest["leaves"]
                      for si in range(entry["nshards"])]
        # batched array GETs in bounded sub-batches, mirroring save()
        limit = max(4 * self.cfg.leaf_shard_bytes, 64 * 1024 * 1024)
        per_batch = max(1, limit // self.cfg.leaf_shard_bytes)
        shards: Dict[str, Optional[torch.Tensor]] = {}
        inflight: List[Any] = []
        for i in range(0, len(shard_keys), per_batch):
            inflight.append(self.store.get_many_arrays_async(
                shard_keys[i:i + per_batch]))
            while len(inflight) >= self.cfg.max_inflight_batches:
                shards.update(inflight.pop(0).result())
        for fut in inflight:
            shards.update(fut.result())
        leaves: Dict[str, torch.Tensor] = {}
        for entry in manifest["leaves"]:
            parts = []
            for si in range(entry["nshards"]):
                a = shards.get(self._leaf_key(step, entry["name"], si))
                if a is None:
                    raise IOError(
                        f"checkpoint shard lost: {entry['name']}/s{si}")
                parts.append(a)
            # the store's array GETs start on 16-byte boundaries, so the
            # dtype view needs no copy
            u8 = parts[0] if len(parts) == 1 else torch.cat(parts)
            leaves[entry["name"]] = u8.view(
                _restore_dtype(entry["dtype"])).reshape(entry["shape"])
        if like is None:
            return leaves
        return _unflatten_like(like, leaves)
