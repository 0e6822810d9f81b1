"""tests/test_frontend_conformance.py's own contracts run against the
port's four frontends (device="cpu"): `InfiniStore`, `ShardedStore`,
and `ProcessShardedStore` over shm rings and over TCP, each under the
port's `repro_torch.devtools.witness.LockWitness`.

Left out: the array contract's `got.dtype == np.uint8` — the port's
`get_array` returns a uint8 torch tensor on the store's device (ROADMAP
queue 3). `test_array_payloads_roundtrip_as_tensors` below holds the
same contract in the port's terms on all four frontends."""
import numpy as np
import torch

from _torch_mirror import mirror

globals().update(mirror("test_frontend_conformance.py", skip={
    "test_array_payloads_roundtrip":
        "compares a torch tensor's dtype with np.uint8",
}))


def test_array_payloads_roundtrip_as_tensors(frontend):
    arr = np.arange(40_000, dtype=np.uint8)
    assert frontend.put("arr", arr) == 1
    got = frontend.get_array("arr")
    assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
    assert got.device == torch.device("cpu")
    assert np.array_equal(got.numpy(), arr)
    assert frontend.get_array("absent") is None
    out = frontend.get_many_arrays(["arr", "absent"])
    assert np.array_equal(out["arr"].numpy(), arr) and out["absent"] is None
    # a writable tensor of its own: writing to it changes no stored byte
    got[:] = 0
    assert frontend.get("arr") == arr.tobytes()
