"""tests/test_async_api.py's own test bodies run against the port
(device="cpu"). Left out: the checks of numpy/jax return types and
read-only views — the port's array GETs return private uint8 tensors,
held instead by test_torch_store.py's tensor-payload tests."""
from _torch_mirror import mirror

_NUMPY_RESULT = "get_array returns a uint8 torch.Tensor, not a numpy view"
globals().update(mirror("test_async_api.py", skip={
    "test_numpy_payload_roundtrip": _NUMPY_RESULT,
    "test_jax_array_payload_roundtrip": _NUMPY_RESULT,
    "test_bfloat16_device_payload_roundtrip": _NUMPY_RESULT,
    "test_durable_after_flush_with_array_payloads": _NUMPY_RESULT,
    "test_get_array_results_are_read_only":
        "torch has no read-only tensors: array GETs are private copies",
    "test_checkpoint_device_payloads_use_array_path":
        "the checkpointer is slice D, not ported yet",
}))
