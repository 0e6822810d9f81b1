"""tests/test_get_pipeline.py's own test bodies run against the port
(device="cpu"). Left out: the read-only check on array results — torch
has no read-only tensors (test_torch_store.py holds the port's
private-copy contract and the ready-order decode batches instead)."""
from _torch_mirror import mirror

globals().update(mirror("test_get_pipeline.py", skip={
    "test_ready_order_decode_batches_and_array_path":
        "asserts numpy read-only flags on array GET results",
}))
