"""tests/test_sharding.py's own test bodies run against the port: the
port's `PartitionSpec` in place of JAX's, `make_test_mesh` on the CPU (a
gloo world of one)."""
from _torch_mirror import mirror

globals().update(mirror("test_sharding.py"))
