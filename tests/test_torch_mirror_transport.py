"""tests/test_transport.py's own test bodies run against the port (device="cpu")."""
from _torch_mirror import mirror

globals().update(mirror("test_transport.py"))
