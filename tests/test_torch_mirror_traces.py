"""tests/test_traces.py's own test bodies run against the port's
`data/traces.py` (numpy only, carried over with its imports rewritten)."""
from _torch_mirror import mirror

globals().update(mirror("test_traces.py"))
