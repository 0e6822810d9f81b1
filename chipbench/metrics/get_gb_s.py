"""Bytes returned by every GET that completed inside the window, over
the window, in GB/s (10^9)."""
from chipbench.drivers.store_reads import in_window


def read(run):
    recs = in_window(run)
    if not recs:
        return None
    return sum(r[2] for r in recs) / run.seconds / 1e9
