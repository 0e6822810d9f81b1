"""Bytes the store restored from COS in the window (its exported
`recovery_bytes` counter) over the summed length of the window's
`recovery.session` spans, in GB/s (10^9)."""
from chipbench.drivers.store_reclaim import recovery_gb_s


def read(run):
    return recovery_gb_s(run)
