"""95th percentile of the latency of every GET that completed inside the
window, issue to tensor on the card (synchronised), in ms, in the
`store.ycsb-c.reclaim` cell: the GETs that waited behind a recovery on
the daemon thread set it."""
from chipbench.drivers.store_reads import get_p95_ms


def read(run):
    return get_p95_ms(run)
