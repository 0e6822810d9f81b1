"""95th percentile of the latency of every GET that completed inside the
window, issue to tensor on the card (synchronised), in ms, in the
`store.ycsb-c.degraded` cell. Its runs spread too widely for a bound (a few
stalls of tens of ms set it), so it is read beside `get_gb_s`."""
from chipbench.drivers.store_reads import get_p95_ms


def read(run):
    return get_p95_ms(run)
