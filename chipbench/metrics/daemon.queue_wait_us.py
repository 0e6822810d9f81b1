"""Median of the program's `daemon.queue_wait_us` histogram over the
window: how long a task waited in the store's daemon queue, from its
submission to the daemon thread starting it, in us."""
from chipbench.metrics._hist import quantile_us


def read(run):
    counts = run.obs_delta.get("daemon.queue_wait_us")
    return quantile_us(counts, 0.5) if counts else None
