"""Median of the program's `daemon.get_us` histogram over the window:
the daemon thread's host time for one GET batch (its `daemon.get_many`
span), in us."""
from chipbench.metrics._hist import quantile_us


def read(run):
    counts = run.obs_delta.get("daemon.get_us")
    return quantile_us(counts, 0.5) if counts else None
