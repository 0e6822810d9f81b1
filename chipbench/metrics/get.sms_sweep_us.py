"""Median of the program's `get.sms_sweep_us` histogram over the window:
host time of the grouped SMS sweep of one GET batch, in us."""
from chipbench.metrics._hist import quantile_us


def read(run):
    counts = run.obs_delta.get("get.sms_sweep_us")
    return quantile_us(counts, 0.5) if counts else None
