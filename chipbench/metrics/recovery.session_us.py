"""Median of the program's `recovery.session_us` histogram over the
window: one `_recover` call, from the detection of a reclaimed function
to the resumption of its service (its `recovery.session` span), in us."""
from chipbench.metrics._hist import quantile_us


def read(run):
    counts = run.obs_delta.get("recovery.session_us")
    return quantile_us(counts, 0.5) if counts else None
