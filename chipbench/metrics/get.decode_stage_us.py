"""Median of the program's `get.decode_batch_us` histogram over the
window: host time of one ready-order decode batch (staging the
survivors, launching the product, unframing), in us."""
from chipbench.metrics._hist import quantile_us


def read(run):
    counts = run.obs_delta.get("get.decode_batch_us")
    return quantile_us(counts, 0.5) if counts else None
