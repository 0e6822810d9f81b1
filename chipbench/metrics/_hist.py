"""Quantiles of the program's latency histograms (`repro_torch.obs`):
96 buckets, bucket i holding (2^((i-1)/4), 2^(i/4)] us, the first
everything up to 1 us, the last the overflow. A quantile reads the
geometric middle of its bucket."""
from __future__ import annotations

import math
from typing import Optional, Sequence

NBUCKETS = 96


def _middle_us(i: int) -> float:
    if i == 0:
        return 1.0
    if i >= NBUCKETS - 1:
        return 2.0 ** ((NBUCKETS - 2) / 4.0)
    return math.sqrt(2.0 ** ((i - 1) / 4.0) * 2.0 ** (i / 4.0))


def quantile_us(counts: Sequence[int], q: float) -> Optional[float]:
    total = sum(counts)
    if total == 0:
        return None
    rank = max(1, math.ceil(q * total))
    seen = 0
    for i, c in enumerate(counts):
        seen += c
        if seen >= rank:
            return _middle_us(i)
    return _middle_us(NBUCKETS - 1)
