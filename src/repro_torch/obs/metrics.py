"""Lock-free log-spaced latency histograms + Prometheus/JSON export.

`LatencyHistogram` is a fixed-bucket histogram over microseconds with
log-spaced bounds (factor 2^(1/4) ≈ 19% per bucket, 1 µs .. ~12 s, one
overflow bucket). Every bucket cell is an `itertools.count` — a record
is ONE `next()` call, atomic under the GIL, so any number of writer
threads (client daemon, writeback writer, GET I/O workers, heartbeat
loops) increment concurrently without a lock and without lost updates:
the same multi-writer discipline as `store.AtomicCounter`. Reads
snapshot each cell via `__reduce__` (also one C call).

Snapshots are plain count lists, so they are *mergeable*: per-shard and
per-worker-process histograms sum bucket-wise into the store-wide view
(`merge_counts`), and percentiles are extracted from any count list
(`summarize` → p50/p99/p999 at bucket resolution, ≤ ~10% relative
error — honest for SLO reporting, cheap enough for the hot path).

`to_prometheus` renders a `snapshot_metrics()` dict as Prometheus text
(summary-style quantile series + plain counters); `scripts/
check_metrics_dump.py` gates that the dump parses and covers every
`HISTOGRAM_SITES` name.
"""
from __future__ import annotations

import itertools
import json
import math
from bisect import bisect_right
from typing import Dict, Iterable, List, Optional, Sequence

NBUCKETS = 96
# bucket i holds values in (BOUNDS_US[i-1], BOUNDS_US[i]]; the last
# bucket is the overflow bucket
BOUNDS_US = tuple(2.0 ** (i / 4.0) for i in range(NBUCKETS - 1))


def bucket_of(us: float) -> int:
    if us <= 1.0:
        return 0
    return bisect_right(BOUNDS_US, us)


def bucket_upper_us(i: int) -> float:
    if i >= NBUCKETS - 1:
        return math.inf
    return BOUNDS_US[i]


def _bucket_rep_us(i: int) -> float:
    """Representative value reported for bucket i: the geometric middle
    of its bounds (the upper bound for the edge buckets)."""
    if i == 0:
        return 1.0
    if i >= NBUCKETS - 1:
        return BOUNDS_US[-1]
    return math.sqrt(BOUNDS_US[i - 1] * BOUNDS_US[i])


class LatencyHistogram:
    """Fixed-bucket log-spaced histogram; see the module docstring for
    the concurrency model."""
    __slots__ = ("_cells",)

    def __init__(self, counts: Optional[Sequence[int]] = None):
        if counts is None:
            self._cells = [itertools.count(0) for _ in range(NBUCKETS)]
        else:
            self._cells = [itertools.count(int(c)) for c in counts]

    def record(self, us: float) -> None:
        """Lock-free: one GIL-atomic `next()` on the bucket cell."""
        next(self._cells[bucket_of(us)])

    def snapshot(self) -> List[int]:
        return [c.__reduce__()[1][0] for c in self._cells]

    def count(self) -> int:
        return sum(self.snapshot())


def merge_counts(counts_list: Iterable[Sequence[int]]) -> List[int]:
    """Bucket-wise sum of histogram snapshots (shards, workers)."""
    merged = [0] * NBUCKETS
    for counts in counts_list:
        for i, c in enumerate(counts):
            merged[i] += c
    return merged


def quantile_us(counts: Sequence[int], q: float) -> float:
    total = sum(counts)
    if total == 0:
        return 0.0
    rank = max(1, math.ceil(q * total))
    seen = 0
    for i, c in enumerate(counts):
        seen += c
        if seen >= rank:
            return _bucket_rep_us(i)
    return _bucket_rep_us(NBUCKETS - 1)


def summarize(counts: Sequence[int]) -> Dict[str, float]:
    """count + p50/p99/p999 (µs) from one bucket-count snapshot."""
    total = sum(counts)
    return {"count": total,
            "p50_us": round(quantile_us(counts, 0.50), 1),
            "p99_us": round(quantile_us(counts, 0.99), 1),
            "p999_us": round(quantile_us(counts, 0.999), 1)}


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def _prom_name(site: str) -> str:
    return "istore_" + site.replace(".", "_").replace("-", "_")


def to_prometheus(snapshot: Dict) -> str:
    """Render a `snapshot_metrics()` dict as Prometheus text: one
    summary per histogram site (quantile series + `_count`), one
    counter per entry of the flat counter sections (`counters`, the
    transport totals)."""
    lines: List[str] = []
    for site in sorted(snapshot.get("histograms", {})):
        h = snapshot["histograms"][site]
        name = _prom_name(site)
        lines.append(f"# TYPE {name} summary")
        for q, key in (("0.5", "p50_us"), ("0.99", "p99_us"),
                       ("0.999", "p999_us")):
            lines.append(f'{name}{{quantile="{q}"}} {h[key]}')
        lines.append(f"{name}_count {h['count']}")
    counters = dict(snapshot.get("counters", {}))
    transport = snapshot.get("transport") or {}
    for k, v in (transport.get("totals") or {}).items():
        counters[f"transport.{k}"] = v
    for cname in sorted(counters):
        name = _prom_name(cname)
        lines.append(f"# TYPE {name} counter")
        lines.append(f"{name} {counters[cname]}")
    lines.append(f"istore_obs_enabled {int(bool(snapshot.get('enabled')))}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> Dict[str, Dict]:
    """Minimal parser for the dump format above (the CI gate): returns
    {metric_name: {labels-frozen-str: value}}. Raises ValueError on any
    malformed sample line."""
    out: Dict[str, Dict] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name_part, _, value = line.rpartition(" ")
        if not name_part:
            raise ValueError(f"malformed sample line: {line!r}")
        float(value)                      # must be numeric
        if "{" in name_part:
            name, _, rest = name_part.partition("{")
            if not rest.endswith("}"):
                raise ValueError(f"malformed labels: {line!r}")
            labels = rest[:-1]
        else:
            name, labels = name_part, ""
        out.setdefault(name, {})[labels] = float(value)
    return out


def dump_json(snapshot: Dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(snapshot, f, indent=2, default=str)
        f.write("\n")
