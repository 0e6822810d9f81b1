"""Synthetic workload traces matching the paper's §2 characterization.

Two generators, scaled-down but statistically faithful:

* `ibm_registry_trace` — IBM container-registry-like: log-normal object
  sizes with a heavy tail (~31% of objects > `large_threshold`), strong
  temporal reuse (~80% of re-accesses within `reuse_p80`), shifting
  working set (epoch-wise key-population drift, WSS max/min > 100x), and
  bursty arrivals (CoV > 1 via Pareto inter-arrival times).
* `azure_blob_trace` — Azure-Functions-blob-like: shorter reuse
  intervals (~98% within one interval), heavier burstiness, ~45% large
  objects.

Each event is (time, op, key, size); benchmarks replay them against
InfiniStore and the baselines (Table 2, Figs. 9-11, 15).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass(frozen=True)
class TraceEvent:
    t: float
    op: str           # "get" | "put"
    key: str
    size: int


def _sizes(rng, n, *, large_frac: float, large_threshold: int,
           small_mu: float, small_sigma: float) -> np.ndarray:
    """Log-normal body + heavy tail so `large_frac` of objects exceed
    `large_threshold`."""
    small = rng.lognormal(small_mu, small_sigma, n)
    large = large_threshold * (1.0 + rng.pareto(1.5, n))
    is_large = rng.random(n) < large_frac
    return np.where(is_large, large, np.minimum(small, large_threshold - 1)
                    ).astype(np.int64)


def _bursty_gaps(rng, n, mean_gap: float, cov: float) -> np.ndarray:
    """Pareto-mixture inter-arrival times with coefficient of variation
    > 1 (paper Fig. 1d: ~80% of reused objects have CoV > 1)."""
    shape = 1.0 + 1.0 / max(cov, 1.01)
    gaps = rng.pareto(shape, n) * mean_gap * (shape - 1)
    return gaps


def _trace(rng, *, num_objects: int, num_requests: int, duration: float,
           large_frac: float, large_threshold: int, reuse_interval: float,
           reuse_frac: float, wss_epochs: int, put_frac: float,
           cov: float) -> List[TraceEvent]:
    sizes = _sizes(rng, num_objects, large_frac=large_frac,
                   large_threshold=large_threshold, small_mu=11.0,
                   small_sigma=1.6)
    keys = [f"obj{i:06d}" for i in range(num_objects)]
    gaps = _bursty_gaps(rng, num_requests, duration / num_requests, cov)
    times = np.cumsum(gaps)
    times = times / times[-1] * duration
    # epoch-wise working-set drift: each epoch draws from a sliding window
    # of the key population (drives the WSS shifts of Fig. 1a)
    events: List[TraceEvent] = []
    last_access: dict = {}
    epoch_len = duration / wss_epochs
    for t in times:
        epoch = min(int(t / epoch_len), wss_epochs - 1)
        # working set of this epoch: a window over the population whose
        # width itself varies (max/min WSS ratio >> 1)
        width = max(4, int(num_objects / wss_epochs
                           * (0.1 + 2.0 * abs(np.sin(epoch)))))
        base = int(epoch * num_objects / (wss_epochs + 1))
        if rng.random() < reuse_frac and last_access:
            # temporal reuse: revisit something touched recently
            recent = [k for k, lt in last_access.items()
                      if t - lt <= reuse_interval]
            key = (recent[int(rng.random() * len(recent))]
                   if recent else keys[base + int(rng.random() * width)])
        else:
            key = keys[min(base + int(rng.random() * width),
                           num_objects - 1)]
        op = "put" if (key not in last_access
                       or rng.random() < put_frac) else "get"
        idx = int(key[3:])
        events.append(TraceEvent(float(t), op, key, int(sizes[idx])))
        last_access[key] = t
    return events


def ibm_registry_trace(*, num_objects: int = 400, num_requests: int = 4000,
                       duration: float = 3600.0, scale_bytes: float = 1.0,
                       seed: int = 0) -> List[TraceEvent]:
    rng = np.random.default_rng(seed)
    ev = _trace(rng, num_objects=num_objects, num_requests=num_requests,
                duration=duration, large_frac=0.31,
                large_threshold=int(10 * 1024 * 1024 * scale_bytes),
                reuse_interval=600.0, reuse_frac=0.8, wss_epochs=12,
                put_frac=0.05, cov=4.0)
    return ev


def azure_blob_trace(*, num_objects: int = 300, num_requests: int = 5000,
                     duration: float = 1800.0, scale_bytes: float = 1.0,
                     seed: int = 1) -> List[TraceEvent]:
    rng = np.random.default_rng(seed)
    ev = _trace(rng, num_objects=num_objects, num_requests=num_requests,
                duration=duration, large_frac=0.45,
                large_threshold=int(10 * 1024 * 1024 * scale_bytes),
                reuse_interval=60.0, reuse_frac=0.98, wss_epochs=20,
                put_frac=0.30, cov=3.0)
    return ev


def trace_stats(events: List[TraceEvent]) -> dict:
    """Reuse-interval and IAT-CoV statistics (validates Fig. 1 shape)."""
    last: dict = {}
    reuse: List[float] = []
    arrivals: dict = {}
    for e in events:
        if e.key in last:
            reuse.append(e.t - last[e.key])
        last[e.key] = e.t
        arrivals.setdefault(e.key, []).append(e.t)
    covs = []
    for ts in arrivals.values():
        if len(ts) >= 10:
            gaps = np.diff(ts)
            m = gaps.mean()
            if m > 0:
                covs.append(gaps.std() / m)
    sizes = np.array([e.size for e in events])
    return {
        "num_events": len(events),
        "reuse_p50": float(np.percentile(reuse, 50)) if reuse else 0.0,
        "reuse_p80": float(np.percentile(reuse, 80)) if reuse else 0.0,
        "cov_median": float(np.median(covs)) if covs else 0.0,
        "frac_cov_gt1": float(np.mean([c > 1 for c in covs])) if covs else 0.0,
        "frac_large": float(np.mean(sizes > 10 * 1024 * 1024)),
    }
