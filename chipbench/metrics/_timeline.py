"""Device idle inside the program's spans: the idle gaps of the traced
window (`tracing.Trace.gaps`, us on the profiler's clock) that lie
inside the intervals of one span site of the store's plane
(`ObsPlane.timeline`, Unix ns: the clock the profiler stamps its host
and device events with), over the traced window, in %. The denominator
is `device.idle_pct.store`'s, so the two read on one scale.

A plane keeps its timelines in the process that made it: the store's
daemon thread records into the same plane as the benchmark's thread. A
program without timelines (an earlier commit) reads None."""
from __future__ import annotations

from typing import List, Sequence, Tuple


def merged(intervals) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals, sorted and disjoint."""
    out: List[List[float]] = []
    for s, e in sorted((float(s), float(e)) for s, e in intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap(gaps: Sequence[Tuple[float, float]],
            spans: Sequence[Tuple[float, float]]) -> float:
    """Total length of sorted, disjoint `gaps` that lies inside sorted,
    disjoint `spans`."""
    total, j = 0.0, 0
    for s, e in gaps:
        while j < len(spans) and spans[j][1] <= s:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < e:
            total += min(e, spans[k][1]) - max(s, spans[k][0])
            k += 1
    return total


def idle_in_pct(run, site: str):
    p = run.profile
    timeline = getattr(run.log.get("obs"), "timeline", None)
    if p is None or not p.device or p.window_s <= 0 or timeline is None:
        return None
    rows = timeline(site)
    if len(rows) == 0:
        return None
    spans = merged((s / 1e3, e / 1e3) for s, e in rows.tolist())
    return 100.0 * overlap(p.gaps(), spans) * 1e-6 / p.window_s
