"""The traced run's reduction: device busy time, idle gaps and kernel
times from one `torch.profiler` window.

A `Trace` wraps the profiler around the measured window. Its events are
read once at the end into plain lists: device intervals (kernels,
copies, sets) and host intervals (operators and the benchmark's own
ranges). Busy time is the union of the device intervals; an idle gap is
a stretch between them, named by the innermost host interval that holds
its middle.
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Tuple

import torch

SHORT_GAP_S = 100e-6             # idle gaps below this are summed together


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def short_name(name: str, limit: int = 96) -> str:
    """A kernel's name without its return type and argument list."""
    base = name.replace("(anonymous namespace)::", "").split("(")[0]
    if base.startswith("void "):
        base = base[5:]
    return base.strip()[:limit] or name[:limit]


class Trace:
    def __init__(self):
        self._prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        self.device: List[Tuple[str, float, float]] = []   # name, start, end (us)
        self.host: List[Tuple[float, float, str]] = []     # start, end, name
        self.window_s = 0.0
        self.read_s = 0.0
        self.active = False

    def __enter__(self) -> "Trace":
        _sync()
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        self.active = True
        return self

    def __exit__(self, *exc) -> None:
        _sync()
        self.active = False
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        t = time.perf_counter()
        cuda = torch.autograd.DeviceType.CUDA
        # the raw events, not `events()`: that builds a Python object per
        # event, minutes for the million a serving window records
        for e in self._prof.profiler.kineto_results.events():
            s = e.start_ns() / 1e3
            end = s + e.duration_ns() / 1e3
            if e.device_type() == cuda:
                self.device.append((e.name(), s, end))
            else:
                self.host.append((s, end, e.name()))
        self.device.sort(key=lambda d: d[1])
        self.host.sort()
        self.read_s = time.perf_counter() - t

    # ---- reductions -------------------------------------------------------

    def kernels(self, *patterns: str) -> List[Tuple[str, float]]:
        """(name, seconds) of every device operation whose name holds one
        of `patterns`, in time order."""
        return [(n, (e - s) * 1e-6) for n, s, e in self.device
                if any(p in n for p in patterns)]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for _, s, e in self.device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def span_us(self) -> Tuple[float, float]:
        """First and last instant the trace saw, host or device."""
        starts = [d[1] for d in self.device[:1]] + [h[0] for h in self.host[:1]]
        ends = [max((d[2] for d in self.device), default=0.0),
                max((h[1] for h in self.host), default=0.0)]
        return min(starts), max(ends)

    def gaps(self) -> List[Tuple[float, float]]:
        """Idle stretches of the device inside the traced span (us)."""
        if not self.device:
            return []
        lo, hi = self.span_us()
        out, t = [], lo
        for s, e in self.busy_intervals():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if hi > t:
            out.append((t, hi))
        return out

    def host_at(self, t: float) -> str:
        """The innermost host interval that holds instant `t`; where none
        does, the host ran Python, named by the operation it ended last."""
        i = bisect.bisect_right(self.host, (t, float("inf"), ""))
        best: Optional[Tuple[float, float, str]] = None
        last: Optional[Tuple[float, float, str]] = None
        for s, e, n in reversed(self.host[max(0, i - 256):i]):
            if e >= t and (best is None or e - s < best[1] - best[0]):
                best = (s, e, n)
            elif e < t and (last is None or e > last[1]):
                last = (s, e, n)
        if best is not None:
            return best[2]
        return f"host Python after {last[2]}" if last else "host Python"

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the longest
        idle gaps by what the host was doing (the last entry sums the
        gaps shorter than SHORT_GAP_S)."""
        per: Dict[str, float] = {}
        for n, s, e in self.device:
            k = short_name(n)
            per[k] = per.get(k, 0.0) + (e - s) * 1e-6
        ops = sorted(per.items(), key=lambda kv: -kv[1])[:top]
        gaps = self.gaps()
        short = [(e - s) * 1e-6 for s, e in gaps if (e - s) * 1e-6 < SHORT_GAP_S]
        longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top - 1]
        idle = [[self.host_at((s + e) / 2), (e - s) * 1e-6]
                for s, e in longest]
        if short:
            idle.append([f"{len(short)} gaps under {SHORT_GAP_S * 1e6:.0f} us",
                         sum(short)])
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": idle}
