"""Sequential-scan detection + readahead accounting for the GET pipeline.

Checkpoint shard restore (`ckpt/<step>/<leaf>/s0, s1, ...`) and KV page
restore (`kv/<seq>/p0, p1, ...`) both issue ordered `get_many_arrays`
batches — exactly the access pattern a serverless cache can get ahead
of (Faa$T-style prefetching, PAPERS.md). This module is the policy half:
it watches the object-key stream, detects per-stem runs of consecutive
trailing indices, and predicts the next `depth` keys once a run reaches
`min_run`. The mechanics half lives in `InfiniStore`: predicted objects'
non-resident chunks are fetched from COS on the GET I/O executor and
warmed into bucket cache space (`Slab.cache_put`) while decode of the
current batch is still running.

A key that breaks its stem's sequence cancels the run immediately
(random access must not keep speculating), and every warmed chunk is
accounted: consumed by a later GET -> `hits`; dropped by a cancelled
run, a failed fetch, or the outstanding-cap prune -> `wasted`.
"""
from __future__ import annotations

import re
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# trailing decimal index: "ckpt/8/w/s12" -> ("ckpt/8/w/s", 12, width 2)
_TRAILING_IDX = re.compile(r"^(?P<stem>.*?)(?P<idx>\d+)$")


@dataclass(frozen=True)
class PrefetchConfig:
    enabled: bool = True
    min_run: int = 3        # consecutive keys before a stem is "sequential"
    depth: int = 2          # objects predicted ahead of the scan head
    max_stems: int = 32     # LRU bound on tracked stems
    max_outstanding: int = 256   # warmed-but-unconsumed chunk cap


@dataclass
class PrefetchStats:
    runs_detected: int = 0
    runs_cancelled: int = 0
    predicted: int = 0      # object keys predicted
    issued: int = 0         # chunk warms issued by the store
    hits: int = 0           # warmed chunks later consumed by a GET
    wasted: int = 0         # warmed chunks dropped unconsumed


@dataclass
class _Run:
    last_idx: int
    length: int = 1
    width: int = 0          # zero-padding width of the index ("s007" -> 3)


def split_key(key: str) -> Optional[Tuple[str, int, int]]:
    """(stem, index, pad-width) for keys ending in a decimal index."""
    m = _TRAILING_IDX.match(key)
    if m is None:
        return None
    digits = m.group("idx")
    width = len(digits) if digits.startswith("0") and len(digits) > 1 else 0
    return m.group("stem"), int(digits), width


class SequentialPrefetcher:
    """Per-stem run tracking + warmed-chunk accounting.

    NOT thread-safe by design: the store calls it only from its
    client-daemon thread (the I/O executor touches futures, never this).
    """

    def __init__(self, cfg: PrefetchConfig = PrefetchConfig()):
        self.cfg = cfg
        self.stats = PrefetchStats()
        self._runs: "OrderedDict[str, _Run]" = OrderedDict()
        # warmed, not-yet-consumed chunk keys -> owning stem (insertion
        # order doubles as the prune order)
        self._outstanding: "OrderedDict[str, str]" = OrderedDict()
        # chunk keys dropped by run cancellation / pruning since the last
        # take_dropped() — the store cancels their in-flight fetches
        self._dropped: List[str] = []

    # ---- detection ---------------------------------------------------------

    def observe(self, keys) -> List[Tuple[str, str]]:
        """Feed the next GET's object keys (in request order). Returns
        [(predicted_key, stem)] for every run at/over min_run — the keys
        the store should warm next."""
        if not self.cfg.enabled:
            return []
        predicted: List[Tuple[str, str]] = []
        seen: Dict[str, None] = {}
        for key in keys:
            parts = split_key(key)
            if parts is None:
                continue
            stem, idx, width = parts
            run = self._runs.get(stem)
            if run is not None and idx == run.last_idx + 1:
                run.last_idx = idx
                run.length += 1
                run.width = max(run.width, width)
                if run.length == self.cfg.min_run:
                    self.stats.runs_detected += 1
            elif run is not None and idx == run.last_idx:
                pass                           # re-read of the head: keep
            else:
                if run is not None:
                    self._cancel(stem, run)
                self._runs[stem] = run = _Run(last_idx=idx, width=width)
            self._runs.move_to_end(stem)
            if run.length >= self.cfg.min_run:
                for d in range(1, self.cfg.depth + 1):
                    nxt = self._format(stem, run.last_idx + d, run.width)
                    if nxt not in seen:
                        seen[nxt] = None
                        predicted.append((nxt, stem))
        while len(self._runs) > self.cfg.max_stems:
            stem, run = self._runs.popitem(last=False)
            self._cancel(stem, run, evicted=True)
        self.stats.predicted += len(predicted)
        return predicted

    @staticmethod
    def _format(stem: str, idx: int, width: int) -> str:
        return f"{stem}{idx:0{width}d}" if width else f"{stem}{idx}"

    def _cancel(self, stem: str, run: _Run, *, evicted: bool = False) -> None:
        """Run broken (random access) or evicted: its unconsumed warmed
        chunks are wasted speculation."""
        if run.length >= self.cfg.min_run and not evicted:
            self.stats.runs_cancelled += 1
        stale = [ck for ck, s in self._outstanding.items() if s == stem]
        for ck in stale:
            del self._outstanding[ck]
        self._dropped.extend(stale)
        self.stats.wasted += len(stale)

    def take_dropped(self) -> List[str]:
        """Chunk keys whose warms were abandoned since the last call —
        the store should cancel their queued fetches so stale
        speculation never delays demand reads."""
        out, self._dropped = self._dropped, []
        return out

    # ---- warmed-chunk accounting ------------------------------------------

    def record_issued(self, ckey: str, stem: str) -> None:
        """The store issued a warm fetch for chunk `ckey` of a predicted
        object belonging to `stem`."""
        self._outstanding[ckey] = stem
        self._outstanding.move_to_end(ckey)
        self.stats.issued += 1
        while len(self._outstanding) > self.cfg.max_outstanding:
            old, _ = self._outstanding.popitem(last=False)
            self._dropped.append(old)
            self.stats.wasted += 1

    def consume(self, ckey: str) -> bool:
        """A GET read chunk `ckey`; True (and a hit) iff it was warmed by
        prefetch and not consumed before."""
        if self._outstanding.pop(ckey, None) is None:
            return False
        self.stats.hits += 1
        return True

    def discard(self, ckey: str) -> None:
        """Warm fetch came back empty / got dropped: wasted speculation."""
        if self._outstanding.pop(ckey, None) is not None:
            self.stats.wasted += 1

    @property
    def outstanding(self) -> int:
        return len(self._outstanding)

    def snapshot(self) -> Dict[str, int]:
        return {"runs_detected": self.stats.runs_detected,
                "runs_cancelled": self.stats.runs_cancelled,
                "predicted": self.stats.predicted,
                "issued": self.stats.issued,
                "hits": self.stats.hits,
                "wasted": self.stats.wasted,
                "outstanding": self.outstanding}
