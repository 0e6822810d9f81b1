"""Pay-per-access cost accounting (paper §3.1, §6.1.1, Figs. 10/11/22).

There is no per-invocation bill on a TPU pod, but the paper's cost model
is kept as an accounting model so the cost experiments reproduce: slab
invocations + busy GB-seconds map to Lambda pricing, COS ops/storage map
to S3 pricing. Categories follow Fig. 10: request (GET/PUT service),
warmup, recovery, COS.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

# AWS prices used by the paper (us-east-1, 2022)
LAMBDA_GBS = 0.0000166667          # $ per GB-second
LAMBDA_INVOKE = 0.02 / 1e6         # $ per invocation
S3_PUT = 0.005 / 1e3               # $ per PUT
S3_GET = 0.0004 / 1e3              # $ per GET
S3_GB_MONTH = 0.023                # $ per GB-month
SECONDS_PER_MONTH = 30 * 24 * 3600


@dataclass
class CostLedger:
    """Accumulates billable events by category."""
    gb_seconds: Dict[str, float] = field(
        default_factory=lambda: {"request": 0.0, "warmup": 0.0,
                                 "recovery": 0.0})
    invocations: Dict[str, int] = field(
        default_factory=lambda: {"request": 0, "warmup": 0, "recovery": 0})
    cos_puts: int = 0
    cos_gets: int = 0
    cos_gb_seconds: float = 0.0    # integrated storage (GB * seconds)
    _hourly: List[Dict[str, float]] = field(default_factory=list)

    # ---- event hooks ------------------------------------------------------

    def invoke(self, category: str, *, gb: float, seconds: float) -> None:
        self.invocations[category] = self.invocations.get(category, 0) + 1
        self.gb_seconds[category] = (self.gb_seconds.get(category, 0.0)
                                     + gb * seconds)

    def cos_op(self, op: str, n: int = 1) -> None:
        if op == "put":
            self.cos_puts += n
        else:
            self.cos_gets += n

    def cos_storage(self, gb: float, seconds: float) -> None:
        self.cos_gb_seconds += gb * seconds

    # ---- dollars ------------------------------------------------------------

    def dollars(self) -> Dict[str, float]:
        out = {}
        for cat in self.gb_seconds:
            out[cat] = (self.gb_seconds[cat] * LAMBDA_GBS
                        + self.invocations.get(cat, 0) * LAMBDA_INVOKE)
        out["cos"] = (self.cos_puts * S3_PUT + self.cos_gets * S3_GET
                      + self.cos_gb_seconds / SECONDS_PER_MONTH * S3_GB_MONTH)
        out["total"] = sum(out.values())
        return out

    def pay_per_access_overhead(self) -> float:
        """Paper's metric: (recovery + warmup) / (request + COS) — the cost
        of durability maintenance relative to access+storage cost
        (26.00% for InfiniStore vs 106.51% for InfiniCache)."""
        d = self.dollars()
        denom = d["request"] + d["cos"]
        if denom <= 0:
            return 0.0
        return (d["recovery"] + d["warmup"]) / denom

    def checkpoint_hour(self) -> None:
        self._hourly.append(self.dollars())

    @property
    def hourly(self) -> List[Dict[str, float]]:
        return list(self._hourly)


def elasticache_cost(instance_hourly: float, n_instances: int,
                     hours: float) -> float:
    """Statically-provisioned baseline cost (Fig. 11)."""
    return instance_hourly * n_instances * hours


# Paper's comparison clusters (§6.1.1)
ELASTICACHE_R6G_2XLARGE_HOURLY = 0.821   # cache.r6g.2xlarge
ELASTICACHE_M6G_LARGE_HOURLY = 0.147     # cache.m6g.large
