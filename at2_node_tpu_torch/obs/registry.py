"""Latency histograms for the verifier's pipeline stages.

Counterpart of the ``Histogram`` of ``at2_node_tpu/obs/registry.py``
(stdlib only). Safe to observe from asyncio callbacks and from the
verifier's stage threads: every mutation takes the instrument's own lock.
"""

from __future__ import annotations

import math
import threading
from typing import Sequence

# Default ladder: geometric, 100us .. ~210s in x2 steps (22 buckets + 1
# overflow), from sub-millisecond stages to multi-second stalls.
DEFAULT_BOUNDS: tuple[float, ...] = tuple(1e-4 * 2.0**i for i in range(22))


class Histogram:
    """Log-bucketed latency histogram (values in SECONDS).

    count/sum/max are exact; percentiles are estimated as the upper
    bound of the bucket holding the target rank (clamped to the observed
    max), which for a ×2 ladder bounds the error at 2× — plenty to tell
    "100µs stage" from "10ms stage", which is what the operator view
    needs. The verifier owns its stage histograms directly.
    """

    __slots__ = ("name", "help", "bounds", "_lock", "_counts", "_sum",
                 "_count", "_max")

    def __init__(
        self,
        name: str,
        help: str = "",
        bounds: Sequence[float] | None = None,
    ) -> None:
        self.name = name
        self.help = help
        b = tuple(bounds) if bounds is not None else DEFAULT_BOUNDS
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(f"histogram {name}: bounds must be increasing")
        self.bounds = b
        self._lock = threading.Lock()
        self._counts = [0] * (len(b) + 1)  # last = overflow (+Inf)
        self._sum = 0.0
        self._count = 0
        self._max = 0.0

    def observe(self, value: float) -> None:
        if value < 0 or math.isnan(value):
            return  # clock skew / bad input: never poison the histogram
        # bisect without importing: bounds are tiny (22), linear is fine
        # and avoids holding the lock during a function call
        idx = 0
        for bound in self.bounds:
            if value <= bound:
                break
            idx += 1
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1
            if value > self._max:
                self._max = value

    def _percentile_locked(self, q: float) -> float:
        """Caller holds the lock. Linear interpolation inside the bucket
        holding the target rank (Prometheus histogram_quantile's model),
        capped at the exact observed max — so p50 and p99 stay distinct
        even when they land in the same ×2 bucket."""
        if self._count == 0:
            return 0.0
        rank = q * self._count
        cum = 0
        for i, c in enumerate(self._counts):
            prev_cum = cum
            cum += c
            if cum >= rank and c:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self._max if i >= len(self.bounds) else min(
                    self.bounds[i], self._max
                )
                if hi <= lo:
                    return hi
                return lo + (hi - lo) * ((rank - prev_cum) / c)
        return self._max

    def snapshot(self) -> dict:
        """Exact count/sum/max + estimated percentiles, in milliseconds
        (the unit every stats() dict in this repo already reports)."""
        with self._lock:
            return {
                "count": self._count,
                "sum_ms": round(self._sum * 1e3, 3),
                "max_ms": round(self._max * 1e3, 3),
                "p50_ms": round(self._percentile_locked(0.50) * 1e3, 3),
                "p90_ms": round(self._percentile_locked(0.90) * 1e3, 3),
                "p99_ms": round(self._percentile_locked(0.99) * 1e3, 3),
            }

    def flat(self, prefix: str) -> dict:
        """snapshot() splayed into ``{prefix}_{key}`` form for merging
        into flat stats dicts (snapshot_stats, verifier.stats)."""
        return {f"{prefix}_{k}": v for k, v in self.snapshot().items()}
