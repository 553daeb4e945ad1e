"""Declarative SLOs evaluated with multi-window burn rates.

Counterpart of ``at2_node_tpu/obs/slo.py``.

An *objective* is a machine-checkable service-level target over the
signals the obs stack already exports — commit-latency p99 ceiling,
committed-throughput floor, ingress rejection-rate ceiling, and a
quorum-stall budget. The :class:`SloEngine` turns a stream of periodic
*probe samples* (cumulative counters + the ingress→commit histogram's
cumulative buckets + a stall flag, all read from the node's
``Registry``/``TxTrace``) into burn-rate verdicts served at
``GET /sloz`` and folded into ``/healthz``.

Burn rate is the SRE book's alerting currency: ``burn = observed /
target`` (for ceilings) or ``target / observed`` (for floors), so
``burn > 1`` means the objective is being violated *at the current
rate*. One window is not a verdict — a single slow transaction spikes a
short window, a long window hides an outage for minutes — so every
objective is evaluated over TWO windows (fast + slow) and only flags
**breaching** when BOTH burn above 1.0. That multi-window AND is the
flap suppressor: transient spikes clear the fast window before the slow
window ever burns, and long-degraded states trip both.

Windowed values come from *deltas between samples*, never from
lifetime aggregates: throughput is Δcommitted/Δt, the rejection ratio
is Δrejected/(Δrejected+Δcommitted), and the windowed p99 is recovered
from the histogram's cumulative bucket counts by differencing the
oldest and newest sample in the window (the standard
``histogram_quantile(rate(...))`` construction, done locally). A window
with fewer than two samples reports ``no_data`` and can never breach —
a node that just booted is not in violation of anything.

Offline evaluation: :func:`evaluate_point` applies the same objectives
to a single aggregate measurement dict (throughput / p99 / rejection
ratio / stall fraction), which is how the scenario grid
(tools/scenario_grid.py) and banked bench JSON get re-checked without a
live engine. Everything here is pure, stdlib-only, and clock-injected,
so the verdict math is unit-testable to the edge cases.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

__all__ = [
    "Objective",
    "SloEngine",
    "evaluate_point",
    "default_objectives",
]

# A burn that would be infinite (activity with zero progress) is capped
# to stay JSON-serializable; anything at the cap reads as "maximally
# burning", which is all an alert needs to know.
BURN_CAP = 1e6

# Rejection-ratio windows need a minimum number of admission outcomes
# before the ratio means anything: 1 reject out of 1 attempt is not a
# 100%-rejection incident, it is one unlucky request.
MIN_RATIO_EVENTS = 16

KINDS = (
    "latency_p99",  # windowed ingress→commit p99 <= target (ms)
    "throughput_floor",  # windowed committed tx/s >= target
    "rejection_ratio",  # windowed rejected/(rejected+committed) <= target
    "stall_budget",  # fraction of window commit-stalled <= target
)


@dataclass(frozen=True)
class Objective:
    """One declarative target. ``target`` units depend on ``kind``:
    milliseconds for latency_p99, tx/s for throughput_floor, a [0,1]
    ratio for rejection_ratio and stall_budget."""

    name: str
    kind: str
    target: float

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown objective kind {self.kind!r}")
        if self.target <= 0:
            raise ValueError(f"objective {self.name}: target must be > 0")


def default_objectives(
    *,
    latency_p99_ms: float = 2000.0,
    throughput_floor_tps: float = 0.0,
    rejection_ratio_max: float = 0.95,
    stall_budget: float = 0.5,
) -> List[Objective]:
    """The node's standing objectives. Defaults are deliberately
    lenient — they catch a node that is *broken* (everything rejected,
    commits stalled for most of a window, multi-second p99), not one
    that is merely slow; operators tighten per deployment via the
    ``[slo]`` config table. A target <= 0 disables that objective."""
    objectives = []
    if latency_p99_ms > 0:
        objectives.append(
            Objective("commit_latency_p99", "latency_p99", latency_p99_ms)
        )
    if throughput_floor_tps > 0:
        objectives.append(
            Objective("throughput_floor", "throughput_floor",
                      throughput_floor_tps)
        )
    if rejection_ratio_max > 0:
        objectives.append(
            Objective("rejection_ratio", "rejection_ratio",
                      rejection_ratio_max)
        )
    if stall_budget > 0:
        objectives.append(
            Objective("stall_budget", "stall_budget", stall_budget)
        )
    return objectives


class _FallbackClock:
    monotonic = staticmethod(time.monotonic)
    wall = staticmethod(time.time)


def _delta_p99_ms(
    old: Optional[Tuple[list, float, int]],
    new: Optional[Tuple[list, float, int]],
) -> Optional[float]:
    """Windowed p99 (ms) from two cumulative bucket snapshots
    (``Histogram.buckets()`` shape: ([(le, cum), ...], sum, count)).
    Returns None when the window saw no completions. The estimate is
    the upper bound of the bucket holding the 99th rank — deterministic
    and conservative; the +Inf bucket reports twice the last finite
    bound (there is no windowed max to clamp against)."""
    if new is None:
        return None
    new_pairs, _, new_count = new
    old_pairs, old_count = ([], 0)
    if old is not None:
        old_pairs, _, old_count = old
    total = new_count - old_count
    if total <= 0:
        return None
    old_cum = {le: cum for le, cum in old_pairs}
    rank = 0.99 * total
    last_finite = 0.0
    for le, cum in new_pairs:
        d = cum - old_cum.get(le, 0)
        if le != le or le == float("inf"):
            # +Inf bucket: everything lands here eventually
            if d >= rank:
                return round((last_finite or 1.0) * 2.0 * 1e3, 6)
            continue
        last_finite = le
        if d >= rank:
            return round(le * 1e3, 6)
    return round((last_finite or 1.0) * 2.0 * 1e3, 6)


def _eval_window(
    objective: Objective, samples: List[dict], window_s: float
) -> dict:
    """One objective over one window's samples (oldest..newest already
    filtered to the window). Returns {window_s, status, value, burn}
    with status in {"no_data", "idle", "ok", "breaching"}."""
    out = {"window_s": window_s, "status": "no_data", "value": None,
           "burn": 0.0}
    if len(samples) < 2:
        return out
    old, new = samples[0], samples[-1]
    span = new["t"] - old["t"]
    if span <= 0:
        return out
    d_committed = new["committed"] - old["committed"]
    d_rejected = new["rejected"] - old["rejected"]

    def verdict(value, burn) -> dict:
        burn = min(max(burn, 0.0), BURN_CAP)
        out["value"] = value
        out["burn"] = round(burn, 6)
        out["status"] = "breaching" if burn > 1.0 else "ok"
        return out

    if objective.kind == "latency_p99":
        p99 = _delta_p99_ms(old.get("latency"), new.get("latency"))
        if p99 is None:
            out["status"] = "idle"
            return out
        return verdict(p99, p99 / objective.target)
    if objective.kind == "throughput_floor":
        active = (
            d_committed > 0 or d_rejected > 0 or new.get("pending", 0) > 0
        )
        if not active:
            # a floor only applies under offered load: an idle node is
            # not violating a throughput objective
            out["status"] = "idle"
            return out
        rate = d_committed / span
        burn = BURN_CAP if rate <= 0 else objective.target / rate
        return verdict(round(rate, 6), burn)
    if objective.kind == "rejection_ratio":
        den = d_committed + d_rejected
        if den < MIN_RATIO_EVENTS:
            out["status"] = "idle"
            return out
        ratio = d_rejected / den
        return verdict(round(ratio, 6), ratio / objective.target)
    if objective.kind == "stall_budget":
        stalled = sum(1 for s in samples if s.get("stalled"))
        frac = stalled / len(samples)
        return verdict(round(frac, 6), frac / objective.target)
    raise AssertionError(f"unreachable kind {objective.kind}")


class SloEngine:
    """Bounded sample store + multi-window evaluation.

    ``observe`` one probe sample per tick (the Service's probe loop, or
    a test driving a fake clock); ``evaluate`` renders the full /sloz
    body; ``breaching`` is the healthz hook — the names of objectives
    burning above 1.0 in EVERY window. Single-threaded by contract
    (event-loop callbacks), like TxTrace."""

    def __init__(
        self,
        objectives: List[Objective],
        windows: Tuple[float, float] = (30.0, 300.0),
        clock=None,
    ) -> None:
        if not windows or any(w <= 0 for w in windows):
            raise ValueError("windows must be positive")
        self.objectives = list(objectives)
        self.windows = tuple(sorted(windows))
        self._clock = clock if clock is not None else _FallbackClock()
        self._samples: deque = deque()

    def observe(self, sample: dict) -> None:
        """Append one probe sample: ``{"t", "committed", "rejected",
        "pending", "stalled", "latency": Histogram.buckets()}``. Samples
        older than the slow window (plus one slot of slack) are pruned,
        so memory is bounded by window span / probe interval."""
        self._samples.append(sample)
        horizon = sample["t"] - self.windows[-1] - 1.0
        while self._samples and self._samples[0]["t"] < horizon:
            self._samples.popleft()

    @property
    def sample_count(self) -> int:
        return len(self._samples)

    def evaluate(self, now: Optional[float] = None) -> dict:
        """The /sloz body: per-objective per-window burn verdicts plus
        the overall breaching list. JSON-safe (no inf/nan)."""
        if now is None:
            now = self._clock.monotonic()
        per_window: Dict[float, List[dict]] = {}
        for w in self.windows:
            cutoff = now - w
            per_window[w] = [s for s in self._samples if s["t"] >= cutoff]
        objectives_out = []
        breaching = []
        for obj in self.objectives:
            windows_out = [
                _eval_window(obj, per_window[w], w) for w in self.windows
            ]
            statuses = [w["status"] for w in windows_out]
            if all(s == "breaching" for s in statuses):
                status = "breaching"
                breaching.append(obj.name)
            elif any(s == "no_data" for s in statuses):
                status = "no_data"
            elif all(s == "idle" for s in statuses):
                status = "idle"
            else:
                status = "ok"
            objectives_out.append(
                {
                    "name": obj.name,
                    "kind": obj.kind,
                    "target": obj.target,
                    "status": status,
                    "windows": windows_out,
                }
            )
        return {
            "windows_s": list(self.windows),
            "samples": len(self._samples),
            "objectives": objectives_out,
            "breaching": breaching,
        }

    def breaching(self, now: Optional[float] = None) -> List[str]:
        return self.evaluate(now)["breaching"]

    def fast_burns(self, now: Optional[float] = None) -> Dict[str, float]:
        """Per-objective burn over the FAST window only, as a flat
        ``{objective_name: burn}`` dict — the scrapeable form of the
        signal /sloz buries in JSON. This is both a /metrics gauge
        provider (Service registers it under ``slo_burn_``) and the
        overload controller's SLO input. Idle/no-data objectives read
        as 0.0 burn: no evidence is not pressure."""
        if now is None:
            now = self._clock.monotonic()
        fast = self.windows[0]
        cutoff = now - fast
        samples = [s for s in self._samples if s["t"] >= cutoff]
        out: Dict[str, float] = {}
        for obj in self.objectives:
            w = _eval_window(obj, samples, fast)
            out[obj.name] = w["burn"] if w["status"] in (
                "ok", "breaching"
            ) else 0.0
        return out


def evaluate_point(objectives: List[Objective], measures: dict) -> dict:
    """Offline single-point evaluation for banked artifacts: apply the
    objectives to one aggregate measurement dict with keys
    ``throughput_tps``, ``latency_p99_ms``, ``rejection_ratio``,
    ``stall_fraction`` (missing keys → that objective is skipped as
    "no_data"). Same burn semantics as the live engine, one window.
    Pure — re-runnable from recorded samples alone."""
    key_for = {
        "latency_p99": "latency_p99_ms",
        "throughput_floor": "throughput_tps",
        "rejection_ratio": "rejection_ratio",
        "stall_budget": "stall_fraction",
    }
    out = []
    breaching = []
    for obj in objectives:
        value = measures.get(key_for[obj.kind])
        if value is None:
            out.append(
                {"name": obj.name, "kind": obj.kind, "target": obj.target,
                 "value": None, "burn": 0.0, "status": "no_data"}
            )
            continue
        if obj.kind == "throughput_floor":
            burn = BURN_CAP if value <= 0 else obj.target / value
        else:
            burn = value / obj.target
        burn = min(max(burn, 0.0), BURN_CAP)
        status = "breaching" if burn > 1.0 else "ok"
        if status == "breaching":
            breaching.append(obj.name)
        out.append(
            {"name": obj.name, "kind": obj.kind, "target": obj.target,
             "value": value, "burn": round(burn, 6), "status": status}
        )
    return {
        "objectives": out,
        "breaching": breaching,
        "ok": not breaching,
    }
