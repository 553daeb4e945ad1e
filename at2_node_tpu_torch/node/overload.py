"""Closed-loop overload control: pressure sensing + admission shedding.

Counterpart of ``at2_node_tpu/node/overload.py``.

Every overload signal this fleet produces already existed — the verifier
exports queue depth and queue-wait histograms, the broadcast plane
exports undelivered-slot backlog, the service knows its commit-tail age,
and obs/slo.py computes multi-window burn rates — but nothing *acted* on
any of it: a flash crowd rode straight into unbounded queueing and a
collapsed p99 for every client, well-behaved or not. This module closes
the loop, the way Chop Chop's broker tier sustains network-limit load
only because ingress sheds adaptively (arXiv:2304.07081 §5).

The controller is a pure sampler + ladder, deliberately free of timers
and RNG so it is safe on the deterministic simulator: callers feed it
``clock.monotonic()`` at ingress, it re-samples at most every
``sample_interval`` seconds, and fractional shedding uses an error
accumulator instead of random draws — (seed, config, events) still fully
determine the wire trace.

Design:

* **Pressure** is the worst of five normalized signals — verifier queue
  occupancy, verifier sojourn (windowed mean queue-wait vs a CoDel-style
  target), plane backlog, commit-tail age, and SLO fast-window burn —
  folded through an EWMA so one deep batch doesn't flap the ladder.
  The sojourn signal is additionally *armed*: it must stay above target
  for ``sojourn_arm_s`` continuous seconds before it counts, and
  disarms below half the target (CoDel's interval/hysteresis shape).
* **Shedding** ramps linearly from ``shed_start`` to ``shed_full``
  pressure. Senders already in the gossiped client directory get
  ``registered_grace`` extra headroom — the crowd is, almost by
  definition, the senders the fleet has never seen. Newest-first is
  inherent: shedding happens at admission, so queued work already
  accepted is never discarded.
* **Protocol traffic is exempt.** Echo/Ready attestations, catchup
  sessions and audit beacons ride the inter-node mesh, not client
  ingress — they are the machinery that *drains* the backlog, so
  shedding them would turn overload into livelock. Only SendAsset /
  SendAssetBatch / SendDistilledBatch entries are ever shed.
* **Shed responses are typed.** Every shed aborts RESOURCE_EXHAUSTED
  with a machine-parseable ``retry_after_ms=N`` detail that client.py's
  RetryPolicy honors with jittered exponential backoff, so retries
  cannot become their own flash crowd.

Sheds are accounted separately from signature rejections
(``rejected_at_ingress``) and never charge a sender's admission fail
bucket: an overloaded node refusing valid work is the *node's* state,
not evidence against the sender.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Optional

from .config import OverloadConfig

#: a single pathological signal saturates at 2x full scale — pressure is
#: a control input, not an unbounded gauge
SIGNAL_CAP = 2.0

#: pressure thresholds are expressed relative to the shed ramp; the
#: "elevated" grade (surfaced, not yet shedding) starts at this fraction
#: of shed_start
ELEVATED_FRAC = 0.75

LEVELS = ("normal", "elevated", "shedding", "saturated")

_RETRY_RE = re.compile(r"retry_after_ms=(\d+)")


def format_shed_details(message: str, retry_after_ms: int) -> str:
    """The typed shed/refusal detail string: human text first, then the
    machine hint — parseable from grpc.aio error details and from the
    sim's SimRpcError alike."""
    return f"{message}; retry_after_ms={int(retry_after_ms)}"


def parse_retry_after_ms(details: Optional[str]) -> Optional[int]:
    """Extract the ``retry_after_ms=N`` hint from an error detail string,
    or None when the error carries no hint."""
    if not details:
        return None
    m = _RETRY_RE.search(details)
    return int(m.group(1)) if m else None


def clamp(x: float, lo: float, hi: float) -> float:
    return lo if x < lo else hi if x > hi else x


class OverloadController:
    """Samples pressure signals and decides, deterministically, which
    ingress work to shed. One instance per Service (node-side); the
    broker reuses only the config ladder + detail formatting.

    The signal sources are zero-arg callables so the controller stays
    decoupled from Service internals (and trivially testable): each may
    return None when its subsystem isn't running yet.

    ``verifier_stats``  -> dict with ``queue_depth`` (int), optional.
    ``stage_hists``     -> dict of stage histogram snapshots; the
                           ``queue_wait`` entry's cumulative count/sum_ms
                           are differenced into a windowed mean sojourn.
    ``backlog``         -> undelivered broadcast-slot count.
    ``tail_age``        -> age (s) of the oldest pending payload.
    ``burns``           -> {objective: fast-window burn} from SloEngine.
    """

    def __init__(
        self,
        cfg: OverloadConfig,
        clock,
        *,
        verifier_stats: Optional[Callable[[], Optional[dict]]] = None,
        stage_hists: Optional[Callable[[], Optional[dict]]] = None,
        backlog: Optional[Callable[[], Optional[float]]] = None,
        tail_age: Optional[Callable[[], Optional[float]]] = None,
        burns: Optional[Callable[[], Optional[Dict[str, float]]]] = None,
        on_transition: Optional[Callable[[str, str, float], None]] = None,
    ) -> None:
        self.cfg = cfg
        self.clock = clock
        self._verifier_stats = verifier_stats
        self._stage_hists = stage_hists
        self._backlog = backlog
        self._tail_age = tail_age
        self._burns = burns
        self._on_transition = on_transition

        self.pressure = 0.0
        self.level = 0
        self.samples = 0
        self._last_sample: Optional[float] = None
        self._signals: Dict[str, float] = {}
        # sojourn windowing + CoDel arming state
        self._qw_snap: Optional[tuple] = None  # (count, sum_ms)
        self._sojourn_ms = 0.0
        self._over_since: Optional[float] = None
        self.armed = False
        # drain detection: pressure signals saturate identically while a
        # standing queue builds and while it drains, but only the former
        # justifies shedding the registered tier (their marginal load is
        # not what built the queue)
        self._last_depth = 0.0
        self.draining = False
        # deterministic fractional shedding: per-class error accumulators
        self._debt = {"registered": 0.0, "new": 0.0}

    # -- sampling ---------------------------------------------------------

    def maybe_sample(self, now: Optional[float] = None) -> None:
        """Re-sample at most every ``sample_interval`` seconds. Cheap to
        call on every ingress request; a no-op while disabled."""
        if not self.cfg.enabled:
            return
        if now is None:
            now = self.clock.monotonic()
        if (
            self._last_sample is not None
            and now - self._last_sample < self.cfg.sample_interval
        ):
            return
        self.sample(now)

    def sample(self, now: float) -> float:
        """Take one pressure sample and fold it into the EWMA score."""
        cfg = self.cfg
        sig: Dict[str, float] = {}

        stats = self._verifier_stats() if self._verifier_stats else None
        depth = float((stats or {}).get("queue_depth", 0) or 0)
        sig["occupancy"] = clamp(depth / cfg.queue_target, 0.0, SIGNAL_CAP)
        self.draining = depth < self._last_depth or depth == 0.0
        self._last_depth = depth

        sig["sojourn"] = self._sample_sojourn(now, depth)

        backlog = self._backlog() if self._backlog else None
        sig["backlog"] = clamp(
            float(backlog or 0.0) / cfg.backlog_target, 0.0, SIGNAL_CAP
        )

        tail = self._tail_age() if self._tail_age else None
        sig["tail"] = clamp(
            float(tail or 0.0) / cfg.tail_target_s, 0.0, SIGNAL_CAP
        )

        burns = self._burns() if self._burns else None
        worst_burn = max(burns.values(), default=0.0) if burns else 0.0
        # burn 1.0 = exactly consuming the error budget; treat that as
        # full-scale pressure from the SLO signal
        sig["burn"] = clamp(worst_burn, 0.0, SIGNAL_CAP)

        raw = max(sig.values())
        # fast attack, slow release: rising load must register within a
        # sample or two, but a momentary dip (the queue between retry
        # waves) must not re-open admission while the backlog's
        # downstream work is still in flight — a quarter-rate release
        # makes re-admission wait for sustained calm, not one quiet tick
        a = cfg.smoothing if raw >= self.pressure else cfg.smoothing * 0.25
        self.pressure = a * raw + (1.0 - a) * self.pressure
        self._signals = sig
        self._last_sample = now
        self.samples += 1
        self._set_level(self._level_for(self.pressure))
        return self.pressure

    def _sample_sojourn(self, now: float, depth: float = 0.0) -> float:
        """Windowed mean verifier queue-wait vs the sojourn target, gated
        by CoDel-style arming: above target for ``sojourn_arm_s``
        continuous seconds arms the signal; below half the target
        disarms and resets."""
        cfg = self.cfg
        hists = self._stage_hists() if self._stage_hists else None
        qw = (hists or {}).get("queue_wait")
        if not qw:
            return 0.0
        count = float(qw.get("count", 0) or 0)
        sum_ms = float(qw.get("sum_ms", 0.0) or 0.0)
        if self._qw_snap is None:
            self._qw_snap = (count, sum_ms)
            return 0.0
        d_count = count - self._qw_snap[0]
        d_sum = sum_ms - self._qw_snap[1]
        self._qw_snap = (count, sum_ms)
        if d_count > 0:
            self._sojourn_ms = d_sum / d_count
        elif depth <= 0.0:
            # no completions AND nothing queued: the stale high reading
            # would otherwise hold the signal armed forever after a
            # drain — an empty queue is zero sojourn by definition
            self._sojourn_ms = 0.0
            self._over_since = None
            self.armed = False
            return 0.0
        # no completions with a standing queue: no fresh evidence either
        # way; keep the last reading
        over = self._sojourn_ms > cfg.sojourn_target_ms
        if over:
            if self._over_since is None:
                self._over_since = now
            if now - self._over_since >= cfg.sojourn_arm_s:
                self.armed = True
        else:
            self._over_since = None
            if self._sojourn_ms < cfg.sojourn_target_ms * 0.5:
                self.armed = False
        if not self.armed:
            return 0.0
        return clamp(
            self._sojourn_ms / cfg.sojourn_target_ms, 0.0, SIGNAL_CAP
        )

    def _level_for(self, p: float) -> int:
        cfg = self.cfg
        if p >= cfg.shed_full:
            return 3
        if p >= cfg.shed_start:
            return 2
        if p >= cfg.shed_start * ELEVATED_FRAC:
            return 1
        return 0

    def _set_level(self, level: int) -> None:
        if level == self.level:
            return
        old, self.level = self.level, level
        if self._on_transition is not None:
            self._on_transition(LEVELS[old], LEVELS[level], self.pressure)

    # -- the shed decision ------------------------------------------------

    def shed_fraction(self, *, registered: bool) -> float:
        """The fraction of this class's traffic the current pressure
        says to shed. Linear ramp over [shed_start, shed_full];
        directory-registered senders start their ramp
        ``registered_grace`` later AND are exempt unless the verifier
        queue itself is both past target and growing — a falling or
        sub-target queue means the fleet absorbs their marginal load,
        and the saturated pressure score is the ghost of a burst the
        newcomer tier caused (shedding the steady tier then would
        trade fairness for nothing). Strict priority, in other words:
        newcomers shed to extinction before the registered ramp ever
        engages."""
        cfg = self.cfg
        if registered and (
            self.draining or self._signals.get("occupancy", 0.0) < 1.0
        ):
            return 0.0
        start = cfg.shed_start + (cfg.registered_grace if registered else 0.0)
        span = cfg.shed_full - cfg.shed_start
        return clamp((self.pressure - start) / span, 0.0, 1.0)

    def admit(
        self, *, registered: bool, now: Optional[float] = None
    ) -> Optional[int]:
        """One admission decision. Returns None to admit, or the
        ``retry_after_ms`` hint when the unit of work should be shed.
        Deterministic: a per-class error accumulator turns the shed
        fraction into an exact long-run rate with no RNG."""
        if not self.cfg.enabled:
            return None
        self.maybe_sample(now)
        frac = self.shed_fraction(registered=registered)
        if frac <= 0.0:
            return None
        key = "registered" if registered else "new"
        self._debt[key] += frac
        if self._debt[key] < 1.0:
            return None
        self._debt[key] -= 1.0
        return self.retry_after_ms(registered=registered)

    def retry_after_ms(self, *, registered: bool = False) -> int:
        """Back-off hint scaled with pressure beyond the shed ramp's
        start — deeper overload, longer hold-off. A registered sender's
        shed is a transient growth-window event, so its hint stays at
        the base: it should come right back and land in the next drain
        window, not queue up behind the crowd's long hold-offs."""
        cfg = self.cfg
        if registered:
            return int(cfg.retry_after_ms)
        over = max(0.0, self.pressure - cfg.shed_start)
        ms = cfg.retry_after_ms * (1.0 + 4.0 * over)
        return int(clamp(ms, cfg.retry_after_ms, cfg.retry_after_max_ms))

    # -- surfaces ---------------------------------------------------------

    @property
    def overloaded(self) -> bool:
        """True while the controller is actively shedding — the
        'overloaded' (still serving, non-503) health grade."""
        return self.cfg.enabled and self.level >= 2

    def snapshot(self) -> dict:
        """The /statusz ``pressure`` block."""
        return {
            "enabled": self.cfg.enabled,
            "pressure": round(self.pressure, 4),
            "level": LEVELS[self.level],
            "armed": self.armed,
            "draining": self.draining,
            "sojourn_ms": round(self._sojourn_ms, 3),
            "signals": {k: round(v, 4) for k, v in self._signals.items()},
            "shed_fraction": {
                "registered": round(self.shed_fraction(registered=True), 4),
                "new": round(self.shed_fraction(registered=False), 4),
            },
            "retry_after_ms": self.retry_after_ms(),
            "samples": self.samples,
        }


def broker_retry_after_ms(cfg: OverloadConfig, ratio: float) -> int:
    """The broker's retry-after hint from its buffer-fill ratio — same
    shape as the node ladder (deeper fill, longer hold-off) without
    needing a sampled pressure score."""
    ms = cfg.retry_after_ms * (1.0 + 4.0 * clamp(ratio, 0.0, 1.0))
    return int(clamp(ms, cfg.retry_after_ms, cfg.retry_after_max_ms))


__all__ = [
    "LEVELS",
    "OverloadController",
    "broker_retry_after_ms",
    "format_shed_details",
    "parse_retry_after_ms",
]
