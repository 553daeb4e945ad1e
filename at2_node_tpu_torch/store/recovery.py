"""Recovery state machine + progress surface.

Counterpart of ``at2_node_tpu/store/recovery.py``.

A node restarting from a sharded store walks four states::

    loading_segments -> replaying_wal -> catchup -> live

The first two are local (store/sharded.py ``open``); ``catchup`` is the
existing quorum-confirmed history pull (node/service.py
``_catchup_once``) bringing the node from its checkpoint frontier to
the fleet's live frontier; ``live`` means the last catchup session
found nothing missing (catchup lag zero) — the node is a full quorum
participant again.

:class:`RecoveryProgress` is the single mutable record the service
updates and every surface reads: ``/statusz`` and ``/healthz`` report
``recovering`` until the machine reaches ``live`` (health stays
distinct from ``degraded`` — a recovering node is healthy-but-behind),
and tools/top.py renders the per-stage counters. A fresh node (no
store, or a store with no peers to catch up from) starts directly in
``live``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

#: state progression order (index comparisons gate transitions)
STATES = ("cold", "loading_segments", "replaying_wal", "catchup", "live")


@dataclass
class RecoveryProgress:
    state: str = "cold"
    segments_total: int = 0
    segments_loaded: int = 0
    wal_records_replayed: int = 0
    catchup_lag: int = 0  # missing slots at the last catchup probe
    catchup_sessions: int = 0
    started_at: float = 0.0  # clock.monotonic() at recovery start
    live_at: float = 0.0
    epoch: int = 0
    migrated: bool = False  # legacy monolithic checkpoint imported
    _order: dict = field(
        default_factory=lambda: {s: i for i, s in enumerate(STATES)},
        repr=False,
    )

    @property
    def recovering(self) -> bool:
        return self.state not in ("cold", "live")

    def advance(self, state: str) -> None:
        """Move forward only — a late catchup callback must never drag a
        live node back to ``catchup`` on the status surface."""
        if self._order[state] >= self._order[self.state]:
            self.state = state

    def mark_live(self, now: float) -> None:
        if self.state != "live":
            self.live_at = now
        self.state = "live"
        self.catchup_lag = 0

    def to_dict(self, now: float) -> dict:
        """The /statusz ``recovery`` block (and top.py's data source)."""
        elapsed = 0.0
        if self.started_at:
            end = self.live_at if self.state == "live" else now
            elapsed = max(0.0, end - self.started_at)
        return {
            "state": self.state,
            "segments_loaded": self.segments_loaded,
            "segments_total": self.segments_total,
            "wal_records_replayed": self.wal_records_replayed,
            "catchup_lag": self.catchup_lag,
            "catchup_sessions": self.catchup_sessions,
            "elapsed_s": round(elapsed, 3),
            "epoch": self.epoch,
            "migrated": self.migrated,
        }
