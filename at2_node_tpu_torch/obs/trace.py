"""Per-transaction lifecycle tracing: ingress → … → committed.

Counterpart of ``at2_node_tpu/obs/trace.py``.

``TxTrace`` answers the question the flat counters cannot: WHERE does a
transfer spend its time between arriving on the RPC surface and landing
in the ledger? Each traced transaction is stamped through the stage
ladder

    ingress → admitted → echoed → ready_quorum → delivered → committed

and every stamp feeds a ``tx_ingress_to_<stage>`` histogram measured
from the ingress timestamp, so ``/statusz`` can report p50/p99 for any
prefix of the pipeline (ingress→commit being the headline number).

Fleet stitching (tools/trace_collect.py) needs more than the local
percentiles, so every stamp additionally retains BOTH timestamps:

* **monotonic** — the node's scheduling clock, good for intra-node
  durations but meaningless across hosts;
* **wall** — the node's wall clock, the only cross-node join axis.
  Under the deterministic simulator both come from the same virtual
  clock, so stitched timelines are exact (and reproducible bit-for-bit
  from a seed).

Terminal stamps (``committed``, or the out-of-ladder ``rejected`` that
admission control applies at the RPC boundary) retire the record into a
bounded *completed ring* (``done_cap`` newest completions) that
``/tracez`` exports next to the still-live records.

Cardinality control — a tracer must never become the memory leak it is
supposed to find:

* **Sampling**: only every Nth transaction seen at ingress is traced
  (``sample_every``; 1 = all, 0 = disabled). Stamps for untraced keys
  are a single dict miss.
* **Cap**: at most ``cap`` live (unterminated) traces; beginning a new
  one past the cap evicts the oldest, counted in ``tx_trace_evicted``.
  A transaction that never terminates (byzantine, equivocated)
  therefore ages out instead of pinning memory forever.

Stamps are idempotent and order-tolerant: a duplicate or backwards stamp
(the batched plane can deliver before the per-entry echo bookkeeping
runs; retransmits re-echo) is ignored, so each histogram sees each
transaction at most once.

Keys are ``(sender_public_key, sequence)`` — the identity the broadcast
plane itself dedups on, and therefore globally unique across the fleet.
Transactions that entered through THIS node's RPC ingress get *origin*
records (they carry the ``ingress`` stamp and feed the histograms);
relayed traffic gets *relay* records opened lazily at the first
non-terminal stamp (no local ingress time, no histogram contribution) —
those are the spans trace_collect joins across nodes. The local
percentiles therefore stay what they always were: end-to-end client
latency as this node's clients experience it.
"""

from __future__ import annotations

import time
from collections import deque

from .registry import Histogram, Registry

__all__ = [
    "BROKER_STAGES", "PHASE_MARKERS", "REJECTED", "STAGES", "TxTrace",
]

STAGES: tuple[str, ...] = (
    "ingress",
    "admitted",
    "echoed",
    "ready_quorum",
    "delivered",
    "committed",
)
_STAGE_IDX = {s: i for i, s in enumerate(STAGES)}

# Broker-hop relay stamps. The broker tier sits BEFORE node ingress on
# the distilled path (client → broker _collect → distill → node
# SendDistilledBatch), so its stages get negative ladder indices: they
# order ahead of ``ingress`` (index 0) for stitching, while the
# ``idx <= rec[_IDX]`` monotonicity guard makes node-side records (which
# start at index >= 0) ignore them for free. Brokers never call
# ``begin()`` — every broker record is a relay span opened by the keyed
# lottery, so all parties sample the SAME transactions and
# trace_collect joins client → broker → node → commit. Deliberately NOT
# appended to ``STAGES``: the ladder is the node-local happy path and
# its consumers (histogram construction, snapshot()) iterate it.
BROKER_STAGES: tuple[str, ...] = ("broker_rx", "broker_flush")
_STAGE_IDX["broker_rx"] = -2
_STAGE_IDX["broker_flush"] = -1

# Order-free phase markers (phase-overlap accounting). With
# [wan] overlap_ready on, a node emits its Ready in the same frame as
# its Echo — so "the echo quorum was observed" and "own Ready was sent"
# can land in EITHER order, which the ``idx <= rec[_IDX]`` ladder guard
# would silently truncate to whichever arrived first. Markers are
# therefore stamped OUTSIDE the ladder: appended once to the record's
# stamp list (first arrival wins per marker), never advancing the
# ladder index, never feeding a histogram, never opening a relay span.
# trace_collect.py reads them back as the per-slot echo→ready gap
# (negative = piggybacked). Deliberately NOT in ``STAGES`` for the same
# reason BROKER_STAGES is not.
PHASE_MARKERS: frozenset = frozenset({"echo_quorum", "ready_sent"})

# Out-of-ladder terminal: admission control refused the transaction at
# the RPC boundary (token-bucket throttle or failed pre-verification).
# Not a STAGES member — the ladder is the happy path and existing
# consumers iterate it — but it finalizes a record exactly like
# ``committed`` does.
REJECTED = "rejected"

# _live record layout (a list, mutated in place on the hot path)
_IDX = 0  # highest stage index stamped so far
_T0 = 1  # monotonic reference (ingress for origin, first stamp for relay)
_ORIGIN = 2  # True = entered through this node's RPC ingress
_STAMPS = 3  # [(stage, monotonic, wall), ...] in arrival order


class _FallbackClock:
    """time-module clock used when no clock seam is injected (direct
    TxTrace construction in tests/benchmarks)."""

    monotonic = staticmethod(time.monotonic)
    wall = staticmethod(time.time)


class TxTrace:
    """Sampled, capped lifecycle tracker. Single-threaded by contract:
    every stamp site runs on the node's event loop (RPC handlers, the
    broadcast worker callbacks, the commit tail), so the live-trace dict
    needs no lock — only the histograms it feeds are thread-safe."""

    def __init__(
        self,
        registry: Registry,
        sample_every: int = 1,
        cap: int = 8192,
        done_cap: int = 1024,
        clock=None,
        retire_at: str | None = None,
    ) -> None:
        if sample_every < 0:
            raise ValueError("sample_every must be >= 0 (0 disables)")
        if cap < 1:
            raise ValueError("cap must be >= 1")
        if done_cap < 1:
            raise ValueError("done_cap must be >= 1")
        if retire_at is not None and retire_at not in _STAGE_IDX:
            raise ValueError(f"unknown retire_at stage {retire_at!r}")
        self._sample_every = sample_every
        self._cap = cap
        # A non-terminal stage that retires records for THIS tracer.
        # The broker's tracer sets retire_at="broker_flush": its
        # custody of a transaction ends at flush, so the record moves to
        # the completed ring (and /tracez) instead of idling at the live
        # cap until eviction. Node tracers leave it None.
        self._retire_at = retire_at
        self._clock = clock if clock is not None else _FallbackClock()
        self._live: dict[tuple, list] = {}
        self._done: deque = deque(maxlen=done_cap)
        self._seen = 0
        self._traced = registry.counter(
            "tx_traced", "transactions sampled into the lifecycle tracer"
        )
        self._relayed = registry.counter(
            "tx_trace_relayed",
            "relay-side trace records opened for fleet stitching",
        )
        self._completed = registry.counter(
            "tx_trace_completed", "traces that reached committed"
        )
        self._rejected_c = registry.counter(
            "tx_trace_rejected", "traces terminated by admission rejection"
        )
        self._evicted = registry.counter(
            "tx_trace_evicted", "live traces evicted at the cardinality cap"
        )
        self._hists: dict[str, Histogram] = {
            s: registry.histogram(
                f"tx_ingress_to_{s}", f"latency from ingress to {s}"
            )
            for s in STAGES[1:]
        }
        self._hists[REJECTED] = registry.histogram(
            "tx_ingress_to_rejected", "latency from ingress to rejection"
        )

    @property
    def enabled(self) -> bool:
        return self._sample_every > 0

    def _evict_for_room(self) -> None:
        if len(self._live) >= self._cap:
            # dicts iterate in insertion order: the first key is oldest
            self._live.pop(next(iter(self._live)))
            self._evicted.inc()

    def begin(self, key: tuple, now: float | None = None) -> None:
        """Record ingress for ``key`` if it wins the sampling lottery."""
        if not self._sample_every:
            return
        self._seen += 1
        if self._seen % self._sample_every:
            return
        if key in self._live:
            return  # client retry of an in-flight tx: keep first ingress
        self._evict_for_room()
        t = self._clock.monotonic() if now is None else now
        self._live[key] = [0, t, True, [("ingress", t, self._clock.wall())]]
        self._traced.inc()

    def stamp(self, key: tuple, stage: str, now: float | None = None) -> None:
        rec = self._live.get(key)
        if stage in PHASE_MARKERS:
            # order-free annotation on an already-open record: no ladder
            # index, no histogram, no relay-span open
            if rec is None:
                return
            if any(s == stage for s, _, _ in rec[_STAMPS]):
                return  # first arrival wins
            t = self._clock.monotonic() if now is None else now
            rec[_STAMPS].append((stage, t, self._clock.wall()))
            return
        terminal = stage == "committed" or stage == REJECTED
        if rec is None:
            # Relay-side open: a stamp for a key this node never saw at
            # ingress starts a relay span (the cross-node half of a
            # stitched timeline) — but never from a terminal stamp
            # alone, a record holding nothing but its own tombstone is
            # useless. The relay lottery is keyed (not sequential) so
            # every node samples the SAME transactions and spans join.
            if terminal or not self._sample_every:
                return
            if self._sample_every > 1 and (
                (key[0][0] + key[1]) % self._sample_every
            ):
                return
            self._evict_for_room()
            t = self._clock.monotonic() if now is None else now
            self._live[key] = rec = [_STAGE_IDX[stage], t, False, []]
            rec[_STAMPS].append((stage, t, self._clock.wall()))
            self._relayed.inc()
            if stage == self._retire_at:
                # e.g. broker_flush for a record evicted between rx and
                # flush: retire the single-stamp span rather than leave
                # it live forever
                self._retire(key, rec, stage)
                self._completed.inc()
            return
        if stage == REJECTED:
            t = self._clock.monotonic() if now is None else now
            if rec[_ORIGIN]:
                self._hists[REJECTED].observe(t - rec[_T0])
            rec[_STAMPS].append((REJECTED, t, self._clock.wall()))
            self._retire(key, rec, REJECTED)
            self._rejected_c.inc()
            return
        idx = _STAGE_IDX[stage]
        if idx <= rec[_IDX]:
            return  # duplicate or out-of-order: first arrival wins
        t = self._clock.monotonic() if now is None else now
        if rec[_ORIGIN]:
            self._hists[stage].observe(t - rec[_T0])
        rec[_IDX] = idx
        rec[_STAMPS].append((stage, t, self._clock.wall()))
        if stage == "committed" or stage == self._retire_at:
            self._retire(key, rec, stage)
            self._completed.inc()

    def _retire(self, key: tuple, rec: list, terminal: str) -> None:
        del self._live[key]
        self._done.append(self._export(key, rec, terminal))

    @staticmethod
    def _export(key: tuple, rec: list, terminal: str | None) -> dict:
        return {
            "sender": key[0].hex(),
            "seq": key[1],
            "origin": rec[_ORIGIN],
            "terminal": terminal,
            "stages": [
                [s, round(m, 9), round(w, 9)] for s, m, w in rec[_STAMPS]
            ],
        }

    @property
    def live(self) -> int:
        return len(self._live)

    def snapshot(self) -> dict:
        """Per-stage histogram snapshots for /statusz."""
        out = {
            f"ingress_to_{s}": self._hists[s].snapshot() for s in STAGES[1:]
        }
        out["ingress_to_rejected"] = self._hists[REJECTED].snapshot()
        out["live_traces"] = len(self._live)
        return out

    def tracez(self, limit: int | None = None) -> dict:
        """Live + completed trace records for GET /tracez and the sim
        episode capture. ``limit`` keeps only the newest N completed
        records (the ring is already bounded by ``done_cap``)."""
        done = list(self._done)
        if limit is not None and limit >= 0:
            # a limit past the ring's length keeps the whole ring (a bare
            # ``len(done) - limit`` start would go negative and count
            # from the end)
            done = done[max(0, len(done) - limit):] if limit else []
        return {
            "live": [
                self._export(k, rec, None) for k, rec in self._live.items()
            ],
            "completed": done,
        }
