"""Protocol flight recorder: a fixed-size ring of compact protocol
events, always on, dumped only when something goes wrong.

Counterpart of ``at2_node_tpu/obs/recorder.py``.

The pattern is FoundationDB's: you cannot reproduce a distributed
anomaly after the fact, so every node continuously records the last N
protocol-level events — frame rx/tx by kind byte, slot state
transitions, quorum edges, admission rejects, stall kicks, verifier
flush decisions — into a bounded ring (`deque(maxlen=cap)`) that costs
one lock + one append per event and can never grow. ``GET /debugz``
dumps it on demand; the owning Service *snapshots* it automatically the
moment an anomaly fires (``/healthz`` flipping to degraded, a stall
kick), so the lead-up to the anomaly survives even though the ring
itself keeps rolling.

Events are ``(t_monotonic, code, detail)`` with ``detail`` a small
tuple of scalars — no string formatting on the hot path. Wall-clock
alignment happens once at dump time (the dump carries a paired
``now_monotonic``/``now_wall`` reading from the same clock), which is
exact under the simulator's virtual clock and good to scheduler jitter
on a real host.

Thread/asyncio safety: ``record`` can be called from the event loop,
the verifier's flush task, or (in principle) executor threads — a plain
``threading.Lock`` around the deque keeps the ring coherent everywhere;
the lock is uncontended in steady state so the cost is a couple hundred
nanoseconds per event.

``cap = 0`` disables recording entirely (the config kill-switch);
``record`` then returns before taking the lock.
"""

from __future__ import annotations

import threading
import time
from collections import deque

__all__ = ["FlightRecorder"]


class _FallbackClock:
    monotonic = staticmethod(time.monotonic)
    wall = staticmethod(time.time)


class FlightRecorder:
    def __init__(
        self,
        cap: int = 2048,
        clock=None,
        max_snapshots: int = 4,
    ) -> None:
        if cap < 0:
            raise ValueError("recorder cap must be >= 0 (0 disables)")
        if max_snapshots < 1:
            raise ValueError("max_snapshots must be >= 1")
        self._cap = cap
        self._clock = clock if clock is not None else _FallbackClock()
        self._ring: deque = deque(maxlen=cap or 1)
        self._lock = threading.Lock()
        self._total = 0
        # frozen ring copies captured at anomaly time; bounded so a
        # flapping health check cannot turn the recorder into a leak
        self._snapshots: deque = deque(maxlen=max_snapshots)
        self._snapshots_taken = 0

    @property
    def enabled(self) -> bool:
        return self._cap > 0

    @property
    def recorded(self) -> int:
        """Total events ever recorded (ring holds the newest ``cap``)."""
        return self._total

    @property
    def snapshots_taken(self) -> int:
        return self._snapshots_taken

    def record(self, code: str, detail: tuple = ()) -> None:
        """Append one event. ``detail`` must be a tuple of scalars
        (ints / short strings) — it is exported as-is."""
        if not self._cap:
            return
        t = self._clock.monotonic()
        with self._lock:
            self._ring.append((t, code, detail))
            self._total += 1

    def events_since(self, n: int) -> tuple[list, int]:
        """Events whose total-counter position is ``> n``, formatted, plus
        the new total. The delta-export primitive for shipping recorder
        events out of a worker process: the caller remembers the returned
        total and passes it back next time. Events that rolled out of the
        ring between calls are simply gone (same loss contract as the
        ring itself)."""
        with self._lock:
            total = self._total
            missing = total - n
            if missing <= 0:
                return [], total
            take = min(missing, len(self._ring))
            events = [self._fmt(e) for e in list(self._ring)[-take:]]
        return events, total

    def snapshot(self, reason: str, extra: dict | None = None) -> None:
        """Freeze the current ring under ``reason`` (anomaly capture).
        The frozen copy survives ring rollover; at most ``max_snapshots``
        newest snapshots are kept. ``extra`` attaches an arbitrary
        forensic payload (e.g. a dead worker's post-mortem drain) to the
        frozen copy."""
        if not self._cap:
            return
        now_m = self._clock.monotonic()
        now_w = self._clock.wall()
        with self._lock:
            snap = {
                "reason": reason,
                "now_monotonic": round(now_m, 9),
                "now_wall": round(now_w, 9),
                "events": [self._fmt(e) for e in self._ring],
            }
            if extra is not None:
                snap["extra"] = extra
            self._snapshots.append(snap)
            self._snapshots_taken += 1

    @staticmethod
    def _fmt(event: tuple) -> list:
        t, code, detail = event
        return [round(t, 9), code, list(detail)]

    def dump(self) -> dict:
        """The /debugz body: current ring + anomaly snapshots + paired
        clock readings for wall alignment."""
        now_m = self._clock.monotonic()
        now_w = self._clock.wall()
        with self._lock:
            events = [self._fmt(e) for e in self._ring]
            snapshots = list(self._snapshots)
        return {
            "cap": self._cap,
            "recorded": self._total,
            "dropped": max(0, self._total - len(events)),
            "now_monotonic": round(now_m, 9),
            "now_wall": round(now_w, 9),
            "events": events,
            "snapshots": snapshots,
        }
