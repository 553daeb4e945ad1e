"""What a run saw in its measured window, handed to every metric reader.

A reader (``benchmark/metrics/<metric>.py``) is a module with one
function ``read(w: Window)`` that returns the metric's value, or None
where the window holds nothing for it to read; the harness then leaves
the metric out of the result line.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from benchmark.harness.chrome import DeviceWindow


@dataclass
class Window:
    lo: float  # wall clock, seconds
    hi: float
    card: str
    # per call: (t_send, t_done, n, tag, status) in a net cell; (t_send,
    # t_done, n, tag, ok) in a replay; every call sent in the run
    calls: List[tuple] = field(default_factory=list)
    committed: Optional[int] = None  # transfers committed on every node in the window
    # (at the window's start, at its end) of each node's or verifier's counters
    counters: List[Tuple[Dict[str, float], Dict[str, float]]] = field(default_factory=list)
    stages: Optional[Tuple[dict, dict]] = None  # the verifier's stage_histograms()
    device: Optional[DeviceWindow] = None  # the traced run's device activity

    @property
    def seconds(self) -> float:
        return self.hi - self.lo

    def delta(self, name: str) -> float:
        """A counter's growth over the window, summed over the nodes."""
        return sum(close.get(name, 0.0) - open_.get(name, 0.0) for open_, close in self.counters)

    def calls_sent_inside(self) -> List[tuple]:
        return [c for c in self.calls if self.lo <= c[0] < self.hi]


def occupancy_pct(w: Window, signatures: str, occupancy: str) -> Optional[float]:
    """Signatures over lanes launched in the window, in percent, summed
    over the counters' sources; the lanes so far are signatures over the
    lifetime occupancy, at each end of the window."""
    sigs = lanes = 0.0
    for open_, close in w.counters:
        s0, s1 = open_.get(signatures, 0.0), close.get(signatures, 0.0)
        o0, o1 = open_.get(occupancy, 0.0), close.get(occupancy, 0.0)
        if o1 <= 0:
            continue
        sigs += s1 - s0
        lanes += s1 / o1 - (s0 / o0 if o0 > 0 else 0.0)
    return 100.0 * sigs / lanes if lanes > 0 else None


def idle_pct(w: Window) -> Optional[float]:
    if w.device is None or w.seconds <= 0:
        return None
    return 100.0 * (1.0 - w.device.busy_s() / w.seconds)
