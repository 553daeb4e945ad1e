"""Real signatures over kernel lanes launched in the window, in percent,
from the pool verifier's ``stats()`` at the window's two ends."""

from benchmark.harness.window import occupancy_pct


def read(w):
    return occupancy_pct(w, "signatures", "batch_occupancy")
