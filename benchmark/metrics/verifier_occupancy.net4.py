"""Real signatures over kernel lanes launched in the window, in percent,
summed over the four nodes' verifiers (their /metrics
``verifier_signatures`` and ``verifier_batch_occupancy``)."""

from benchmark.harness.window import occupancy_pct


def read(w):
    return occupancy_pct(w, "at2_verifier_signatures", "at2_verifier_batch_occupancy")
