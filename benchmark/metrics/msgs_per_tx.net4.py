"""Broadcast messages received per committed transfer: the growth of
every node's gossip, echo and ready counters and their batch forms over
the window, summed over the nodes, over the transfers committed on every
node in the window."""

RX = ("gossip_rx", "echo_rx", "ready_rx", "batch_rx", "batch_echo_rx", "batch_ready_rx")


def read(w):
    if not w.committed:
        return None
    return sum(w.delta(f"at2_{name}_total") for name in RX) / w.committed
