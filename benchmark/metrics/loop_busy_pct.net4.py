"""The share of the window, in percent, each node's event loop spent
outside its selector's wait (running callbacks and tasks), the mean over
the nodes that export it: the growth of a node's /metrics
``event_loop_busy_ns`` over the window's nanoseconds. None where no node
exports it."""

NAME = "at2_event_loop_busy_ns"


def read(w):
    shares = [
        100.0 * (close[NAME] - open_[NAME]) / (1e9 * w.seconds)
        for open_, close in w.counters
        if NAME in open_ and NAME in close
    ]
    if not shares or w.seconds <= 0:
        return None
    return sum(shares) / len(shares)
