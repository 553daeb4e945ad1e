"""The card's idle share of the window, in percent: one minus the union
of every kernel, copy and fill interval of the four nodes' traces over
the window's length."""

from benchmark.harness.window import idle_pct


def read(w):
    return idle_pct(w)
