"""K1's share of its roofline, in percent: the least time the H100 needs
for the real signatures the pool verified in the window over K1's summed
kernel time in the window, from the harness process's device trace."""

from benchmark.harness import yardstick

KERNEL = "ed25519_verify_kernel"


def read(w):
    if w.device is None:
        return None
    return yardstick.roofline_pct(w.delta("signatures"), w.device.kernel_s(KERNEL), w.card)
