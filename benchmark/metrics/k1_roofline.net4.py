"""K1's share of its roofline, in percent: the least time the H100 needs
for the real signatures the four nodes verified in the window (the
frozen work of benchmark/harness/yardstick.py) over K1's summed kernel
time in the window, from the four nodes' device traces."""

from benchmark.harness import yardstick

KERNEL = "ed25519_verify_kernel"


def read(w):
    if w.device is None:
        return None
    return yardstick.roofline_pct(w.delta("at2_verifier_signatures"), w.device.kernel_s(KERNEL), w.card)
