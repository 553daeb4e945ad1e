"""Share, in percent, of the batches the four nodes' verifiers resolved in
the window that the native seam took (its worker thread and eventfd, not
the Python stage threads): 100 x the growth of every node's /metrics
``verifier_native_batches`` over that of ``verifier_batches``. None where
no node exports the native counter (the host verifier, a program without
the seam) or the window resolved no batch."""

NATIVE, ALL = "at2_verifier_native_batches", "at2_verifier_batches"


def read(w):
    if not any(NATIVE in close for _, close in w.counters):
        return None
    n = w.delta(ALL)
    if n <= 0:
        return None
    return 100.0 * w.delta(NATIVE) / n
