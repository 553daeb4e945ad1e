"""Mean time, in ms, from a signature being taken by a flush to its
verdict being set (the in-flight slot, host prep, launch, the device and
the finish), over the signatures the four nodes' verifiers resolved in
the window: the growth of every node's /metrics
``verifier_seam_pipeline_s`` over that of ``verifier_seam_resolved``.
None where the nodes export neither."""

SUM, COUNT = "at2_verifier_seam_pipeline_s", "at2_verifier_seam_resolved"


def read(w):
    n = w.delta(COUNT)
    if n <= 0:
        return None
    return 1e3 * w.delta(SUM) / n
