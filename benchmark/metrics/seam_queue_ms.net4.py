"""Mean time, in ms, a signature waited in the verifier seam from its
enqueue to being taken by a flush, over the signatures the four nodes'
flushes took in the window: the growth of every node's /metrics
``verifier_seam_queue_s`` over that of ``verifier_seam_taken``
(``crypto/verifier.py`` ``CudaBatchVerifier``). None where the nodes
export neither, as the host verifier does not."""

SUM, COUNT = "at2_verifier_seam_queue_s", "at2_verifier_seam_taken"


def read(w):
    n = w.delta(COUNT)
    if n <= 0:
        return None
    return 1e3 * w.delta(SUM) / n
