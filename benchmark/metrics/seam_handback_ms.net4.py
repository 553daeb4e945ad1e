"""Mean time, in ms, from a ``verify_many`` call's last verdict being set
to its caller running again on the node's event loop, over the calls the
four nodes' verifiers answered in the window: the growth of every node's
/metrics ``verifier_seam_handback_s`` over that of
``verifier_seam_calls``. None where the nodes export neither."""

SUM, COUNT = "at2_verifier_seam_handback_s", "at2_verifier_seam_calls"


def read(w):
    n = w.delta(COUNT)
    if n <= 0:
        return None
    return 1e3 * w.delta(SUM) / n
