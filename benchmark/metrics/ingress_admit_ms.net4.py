"""Mean time, in ms, from a transfer's arrival in a node's gRPC handler
to its admission, over the transfers the four nodes admitted in the
window: the nodes' own span of RPC ingress, which holds the overload
gate and the pre-verification of the client's signature through the
verifier seam (``node/service.py`` ``_admit``). The growth of every
node's /metrics ``tx_ingress_to_admitted`` histogram sum over that of
its count; tampered transfers end in ``tx_ingress_to_rejected`` and are
not in it."""

SPAN = "at2_tx_ingress_to_admitted_seconds"


def read(w):
    n = w.delta(f"{SPAN}_count")
    if n <= 0:
        return None
    return 1e3 * w.delta(f"{SPAN}_sum") / n
