"""Host prep time per signature, in us: the growth of the verifier's
``prep`` stage histogram sum over the window (host prep and the upload's
enqueue, including the wait for the prep executor's one thread) over the
signatures verified in the window."""


def read(w):
    if w.stages is None:
        return None
    sigs = w.delta("signatures")
    prep_ms = w.stages[1]["prep"]["sum_ms"] - w.stages[0]["prep"]["sum_ms"]
    return 1e3 * prep_ms / sigs if sigs > 0 else None
