"""Host self time of the losses an iteration: the program's ``loss.frame``
spans, from the first loss term to the total, over the traced
iterations."""

from harness import spans


def read(r):
    if r.kind != "train":
        return None
    return spans.self_ms(r, ("loss.frame",))
