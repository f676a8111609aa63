"""Device-idle time an iteration while the innermost program span open is
``deform.query``: the card waits on the host's deform query."""

from harness import spans


def read(r):
    if r.kind != "train":
        return None
    return spans.idle_ms(r, ("deform.query",))
