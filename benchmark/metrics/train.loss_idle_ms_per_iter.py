"""Device-idle time an iteration while the innermost program span open is
``loss.frame``: the card waits on the host's losses."""

from harness import spans


def read(r):
    if r.kind != "train":
        return None
    return spans.idle_ms(r, ("loss.frame",))
