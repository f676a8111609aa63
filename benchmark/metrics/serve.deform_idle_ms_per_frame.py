"""Device-idle time a served frame while the innermost program span open
is ``deform.query``."""

from harness import spans


def read(r):
    if r.kind != "serve":
        return None
    return spans.idle_ms(r, ("deform.query",))
