"""Device-idle time a served frame while the innermost program span open
is ``serve.frame`` or ``serve.to_host``: the frame's entry, its transfer
and the host's wait for it."""

from harness import spans


def read(r):
    if r.kind != "serve":
        return None
    return spans.idle_ms(r, ("serve.frame", "serve.to_host"))
