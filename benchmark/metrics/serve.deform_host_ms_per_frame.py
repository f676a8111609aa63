"""Host self time of the deform query a served frame: the program's
``deform.query`` spans less the program spans nested in them, over the
traced frames."""

from harness import spans


def read(r):
    if r.kind != "serve":
        return None
    return spans.self_ms(r, ("deform.query",))
