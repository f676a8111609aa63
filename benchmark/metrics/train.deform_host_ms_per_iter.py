"""Host self time of the deform query an iteration: the program's
``deform.query`` spans (the MLP and its compaction, the flow frame's extra
query too) less the program spans nested in them, over the traced
iterations."""

from harness import spans


def read(r):
    if r.kind != "train":
        return None
    return spans.self_ms(r, ("deform.query",))
