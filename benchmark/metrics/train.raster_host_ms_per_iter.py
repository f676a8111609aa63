"""Host self time of the rasterizer's three stages an iteration: the
program's ``render.preprocess``, ``render.binning`` and
``render.composite`` spans less the program spans nested in them, over
the traced iterations (the forward only: autograd runs the backward on
its own thread, under no program span)."""

from harness import spans


def read(r):
    if r.kind != "train":
        return None
    return spans.self_ms(r, spans.RENDER)
