"""Device-idle time an iteration while the innermost program span open is
one of ``render.preprocess``, ``render.binning`` and ``render.composite``:
the card waits on the host's rasterizer."""

from harness import spans


def read(r):
    if r.kind != "train":
        return None
    return spans.idle_ms(r, spans.RENDER)
