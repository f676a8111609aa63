"""The whole served frame's share of the card's fp32 peak: the window's
counted operations (the deform MLP's GEMMs over the rows queried and the
forward compositing kernel's counted work) over the traced window's time,
over 67 TFLOP/s."""


def read(r):
    return r.mfu() if r.kind == "serve" else None
