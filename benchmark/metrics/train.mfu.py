"""The whole training step's share of the card's fp32 peak: the window's
counted operations (the deform MLP's GEMMs forward and backward over the
rows queried, and the compositing kernels' counted work) over the traced
window's time, over 67 TFLOP/s."""


def read(r):
    return r.mfu() if r.kind == "train" else None
