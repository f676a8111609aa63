"""The dense forward compositing kernel's share of its roofline in training:
the least time of the kept calls' counted work (traffic/peaks.py) over the
device time of their launches."""


def read(r):
    return r.roofline("forward") if r.kind == "train" else None
