"""The dense forward compositing kernel's share of its roofline in serving:
the least time of the kept calls' counted work over the device time of
their launches."""


def read(r):
    return r.roofline("forward") if r.kind == "serve" else None
