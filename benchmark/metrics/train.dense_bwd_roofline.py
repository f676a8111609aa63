"""The dense backward compositing kernel's share of its roofline in
training: the least time of the kept calls' counted work over the device
time of their launches."""


def read(r):
    return r.roofline("backward") if r.kind == "train" else None
