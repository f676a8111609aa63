"""Device-idle time an iteration while ``train_step.update`` is the
innermost program span open: the host in the statistics and both Adams."""

from harness import spans


def read(r):
    if r.kind != "train":
        return None
    return spans.idle_ms(r, ("train_step.update",))
