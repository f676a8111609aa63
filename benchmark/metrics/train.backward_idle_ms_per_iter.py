"""Device-idle time an iteration while ``train_step.backward`` is the
innermost program span open: the host in autograd's backward call."""

from harness import spans


def read(r):
    if r.kind != "train":
        return None
    return spans.idle_ms(r, ("train_step.backward",))
