"""Device-idle time an iteration while ``train_step.forward`` is the
innermost program span open: what the deform, render and loss spans
leave of the forward (backgrounds, composition, compaction)."""

from harness import spans


def read(r):
    if r.kind != "train":
        return None
    return spans.idle_ms(r, ("train_step.forward",))
