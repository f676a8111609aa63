"""Device-idle time an iteration while the innermost program span open is
one of the Trainer's (``trainer.step``, ``.wait``, ``.replay``,
``.densify``, ``.reset``, ``.prune``): camera picks, the metrics
pipeline, replays and the events."""

from harness import spans


def read(r):
    if r.kind != "train":
        return None
    return spans.idle_ms(r, spans.TRAINER)
