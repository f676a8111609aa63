"""Host time the Trainer waits on its metrics pipeline an iteration: the
program's ``trainer.wait`` spans (the wait on a step's recorded event and
the read of its metrics), over the traced iterations."""

from harness import spans


def read(r):
    if r.kind != "train":
        return None
    return spans.self_ms(r, ("trainer.wait",))
