"""Steps the Trainer dispatched again after a capacity overflow, per 1,000
iterations: the program's ``trainer.replay`` spans in the traced window;
0 where the program emits its spans but replayed nothing."""

from harness import spans


def read(r):
    if r.kind != "train":
        return None
    return spans.count_per_kunit(r, ("trainer.replay",))
