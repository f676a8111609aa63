"""Host time of the Trainer layer an iteration (train/loop.py::Trainer.step):
the harness span around Trainer.step() less the program's train_step.*
spans and the event spans inside it, over the traced iterations. It holds
the waits of the metrics pipeline."""


def read(r):
    if r.kind != "train" or not r.n_outer:
        return None
    return 1e3 * r.host_self_s / r.units
