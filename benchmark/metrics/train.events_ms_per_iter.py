"""Time of the densify and opacity-reset events an iteration: the harness
spans around the Trainer's _densify and _reset_opacity, over the traced
iterations; nothing where no event fell in the window."""


def read(r):
    if r.kind != "train" or not r.n_events:
        return None
    return 1e3 * r.event_s / r.units
