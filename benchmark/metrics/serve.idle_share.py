"""Share of the traced serving window in which no operation ran on the
card."""


def read(r):
    if r.kind != "serve" or r.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
