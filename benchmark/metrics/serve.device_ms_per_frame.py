"""Device-busy time a served frame: the union of every operation the
profiler saw on the card in the traced window, over its frames."""


def read(r):
    if r.kind != "serve" or r.busy_s <= 0:
        return None
    return 1e3 * r.busy_s / r.units
