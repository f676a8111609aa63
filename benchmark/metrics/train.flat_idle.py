"""Device-idle time an iteration while the innermost program span open is
``composite.flat`` (the flat stream's binning, gather and compositing) or
``flat.backward`` (the flat kernel's backward on autograd's thread): the
innermost rule of ``harness/spans.py`` over its program spans and these
two. None where neither lies in the window."""

import copy

from harness import spans

FLAT = ("composite.flat", "flat.backward")


def read(r):
    if r.kind != "train" or not spans.present(r) or not spans._inside(r, FLAT):
        return None
    # The innermost rule with the two spans among the program's: a copy of
    # the reading, so the cached owners of the other readers stay as they
    # are.
    view = copy.copy(r)
    view._idle_by_owner = None
    program = spans.PROGRAM
    spans.PROGRAM = program + FLAT
    try:
        owned = spans.idle_by_owner(view)
    finally:
        spans.PROGRAM = program
    return 1e3 * sum(owned.get(n, 0.0) for n in FLAT) / r.units
