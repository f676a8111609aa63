"""Readings of the program's own spans in a traced window: host self time,
device-idle time and counts by span, for the per-layer readers.

The program opens its spans (``gftorf_tpu_torch/utils/trace.py``) as
``record_function`` ranges while a profiler runs, so they lie on the
profiler's clock beside the card's operations. A program without them (an
older commit) leaves every reading here at None.

- self: the summed durations of the named spans inside the window, less
  the part of each that other program spans nested in it cover.
- idle: the window's device-idle time (the complement of the union of the
  card's operations, as ``Reading`` computes busy time), each instant
  given to the innermost program span open then: the latest-started of
  those that cover it. Idle time under no program span has the owner None.
- count: the named spans inside the window.

Each is per unit (iteration or frame) of the reading; self and idle in ms,
counts per 1,000 units."""

from __future__ import annotations

from typing import Dict, Optional

from harness.trace import PROGRAM_SPANS as STEP_SPANS
from harness.trace import _clip, _length, _union

TRAINER = ("trainer.step", "trainer.wait", "trainer.replay",
           "trainer.densify", "trainer.reset", "trainer.prune")
RENDER = ("render.preprocess", "render.binning", "render.composite")
SERVE = ("serve.frame", "serve.to_host")
# Every span the innermost rule looks at.
PROGRAM = STEP_SPANS + TRAINER + ("deform.query",) + RENDER + ("loss.frame",) \
    + SERVE
# The span that opens each unit, per kind of reading.
ROOT = {"train": "trainer.step", "serve": "serve.frame"}


def _inside(r, names):
    """(start, end, name) of the spans named ``names`` that lie inside the
    window, by start and, at one start, the longer first."""
    return sorted(((a, b, n) for n, a, b in r.cpu
                   if n in names and a >= r.w0 and b <= r.w1),
                  key=lambda s: (s[0], -s[1]))


def present(r) -> bool:
    """Whether the program emitted its spans in this window."""
    root = ROOT.get(r.kind)
    return any(n == root for n, _, _ in r.cpu)


def self_ms(r, names) -> Optional[float]:
    """Host self time of the spans ``names``, in ms per unit."""
    if not present(r):
        return None
    spans = _inside(r, PROGRAM)
    total, found = 0.0, 0
    for i, (a, b, n) in enumerate(spans):
        if n not in names:
            continue
        found += 1
        inner = []
        for a2, b2, _ in spans[i + 1:]:
            if a2 >= b:
                break
            if b2 <= b:
                inner.append((a2, b2))
        total += (b - a) - _length(_union(inner))
    return 1e3 * total / r.units if found else None


def count_per_kunit(r, names) -> Optional[float]:
    """Spans ``names`` in the window per 1,000 units (0 where the program
    emits spans but none of these)."""
    if not present(r):
        return None
    return 1e3 * len(_inside(r, names)) / r.units


def idle_by_owner(r) -> Dict[Optional[str], float]:
    """Device-idle seconds of the window by the innermost program span
    open at each instant (None: under no program span). The values sum to
    the window's idle time."""
    cached = getattr(r, "_idle_by_owner", None)
    if cached is not None:
        return cached
    spans = [(max(a, r.w0), min(b, r.w1), n) for n, a, b in r.cpu
             if n in PROGRAM and b > r.w0 and a < r.w1 and b > a]
    busy = _union(_clip([(a, b) for _, a, b in r.dev], r.w0, r.w1))
    edges = [r.w0] + [x for iv in busy for x in iv] + [r.w1]
    idle = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    opens = sorted(range(len(spans)),
                   key=lambda i: (spans[i][0], -spans[i][1]))
    closes = sorted(range(len(spans)), key=lambda i: spans[i][1])
    times = sorted({t for a, b, _ in spans for t in (a, b)} | {r.w0, r.w1})
    out: Dict[Optional[str], float] = {}
    stack, oi, ci, j = [], 0, 0, 0
    for t, t_next in zip(times, times[1:]):
        while ci < len(closes) and spans[closes[ci]][1] <= t:
            stack.remove(closes[ci])
            ci += 1
        while oi < len(opens) and spans[opens[oi]][0] <= t:
            stack.append(opens[oi])
            oi += 1
        while j < len(idle) and idle[j][1] <= t:
            j += 1
        k, s = j, 0.0
        while k < len(idle) and idle[k][0] < t_next:
            s += min(idle[k][1], t_next) - max(idle[k][0], t)
            k += 1
        if s > 0.0:
            owner = spans[stack[-1]][2] if stack else None
            out[owner] = out.get(owner, 0.0) + s
    r._idle_by_owner = out
    return out


def idle_ms(r, names) -> Optional[float]:
    """Device-idle time whose innermost open span is one of ``names``, in
    ms per unit; None where none of them lies in the window."""
    if not present(r) or not _inside(r, names):
        return None
    owned = idle_by_owner(r)
    return 1e3 * sum(owned.get(n, 0.0) for n in names) / r.units
