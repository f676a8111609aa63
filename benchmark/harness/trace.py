"""The traced run: what the profiler and the harness's own counters saw in
the traced window, reduced to the quantities the per-layer readers take.

Spans are the harness's ``record_function`` ranges (``bench.window``,
``bench.step``, ``bench.frame``, ``bench.densify``, ``bench.reset``) and the
program's own (``train_step.forward`` / ``.backward`` / ``.update``). Device
activity is every operation the profiler saw on the card. Times are
seconds."""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch

from traffic import peaks

PROGRAM_SPANS = ("train_step.forward", "train_step.backward",
                 "train_step.update")
EVENT_SPANS = ("bench.densify", "bench.reset")
TOP = 10
# Compositing calls a traced window keeps, of each kind, to count their work.
KEPT_CALLS = 4
KINDS = ("forward", "backward", "flat_forward", "flat_backward")


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def _clip(intervals, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def profiler_events(prof):
    """(cpu, device): lists of (name, start_s, end_s) from the profiler's
    raw events (``prof.events()`` would build a tree of them first, which
    takes minutes on a window of a few hundred thousand); the device list
    holds the operations that ran on the card, not the ranges of
    ``record_function`` spans that the profiler also draws there."""
    cuda = torch.autograd.DeviceType.CUDA
    cpu, dev, annotations = [], [], set()
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns() * 1e-9
        item = (e.name(), a, a + e.duration_ns() * 1e-9)
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                dev.append(item)
        else:
            cpu.append(item)
            if e.is_user_annotation():
                annotations.add(item[0])
    return cpu, [d for d in dev if d[0] not in annotations]


class CompositeCalls:
    """Counts the compositing calls of the traced window, dense
    (``forward``, ``backward``) and flat (``flat_forward``,
    ``flat_backward``), and keeps the inputs and outputs of the first
    ``keep`` calls of each kind, to count their work once the window has
    closed. Installed in place of the program's ``composite_forward`` /
    ``composite_backward`` and ``composite_forward_flat`` /
    ``composite_backward_flat``."""

    def __init__(self, dense_module, flat_module, keep: int = KEPT_CALLS):
        self.dense, self.flat = dense_module, flat_module
        self.keep = keep
        self.kept: Dict[str, List[tuple]] = {k: [] for k in KINDS}
        self.n: Dict[str, int] = dict.fromkeys(KINDS, 0)
        self._orig = (dense_module.composite_forward,
                      dense_module.composite_backward,
                      flat_module.composite_forward_flat,
                      flat_module.composite_backward_flat)

    def _count(self, kind: str, item) -> None:
        self.n[kind] += 1
        if len(self.kept[kind]) < self.keep:
            self.kept[kind].append(item)

    def install(self):
        fwd, bwd, flat_fwd, flat_bwd = self._orig

        @functools.wraps(fwd)
        def forward(feat_tl, bg_tiles, counts, origins, config):
            out, contrib = fwd(feat_tl, bg_tiles, counts, origins, config)
            self._count("forward", (feat_tl, counts, origins, config, contrib))
            return out, contrib

        @functools.wraps(bwd)
        def backward(feat_tl, bg_tiles, out_res, g, counts, origins, config,
                     has_flow):
            self._count("backward", (feat_tl, has_flow))
            return bwd(feat_tl, bg_tiles, out_res, g, counts, origins, config,
                       has_flow)

        @functools.wraps(flat_fwd)
        def forward_flat(feat_fl, bg_tiles, tile_start, tile_count, origins,
                         config):
            out, contrib = flat_fwd(feat_fl, bg_tiles, tile_start, tile_count,
                                    origins, config)
            self._count("flat_forward", (feat_fl, tile_start, tile_count,
                                         origins, config, contrib))
            return out, contrib

        @functools.wraps(flat_bwd)
        def backward_flat(feat_fl, bg_tiles, out_res, g, tile_start,
                          tile_count, origins, config, has_flow):
            self._count("flat_backward", (feat_fl, has_flow))
            return flat_bwd(feat_fl, bg_tiles, out_res, g, tile_start,
                            tile_count, origins, config, has_flow)

        self.dense.composite_forward = forward
        self.dense.composite_backward = backward
        self.flat.composite_forward_flat = forward_flat
        self.flat.composite_backward_flat = backward_flat

    def uninstall(self):
        (self.dense.composite_forward, self.dense.composite_backward,
         self.flat.composite_forward_flat,
         self.flat.composite_backward_flat) = self._orig

    def work(self) -> Dict[str, Tuple[float, float, int]]:
        """For each kind: (least seconds summed over the kept calls, fp32
        operations summed over them, calls kept). A backward call is
        counted with the inputs and contributions of its forward call."""
        out = {}
        for fwd, bwd, count in (("forward", "backward", peaks.work_of),
                                ("flat_forward", "flat_backward",
                                 peaks.flat_work_of)):
            least = ops = 0.0
            for *inputs, contrib in self.kept[fwd]:
                b, o = count(*inputs, contrib)
                least += peaks.least_seconds(b, o)
                ops += o
            out[fwd] = (least, ops, len(self.kept[fwd]))
            by_ptr = {f[0].data_ptr(): f for f in self.kept[fwd]}
            least = ops = 0.0
            kept = 0
            for feat, has_flow in self.kept[bwd]:
                f = by_ptr.get(feat.data_ptr())
                if f is None:
                    continue
                b, o = count(*f, backward=True, has_flow=has_flow)
                least += peaks.least_seconds(b, o)
                ops += o
                kept += 1
            out[bwd] = (least, ops, kept)
        return out

    def release(self):
        for calls in self.kept.values():
            calls.clear()


class Reading:
    """The traced window as the per-layer readers see it."""

    def __init__(self, kind: str, cpu, dev, units: int,
                 composite: Optional[Dict[str, Tuple[float, float, int]]],
                 calls: Dict[str, int], deform_ops: float,
                 kernel_names: Dict[str, str]):
        self.kind = kind
        self.units = units  # iterations or frames in the window
        win = [(a, b) for n, a, b in cpu if n == "bench.window"]
        if len(win) != 1:
            raise RuntimeError(f"{len(win)} bench.window spans in the trace")
        self.w0, self.w1 = win[0]
        self.window_s = self.w1 - self.w0
        dev = [(n, a, b) for n, a, b in dev if b > self.w0 and a < self.w1]
        busy = _union(_clip([(a, b) for _, a, b in dev], self.w0, self.w1))
        self.busy_s = _length(busy)
        self.cpu = cpu
        self.dev = dev
        self._busy = busy

        def spans(names):
            return [(a, b) for n, a, b in cpu if n in names
                    and a >= self.w0 and b <= self.w1]

        self.event_s = _length(_union(spans(EVENT_SPANS)))
        self.n_events = len(spans(EVENT_SPANS))
        outer = spans(("bench.step",))
        inner = spans(PROGRAM_SPANS + EVENT_SPANS)
        self.host_self_s = sum(
            (b - a) - _length(_union(_clip(inner, a, b))) for a, b in outer)
        self.n_outer = len(outer)

        # Per compositing direction: device seconds of its kernel's first
        # launches in the window, the ones the kept calls made.
        self.kernel_first_s: Dict[str, float] = {}
        launches = sorted(dev, key=lambda x: x[1])
        for key, pattern in kernel_names.items():
            kept = (composite or {}).get(key, (0.0, 0.0, 0))[2]
            times = [b - a for n, a, b in launches if pattern in n]
            self.kernel_first_s[key] = sum(times[:kept])
        self.composite = composite or {}
        self.calls = calls
        self.deform_ops = deform_ops

    def roofline(self, key: str) -> Optional[float]:
        """Least time over measured time, in %, over the kept calls of one
        compositing direction; None where no call was kept or timed."""
        least, _, kept = self.composite.get(key, (0.0, 0.0, 0))
        t = self.kernel_first_s.get(key, 0.0)
        if not kept or t <= 0.0:
            return None
        return 100.0 * least / t

    def counted_ops(self) -> Optional[float]:
        """fp32 operations of the window: the deform MLP's GEMMs over the
        rows queried, and each compositing direction's kept calls' mean
        operations times its calls in the window."""
        ops = self.deform_ops
        for key, (_, o, kept) in self.composite.items():
            if kept:
                ops += o / kept * self.calls.get(key, 0)
        return ops if ops > 0 else None

    def mfu(self) -> Optional[float]:
        ops = self.counted_ops()
        if ops is None or self.window_s <= 0:
            return None
        return 100.0 * ops / self.window_s / peaks.PEAK_FP32_PER_S

    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest idle
        gaps, each named by the innermost host operation running through
        its middle."""
        by_name: Dict[str, float] = {}
        for n, a, b in self.dev:
            by_name[n] = by_name.get(n, 0.0) + (min(b, self.w1) - max(a, self.w0))
        ops = sorted(by_name.items(), key=lambda x: -x[1])[:TOP]
        gaps = []
        edges = [self.w0] + [x for iv in self._busy for x in iv] + [self.w1]
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                gaps.append((a, b))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
        named = []
        for a, b in gaps:
            mid = 0.5 * (a + b)
            host = [(s, n) for n, s, e in self.cpu
                    if s <= mid <= e and n != "bench.window"]
            name = max(host)[1] if host else "idle"
            named.append([name, b - a])
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}
