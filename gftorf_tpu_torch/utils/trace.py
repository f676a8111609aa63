"""The port's spans: ``record_function`` ranges at its layer boundaries.

``span(name)`` opens a ``torch.profiler.record_function`` range while a
profiler is active, so the span lands on the profiler's own clock beside
the card's activity, and is a shared no-op otherwise: with tracing off a
span costs one flag check. There is no collector of its own: whoever
runs ``torch.profiler`` (the train CLI's ``--profile_steps``, the
benchmark's traced window, ``chip_smoke.py --profile``) reads the spans.

``SPANS`` lists every span the package emits, with its layer. A span is
emitted once per layer call, never inside a loop over Gaussians, tiles
or parameter leaves. ``preprocess.backward`` opens in the preprocess
kernels' autograd backward (``render/kernels/preprocess.py``), on
autograd's own thread, and only on a CUDA tensor: the plain version's
backward is autograd's ops, under no span. ``flat.backward`` opens in the
same way in the flat compositor's backward (``render/kernels/flat.py``),
on a CUDA tensor. ``composite.flat`` opens inside ``render.binning`` and
``render.composite`` (``render/rasterize.py``) when a render takes the
flat stream: the flat binning, the stream's gather and its compositing.
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

SPANS = (
    ("trainer.step", "Trainer"),
    ("trainer.wait", "Trainer"),
    ("trainer.replay", "Trainer"),
    ("trainer.densify", "events"),
    ("trainer.reset", "events"),
    ("trainer.prune", "events"),
    ("train_step.forward", "entry"),
    ("train_step.backward", "entry"),
    ("train_step.update", "losses, update"),
    ("deform.query", "deform query"),
    ("render.preprocess", "preprocess, binning"),
    ("preprocess.backward", "preprocess, binning"),
    ("render.binning", "preprocess, binning"),
    ("render.composite", "kernels"),
    ("composite.flat", "kernels"),
    ("flat.backward", "kernels"),
    ("loss.frame", "losses, update"),
    ("serve.frame", "entry"),
    ("serve.to_host", "entry"),
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while a profiler is active, else
    a shared no-op context."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _OFF
