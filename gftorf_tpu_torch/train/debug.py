"""Parameter histograms of the live Gaussians, logged at each evaluation.

Port of ``param_series`` and ``param_histograms`` of
``gftorf_tpu/train/debug.py`` (the reference's TensorBoard histograms,
train.py:595-601), as plain dicts for train_log.jsonl. The debug image
dumps (``dump_debug_images``) need the visualisation helpers, which are
not ported yet.
"""

from __future__ import annotations

import numpy as np

from gftorf_tpu_torch.models.gaussians import get_opacity, get_scaling
from gftorf_tpu_torch.ops.sh import sh2pa


def param_series(model) -> dict:
    """Per-live-Gaussian opacity, center distance, amplitude and mean
    scale as {name: 1-D np.ndarray}."""
    alive = model.aux.alive.cpu().numpy()
    params = model.params
    return {
        "opacity": get_opacity(params)[:, 0].cpu().numpy()[alive],
        "dist": np.linalg.norm(params.xyz.cpu().numpy()[alive], axis=-1),
        "amplitude": sh2pa(params.sh_amp[:, 0]).cpu().numpy()[alive],
        "scale": get_scaling(params).mean(-1).cpu().numpy()[alive],
    }


def param_histograms(model, bins: int = 32) -> dict:
    """{name: {"edges": [...], "counts": [...]}} of ``param_series``."""
    out = {}
    for name, vals in param_series(model).items():
        if vals.size == 0:
            out[name] = {"edges": [], "counts": []}
            continue
        counts, edges = np.histogram(vals, bins=bins)
        out[name] = {"edges": [round(float(e), 6) for e in edges],
                     "counts": [int(c) for c in counts]}
    return out
