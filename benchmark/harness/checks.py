"""The numbers that decide ``correct``, worked out alike from the program's
run and from the plain reference's.

Training, from the benchmark's start state: the first ``n`` steps, each
through ``Trainer.step()`` and drained, give each step's loss, the first
gradient as Adam got it (its first moment after one step over 1 - beta1,
the moments starting at zero) and the parameters' change over the ``n``
steps. Training, one step of the timed window from the state the program
held before it: its loss, the gradient as Adam got it (worked out from the
first moment before and after), the parameters' change and the
densification statistics' increments. Each is reduced to one norm a leaf
and compared leaf by leaf (``leaf_gap``). A densify event is compared on
the rows it left (``reference/densify.py``); a served frame on its colour,
phasor and depth (``frame_gap``).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import numpy as np
import torch

ADAM_B1 = 0.9
# A leaf whose reference gradient is under this share of the median leaf's
# moves under Adam by round-off alone: its change is not compared.
NOUGHT = 1e-3
STATS = ("max_radii2d", "xyz_grad_accum", "denom")
# The statistics whose increments a window step compares. ``max_radii2d``
# is a running maximum of an integer radius: its increments are sparse,
# so one radius that rounds across its ceiling weighs much (a torf seed
# read 5.3e-3 where its other 11 read 0); it is only reported.
COMPARED_STATS = ("xyz_grad_accum", "denom")


def model_state(model) -> dict:
    """The program's GaussianModelState as tensors by name."""
    return {"params": model.params._asdict(), "aux": model.aux._asdict(),
            "mu": model.adam.mu._asdict(), "nu": model.adam.nu._asdict(),
            "step": int(model.adam.step)}


def plain_state(model, deform, deform_adam) -> dict:
    """The program's state (its GaussianModelState, deform dict and deform
    AdamState) as tensors by name."""
    return dict(model_state(model), deform=dict(deform),
                dmu=dict(deform_adam.mu), dnu=dict(deform_adam.nu),
                dstep=int(deform_adam.step))


def _leaves(state: dict, which: str) -> Dict[str, torch.Tensor]:
    g, d = ("params", "deform") if which == "params" else ("mu", "dmu")
    out = {f"gauss.{k}": v for k, v in state[g].items()}
    out.update({f"deform.{k}": v for k, v in state[d].items()})
    return out


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def first_steps(trainer, n: int) -> dict:
    """Drive ``trainer`` through ``n`` steps, draining after each, and
    return each step's iteration, camera and loss, each leaf's first
    gradient norm and each leaf's change norm over the ``n`` steps."""
    def program_state():
        return plain_state(trainer.model, trainer.deform, trainer.deform_adam)

    start = _leaves(program_state(), "params")
    losses, cameras, its, grad = [], [], [], {}
    for k in range(n):
        trainer.step()
        trainer.drain()
        rec = trainer.history[-1]
        losses.append(float(rec["loss"]))
        cameras.append(int(rec["idx"]))
        its.append(int(rec["iteration"]))
        if k == 0:
            mu = _leaves(program_state(), "mu")
            grad = {name: _norm(v) / (1.0 - ADAM_B1) for name, v in mu.items()}
    end = _leaves(program_state(), "params")
    change = {name: _norm(end[name] - start[name]) for name in start}
    return {"loss": losses, "camera": cameras, "iteration": its,
            "grad": grad, "change": change}


def reduce_steps(start: dict, losses: List[float], states: List[dict]) -> dict:
    """The reference's steps reduced as ``first_steps`` reduces the
    program's."""
    s0 = _leaves(start, "params")
    mu = _leaves(states[0], "mu")
    end = _leaves(states[-1], "params")
    return {"loss": list(losses),
            "grad": {k: _norm(v) / (1.0 - ADAM_B1) for k, v in mu.items()},
            "change": {k: _norm(end[k] - s0[k]) for k in s0}}


def one_step(pre: dict, post: dict, loss: float) -> dict:
    """One step reduced: its loss, each leaf's gradient as Adam got it
    ((mu after - beta1 mu before) / (1 - beta1)), each leaf's change and
    each densification statistic's increment."""
    a, b = _leaves(pre, "mu"), _leaves(post, "mu")
    p0, p1 = _leaves(pre, "params"), _leaves(post, "params")
    return {"loss": [loss],
            "grad": {k: _norm((b[k].double() - ADAM_B1 * a[k].double())
                              / (1.0 - ADAM_B1)) for k in a},
            "change": {k: _norm(p1[k] - p0[k]) for k in p0},
            "stats": {k: _norm(post["aux"][k] - pre["aux"][k]) for k in STATS}}


def _median_positive(values) -> float:
    pos = [v for v in values if v > 0]
    return statistics.median(pos) if pos else 0.0


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              names: List[str]) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's
    (of the leaves whose reference norm is not zero)."""
    med = _median_positive(ref[k] for k in names)
    out = {}
    for k in names:
        den = max(ref[k], med)
        gap = abs(prog[k] - ref[k]) / den if den > 0 else abs(prog[k] - ref[k])
        out[k] = gap if math.isfinite(gap) else math.inf
    return out


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             names: List[str]) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(prog, ref, names).values(), default=0.0)


def _moving(ref: dict) -> List[str]:
    """The leaves whose reference gradient is not nought."""
    med = _median_positive(ref["grad"].values())
    return [k for k in sorted(ref["grad"]) if ref["grad"][k] >= NOUGHT * med]


def _loss_gap(prog: List[float], ref: List[float]) -> float:
    if not all(math.isfinite(x) for x in prog):
        return math.inf
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def step_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``loss_gap``: the largest relative gap of a step's loss;
    ``grad_gap``: the worst leaf's gap of the gradient's norm;
    ``change_gap``: the worst leaf's gap of the change's norm, over the
    leaves whose reference gradient is not nought (under ``NOUGHT`` of the
    median leaf's)."""
    return {
        "loss_gap": _loss_gap(prog["loss"], ref["loss"]),
        "grad_gap": leaf_gap(prog["grad"], ref["grad"], sorted(ref["grad"])),
        "change_gap": leaf_gap(prog["change"], ref["change"], _moving(ref)),
    }


def window_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """A window step's ``window_change_gap`` (as ``change_gap``) and, where
    the step keeps densification statistics, ``window_stats_gap``: the
    worse of ``COMPARED_STATS``'s relative gaps of their increments'
    norms. Its loss and its gradient worked out from the moments are not
    compared: their control readings lie within a few times of their sound
    ones (see PERF.md), so ``window_diagnostics`` only reports them."""
    out = {"window_change_gap": leaf_gap(prog["change"], ref["change"],
                                         _moving(ref))}
    if any(ref["stats"][k] > 0 for k in COMPARED_STATS):
        gaps = [abs(prog["stats"][k] - ref["stats"][k]) / ref["stats"][k]
                if ref["stats"][k] > 0 else abs(prog["stats"][k])
                for k in COMPARED_STATS]
        out["window_stats_gap"] = max(g if math.isfinite(g) else math.inf
                                      for g in gaps)
    return out


def window_diagnostics(prog: dict, ref: dict) -> dict:
    """The window step's loss gap, gradient gap, worst leaves and each
    statistic's increment (program, reference), for the record."""
    return {"loss_gap": _loss_gap(prog["loss"], ref["loss"]),
            "grad_gap": leaf_gap(prog["grad"], ref["grad"], sorted(ref["grad"])),
            "worst": worst_leaves(prog, ref),
            "stats": {k: (prog["stats"][k], r) for k, r in ref["stats"].items()}}


def worst_leaves(prog: dict, ref: dict) -> Dict[str, str]:
    """The leaf that sets ``grad_gap`` and the one that sets
    ``change_gap``, with its gap and its reference norm."""
    out = {}
    for key, names in (("grad", sorted(ref["grad"])),
                       ("change", _moving(ref))):
        gaps = leaf_gaps(prog[key], ref[key], names)
        if gaps:
            k = max(gaps, key=gaps.get)
            out[key] = f"{k} {gaps[k]:.3g} (reference {ref[key][k]:.4g})"
    return out


def frame_gap(prog: List[dict], ref: List[dict]) -> Dict[str, float]:
    """For colour, phasor and depth: the worst frame's relative L2 gap,
    ||program - reference|| / ||reference||."""
    out = {}
    for key in ("color", "phasor", "depth"):
        worst = 0.0
        for p, r in zip(prog, ref):
            p64, r64 = np.asarray(p[key], np.float64), np.asarray(r[key], np.float64)
            g = float(np.linalg.norm(p64 - r64) / max(np.linalg.norm(r64), 1e-30))
            worst = max(worst, g if math.isfinite(g) else math.inf)
        out[f"{key}_gap"] = worst
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number lies at or under its limit (a number without
    a limit, or one that is not finite, fails)."""
    return all(k in limits and math.isfinite(v) and v <= limits[k]
               for k, v in numbers.items())
