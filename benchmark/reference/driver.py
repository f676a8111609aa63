"""The plain reference of the cells, in plain PyTorch (``scene.py``,
``render.py``, ``step.py``, ``densify.py``). It imports nothing of the
program and takes nothing the program made: the scene from the files the
benchmark wrote, the start state from the benchmark's own tensors, and
where it follows the program's run (a step of the timed window, a densify
event) the state the program held before it, as tensors by name.

Float32 matrix products run in float32 (TF32 off)."""

from __future__ import annotations

from typing import Dict, List

import torch

from reference import densify, scene as plain_scene, step


def read_scene(path: str, cfg: dict, device):
    return plain_scene.read(path, cfg, device)


def start(params: Dict[str, torch.Tensor], aux: Dict[str, torch.Tensor],
          deform: Dict[str, torch.Tensor], adam_step: int) -> dict:
    """A state from the benchmark's start state: zero moments, both Adam
    counters at ``adam_step``."""
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    dzeros = {k: torch.zeros_like(v) for k, v in deform.items()}
    return {"params": dict(params), "aux": dict(aux), "mu": zeros,
            "nu": dict(zeros), "step": adam_step, "deform": dict(deform),
            "dmu": dzeros, "dnu": dict(dzeros), "dstep": adam_step}


def follow(cfg: dict, sc, state: dict, schedule: List[tuple], seed: int):
    """The steps ``schedule`` ((iteration, frame) each) from ``state``:
    returns each step's loss and the state after each."""
    step.no_tf32()
    losses, states = [], []
    for it, fid in schedule:
        state, loss = step.train_step(cfg, sc, state, it, fid, seed)
        losses.append(loss)
        states.append(state)
    return losses, states


def densify_numbers(pre: dict, post: dict, cfg: dict, sc, it: int):
    """The densify event at iteration ``it`` held against the rule."""
    reset = cfg["opacity_reset_interval"]
    if 0 < cfg.get("tof_iters", 0) < it:
        reset = int(reset / 2)
    return densify.numbers(pre, post, cfg, sc.extent, size_rule=it > reset)


def render(cfg: dict, sc, params: dict, deform: dict, alive, it: int,
           fids: List[int]) -> List[dict]:
    step.no_tf32()
    return [step.render_frame(cfg, sc, params, deform, alive, it, f)
            for f in fids]
