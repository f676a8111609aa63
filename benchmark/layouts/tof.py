"""The time-of-flight layouts: the F-ToRF quad capture (``write_dataset``)
and the ToRF real capture (``write_torf_capture``) of
``traffic/analytic.py``, which the config's ``scene["writer"]`` picks;
started as the configs' random init lays them out, in the ToF frustum;
held against the plain reference of ``reference/``. The layout of a
config file that names none."""

from __future__ import annotations

from harness import state
from traffic import analytic


def write(out_dir: str, writer: str, **params) -> None:
    getattr(analytic, writer)(out_dir, **params)


def start_bounds(cfg: dict, scene: dict):
    """The ToF frustum's bounds, the random init's box."""
    dr = scene["depth_range"]
    f = 0.9 * scene["width"]
    return state.frustum_bounds(f, f, scene["width"], scene["height"],
                                cfg.get("min_depth_fac", 0.05) * dr * 0.9,
                                cfg.get("max_depth_fac", 0.55) * dr * 1.1)


def start_state(cfg: dict, scene: dict, seed: int, capacity: int, step: int,
                device) -> state.StartState:
    return state.make_start_state(cfg, start_bounds(cfg, scene), seed,
                                  capacity, step, device)


def start_meta(cfg: dict, start: int) -> dict:
    """The Trainer's host state at iteration ``start`` as its own cadence
    leaves it: the SH degree raised every 1,000 iterations, and past
    ``tof_iters`` the colour loss on and the opacity reset interval
    halved."""
    flipped = 0 < cfg["tof_iters"] <= start
    interval = cfg["opacity_reset_interval"]
    return {"iteration": start,
            "active_sh_degree": min(start // 1000, cfg["sh_degree"]),
            "lambda_color": 1.0 if flipped else cfg["lambda_color"],
            "opacity_reset_interval": int(interval / 2) if flipped else interval}


def reference():
    from reference import driver

    return driver
