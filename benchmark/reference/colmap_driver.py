"""The plain reference of the ``colmap`` layout's cells: 3D Gaussian
Splatting's colour-only training step, in plain PyTorch, from a state of
tensors (``reference/driver.py``'s state dict).

A step: the Gaussians rendered from the view over a black background
(``render.py``: project, then every pixel composited in depth order over
the Gaussians whose block cover holds it, in groups of pixels of one
block row, so that millions of Gaussians at 1297x840 fit); the loss
0.8 * L1 + 0.2 * (1 - SSIM) of the colour image to the view's; its
gradient by autograd; the densification statistics (the screen means'
gradient norm and the pixels each Gaussian reached); Adam
(``step.adam``) on every leaf at the rates of ``step.Settings``, dead rows
getting no gradient. A densify event is held against ``densify.py``.
TF32 is off. Under the control (``reference/lower.py``'s ``tf32_matmuls``
active) on a card, the steps take the card's own TF32 products in its
place (``_products``).

Where this departs from 3DGS's published description, it follows the
program's configuration, which is GF-ToRF's:

- each loss term and statistic is weighted as above, but the densification
  statistic counts a Gaussian once per pixel it reached (GF-ToRF's
  ``xyz_grad_accum += |grad| * pixels``, ``denom += pixels``) where 3DGS
  counts it once per view;
- the prune at a densify event after the first opacity reset is GF-ToRF's
  world-size rule (a largest scale over 0.05 or under 0.001 of the
  extent); 3DGS prunes a screen radius over 20 pixels and a scale over 0.1
  of the extent;
- the position's learning rate decays from the step itself, with no delay
  (3DGS's delay multiplier of 0.01 acts only over delay steps it sets to
  0), and the SH degree is the configuration's at every step;
- the Gaussians carry GF-ToRF's phasor features, which the colour loss
  never reads: their gradient is zero and Adam leaves them unchanged.

Each function prints its seconds to standard error."""

from __future__ import annotations

import sys
import time
from contextlib import contextmanager
from typing import List

import torch
from torch.utils._python_dispatch import (_get_current_dispatch_mode,
                                          _pop_mode_temporarily)

from reference import colmap_scene, densify, step
from reference import render as raster
from reference.lower import tf32_matmuls
from reference.driver import start  # noqa: F401  (the layout's ``start``)


def read_scene(path: str, cfg: dict, device):
    t0 = time.perf_counter()
    sc = colmap_scene.read(path, cfg, device)
    _took("read_scene", t0)
    return sc


def _took(what: str, t0: float) -> None:
    print(f"reference {what}: {time.perf_counter() - t0:.3f} s",
          file=sys.stderr)


def _draw(cfg: dict, sc, params, alive, st, cam, offset):
    """The projection of the Gaussians in ``cam`` and its render over
    black."""
    n = params["xyz"].shape[0]
    m = (cfg["sh_degree"] + 1) ** 2
    dev = params["xyz"].device
    gs = step.gaussians(st, params, torch.zeros((n, 3), device=dev),
                        torch.zeros((n, m, 3), device=dev), alive)
    block = step.block_of(cfg)
    pr = raster.project(*gs, offset, cam, st.degree, sc.depth_range, 0.0,
                        0.0, block)
    bg = torch.zeros((7, cam.height, cam.width), device=dev)
    return pr, bg, raster.composite(pr, cam, bg, block)


def loss_and_grads(cfg: dict, sc, state: dict, it: int, fid: int):
    """The loss of one step and the gradients of ``gauss.<name>`` and of
    ``means2d``, with the render's ``pixels`` and ``radius``."""
    st = step.Settings(cfg, sc, it)
    frame = sc.frames[fid]
    params = {k: v.detach().requires_grad_(True)
              for k, v in state["params"].items()}
    alive = state["aux"]["alive"]
    n = params["xyz"].shape[0]
    offset = torch.zeros((n, 2), device=params["xyz"].device,
                         requires_grad=True)
    pr, bg, r = _draw(cfg, sc, params, alive, st, frame.color, offset)
    col = r.color.clone().requires_grad_(True)
    l1 = (col - frame.image).abs().mean()
    loss = st.w_color * ((1.0 - st.dssim) * l1
                         + st.dssim * (1.0 - step.ssim(col, frame.image)))
    (g_col,) = torch.autograd.grad(loss, [col])
    tensors, cots = raster.backward(pr, frame.color, bg, step.block_of(cfg),
                                    {"color": g_col})
    if tensors:
        torch.autograd.backward(tensors, cots)
    grads = {k: v.grad if v.grad is not None else torch.zeros_like(v)
             for k, v in params.items()}
    g_means = offset.grad if offset.grad is not None else torch.zeros_like(offset)
    return float(loss.detach()), grads, g_means, r.pixels, r.radius, st


def train_step(cfg: dict, sc, state: dict, it: int, fid: int):
    """One iteration on ``state``; returns (new state, loss)."""
    loss, grads, g_means, pixels, radius, st = loss_and_grads(cfg, sc, state,
                                                              it, fid)
    out = dict(state)
    with torch.no_grad():
        aux = state["aux"]
        alive = aux["alive"]
        seen = radius > 0
        gnorm = torch.linalg.vector_norm(g_means, dim=-1)
        out["aux"] = dict(
            aux,
            max_radii2d=torch.where(seen, torch.maximum(aux["max_radii2d"],
                                                        radius),
                                    aux["max_radii2d"]),
            xyz_grad_accum=torch.where(seen, aux["xyz_grad_accum"]
                                       + gnorm * pixels, aux["xyz_grad_accum"]),
            denom=torch.where(seen, aux["denom"] + pixels, aux["denom"]))
        g = {}
        for k, gk in grads.items():
            if gk.ndim and gk.shape[0] == alive.shape[0]:
                keep = alive.reshape((-1,) + (1,) * (gk.ndim - 1))
                gk = torch.where(keep, gk, 0.0)
            g[k] = gk
        out["params"], out["mu"], out["nu"], out["step"] = step.adam(
            state["params"], g, state["mu"], state["nu"], state["step"],
            st.lrs)
    return out, loss


def follow(cfg: dict, sc, state: dict, schedule: List[tuple], seed: int):
    """The steps ``schedule`` ((iteration, training view) each) from
    ``state``: each step's loss and the state after each. The background
    is black, so ``seed`` draws nothing."""
    t0 = time.perf_counter()
    losses, states = [], []
    with _products(state["params"]["xyz"].device):
        for it, fid in schedule:
            state, loss = train_step(cfg, sc, state, it, fid)
            losses.append(loss)
            states.append(state)
    _took(f"follow ({len(schedule)} steps)", t0)
    return losses, states


@contextmanager
def _products(device):
    """float32 matrix products; under the control on a card, the card's
    TF32 products (``allow_tf32``: each float32 input rounded to TF32, the
    sums in float32) in place of the mode, which rounds the same inputs
    in Python around every product and is far too slow at millions of
    Gaussians (one step's backward did not end in 5 minutes). Elsewhere
    the mode, if any, stays."""
    step.no_tf32()
    if device.type != "cuda" or not isinstance(_get_current_dispatch_mode(),
                                               tf32_matmuls):
        yield
        return
    with _pop_mode_temporarily():
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            step.no_tf32()


def densify_numbers(pre: dict, post: dict, cfg: dict, sc, it: int):
    """The densify event at iteration ``it`` held against the rule (its
    world-size prune once past the first opacity reset)."""
    t0 = time.perf_counter()
    out = densify.numbers(pre, post, cfg, sc.extent,
                          size_rule=it > cfg["opacity_reset_interval"])
    _took("densify_numbers", t0)
    return out


def render(cfg: dict, sc, params: dict, deform: dict, alive, it: int,
           fids: List[int]) -> List[dict]:
    """Served frames: each training view's colour over black at the full SH
    degree (``deform`` is unused: the layout's Gaussians are static)."""
    step.no_tf32()
    zero = torch.zeros((params["xyz"].shape[0], 2), device=params["xyz"].device)
    out = []
    with torch.no_grad():
        for f in fids:
            st = step.Settings(cfg, sc, it)
            st.degree = cfg["sh_degree"]
            r = _draw(cfg, sc, params, alive, st, sc.frames[f].color, zero)[2]
            out.append({"color": r.color.cpu().numpy()})
    return out
