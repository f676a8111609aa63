"""The start state of a cell, made from ``--seed`` on the device, and the
files through which the program takes it.

The Gaussians are laid out as a config's random init lays them out (the
reader's ``_init_pcd_ftorf`` / ``_init_pcd_torf`` and ``init_from_pcd``):
``num_points`` uniform in the ToF frustum's bounds, all dynamic, colour,
phase and amplitude as the random init draws them, scales from the mean
squared distance to the three nearest neighbours, opacity
``initial_opacity``. The deform MLP's hidden layers are xavier-normal with
zero biases; its heads are xavier-normal scaled by ``HEAD_SCALE``, so that
the field moves the points as a trained one does. Adam's moments are zero
and its step is the start iteration.

Nothing here imports the program: the state is handed to it through the
files its own readers take (a Trainer checkpoint, or a trained model's
artifacts), and to the plain reference as tensors.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, NamedTuple

import numpy as np
import torch

SH_C0 = 0.28209479177387814
HEAD_SCALE = 0.1
# The fields of the program's GaussianParams and GaussianAux, in order.
PARAM_FIELDS = ("xyz", "sh_color", "sh_phase", "sh_amp", "scaling", "rotation",
                "opacity", "seg_color", "phase_offset", "dc_offset")
AUX_FIELDS = ("alive", "max_radii2d", "xyz_grad_accum", "denom")
HEADS = ("xyz", "rot", "r", "g", "b", "a")


class StartState(NamedTuple):
    params: Dict[str, torch.Tensor]  # PARAM_FIELDS, capacity rows
    aux: Dict[str, torch.Tensor]  # AUX_FIELDS
    deform: Dict[str, torch.Tensor]  # hidden.{i}.weight (out, in), heads.{h}.bias, ...
    n: int  # live rows (the first n)
    step: int  # Adam's step counter


def deform_widths(cfg: dict):
    """(hidden layer input widths, head output widths) of the config's
    deform MLP (models/deform.py: the skip re-feeds the embedded input to
    layer D/2 + 1)."""
    d, w = cfg["D"], cfg["W"]
    emb = 3 + 6 * cfg["xyz_multires"] + 1 + 2 * cfg["t_multires"]
    ins = [emb if i == 0 else (w + emb if i == d // 2 + 1 else w)
           for i in range(d)]
    m = (cfg["sh_degree"] + 1) ** 2
    heads = {"xyz": 3, "rot": 4, "r": m, "g": m, "b": m, "a": m}
    return ins, heads


def frustum_bounds(fx, fy, width, height, znear, zfar):
    """The readers' ``_frustum_bounds`` for one camera at the origin looking
    down +z (the analytic scenes' identity extrinsics), with its formula:
    the near plane's height from fov_y, the far plane's from fov_x."""
    fov_x = 2.0 * math.atan(width / (2.0 * fx))
    fov_y = 2.0 * math.atan(height / (2.0 * fy))
    aspect = width / height
    hnear = 2.0 * math.tan(fov_y / 2.0) * znear
    hfar = 2.0 * math.tan(fov_x / 2.0) * zfar
    corners = []
    for dist, hh, ww in ((znear, hnear, hnear * aspect),
                         (zfar, hfar, hfar * aspect)):
        for su in (1, -1):
            for sr in (1, -1):
                corners.append((sr * ww / 2.0, -su * hh / 2.0, dist))
    c = np.array(corners)
    return c.min(0), c.max(0)


def mean_knn_sq_dist(xyz: torch.Tensor, k: int = 3, block: int = 512):
    """Mean squared distance of each point to its ``k`` nearest others, by
    exact differences in blocks of rows."""
    out = torch.empty(xyz.shape[0], device=xyz.device)
    for i in range(0, xyz.shape[0], block):
        d2 = ((xyz[i:i + block, None, :] - xyz[None, :, :]) ** 2).sum(-1)
        rows = torch.arange(i, min(i + block, xyz.shape[0]), device=xyz.device)
        d2[rows - i, rows] = float("inf")
        out[i:i + block] = d2.topk(k, dim=1, largest=False).values.mean(1)
    return out


def make_start_state(cfg: dict, bounds, seed: int, capacity: int, step: int,
                     device) -> StartState:
    """The cell's start state from ``seed``: a few large draws from one
    generator on ``device``."""
    n = int(cfg["num_points"])
    m = (cfg["sh_degree"] + 1) ** 2
    g = torch.Generator(device=device).manual_seed(int(seed))
    lo = torch.as_tensor(bounds[0], dtype=torch.float32, device=device)
    hi = torch.as_tensor(bounds[1], dtype=torch.float32, device=device)
    u = torch.rand((n, 4), generator=g, device=device)
    xyz = lo + (hi - lo) * u[:, :3]
    phase = u[:, 3] * (2.0 * math.pi)
    torf = cfg["dataset_type"] == "real"
    colour = 0.5 if torf else 1.0  # torf: grey; F-ToRF: the seg colour

    def rows(*shape):
        return torch.zeros((capacity,) + shape, device=device)

    sh_color = rows(m, 3)
    sh_color[:n, 0, :] = (torch.tensor([colour, 0.5 if torf else 0.0,
                                        0.5 if torf else 0.0],
                                       device=device) - 0.5) / SH_C0
    sh_phase, sh_amp = rows(m), rows(m)
    sh_phase[:n, 0] = (phase - 0.5) / SH_C0
    sh_amp[:n, 0] = (cfg.get("initial_amplitude", 0.1) - 0.5) / SH_C0
    d2 = mean_knn_sq_dist(xyz)
    scaling = rows(3)
    scaling[:n] = torch.log(torch.sqrt(d2.clamp(min=1e-7)))[:, None]
    rotation = rows(4)
    rotation[:n, 0] = 1.0
    opacity = rows(1)
    o = float(cfg["initial_opacity"])
    opacity[:n] = math.log(o / (1.0 - o))
    seg = rows(3)
    seg[:n, 0] = 1.0
    params = dict(xyz=torch.cat([xyz, xyz.new_zeros((capacity - n, 3))]),
                  sh_color=sh_color, sh_phase=sh_phase, sh_amp=sh_amp,
                  scaling=scaling, rotation=rotation, opacity=opacity,
                  seg_color=seg,
                  phase_offset=torch.zeros((1,), device=device),
                  dc_offset=torch.zeros((1,), device=device))
    aux = dict(alive=torch.arange(capacity, device=device) < n,
               max_radii2d=rows(), xyz_grad_accum=rows(), denom=rows())

    ins, heads = deform_widths(cfg)
    width = cfg["W"]
    total = sum(i * width for i in ins) + sum(width * o for o in heads.values())
    z = torch.randn((total,), generator=g, device=device)
    deform, pos = {}, 0
    for i, fan_in in enumerate(ins):
        w = z[pos:pos + fan_in * width].view(width, fan_in)
        deform[f"hidden.{i}.weight"] = w * math.sqrt(2.0 / (fan_in + width))
        deform[f"hidden.{i}.bias"] = torch.zeros((width,), device=device)
        pos += fan_in * width
    for h, out in heads.items():
        w = z[pos:pos + out * width].view(out, width)
        deform[f"heads.{h}.weight"] = w * (HEAD_SCALE
                                           * math.sqrt(2.0 / (width + out)))
        deform[f"heads.{h}.bias"] = torch.zeros((out,), device=device)
        pos += out * width
    return StartState(params=params, aux=aux, deform=deform, n=n, step=step)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _deform_leaves(d: Dict[str, torch.Tensor], depth: int):
    """The JAX DeformParams leaves, flattened: hidden weights (in, out),
    hidden biases, then head weights and head biases in sorted head
    order."""
    out = [_np(d[f"hidden.{i}.weight"]).T for i in range(depth)]
    out += [_np(d[f"hidden.{i}.bias"]) for i in range(depth)]
    out += [_np(d[f"heads.{h}.weight"]).T for h in sorted(HEADS)]
    out += [_np(d[f"heads.{h}.bias"]) for h in sorted(HEADS)]
    return out


def write_checkpoint(path: str, s: StartState, depth: int, meta: dict) -> None:
    """The state as a Trainer checkpoint: the leaves of {"deform",
    "deform_adam", "model"} in ``jax.tree.flatten`` order, as
    ``utils/checkpoint.py::save_pytree`` lays them out, and the meta."""
    zeros_d = {k: torch.zeros_like(v) for k, v in s.deform.items()}
    step = np.array(s.step, np.int32)
    leaves = _deform_leaves(s.deform, depth)
    leaves += _deform_leaves(zeros_d, depth) * 2 + [step]
    leaves += [_np(s.params[k]) for k in PARAM_FIELDS]
    leaves += [_np(s.aux[k]) for k in AUX_FIELDS]
    zeros = [np.zeros(s.params[k].shape, np.float32) for k in PARAM_FIELDS]
    leaves += zeros + zeros + [step]
    arrays = {f"leaf_{i}": a for i, a in enumerate(leaves)}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **arrays)


def write_ply(path: str, props: Dict[str, np.ndarray]) -> None:
    """A binary little-endian vertex-only PLY of float32 properties."""
    names = list(props)
    n = len(props[names[0]])
    rec = np.empty(n, dtype=[(k, np.float32) for k in names])
    for k in names:
        rec[k] = props[k]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        head = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
        head += [f"property float {k}" for k in names] + ["end_header"]
        f.write(("\n".join(head) + "\n").encode("ascii"))
        rec.tofile(f)


def write_artifacts(model_dir: str, s: StartState, cfg: dict, iteration: int,
                    depth: int) -> None:
    """The state's live rows as a trained model's artifacts, in the layout
    ``render_sets.load_trained`` reads: ``cfg_args_full.json`` and
    ``point_cloud/iteration_N/{point_cloud_full.ply, phase_offset.npy,
    dc_offset.npy, deform_model.npz}`` (the reference's save_ply names)."""
    art = os.path.join(model_dir, "point_cloud", f"iteration_{iteration}")
    os.makedirs(art, exist_ok=True)
    with open(os.path.join(model_dir, "cfg_args_full.json"), "w") as f:
        json.dump(cfg, f, indent=1)
    p = {k: _np(v[:s.n]) for k, v in s.params.items()
         if k not in ("phase_offset", "dc_offset")}
    m = p["sh_color"].shape[1]
    props = {"x": p["xyz"][:, 0], "y": p["xyz"][:, 1], "z": p["xyz"][:, 2]}
    for i in range(3):
        props[f"f_dc_{i}"] = p["sh_color"][:, 0, i]
    rest = p["sh_color"][:, 1:, :].transpose(0, 2, 1).reshape(s.n, -1)
    for i in range(rest.shape[1]):
        props[f"f_rest_{i}"] = rest[:, i]
    for name in ("phase", "amp"):
        props[f"{name}_f_dc_0"] = p[f"sh_{name}"][:, 0]
        for i in range(m - 1):
            props[f"{name}_f_rest_{i}"] = p[f"sh_{name}"][:, i + 1]
    props["opacity"] = p["opacity"][:, 0]
    for i in range(p["scaling"].shape[1]):
        props[f"scale_{i}"] = p["scaling"][:, i]
    for i in range(4):
        props[f"rot_{i}"] = p["rotation"][:, i]
    for i in range(3):
        props[f"f_seg_color_{i}"] = p["seg_color"][:, i]
    write_ply(os.path.join(art, "point_cloud_full.ply"), props)
    np.save(os.path.join(art, "phase_offset.npy"), _np(s.params["phase_offset"]))
    np.save(os.path.join(art, "dc_offset.npy"), _np(s.params["dc_offset"]))
    leaves = _deform_leaves(s.deform, depth)
    np.savez(os.path.join(art, "deform_model.npz"),
             **{f"leaf_{i}": a for i, a in enumerate(leaves)})
