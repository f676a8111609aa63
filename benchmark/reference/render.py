"""A plain renderer of Gaussians with time-of-flight channels: the
published 3D Gaussian splatting rasterizer's semantics (project, EWA
covariance, the 3-sigma screen radius and its block cover, front-to-back
alpha compositing with the 1/255 alpha floor, the 0.99 alpha cap and the
1e-4 transmittance stop), with the ToF phasor composited by the squared
transmittance (the light goes out and back) and scene flow by weights
that carry no gradient.

Every pixel composites, in order of view depth, every Gaussian whose
screen block cover holds the pixel's block. Pixels are taken a few rows
and columns at a time only to bound the memory of the pairs; the
Gaussians that cannot reach a group are left out of it, which changes no
pixel. A render's gradient comes in two passes: the images first (no
graph), then the loss's gradient at each pixel is carried back through
the same pairs, group by group, to the Gaussians' projected quantities,
and from there through the projection by autograd."""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)
ALPHA_FLOOR = 1.0 / 255.0
ALPHA_CAP = 0.99
T_STOP = 1e-4
LOWPASS = 0.3
# Pairs of (pixel, Gaussian) held at once.
PAIR_BUDGET = 1 << 24


def sh_eval(degree: int, coeffs: torch.Tensor, dirs: torch.Tensor):
    """(P, C) values of (P, M, C) real SH coefficients at (P, 3) unit
    directions, up to ``degree``."""
    x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    basis = [torch.full_like(x, SH_C0)]
    if degree > 0:
        basis += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree > 1:
        xx, yy, zz = x * x, y * y, z * z
        basis += [SH_C2[0] * x * y, SH_C2[1] * y * z,
                  SH_C2[2] * (2.0 * zz - xx - yy), SH_C2[3] * x * z,
                  SH_C2[4] * (xx - yy)]
    if degree > 2:
        basis += [SH_C3[0] * y * (3.0 * xx - yy), SH_C3[1] * x * y * z,
                  SH_C3[2] * y * (4.0 * zz - xx - yy),
                  SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                  SH_C3[4] * x * (4.0 * zz - xx - yy),
                  SH_C3[5] * z * (xx - yy), SH_C3[6] * x * (xx - 3.0 * yy)]
    b = torch.stack(basis, -1)  # (P, k)
    return (coeffs[:, :b.shape[1], :] * b[:, :, None]).sum(1)


def projection(cam) -> torch.Tensor:
    """(4, 4) clip-from-world matrix: the perspective frustum of the
    camera's intrinsics (principal point shifted), z mapped to [0, 1],
    times its world-to-camera matrix."""
    n, f = cam.znear, cam.zfar
    tan_x = cam.width / (2.0 * cam.fx)
    tan_y = cam.height / (2.0 * cam.fy)
    ox = (cam.cx - cam.width / 2.0) / cam.fx * n
    oy = (cam.cy - cam.height / 2.0) / cam.fy * n
    left, right = -tan_x * n + ox, tan_x * n + ox
    bottom, top = -tan_y * n + oy, tan_y * n + oy
    P = torch.zeros((4, 4), dtype=torch.float64)
    P[0, 0] = 2.0 * n / (right - left)
    P[1, 1] = 2.0 * n / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = f / (f - n)
    P[2, 3] = -(f * n) / (f - n)
    V = cam.view.double().cpu()
    return (P @ V).float().to(cam.view.device)


class Projected(NamedTuple):
    """What the compositor reads of each Gaussian."""

    valid: torch.Tensor  # (P,) bool
    depth: torch.Tensor  # (P,) view z, the order
    mean: torch.Tensor  # (P, 2) pixels
    conic: torch.Tensor  # (P, 3) a, b, c of the inverse screen covariance
    opacity: torch.Tensor  # (P,)
    rgb: torch.Tensor  # (P, 3)
    dist: torch.Tensor  # (P,) distance to the camera (and light)
    phasor: torch.Tensor  # (P, 7)
    flow: Optional[torch.Tensor]  # (P, 6)
    radius: torch.Tensor  # (P,) pixels, 0 where not valid
    cover: torch.Tensor  # (P, 4) int: block columns [x0, x1), rows [y0, y1)


def project(means, scales, quats, opacity, shs, shs_p, offset_ndc, cam,
            degree: int, depth_range: float, phase_offset: float,
            dc_offset: float, block, flow=None) -> Projected:
    """Project Gaussians (unit quaternions ``quats``) into ``cam``.
    ``offset_ndc`` is added to the screen means in normalised device
    coordinates (the gradient there is the densification signal)."""
    V = cam.view
    R, t = V[:3, :3], V[:3, 3]
    pv = means @ R.T + t
    z = pv[:, 2]
    in_frustum = (z >= cam.znear) & (z <= cam.zfar)
    pv = torch.where(in_frustum[:, None], pv, torch.ones_like(pv))
    full = projection(cam)
    ph = means @ full[:, :3].T + full[:, 3]
    w = torch.where(in_frustum, ph[:, 3] + 1e-7, torch.ones_like(z))
    ndc = ph[:, :2] * (1.0 / w)[:, None] + offset_ndc
    size = torch.tensor([cam.width, cam.height], dtype=ndc.dtype,
                        device=ndc.device)
    mean = ((ndc + 1.0) * size - 1.0) * 0.5

    # Sigma = (R(q) S)(R(q) S)^T, then J W Sigma W^T J^T + low-pass.
    r, x, y, zq = quats[:, 0], quats[:, 1], quats[:, 2], quats[:, 3]
    Rq = torch.stack([
        torch.stack([1 - 2 * (y * y + zq * zq), 2 * (x * y - r * zq),
                     2 * (x * zq + r * y)], -1),
        torch.stack([2 * (x * y + r * zq), 1 - 2 * (x * x + zq * zq),
                     2 * (y * zq - r * x)], -1),
        torch.stack([2 * (x * zq - r * y), 2 * (y * zq + r * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)
    M = Rq * scales[:, None, :]
    sigma = M @ M.transpose(1, 2)
    tz = pv[:, 2]
    lim_x = 1.3 * cam.width / (2.0 * cam.fx)
    lim_y = 1.3 * cam.height / (2.0 * cam.fy)
    tx = torch.clamp(pv[:, 0] / tz, -lim_x, lim_x) * tz
    ty = torch.clamp(pv[:, 1] / tz, -lim_y, lim_y) * tz
    row0 = (cam.fx / tz)[:, None] * R[0] - (cam.fx * tx / (tz * tz))[:, None] * R[2]
    row1 = (cam.fy / tz)[:, None] * R[1] - (cam.fy * ty / (tz * tz))[:, None] * R[2]
    s0 = (sigma @ row0[:, :, None])[:, :, 0]
    s1 = (sigma @ row1[:, :, None])[:, :, 0]
    ca = (row0 * s0).sum(-1) + LOWPASS
    cb = (row0 * s1).sum(-1)
    cc = (row1 * s1).sum(-1) + LOWPASS
    det = ca * cc - cb * cb
    inv = 1.0 / torch.where(det == 0.0, torch.ones_like(det), det)
    conic = torch.stack([cc * inv, -cb * inv, ca * inv], -1)
    mid = 0.5 * (ca + cc)
    radius = torch.ceil(3.0 * torch.sqrt(
        mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))))

    bh, bw = block
    gw, gh = -(-cam.width // bw), -(-cam.height // bh)
    m, rd = mean.detach(), radius.detach()
    x0 = torch.clamp(torch.floor((m[:, 0] - rd) / bw), 0, gw)
    y0 = torch.clamp(torch.floor((m[:, 1] - rd) / bh), 0, gh)
    x1 = torch.clamp(torch.floor((m[:, 0] + rd + bw - 1) / bw), 0, gw)
    y1 = torch.clamp(torch.floor((m[:, 1] + rd + bh - 1) / bh), 0, gh)
    cover = torch.stack([x0, x1, y0, y1], -1).long()
    valid = (in_frustum & (det != 0.0) & ((x1 - x0) * (y1 - y0) > 0)
             & (opacity > 0.0))

    cpos = -(R.T @ t)
    d = means - cpos
    dirs = d * torch.rsqrt((d * d).sum(-1, keepdim=True) + 1e-20)
    rgb = torch.clamp(sh_eval(degree, shs, dirs) + 0.5, min=0.0)
    amp = torch.clamp(sh_eval(degree, shs_p, dirs)[:, 1] + 0.5, min=0.0)
    dist = torch.linalg.vector_norm(pv, dim=-1)
    phase = dist * (4.0 * math.pi / depth_range) + phase_offset
    af = amp / (dist * dist)
    c, s = torch.cos(phase), torch.sin(phase)
    phasor = torch.stack([c * af, s * af, af, (c + dc_offset) * af,
                          (-c + dc_offset) * af, (s + dc_offset) * af,
                          (-s + dc_offset) * af], -1)
    return Projected(valid, z.detach(), mean, conic, opacity, rgb, dist,
                     phasor, flow, torch.where(valid, radius, 0.0).detach(),
                     cover)


FEATURES = ("mean", "conic", "opacity", "rgb", "dist", "phasor", "flow")


def _pairs(g: Dict[str, torch.Tensor], cover, px, py, block):
    """The images of the pixels (px, py) from the depth-ordered Gaussians
    ``g`` (this group's candidates) and the count of pixels each one
    reached."""
    if not cover.shape[0]:
        z = px.new_zeros((px.shape[0],), dtype=torch.float32)
        out = {"rgb": z[:, None].expand(-1, 3), "dist": z[:, None],
               "phasor": z[:, None].expand(-1, 7), "t_final": z + 1.0}
        if g.get("flow") is not None:
            out["flow"] = z[:, None].expand(-1, 6)
        return out, cover.new_zeros((0,))
    bh, bw = block
    bx = torch.div(px, bw, rounding_mode="floor")[:, None]
    by = torch.div(py, bh, rounding_mode="floor")[:, None]
    holds = ((cover[:, 0] <= bx) & (bx < cover[:, 1])
             & (cover[:, 2] <= by) & (by < cover[:, 3]))
    dx = g["mean"][:, 0] - px[:, None].float()
    dy = g["mean"][:, 1] - py[:, None].float()
    a, b, c = g["conic"][:, 0], g["conic"][:, 1], g["conic"][:, 2]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = torch.clamp(g["opacity"] * torch.exp(torch.clamp(power, max=0.0)),
                        max=ALPHA_CAP)
    ok = holds & (power <= 0.0) & (alpha >= ALPHA_FLOOR)
    q = 1.0 - torch.where(ok, alpha, 0.0)
    t_incl = torch.cumprod(q, 1)
    t_excl = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], 1)
    takes = ok & (t_incl >= T_STOP)
    w = torch.where(takes, alpha * t_excl, 0.0)
    out = {"rgb": w @ g["rgb"], "dist": w @ g["dist"][:, None],
           "phasor": (w * t_excl) @ g["phasor"],
           "t_final": torch.where(takes, t_incl, 1.0).amin(1)}
    if g.get("flow") is not None:
        out["flow"] = w.detach() @ g["flow"]
    return out, takes.sum(0)


def _groups(pr: Projected, order, width: int, height: int, block):
    """Groups of pixels (a few rows by a few columns) with the positions,
    in ``order``, of the Gaussians that can reach them."""
    bh, bw = block
    cover = pr.cover[order]
    rows = bh
    cols = bw * 2
    for y0 in range(0, height, rows):
        y1 = min(height, y0 + rows)
        for x0 in range(0, width, cols):
            x1 = min(width, x0 + cols)
            near = ((cover[:, 0] <= (x1 - 1) // bw) & (cover[:, 1] > x0 // bw)
                    & (cover[:, 2] <= (y1 - 1) // bh) & (cover[:, 3] > y0 // bh))
            pos = torch.nonzero(near).flatten()
            ys, xs = torch.meshgrid(
                torch.arange(y0, y1, device=order.device),
                torch.arange(x0, x1, device=order.device), indexing="ij")
            py, px = ys.flatten(), xs.flatten()
            step = max(1, PAIR_BUDGET // max(1, pos.numel()))
            for k in range(0, px.numel(), step):
                yield pos, cover[pos], px[k:k + step], py[k:k + step]


def _sorted_features(pr: Projected, order, leaves: bool):
    g = {}
    for k in FEATURES:
        v = getattr(pr, k)
        if v is None:
            continue
        v = v[order]
        g[k] = v.detach().requires_grad_(True) if leaves else v.detach()
    return g


class Render(NamedTuple):
    color: torch.Tensor  # (3, H, W), background included
    phasor: torch.Tensor  # (7, H, W), background included
    depth: torch.Tensor  # (1, H, W)
    flow: Optional[torch.Tensor]  # (6, H, W)
    pixels: torch.Tensor  # (P,) pixels each Gaussian reached
    radius: torch.Tensor  # (P,)


def composite(pr: Projected, cam, bg: torch.Tensor, block) -> Render:
    """The images of a projection over the (7, H, W) background ``bg``
    (colour from its first 3 channels, the phasor from all 7), without a
    graph."""
    W, H = cam.width, cam.height
    order = torch.nonzero(pr.valid).flatten()
    order = order[torch.argsort(pr.depth[order], stable=True)]
    g = _sorted_features(pr, order, leaves=False)
    dev = bg.device
    color = torch.zeros((3, H * W), device=dev)
    phasor = torch.zeros((7, H * W), device=dev)
    depth = torch.zeros((1, H * W), device=dev)
    flow = torch.zeros((6, H * W), device=dev) if pr.flow is not None else None
    counts = torch.zeros(order.numel(), device=dev)
    bgf = bg.reshape(7, -1)
    with torch.no_grad():
        for pos, cover, px, py in _groups(pr, order, W, H, block):
            out, n = _pairs({k: v[pos] for k, v in g.items()}, cover, px, py,
                            block)
            pix = py * W + px
            tf = out["t_final"]
            color[:, pix] = (out["rgb"] + tf[:, None] * bgf[:3, pix].T).T
            phasor[:, pix] = (out["phasor"] + tf[:, None] * bgf[:, pix].T).T
            depth[:, pix] = out["dist"].T
            if flow is not None:
                flow[:, pix] = out["flow"].T
            counts.index_add_(0, pos, n.float())
    pixels = torch.zeros(pr.valid.shape[0], device=dev)
    pixels[order] = counts
    return Render(color.reshape(3, H, W), phasor.reshape(7, H, W),
                  depth.reshape(1, H, W),
                  None if flow is None else flow.reshape(6, H, W), pixels,
                  pr.radius)


def backward(pr: Projected, cam, bg: torch.Tensor, block,
             grads: Dict[str, torch.Tensor]):
    """Carry the loss's gradient at each pixel (``grads``: ``color``,
    ``phasor``, ``flow`` images, any of them left out) back to the
    projected quantities of ``pr``: returns those that need a gradient
    and their gradients, for one ``torch.autograd.backward`` over every
    render of a step."""
    W, H = cam.width, cam.height
    order = torch.nonzero(pr.valid).flatten()
    order = order[torch.argsort(pr.depth[order], stable=True)]
    g = _sorted_features(pr, order, leaves=True)
    bgf = bg.reshape(7, -1)
    flat = {k: v.reshape(v.shape[0], -1) for k, v in grads.items()}
    for pos, cover, px, py in _groups(pr, order, W, H, block):
        out, _ = _pairs({k: v[pos] for k, v in g.items()}, cover, px, py,
                        block)
        pix = py * W + px
        tf = out["t_final"][:, None]
        outs, cots = [], []
        if "color" in flat:
            outs.append(out["rgb"] + tf * bgf[:3, pix].T)
            cots.append(flat["color"][:, pix].T)
        if "phasor" in flat:
            outs.append(out["phasor"] + tf * bgf[:, pix].T)
            cots.append(flat["phasor"][:, pix].T)
        if "flow" in flat and "flow" in out:
            outs.append(out["flow"])
            cots.append(flat["flow"][:, pix].T)
        if outs and pos.numel():
            torch.autograd.backward(outs, cots)
    tensors, cots = [], []
    for k, v in g.items():
        src = getattr(pr, k)
        if v.grad is not None and src.requires_grad:
            full = torch.zeros_like(src)
            full[order] = v.grad
            tensors.append(src)
            cots.append(full)
    return tensors, cots
