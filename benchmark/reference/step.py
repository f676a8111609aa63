"""A plain training step and frame render of GF-ToRF, from a state of
tensors.

The state is a dict: ``params``, ``aux``, ``mu``, ``nu`` (dicts by the
parameter names), ``step`` (Adam's shared counter), ``deform``,
``dmu``, ``dnu``, ``dstep`` (the deform MLP's weights by name and its
Adam). What the step does, in the published training loop's order and
with the configuration's settings:

- the deform MLP (positional encodings of the normalised position and the
  time, D ReLU layers of width W with the input fed again after layer
  D/2, linear heads) moves the live dynamic Gaussians once past
  ``warm_up``: F-ToRF lerps between the two integration frames around
  the frame, ToRF takes the frame's own time and colour deltas; each
  move is cut to ``deform_clip`` of the scene's extent;
- the render (``render.py``) over a random background, the loss of the
  configuration (the ToF term on the frame's quad or on the phasor's
  first channels, the colour term where it is on, each an L1 or L2 mixed
  with 1 - SSIM by ``lambda_dssim``; F-ToRF's flow term on integration
  frames), its gradient by autograd;
- the densification statistics, Adam on the Gaussians (per-leaf rates
  and schedules; dead rows get no gradient), the deform MLP's gradient cut
  to a global norm of 1 and its Adam, paused for 200 iterations after each
  opacity reset.

``deform_clip`` is the program's trust region on the deformation (its
default, 0.5, where the configuration does not set it)."""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from reference import render

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-15
PARAMS = ("xyz", "sh_color", "sh_phase", "sh_amp", "scaling", "rotation",
          "opacity", "seg_color", "phase_offset", "dc_offset")


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def f32_div(a: int, b: int) -> float:
    return float(torch.tensor(float(a), dtype=torch.float32)
                 / torch.tensor(float(b), dtype=torch.float32))


def expon_lr(it: float, lr_init: float, lr_final: float, steps: int) -> float:
    """The log-linear schedule from ``lr_init`` to ``lr_final`` over
    ``steps``."""
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    if it < 0:
        return 0.0
    t = min(max(it / max(steps, 1), 0.0), 1.0)
    return math.exp(math.log(max(lr_init, 1e-38)) * (1.0 - t)
                    + math.log(max(lr_final, 1e-38)) * t)


class Settings:
    """What the configuration and the iteration make of a step."""

    def __init__(self, cfg: dict, scene, it: int):
        self.cfg, self.it = cfg, it
        get = cfg.get
        self.kind = scene.kind
        self.extent = scene.extent
        warm = get("warm_up", 3000)
        self.dynamic = bool(get("dynamic", False)) and it > warm
        self.frozen = it >= get("densify_until_iter", 15000)
        self.dynamic_only = scene.kind == "torf"
        tof_iters = get("tof_iters", 0)
        lam_c = get("lambda_color", 1.0)
        self.color_on = lam_c != 0.0 or 0 < tof_iters < get("iterations", 30000)
        self.w_color = 1.0 if tof_iters > 0 and it > tof_iters else lam_c
        self.w_tof = get("lambda_tof", 1.0)
        self.dssim = get("lambda_dssim", 0.2)
        lam_f = get("lambda_flow", 0.01)
        self.flow_on = scene.kind == "ftorf" and lam_f != 0.0 and self.dynamic
        fstart = get("flow_loss_iter_start", 0)
        self.w_flow = lam_f if not (fstart > 0 and it <= fstart) else 0.0
        self.use_quad = bool(get("use_quad", False))
        self.channels = get("num_phasor_channels", 2)
        self.degree = min(it // 1000, get("sh_degree", 3))
        self.clip = get("deform_clip", 0.5) * scene.extent
        reset = get("opacity_reset_interval", 3000)
        if tof_iters > 0 and it > tof_iters:
            reset //= 2
        self.deform_on = it % reset > 200 or self.frozen
        for key in ("use_wl1c", "use_wl1p", "lambda_depth", "lambda_dd",
                    "use_opacity_entropy_loss", "use_scale_loss",
                    "lambda_mlp_reg", "optimize_phase_offset",
                    "optimize_dc_offset", "use_view_dependent_phase"):
            if get(key, 0):
                raise ValueError(f"{key} is not in the plain reference")
        if 0 < get("optimize_sync_iters", -1):
            raise ValueError("optimize_sync_iters is not in the plain reference")
        ext, s = scene.extent, cfg
        m = (get("sh_degree", 3) + 1) ** 2
        self.lrs = {
            "xyz": expon_lr(it, s["position_lr_init"] * ext,
                            s["position_lr_final"] * ext,
                            get("position_lr_max_steps", 30000)),
            "sh_color": torch.tensor([get("feature_lr", 0.0025)]
                                     + [get("feature_lr", 0.0025) / 20.0] * (m - 1)
                                     )[:, None],
            "sh_phase": expon_lr(it, get("feature_phase_lr_init", 0.0) * ext,
                                 get("feature_phase_lr_final", 0.0) * ext,
                                 get("position_lr_max_steps", 30000)),
            "sh_amp": expon_lr(it, get("feature_amp_lr_init", 1e-4) * ext * ext,
                               get("feature_amp_lr_final", 1e-4),
                               get("position_lr_max_steps", 30000)),
            "scaling": get("scaling_lr", 0.005),
            "rotation": get("rotation_lr", 0.001),
            "opacity": get("opacity_lr", 0.05),
            "seg_color": 0.0,
            "phase_offset": 0.0, "dc_offset": 0.0,
        }
        self.deform_lr = expon_lr(it - warm, get("deform_lr_init", 1.6e-4),
                                  get("deform_lr_final", 1.6e-6),
                                  get("position_lr_max_steps", 30000) - warm)


def _embed(x: torch.Tensor, n: int) -> torch.Tensor:
    out = [x]
    for k in range(n):
        out += [torch.sin(x * 2.0 ** k), torch.cos(x * 2.0 ** k)]
    return torch.cat(out, -1)


def mlp(dp: Dict[str, torch.Tensor], cfg: dict, xyz_n: torch.Tensor,
        t: float):
    """The deform MLP at normalised positions (N, 3) and one time:
    (d_xyz (N, 3), d_sh (N, M, 3))."""
    x_emb = _embed(xyz_n, cfg["xyz_multires"])
    t_emb = _embed(torch.full((xyz_n.shape[0], 1), t, device=xyz_n.device),
                   cfg["t_multires"])
    h = torch.cat([x_emb, t_emb], -1)
    depth = cfg["D"]
    for i in range(depth):
        h = torch.relu(F.linear(h, dp[f"hidden.{i}.weight"],
                                dp[f"hidden.{i}.bias"]))
        if i == depth // 2 and i + 1 < depth:
            h = torch.cat([x_emb, t_emb, h], -1)

    def head(k):
        return F.linear(h, dp[f"heads.{k}.weight"], dp[f"heads.{k}.bias"])

    return head("xyz"), torch.stack([head(c) for c in "rgb"], -1)


def _cut(d: torch.Tensor, bound: float) -> torch.Tensor:
    if bound <= 0:
        return d
    norm = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return d * torch.clamp(bound / norm.clamp(min=1e-12), max=1.0)


def deformation(st: Settings, params, dp, alive, fid: int, n_views: int):
    """(d_xyz, d_sh, flow) for every row: zeros off the live dynamic rows;
    ``flow`` is F-ToRF's (P, 6) scene flow to the next and the previous
    integration frame, on integration frames with the flow term on."""
    cfg = st.cfg
    n = params["xyz"].shape[0]
    m = (cfg["sh_degree"] + 1) ** 2
    dev = params["xyz"].device
    rows = torch.nonzero((params["seg_color"][:, 0] > 0.5) & alive).flatten()
    xyz_n = params["xyz"].detach()[rows] / st.extent
    denom = max(n_views - 1, 1)

    def full(d, width):
        return torch.zeros((n,) + tuple(width), device=dev).index_copy(
            0, rows, d)

    flow = None
    if st.kind == "torf":
        d_xyz, d_sh = mlp(dp, cfg, xyz_n, f32_div(fid, denom))
        return full(_cut(d_xyz, st.clip), (3,)), full(d_sh, (m, 3)), None
    curr = (fid // 4) * 4
    d_curr = _cut(mlp(dp, cfg, xyz_n, f32_div(curr, denom))[0], st.clip)
    d_next = _cut(mlp(dp, cfg, xyz_n, f32_div(curr + 4, denom))[0], st.clip)
    if fid % 4 == 0:
        d_xyz = d_curr
    else:
        d_xyz = 0.25 * (float(fid - curr) * d_next + float(curr + 4 - fid) * d_curr)
    if st.flow_on and fid % 4 == 0:
        d_prev = mlp(dp, cfg, xyz_n, f32_div(curr - 4, denom))[0]
        flow = full(torch.cat([d_next - d_xyz, d_prev - d_xyz], -1), (6,))
    return full(d_xyz, (3,)), torch.zeros((n, m, 3), device=dev), flow


def gaussians(st: Settings, params, d_xyz, d_sh, alive):
    """The rendered Gaussians: positions, scales, unit rotations,
    opacities (0 off the rendered set), colour and phasor SH."""
    motion = params["seg_color"][:, 0] > 0.5
    include = alive & (motion if st.dynamic_only else True)
    q = params["rotation"]
    rot = q * torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-20)
    opac = torch.where(include, torch.sigmoid(params["opacity"])[:, 0], 0.0)
    return (torch.where(motion[:, None], params["xyz"] + d_xyz, params["xyz"]),
            torch.exp(params["scaling"]).expand(-1, 3), rot, opac,
            torch.where(motion[:, None, None], params["sh_color"] + d_sh,
                        params["sh_color"]),
            torch.stack([params["sh_phase"], params["sh_amp"]], -1))


def _window(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float64) - size // 2
    g = torch.exp(-x * x / (2.0 * sigma ** 2))
    g = (g / g.sum()).float()
    return g[:, None] * g[None, :]


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two (C, H, W) images: an 11x11 Gaussian window
    (sigma 1.5) with zero padding."""
    c = a.shape[0]
    w = _window().to(a.device)[None, None].expand(c, 1, 11, 11)

    def blur(x):
        return F.conv2d(x[None], w, padding=5, groups=c)[0]

    mu1, mu2 = blur(a), blur(b)
    s1 = blur(a * a) - mu1 * mu1
    s2 = blur(b * b) - mu2 * mu2
    s12 = blur(a * b) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
            / ((mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))).mean()


def _mixed(pred, gt, dssim, l2: bool):
    err = ((pred - gt) ** 2).mean() if l2 else (pred - gt).abs().mean()
    return (1.0 - dssim) * err + dssim * (1.0 - ssim(pred, gt))


def _flow_term(frame, depth, flow) -> torch.Tensor:
    """The mean squared gap of the rendered scene flow, projected to the
    image from the points the rendered depth (distance) puts at each
    pixel, to the frame's 2D flows."""
    cam = frame.tof
    h, w = depth.shape[1:]
    dev = depth.device
    u = torch.arange(w, dtype=torch.float32, device=dev).expand(h, w)
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    ray = torch.sqrt(((u - cam.cx) / cam.fx) ** 2 + ((v - cam.cy) / cam.fy) ** 2 + 1)
    z = depth[0] / ray
    pts = torch.stack([(u - cam.cx) * z / cam.fx, (v - cam.cy) * z / cam.fy,
                       z]).reshape(3, -1)
    V = cam.view
    Vi = torch.linalg.inv(V)
    world = Vi[:3, :3] @ pts + Vi[:3, 3:4]
    K = torch.tensor([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy],
                      [0.0, 0.0, 1.0]], device=dev)

    def to_image(p):
        hom = K @ (V[:3, :3] @ p + V[:3, 3:4])
        return hom[:2] / (hom[2:] + 1e-7)

    base = to_image(world)
    total = torch.zeros((), device=dev)
    for gt, part in ((frame.forward_flow, flow[0:3]),
                     (frame.backward_flow, flow[3:6])):
        if gt is not None:
            moved = to_image(world + part.reshape(3, -1)) - base
            total = total + ((moved - gt.reshape(2, -1)) ** 2).mean()
    return total


def background(seed: int, it: int, sizes, device):
    """The step's random background, as the program draws it: uniform in
    [-1, 1) from a generator seeded with ``(seed << 32) + it``, one (7, H, W)
    map a camera size (one for both where the sizes agree)."""
    g = torch.Generator(device=device).manual_seed((seed << 32) + it)
    first = torch.rand((7,) + tuple(sizes[0]), generator=g, device=device) * 2 - 1
    if tuple(sizes[1]) == tuple(sizes[0]):
        return first, first
    return first, torch.rand((7,) + tuple(sizes[1]), generator=g,
                             device=device) * 2 - 1


def block_of(cfg: dict):
    return int(cfg.get("tile_h", 16)), int(cfg.get("tile_w", 32))


def loss_and_grads(cfg: dict, scene, state: dict, it: int, fid: int,
                   seed: int):
    """The loss of one step and its gradients: a dict by ``gauss.<name>``
    and ``deform.<name>`` (Gaussian leaves absent where they are frozen),
    ``means2d`` (the screen means' gradient) and the ToF render's
    ``pixels`` and ``radius``."""
    st = Settings(cfg, scene, it)
    frame = scene.frames[fid]
    block = block_of(cfg)
    p_in, alive = state["params"], state["aux"]["alive"]
    params = {k: v.detach().requires_grad_(not st.frozen) for k, v in p_in.items()}
    dp = {k: v.detach().requires_grad_(True) for k, v in state["deform"].items()}
    n = params["xyz"].shape[0]
    dev = params["xyz"].device
    offset = torch.zeros((n, 2), device=dev, requires_grad=not st.frozen)
    if st.dynamic:
        d_xyz, d_sh, flow = deformation(st, params, dp, alive, fid,
                                        len(scene.frames))
    else:
        m = (cfg["sh_degree"] + 1) ** 2
        d_xyz, d_sh, flow = (torch.zeros((n, 3), device=dev),
                             torch.zeros((n, m, 3), device=dev), None)
    means, scales, rots, opac, shs, shs_p = gaussians(st, params, d_xyz,
                                                      d_sh, alive)
    sizes = [(frame.tof.height, frame.tof.width),
             (frame.color.height, frame.color.width)]
    bg_tof, bg_col = background(seed, it, sizes, dev)

    def proj(cam, with_flow):
        return render.project(means, scales, rots, opac, shs, shs_p, offset,
                              cam, st.degree, scene.depth_range,
                              scene.phase_offset, scene.dc_offset, block,
                              flow=flow if with_flow else None)

    p_tof = proj(frame.tof, True)
    r_tof = render.composite(p_tof, frame.tof, bg_tof, block)
    color_cam = st.color_on and not scene.same_camera
    if color_cam:
        p_col = proj(frame.color, False)
        r_col = render.composite(p_col, frame.color, bg_col, block)
    else:
        r_col = r_tof

    # The loss over image leaves: its gradient at each pixel.
    img = {"phasor": r_tof.phasor.clone().requires_grad_(True)}
    col = r_col.color.clone().requires_grad_(True)
    total = torch.zeros((), device=dev)
    if st.color_on:
        total = total + st.w_color * _mixed(col, frame.image, st.dssim, False)
    if st.use_quad:
        k = fid % 4
        total = total + st.w_tof * _mixed(img["phasor"][3 + k][None],
                                          frame.quad, st.dssim, True)
    else:
        c = st.channels
        total = total + st.w_tof * _mixed(img["phasor"][:c], frame.phasor[:c],
                                          st.dssim, True)
    if st.flow_on and fid % 4 == 0:
        img["flow"] = r_tof.flow.clone().requires_grad_(True)
        total = total + st.w_flow * _flow_term(frame, r_tof.depth, img["flow"])
    leaves = list(img.values()) + [col]
    g_img = torch.autograd.grad(total, leaves, allow_unused=True)
    g = {k: gi for k, gi in zip(img, g_img) if gi is not None}
    g_col = g_img[-1]
    if g_col is not None and not color_cam:
        g["color"] = g_col
    tensors, cots = render.backward(p_tof, frame.tof, bg_tof, block, g)
    if color_cam and g_col is not None:
        more = render.backward(p_col, frame.color, bg_col, block,
                               {"color": g_col})
        tensors, cots = tensors + more[0], cots + more[1]
    if tensors:
        torch.autograd.backward(tensors, cots)

    grads = {}
    for k, v in params.items():
        if not st.frozen:
            grads[f"gauss.{k}"] = (v.grad if v.grad is not None
                                   else torch.zeros_like(v))
    for k, v in dp.items():
        grads[f"deform.{k}"] = v.grad if v.grad is not None else torch.zeros_like(v)
    grads["means2d"] = (offset.grad if offset.grad is not None
                        else torch.zeros_like(offset))
    return float(total.detach()), grads, r_tof.pixels, r_tof.radius, st


def adam(params: dict, grads: dict, mu: dict, nu: dict, step: int, lrs):
    """One Adam step (bias-corrected, eps 1e-15) with a rate a leaf."""
    step += 1
    bc1 = 1.0 - ADAM_B1 ** step
    bc2 = 1.0 - ADAM_B2 ** step
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        m = ADAM_B1 * mu[k] + (1 - ADAM_B1) * g
        v = ADAM_B2 * nu[k] + (1 - ADAM_B2) * g * g
        lr = lrs[k]
        if torch.is_tensor(lr):
            lr = lr.to(p.device)
        new_p[k] = p - lr / bc1 * m / (torch.sqrt(v) / math.sqrt(bc2) + ADAM_EPS)
        new_m[k], new_v[k] = m, v
    return new_p, new_m, new_v, step


def train_step(cfg: dict, scene, state: dict, it: int, fid: int, seed: int):
    """One training iteration on ``state``; returns (new state, loss)."""
    loss, grads, pixels, radius, st = loss_and_grads(cfg, scene, state, it,
                                                     fid, seed)
    out = dict(state)
    with torch.no_grad():
        if not st.frozen:
            aux = state["aux"]
            alive = aux["alive"]
            update = radius > 0
            motion = state["params"]["seg_color"][:, 0] > 0.5
            sel = update & motion if st.dynamic_only else update
            gnorm = torch.linalg.vector_norm(grads["means2d"], dim=-1)
            out["aux"] = dict(
                aux,
                max_radii2d=torch.where(update, torch.maximum(
                    aux["max_radii2d"], radius), aux["max_radii2d"]),
                xyz_grad_accum=torch.where(sel, aux["xyz_grad_accum"]
                                           + gnorm * pixels,
                                           aux["xyz_grad_accum"]),
                denom=torch.where(sel, aux["denom"] + pixels, aux["denom"]))
            g = {}
            for k in PARAMS:
                gk = grads[f"gauss.{k}"]
                if gk.ndim and gk.shape[0] == alive.shape[0]:
                    keep = alive.reshape((-1,) + (1,) * (gk.ndim - 1))
                    gk = torch.where(keep, gk, 0.0)
                g[k] = gk
            out["params"], out["mu"], out["nu"], out["step"] = adam(
                state["params"], g, state["mu"], state["nu"], state["step"],
                st.lrs)
        gd = {k[len("deform."):]: v for k, v in grads.items()
              if k.startswith("deform.")}
        norm = torch.sqrt(sum((v * v).sum() for v in gd.values()))
        scale = torch.clamp(1.0 / (norm + 1e-6), max=1.0)
        gd = {k: v * scale for k, v in gd.items()}
        if st.deform_on:
            out["deform"], out["dmu"], out["dnu"], out["dstep"] = adam(
                state["deform"], gd, state["dmu"], state["dnu"],
                state["dstep"], {k: st.deform_lr for k in gd})
    return out, loss


def render_frame(cfg: dict, scene, params: dict, deform: dict, alive,
                 it: int, fid: int) -> dict:
    """A served frame: colour, phasor and depth over a zero background."""
    st = Settings(cfg, scene, it)
    frame = scene.frames[fid]
    block = block_of(cfg)
    n = params["xyz"].shape[0]
    dev = params["xyz"].device
    with torch.no_grad():
        if st.dynamic:
            st.flow_on = False
            d_xyz, d_sh, _ = deformation(st, params, deform, alive, fid,
                                         len(scene.frames))
        else:
            m = (cfg["sh_degree"] + 1) ** 2
            d_xyz = torch.zeros((n, 3), device=dev)
            d_sh = torch.zeros((n, m, 3), device=dev)
        means, scales, rots, opac, shs, shs_p = gaussians(st, params, d_xyz,
                                                          d_sh, alive)
        zero = torch.zeros((n, 2), device=dev)
        st.degree = cfg["sh_degree"]

        def draw(cam):
            pr = render.project(means, scales, rots, opac, shs, shs_p, zero,
                                cam, st.degree, scene.depth_range,
                                scene.phase_offset, scene.dc_offset, block)
            bg = torch.zeros((7, cam.height, cam.width), device=dev)
            return render.composite(pr, cam, bg, block)

        r_tof = draw(frame.tof)
        r_col = r_tof if scene.same_camera else draw(frame.color)
    return {"color": r_col.color.cpu().numpy(),
            "phasor": r_tof.phasor.cpu().numpy(),
            "depth": r_tof.depth[0].cpu().numpy()}
