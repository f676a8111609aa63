"""The COLMAP layout: a capture as 3D Gaussian Splatting reads it (the
Mip-NeRF 360 scenes), held against the colour-only plain reference.

- ``write``: a stand-in for a Mip-NeRF 360 garden capture, made with no
  randomness from ``--seed``: one shared ``PINHOLE`` camera, ``views``
  inward-facing views on a jittered orbit around a table with an object on
  it, ray-traced against analytic surfaces (a textured lawn, a round table
  on one leg, a checkered ball on it, a hedge all round and the sky), and
  written as COLMAP's ``sparse/0/{cameras,images,points3D}.bin`` and
  lossless 8-bit PNGs under ``<images>/`` (every row with filter 0, so
  the program and the reference read the same pixels). ``points3D`` holds
  points sampled as the start population is (below), with their colours.
- ``start_state``: the population of a run in the middle of its densify
  phase, made from ``--seed``: ``num_points`` Gaussians on the surfaces
  with a small normal jitter, a share of them in a shell through the ball
  (denser around the central object, as a trained model is), scales from
  the three nearest neighbours (a search over Morton-ordered windows),
  random rotations, opacities drawn over (0, 1), SH DC from the shaded
  surface colour and small higher orders, all static (``seg_color`` 0),
  zero Adam moments with the step at the start iteration, and the deform
  MLP as the time-of-flight layout writes it (unused: ``dynamic`` is off).
- ``start_meta``: the host state at the start iteration, the SH degree
  raised every 1,000 iterations, no ToF flip, and the configuration's
  ``start_occupancy`` (the tile ceiling, ``dup_factor`` and the flat
  stream that a checkpoint saved there carries).
- ``reference``: ``reference/colmap_driver.py``.

World units: z up, the table's centre over the origin. The writer runs on
the card when there is one (it is not timed), else on the CPU."""

from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np
import torch

from harness import state

# Surfaces (world units, z up).
GROUND_R = 9.0  # the lawn reaches the hedge
HEDGE_R, HEDGE_TOP = 9.0, 4.0
TABLE_R, TABLE_Z0, TABLE_Z1 = 0.75, 0.72, 0.78
LEG_R = 0.07
BALL_R = 0.34
BALL_C = (0.0, 0.0, TABLE_Z1 + BALL_R)
SUN = (0.45, 0.3, 0.84)
# The orbit: radius, height and the point the views look at.
ORBIT_R, ORBIT_Z = 3.9, 1.75
TARGET = (0.0, 0.0, 0.95)
# Surface ids.
SKY, LAWN, HEDGE, TOP, RIM, UNDER, LEG, BALL = range(8)

# The start population's shares, by surface, and the ball's shell.
SHARES = {BALL: 0.13, TOP: 0.011, RIM: 0.002, LEG: 0.002, LAWN: 0.46,
          HEDGE: 0.395}
SHELL_IN = 0.08  # the shell through the ball spans radii [SHELL_IN, BALL_R]
LAWN_FALLOFF = 4.0  # the lawn's density falls as exp(-r / LAWN_FALLOFF)
NORMAL_JITTER = 0.002
SCALE_JITTER = 0.2  # each axis's scale: the kNN distance times exp(N(0, .))
SH_REST = 0.01  # the higher SH orders' standard deviation
KNN_WINDOW = 16  # Morton neighbours a side searched for the 3 nearest
SCENE_SEED = 20230718  # the scene's jitters: no part of --seed


# ---------------------------------------------------------------------------
# Textures


def _hash(i, j, salt: int):
    k = (i * 73856093) ^ (j * 19349663) ^ (salt * 83492791)
    k = (k ^ (k >> 13)) * 1274126177
    k = k ^ (k >> 16)
    return (k & 0xFFFFFF).to(torch.float32) / float(1 << 24)


def _noise(u, v, scale: float, salt: int):
    """Value noise in [0, 1) at lattice spacing ``scale``, smoothly
    interpolated."""
    x, y = u / scale, v / scale
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    fx, fy = fx * fx * (3 - 2 * fx), fy * fy * (3 - 2 * fy)
    i, j = x0.to(torch.int64), y0.to(torch.int64)
    a, b = _hash(i, j, salt), _hash(i + 1, j, salt)
    c, d = _hash(i, j + 1, salt), _hash(i + 1, j + 1, salt)
    return (a + (b - a) * fx) + ((c + (d - c) * fx) - (a + (b - a) * fx)) * fy


def _lerp(c0, c1, t):
    c0 = torch.tensor(c0, device=t.device)
    c1 = torch.tensor(c1, device=t.device)
    return c0 + (c1 - c0) * t[:, None]


def _albedo(sid, p):
    """(N, 3) albedo of points ``p`` (N, 3) on the surfaces ``sid`` (N,)."""
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    out = torch.zeros_like(p)

    def put(mask, fn):
        if bool(mask.any()):
            out[mask] = fn(x[mask], y[mask], z[mask])

    def lawn(x, y, z):
        base = _lerp((0.24, 0.44, 0.12), (0.45, 0.36, 0.2),
                     _noise(x, y, 1.7, 1) ** 2)
        detail = 0.55 + 0.45 * _noise(x, y, 0.03, 2)
        fine = 0.8 + 0.4 * _noise(x, y, 0.009, 3)
        c = base * (detail * fine)[:, None]
        flower = _noise(x, y, 0.05, 4) > 0.86
        return torch.where(flower[:, None],
                           torch.tensor((0.92, 0.85, 0.32), device=x.device), c)

    def hedge(x, y, z):
        s = torch.atan2(y, x) * HEDGE_R
        base = _lerp((0.08, 0.22, 0.07), (0.22, 0.4, 0.14),
                     _noise(s, z, 0.35, 5))
        return base * (0.45 + 0.55 * _noise(s, z, 0.06, 6)
                       * (0.7 + 0.3 * _noise(s, z, 0.015, 7)))[:, None]

    def top(x, y, z):
        grain = 0.5 + 0.5 * torch.sin(2 * math.pi * (x * 11.0
                                                     + 1.5 * _noise(x, y, 0.3, 8)))
        return _lerp((0.42, 0.27, 0.15), (0.63, 0.46, 0.28), grain) * (
            0.85 + 0.3 * _noise(x, y, 0.012, 9))[:, None]

    def rim(x, y, z):
        s = torch.atan2(y, x) * TABLE_R
        return _lerp((0.3, 0.19, 0.1), (0.45, 0.3, 0.17),
                     _noise(s, z, 0.02, 10))

    def leg(x, y, z):
        s = torch.atan2(y, x) * LEG_R
        g = 0.28 + 0.1 * _noise(s, z, 0.02, 11)
        return torch.stack([g, g, g * 1.1], -1)

    def ball(x, y, z):
        dx, dy, dz = x - BALL_C[0], y - BALL_C[1], z - BALL_C[2]
        lon = torch.atan2(dy, dx)
        lat = torch.atan2(dz, torch.sqrt(dx * dx + dy * dy))
        cell = (torch.floor(lon * 12 / (2 * math.pi))
                + torch.floor(lat * 8 / math.pi)) % 2
        c = _lerp((0.78, 0.12, 0.1), (0.93, 0.88, 0.76), cell)
        return c * (0.9 + 0.2 * _noise(lon * BALL_R, lat * BALL_R, 0.01,
                                       12))[:, None]

    put(sid == LAWN, lawn)
    put(sid == HEDGE, hedge)
    put(sid == TOP, top)
    put((sid == RIM) | (sid == UNDER), rim)
    put(sid == LEG, leg)
    put(sid == BALL, ball)
    return out


def _normals(sid, p):
    n = torch.zeros_like(p)
    n[:, 2] = 1.0
    r = torch.sqrt(p[:, 0] ** 2 + p[:, 1] ** 2).clamp(min=1e-9)
    radial = torch.stack([p[:, 0] / r, p[:, 1] / r, torch.zeros_like(r)], -1)
    n = torch.where(((sid == RIM) | (sid == LEG))[:, None], radial, n)
    n = torch.where((sid == HEDGE)[:, None], -radial, n)
    n = torch.where((sid == UNDER)[:, None], -n.abs(), n)
    c = torch.tensor(BALL_C, device=p.device)
    nb = (p - c) / torch.linalg.vector_norm(p - c, dim=-1, keepdim=True)
    return torch.where((sid == BALL)[:, None], nb, n)


def surface_colour(sid, p):
    """(N, 3) colour of surface points in [0, 1]: the albedo lit by the sun
    (a Lambert term over an ambient floor), the same from every view."""
    sun = torch.tensor(SUN, device=p.device)
    sun = sun / torch.linalg.vector_norm(sun)
    lit = 0.6 + 0.4 * (_normals(sid, p) @ sun).clamp(min=0.0)
    return (_albedo(sid, p) * lit[:, None]).clamp(0.0, 1.0)


def _sky(d):
    up = d[:, 2].clamp(min=0.0)
    base = _lerp((0.78, 0.86, 0.95), (0.36, 0.56, 0.86), up.sqrt())
    h = d[:, 2].clamp(min=0.05)
    cloud = _noise(d[:, 0] / h, d[:, 1] / h, 0.4, 13)
    return (base + 0.25 * (cloud - 0.5)[:, None]).clamp(0.0, 1.0)


# ---------------------------------------------------------------------------
# Ray tracing


def _cylinder(o, d, r, z0, z1, far: bool):
    """Distance along each ray to the vertical cylinder of radius ``r`` over
    [z0, z1] (the far root: seen from inside), inf where it misses."""
    a = d[:, 0] ** 2 + d[:, 1] ** 2
    b = 2 * (o[:, 0] * d[:, 0] + o[:, 1] * d[:, 1])
    c = o[:, 0] ** 2 + o[:, 1] ** 2 - r * r
    disc = b * b - 4 * a * c
    s = torch.sqrt(disc.clamp(min=0.0))
    t = (-b + s if far else -b - s) / (2 * a).clamp(min=1e-12)
    z = o[:, 2] + t * d[:, 2]
    ok = (disc >= 0) & (t > 1e-6) & (z >= z0) & (z <= z1)
    return torch.where(ok, t, torch.full_like(t, math.inf))


def _disc(o, d, z0, r):
    t = (z0 - o[:, 2]) / torch.where(d[:, 2] == 0, 1e-12, d[:, 2])
    p = o + t[:, None] * d
    ok = (t > 1e-6) & (p[:, 0] ** 2 + p[:, 1] ** 2 <= r * r)
    return torch.where(ok, t, torch.full_like(t, math.inf))


def _sphere(o, d):
    c = torch.tensor(BALL_C, device=o.device)
    oc = o - c
    b = (oc * d).sum(-1)
    disc = b * b - ((oc * oc).sum(-1) - BALL_R ** 2)
    t = -b - torch.sqrt(disc.clamp(min=0.0))
    return torch.where((disc >= 0) & (t > 1e-6), t,
                       torch.full_like(t, math.inf))


def trace(o, d):
    """(N, 3) colours along unit rays from ``o`` in directions ``d``."""
    hits = torch.stack([
        torch.full_like(d[:, 0], math.inf),  # the sky: what nothing else hides
        _disc(o, d, 0.0, GROUND_R),
        _cylinder(o, d, HEDGE_R, 0.0, HEDGE_TOP, far=True),
        _disc(o, d, TABLE_Z1, TABLE_R),
        _cylinder(o, d, TABLE_R, TABLE_Z0, TABLE_Z1, far=False),
        _disc(o, d, TABLE_Z0, TABLE_R),
        _cylinder(o, d, LEG_R, 0.0, TABLE_Z0, far=False),
        _sphere(o, d)], -1)
    t, sid = hits.min(-1)
    sid = torch.where(torch.isinf(t), SKY, sid)
    p = o + torch.where(torch.isinf(t), 0.0, t)[:, None] * d
    colour = surface_colour(sid, p)
    return torch.where((sid == SKY)[:, None], _sky(d), colour)


# ---------------------------------------------------------------------------
# Cameras and files


def look_at(centre, target, roll: float) -> np.ndarray:
    """World-to-camera rotation (COLMAP: x right, y down, z forward)."""
    f = np.asarray(target, np.float64) - centre
    f /= np.linalg.norm(f)
    right = np.cross(f, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    down = np.cross(f, right)
    c, s = math.cos(roll), math.sin(roll)
    right, down = c * right + s * down, -s * right + c * down
    return np.stack([right, down, f])


def orbit(views: int):
    """(rotation, translation) of each view, world to camera: a jittered
    orbit around the table, every view looking at it."""
    rng = np.random.default_rng(SCENE_SEED)
    out = []
    for k in range(views):
        ang = 2 * math.pi * k / views + rng.normal(0.0, 0.012)
        rad = ORBIT_R + rng.normal(0.0, 0.15)
        centre = np.array([rad * math.cos(ang), rad * math.sin(ang),
                           ORBIT_Z + rng.normal(0.0, 0.2)])
        R = look_at(centre, np.asarray(TARGET) + rng.normal(0.0, 0.08, 3),
                    rng.normal(0.0, 0.02))
        out.append((R, -R @ centre))
    return out


def qvec(R: np.ndarray) -> np.ndarray:
    """COLMAP's (w, x, y, z) quaternion of a rotation matrix."""
    w = math.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    x = math.copysign(math.sqrt(max(0.0, 1.0 + R[0, 0] - R[1, 1] - R[2, 2])) / 2,
                      R[2, 1] - R[1, 2])
    y = math.copysign(math.sqrt(max(0.0, 1.0 - R[0, 0] + R[1, 1] - R[2, 2])) / 2,
                      R[0, 2] - R[2, 0])
    z = math.copysign(math.sqrt(max(0.0, 1.0 - R[0, 0] - R[1, 1] + R[2, 2])) / 2,
                      R[1, 0] - R[0, 1])
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def _write_png(path: str, img: np.ndarray) -> None:
    """An 8-bit RGB PNG, every row with filter 0."""
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], 1)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
                + chunk(b"IEND", b""))


def _device():
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _rays(R, t, width, height, focal, dev):
    """Origins and unit directions through the centre of every pixel."""
    v, u = torch.meshgrid(torch.arange(height, device=dev, dtype=torch.float64),
                          torch.arange(width, device=dev, dtype=torch.float64),
                          indexing="ij")
    cam = torch.stack([(u + 0.5 - width / 2) / focal,
                       (v + 0.5 - height / 2) / focal,
                       torch.ones_like(u)], -1).reshape(-1, 3)
    Rt = torch.as_tensor(R, device=dev)
    d = cam @ Rt  # camera to world: R^T c
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    o = (-Rt.T @ torch.as_tensor(t, device=dev)).expand_as(d)
    return o.float(), d.float()


def write(out_dir: str, views: int, width: int, height: int, focal: float,
          images: str, points: int) -> None:
    """The capture: ``views`` PNGs of ``width`` x ``height`` under
    ``images/``, one PINHOLE camera of focal ``focal`` (principal point at
    the centre), and ``points`` surface points in ``points3D.bin``."""
    dev = _device()
    sparse = os.path.join(out_dir, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(os.path.join(out_dir, images), exist_ok=True)
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1) + struct.pack("<iiQQ", 1, 1, width, height)
                + struct.pack("<4d", focal, focal, width / 2, height / 2))
    poses = orbit(views)
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", views))
        for k, (R, t) in enumerate(poses):
            f.write(struct.pack("<i4d3di", k + 1, *qvec(R), *t, 1)
                    + f"frame_{k:05d}.png".encode() + b"\0"
                    + struct.pack("<Q", 0))
    for k, (R, t) in enumerate(poses):
        o, d = _rays(R, t, width, height, focal, dev)
        rgb = trace(o, d).reshape(height, width, 3)
        img = (rgb * 255.0 + 0.5).clamp(0, 255).to(torch.uint8).cpu().numpy()
        _write_png(os.path.join(out_dir, images, f"frame_{k:05d}.png"), img)
    g = torch.Generator(device=dev).manual_seed(SCENE_SEED)
    sid, p, _ = sample_surfaces(points, g, dev)
    rgb = (surface_colour(sid, p) * 255.0 + 0.5).clamp(0, 255).to(torch.uint8)
    rec = np.zeros(points, dtype=[("id", "<u8"), ("xyz", "<f8", 3),
                                  ("rgb", "u1", 3), ("error", "<f8"),
                                  ("track", "<u8")])
    rec["id"] = np.arange(1, points + 1)
    rec["xyz"] = p.double().cpu().numpy()
    rec["rgb"] = rgb.cpu().numpy()
    rec["error"] = 0.5
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", points))
        rec.tofile(f)


# ---------------------------------------------------------------------------
# The start population


def sample_surfaces(n: int, g, dev):
    """(surface id, point on the surface, normal jitter's direction) of
    ``n`` points shared over the surfaces by ``SHARES``; the ball's share
    fills a shell of radii [SHELL_IN, BALL_R], uniform in its volume, and
    the lawn's density falls off away from the table."""
    counts = {s: int(round(n * w)) for s, w in SHARES.items()}
    counts[LAWN] += n - sum(counts.values())
    sids, pts = [], []

    def u(k, d=1):
        return torch.rand((k, d), generator=g, device=dev)

    for s, k in counts.items():
        a = 2 * math.pi * u(k)[:, 0]
        if s == BALL:
            d = torch.randn((k, 3), generator=g, device=dev)
            d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
            r = (SHELL_IN ** 3 + u(k)[:, 0] * (BALL_R ** 3 - SHELL_IN ** 3)) ** (1 / 3)
            p = torch.tensor(BALL_C, device=dev) + r[:, None] * d
        elif s == TOP:
            r = TABLE_R * torch.sqrt(u(k)[:, 0])
            p = torch.stack([r * torch.cos(a), r * torch.sin(a),
                             torch.full_like(r, TABLE_Z1)], -1)
        elif s in (RIM, LEG, HEDGE):
            r, z0, z1 = {RIM: (TABLE_R, TABLE_Z0, TABLE_Z1),
                         LEG: (LEG_R, 0.0, TABLE_Z0),
                         HEDGE: (HEDGE_R, 0.0, HEDGE_TOP)}[s]
            z = z0 + (z1 - z0) * u(k)[:, 0]
            p = torch.stack([r * torch.cos(a), r * torch.sin(a), z], -1)
        else:  # the lawn: radius by inverting its tabulated distribution
            grid = torch.linspace(0.0, GROUND_R, 4097, device=dev,
                                  dtype=torch.float64)
            cdf = torch.cumsum(grid * torch.exp(-grid / LAWN_FALLOFF), 0)
            cdf = cdf / cdf[-1]
            at = torch.searchsorted(cdf, u(k)[:, 0].double()).clamp(max=4096)
            r = (grid[at] - GROUND_R / 4096 * u(k)[:, 0].double()).clamp(min=0).float()
            p = torch.stack([r * torch.cos(a), r * torch.sin(a),
                             torch.zeros_like(r)], -1)
        sids.append(torch.full((k,), s, device=dev))
        pts.append(p)
    sid, p = torch.cat(sids), torch.cat(pts)
    return sid, p, _normals(sid, p)


def _morton(xyz):
    """63-bit Morton codes of points over their bounding box."""
    lo, hi = xyz.min(0).values, xyz.max(0).values
    q = ((xyz - lo) / (hi - lo).clamp(min=1e-9) * (2 ** 21 - 1)).to(torch.int64)
    code = torch.zeros(xyz.shape[0], dtype=torch.int64, device=xyz.device)
    for b in range(21):
        for a in range(3):
            code |= ((q[:, a] >> b) & 1) << (3 * b + a)
    return code


def knn_sq_dist(xyz, k: int = 3, window: int = KNN_WINDOW,
                block: int = 1 << 18):
    """Mean squared distance of each point to its ``k`` nearest others
    among its ``window`` Morton neighbours on each side, the smaller of two
    orders (the second over coordinates shifted by a third of the box), so
    a neighbour across a seam of one order is found by the other."""
    n = xyz.shape[0]
    best = torch.full((n,), math.inf, device=xyz.device)
    span = (xyz.max(0).values - xyz.min(0).values)
    for shift in (0.0, 1.0 / 3.0):
        order = torch.argsort(_morton(xyz + shift * span))
        p = xyz[order]
        offs = torch.cat([torch.arange(-window, 0, device=xyz.device),
                          torch.arange(1, window + 1, device=xyz.device)])
        out = torch.empty(n, device=xyz.device)
        for i in range(0, n, block):
            rows = torch.arange(i, min(n, i + block), device=xyz.device)
            j = rows[:, None] + offs[None]
            ok = (j >= 0) & (j < n)
            d2 = ((p[j.clamp(0, n - 1)] - p[rows, None]) ** 2).sum(-1)
            d2 = torch.where(ok, d2, math.inf)
            out[i:i + rows.numel()] = d2.topk(k, dim=1, largest=False).values.mean(1)
        best[order] = torch.minimum(best[order], out)
    return best


def start_state(cfg: dict, scene: dict, seed: int, capacity: int, step: int,
                device) -> state.StartState:
    """``num_points`` Gaussians on the surfaces (see the module's notes),
    made from ``seed`` on ``device``."""
    n = int(cfg["num_points"])
    m = (cfg["sh_degree"] + 1) ** 2
    g = torch.Generator(device=device).manual_seed(int(seed))
    sid, surf, normal = sample_surfaces(n, g, device)
    jitter = torch.randn((n, 1), generator=g, device=device) * NORMAL_JITTER
    xyz = surf + torch.where((sid == BALL)[:, None], 0.0, jitter * normal)

    def rows(*shape):
        return torch.zeros((capacity,) + shape, device=device)

    sh_color = rows(m, 3)
    sh_color[:n, 0] = (surface_colour(sid, surf) - 0.5) / state.SH_C0
    sh_color[:n, 1:] = SH_REST * torch.randn((n, m - 1, 3), generator=g,
                                             device=device)
    d = torch.sqrt(knn_sq_dist(xyz).clamp(min=1e-7))
    scaling = rows(3)
    scaling[:n] = torch.log(d)[:, None] + SCALE_JITTER * torch.randn(
        (n, 3), generator=g, device=device)
    rotation = rows(4)
    q = torch.randn((n, 4), generator=g, device=device)
    rotation[:n] = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    opacity = rows(1)
    o = torch.rand((n, 1), generator=g, device=device).clamp(1e-3, 1 - 1e-3)
    opacity[:n] = torch.log(o / (1 - o))
    params = dict(xyz=torch.cat([xyz, xyz.new_zeros((capacity - n, 3))]),
                  sh_color=sh_color, sh_phase=rows(m), sh_amp=rows(m),
                  scaling=scaling, rotation=rotation, opacity=opacity,
                  seg_color=rows(3),
                  phase_offset=torch.zeros((1,), device=device),
                  dc_offset=torch.zeros((1,), device=device))
    aux = dict(alive=torch.arange(capacity, device=device) < n,
               max_radii2d=rows(), xyz_grad_accum=rows(), denom=rows())
    # The deform MLP as the time-of-flight layout draws it, from a stand-in
    # of four points (it renders nothing: ``dynamic`` is off).
    deform = state.make_start_state(
        dict(cfg, num_points=4, initial_opacity=0.1),
        (np.zeros(3), np.ones(3)), seed, 4, step, device).deform
    return state.StartState(params=params, aux=aux, deform=deform, n=n,
                            step=step)


def start_meta(cfg: dict, start: int) -> dict:
    """The Trainer's host state at iteration ``start``: the SH degree raised
    every 1,000 iterations; the config's colour weight and reset interval,
    which no ToF flip changes; and the occupancy that a checkpoint saved at
    ``start`` carries (``start_occupancy``: the tile ceiling, ``dup_factor``
    and the flat stream, as the Trainer grew and shrank them on the way),
    so that a resumed run does not grow them again."""
    return {"iteration": start,
            "active_sh_degree": min(start // 1000, cfg["sh_degree"]),
            "lambda_color": cfg["lambda_color"],
            "opacity_reset_interval": cfg["opacity_reset_interval"],
            **cfg.get("start_occupancy", {})}


def reference():
    from reference import colmap_driver

    return colmap_driver
