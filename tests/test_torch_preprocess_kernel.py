"""The preprocess kernels (csrc/preprocess.cu) against their plain version.

``render/preprocess.py::preprocess_plain`` is the specification. On the
card, ``preprocess_cuda`` (the forward kernel and, through autograd, the
backward kernel) is held against it on the same inputs: every
``PreprocessOutputs`` field, and every input's gradient under a random
cotangent on the seven differentiable outputs. The cases cover SH degrees
0-3; ``shs``, ``colors_precomp`` and neither; ``shs_p``,
``phasors_precomp`` and neither; ``cov3d_precomp``; the view-dependent
phase; the offsets as numbers, as tensors and as tensors that need a
gradient; and edge rows: behind the camera, beyond zfar, on both sides of
and exactly at the 1.3*tan(fov) clip, det = 0, zero opacity, a dead slot
at the camera position, and colour and amplitude below 0 and exactly at 0
before their clamps (degree 0, where the tie is exact). Two runs give the
same bits.

Tolerances, and why:
 - rect, tiles_touched and valid equal. The values they are decided
   from (mean2d, radius) are computed in the plain version's operation
   order, and the point transforms as the CPU's GEMM sums them (a
   multiply-add chain in index order, which
   ``test_cpu_point_transforms_sum_as_a_multiply_add_chain`` holds); on the
   card the plain version's batched products and SH sums are library
   kernels that may sum in another order, so a rect edge may sit within
   rounding of a tile boundary: at most ``FLIP_FRAC`` of the rows may
   differ there, each at a value within 1e-4 of a boundary.
 - Floats: |kernel - plain| <= 1e-5 * max|plain| of the field + 1e-5 *
   |plain| (a few float32 ulps of the field's scale; the conic divides by
   det, which cancels). radius exactly, where valid agrees.
 - Gradients: 1e-4 of the row's largest entry (or of the leaf's median
   row, where that is larger) plus 1e-4 relative:
   sums of many terms (the SH basis gradient, the EWA chain) taken in
   another order than autograd's, and the offsets' gradients are sums over
   every row in a fixed tree order against PyTorch's reduction.

The kernels run only on the card, so those tests are marked ``gpu`` and
skip here. On the CPU: ``preprocess`` on CPU tensors takes the plain path
and launches nothing, the point transforms sum as the kernel sums them,
and ``SPANS`` names ``preprocess.backward`` once.
This file imports no JAX.
"""

import math

import numpy as np
import pytest
import torch

from gftorf_tpu_torch.ops.transforms import projection_matrix, world_to_view
from gftorf_tpu_torch.render import preprocess as pre_mod
from gftorf_tpu_torch.render.kernels import preprocess as kpre
from gftorf_tpu_torch.render.settings import CameraSpec, RasterConfig
from gftorf_tpu_torch.utils import trace

W, H = 96, 96
FOV = 0.8
ZNEAR, ZFAR, DEPTH_RANGE = 0.1, 50.0, 10.0
ATOL_F = RTOL_F = 1e-5
ATOL_G = RTOL_G = 1e-4
FLIP_FRAC = 0.01
FLOAT_FIELDS = ("mean2d", "depth_view", "conic", "opacity", "rgb", "phasor",
                "dist", "dist_ndc")
DIFF_FIELDS = ("mean2d", "depth_view", "conic", "opacity", "rgb", "phasor",
               "dist", "dist_ndc")


def camera(device, jitter=0.0, seed=0):
    """A square camera (focal_x == focal_y) looking down +z; with no jitter
    the view transform is the identity, so edge rows are exact."""
    rng = np.random.default_rng(seed)
    a = jitter * rng.normal(size=3)
    c, s = np.cos(a), np.sin(a)
    R = (np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
         @ np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]]))
    view_t = world_to_view(R, jitter * rng.normal(size=3))
    proj_t = projection_matrix(ZNEAR, ZFAR, FOV, FOV)
    return CameraSpec.create(view_t, proj_t, W, H, FOV, FOV, ZNEAR, ZFAR,
                             DEPTH_RANGE, device=device)


def _f32(x):
    return np.float32(x)


def _det_zero_cov(j):
    """A (6,) cov3d for an on-axis point whose EWA cov2d has xx == yy ==
    xy, so det is exactly 0: fl(j * fl(b * j)) == fl(fl(j * fl(a * j)) +
    0.3) searched over float32 neighbours."""
    j = _f32(j)
    for a in np.linspace(0.0, 0.2, 41, dtype=np.float32):
        v = _f32(_f32(j * _f32(a * j)) + _f32(0.3))
        b = _f32(v / (j * j))
        for _ in range(64):
            got = _f32(j * _f32(b * j))
            if got == v:
                return np.array([a, b, 0.0, a, 0.0, 0.05], np.float32)
            b = np.nextafter(b, np.float32(np.inf) if got < v else np.float32(-np.inf))
    raise AssertionError("no cov3d with det exactly 0 found")


def _tie(c):
    """x with fl(x * c) == -0.5 exactly: the colour or amplitude lands
    exactly on its clamp at degree 0 (+0.5 -> 0)."""
    c = _f32(c)
    x = _f32(-0.5 / c)
    for _ in range(64):
        got = _f32(x * c)
        if got == _f32(-0.5):
            return x
        x = np.nextafter(x, np.float32(-np.inf) if got > -0.5 else np.float32(np.inf))
    raise AssertionError("no tie found")


def make_case(seed, n, degree, device, *, colors="shs", phasors="shs_p",
              cov=False, offsets="tensor", vdp=False, jitter=0.0, m=16,
              shp_c=2):
    """Inputs of one ``preprocess`` call: random rows in the frustum of
    ``camera`` and, without jitter, the edge rows at 0-11 (module
    docstring). Returns (args, config): ``args`` as ``preprocess_plain``
    takes them, every float input a leaf that requires grad."""
    rng = np.random.default_rng(seed)
    cam = camera("cpu", jitter, seed)
    z = rng.uniform(1.0, 8.0, n)
    t = math.tan(FOV / 2)
    xyz = np.stack([rng.uniform(-1.4, 1.4, n) * t * z,
                    rng.uniform(-1.4, 1.4, n) * t * z, z], -1).astype(np.float32)
    scales = rng.uniform(0.02, 0.3, (n, 3)).astype(np.float32)
    quat = rng.normal(size=(n, 4)).astype(np.float32)  # unnormalized
    opac = rng.uniform(0.05, 0.95, n).astype(np.float32)
    shs = (0.4 * rng.normal(size=(n, m, 3))).astype(np.float32)
    shs_p = (0.3 * rng.normal(size=(n, m, shp_c))).astype(np.float32)
    shs_p[:, 0, 1] += 1.0
    cov3d = np.zeros((n, 6), np.float32)
    a = rng.normal(size=(n, 3, 3)) * 0.2
    s = a @ a.transpose(0, 2, 1) + 1e-3 * np.eye(3)
    cov3d[:] = s[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]]
    precomp_c = rng.uniform(-0.2, 1.0, (n, 3)).astype(np.float32)
    precomp_p = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.2, 1.0, n),
                          rng.normal(size=n)], -1).astype(np.float32)
    ndc = (1e-3 * rng.normal(size=(n, 2))).astype(np.float32)
    if jitter == 0.0 and n >= 12:
        lim = _f32(_f32(1.3) * _f32(cam.tan_fovx.item()))
        xyz[0] = (0.1, 0.2, -1.0)  # behind the camera
        xyz[1] = (0.1, 0.2, 80.0)  # beyond zfar
        opac[2] = 0.0  # zero opacity
        xyz[3] = cam.campos.numpy()  # a dead slot on the camera
        for row, x in ((4, lim), (5, np.nextafter(lim, _f32(9.0))),
                       (6, np.nextafter(lim, _f32(0.0)))):
            xyz[row] = (_f32(2.0) * x, 0.5, 2.0)  # x / z at, past, inside the clip
            xyz[row + 3] = (-0.5, -_f32(2.0) * x, 2.0)  # the same in -y
        xyz[10] = (0.0, 0.0, 3.0)  # det == 0 with cov3d_precomp
        cov3d[10] = _det_zero_cov(_f32(cam.focal_x.item()) / _f32(3.0))
        shs[11, 0, :] = -3.0  # colour below 0
        shs_p[11, 0, 1] = -3.0  # amplitude below 0
        if degree == 0:  # colour and amplitude exactly at 0
            from gftorf_tpu_torch.ops.sh import SH_C0
            shs[2:4, 0, 1] = _tie(SH_C0)
            shs_p[2:4, 0, 1] = _tie(SH_C0)
    config = RasterConfig(height=H, width=W, tile_h=16, tile_w=16,
                          use_view_dependent_phase=vdp)

    def leaf(x):
        return torch.tensor(x, device=device, requires_grad=True)

    if offsets == "grad":
        po, dc = leaf(np.float32(0.3)), leaf(np.float32(0.05))
    elif offsets == "tensor":
        po = torch.tensor(np.float32(0.3), device=device)
        dc = torch.tensor(np.float32(0.05), device=device)
    else:
        po, dc = 0.3, 0.05
    cam = camera(device, jitter, seed)
    args = (
        leaf(xyz), leaf(scales), leaf(quat), leaf(opac),
        leaf(shs) if colors == "shs" else None,
        leaf(shs_p) if phasors == "shs_p" else None,
        po, dc, leaf(ndc), cam, config, degree,
        leaf(precomp_c) if colors == "precomp" else None,
        leaf(precomp_p) if phasors == "precomp" else None,
        leaf(cov3d) if cov else None,
    )
    return args, config


def leaves(args):
    """name -> the tensor arguments that require grad."""
    names = ("means3d", "scales", "rotations", "opacities", "shs", "shs_p",
             "phase_offset", "dc_offset", "means2d_ndc", "camera", "config",
             "degree", "colors_precomp", "phasors_precomp", "cov3d_precomp")
    return {n: a for n, a in zip(names, args)
            if isinstance(a, torch.Tensor) and a.requires_grad}


def cotangents(out, seed):
    """A cotangent in [-1, 1] for each differentiable output."""
    gen = torch.Generator().manual_seed(seed)
    return {f: (torch.rand(getattr(out, f).shape, generator=gen) * 2 - 1).to(
        getattr(out, f).device) for f in DIFF_FIELDS}


def run(fn, args, seed):
    """(outputs, grads of every leaf) of ``fn(*args)`` under a cotangent
    drawn from ``seed``."""
    out = fn(*args)
    cot = cotangents(out, seed)
    loss = sum((getattr(out, f) * cot[f]).sum() for f in DIFF_FIELDS)
    ls = leaves(args)
    grads = torch.autograd.grad(loss, list(ls.values()), allow_unused=True)
    return out, {n: (torch.zeros_like(x) if g is None else g)
                 for (n, x), g in zip(ls.items(), grads)}


def near_boundary(ref, config):
    """Rows whose tile-rect inputs lie within 1e-4 of a tile boundary."""
    m, r = ref.mean2d.detach(), ref.radius.detach()
    edges = torch.stack([(m[:, 0] - r) / config.tile_w, (m[:, 1] - r) / config.tile_h,
                         (m[:, 0] + r + config.tile_w - 1) / config.tile_w,
                         (m[:, 1] + r + config.tile_h - 1) / config.tile_h], -1)
    return ((edges - edges.round()).abs() < 1e-4).any(-1)


def compare(got, ref, config, what):
    """Raise unless the kernel's outputs match the plain version's by the
    module docstring's tolerances; returns the largest float error."""
    flips = ((got.rect != ref.rect).any(-1) | (got.valid != ref.valid)
             | (got.tiles_touched != ref.tiles_touched))
    n = got.valid.shape[0]
    assert int(flips.sum()) <= FLIP_FRAC * n, (what, int(flips.sum()))
    assert bool(near_boundary(ref, config)[flips].all()), (what, flips.nonzero())
    keep = ~flips
    assert torch.equal(got.radius[keep], ref.radius.detach()[keep]), what
    worst = 0.0
    for f in FLOAT_FIELDS:
        a, b = getattr(got, f).detach(), getattr(ref, f).detach()
        assert a.shape == b.shape and a.dtype == b.dtype, (what, f)
        assert bool(torch.isfinite(a).all()), (what, f)
        err = (a - b).abs()
        tol = ATOL_F * b.abs().max() + RTOL_F * b.abs()
        bad = err > tol
        assert not bool(bad.any()), (what, f, float(err.max()), bad.nonzero()[:5])
        worst = max(worst, float(err.max()))
    return worst


def compare_grads(got, ref, what):
    """Raise unless every leaf's gradient matches; returns the largest
    error relative to its row's largest entry."""
    assert got.keys() == ref.keys(), what
    worst = 0.0
    for name, b in ref.items():
        a = got[name]
        assert a.shape == b.shape, (what, name)
        assert bool(torch.isfinite(a).all()), (what, name)
        # Each row against its own scale (a dead slot's gradient is 1e10
        # times the others'), but no finer than the leaf's median row: a
        # row's entries may be small by cancellation of larger terms.
        rows = b.reshape(b.shape[0], -1) if b.dim() else b.reshape(1, 1)
        row_max = rows.abs().amax(-1, keepdim=True)
        scale = torch.maximum(row_max, row_max.median()).clamp(min=1e-30)
        err = (a.reshape(rows.shape) - rows).abs()
        bad = err > ATOL_G * scale + RTOL_G * rows.abs()
        assert not bool(bad.any()), (what, name, float((err / scale).max()),
                                     bad.nonzero()[:5])
        worst = max(worst, float((err / scale).max()))
    return worst


# Each case: (degree, make_case keywords).
CASES = [
    (3, dict()),
    (3, dict(offsets="grad", vdp=True)),
    (3, dict(jitter=0.05, offsets="grad")),
    (2, dict(offsets="number", cov=True)),
    (1, dict(colors="precomp", phasors="precomp", offsets="grad", vdp=True)),
    (1, dict(colors="none", phasors="none", m=4)),
    (0, dict(offsets="grad", shp_c=3)),
    (0, dict(colors="precomp", phasors="precomp", cov=True, m=1)),
    (2, dict(jitter=0.05, phasors="precomp", offsets="grad", m=9)),
]


def check_case(degree, kw, device, seed=0, n=300):
    """Run one case on ``device`` through the kernels and the plain
    version; returns (forward error, gradient error)."""
    args, config = make_case(seed, n, degree, device, **kw)
    ref_out, ref_g = run(pre_mod.preprocess_plain, args, seed + 1)
    got_out, got_g = run(pre_mod.preprocess_cuda, args, seed + 1)
    what = f"degree {degree} {kw}"
    return compare(got_out, ref_out, config, what), compare_grads(got_g, ref_g, what)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this on the H100")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("degree,kw", CASES)
def test_kernels_match_plain_on_card(cuda, degree, kw):
    fwd0 = kpre.preprocess_forward_cuda.launches
    bwd0 = kpre.preprocess_backward_cuda.launches
    check_case(degree, kw, cuda)
    torch.cuda.synchronize()
    assert kpre.preprocess_forward_cuda.launches == fwd0 + 1
    assert kpre.preprocess_backward_cuda.launches == bwd0 + 1


@pytest.mark.gpu
def test_kernels_repeat_bitwise_on_card(cuda):
    args, _ = make_case(1, 5000, 3, cuda, offsets="grad", jitter=0.05)
    runs = [run(pre_mod.preprocess_cuda, args, 7) for _ in range(2)]
    for f in runs[0][0]._fields:
        assert torch.equal(getattr(runs[0][0], f), getattr(runs[1][0], f)), f
    for name in runs[0][1]:
        assert torch.equal(runs[0][1][name], runs[1][1][name]), name


@pytest.mark.gpu
def test_preprocess_dispatches_to_the_kernels_on_card(cuda):
    args, _ = make_case(2, 64, 3, cuda)
    fwd0 = kpre.preprocess_forward_cuda.launches
    out = pre_mod.preprocess(*args)
    assert out.mean2d.device.type == "cuda"
    assert kpre.preprocess_forward_cuda.launches == fwd0 + 1


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    calls = []
    real = pre_mod.preprocess_plain
    monkeypatch.setattr(pre_mod, "preprocess_plain",
                        lambda *a: calls.append(1) or real(*a))
    kpre.preprocess_forward_cuda.launches = 0
    kpre.preprocess_backward_cuda.launches = 0
    args, _ = make_case(3, 40, 3, "cpu", offsets="grad")
    out, grads = run(pre_mod.preprocess, args, 4)
    assert calls == [1] and out.mean2d.device.type == "cpu"
    assert grads["means3d"].abs().sum() > 0
    assert kpre.preprocess_forward_cuda.launches == 0
    assert kpre.preprocess_backward_cuda.launches == 0


def test_cuda_wrappers_refuse_cpu_tensors():
    args, _ = make_case(3, 16, 3, "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        kpre.preprocess_forward_cuda(*args[:12])


def test_edge_rows_of_the_plain_version():
    """The edge rows do what the module docstring says they do."""
    args, config = make_case(0, 40, 0, "cpu", cov=True)
    out = pre_mod.preprocess_plain(*args)
    assert not bool(out.valid[:4].any())  # behind, beyond, zero opacity, ...
    assert bool(torch.isfinite(out.conic).all() & torch.isfinite(out.phasor).all())
    assert not bool(out.valid[10]) and float(out.conic[10].detach().abs().sum()) > 0
    lim = args[9].tan_fovx * np.float32(1.3)
    xz = args[0][4:7, 0] / args[0][4:7, 2]
    assert xz[0] == lim and xz[1] > lim and xz[2] < lim


def _fma(a, b, c):
    """float32 fma(a, b, c) of float32 arrays: the product is exact in
    float64 and the sum rounds once more there (a double rounding only where
    the exact sum lies within 2**-29 of a float32 midpoint)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c).astype(np.float32)


@pytest.mark.parametrize("rows", [1, 300, 131072])
def test_cpu_point_transforms_sum_as_a_multiply_add_chain(rows):
    """The kernel's projection (csrc/preprocess_row.cuh::gemm_dot3) sums
    ``p @ m[:3]`` as fma(p2, m2, fma(p1, m1, p0 * m0)) to carry the CPU plain
    version's bits in mean2d and the view depth; this holds that order
    against ``transform_point_4x4`` and ``transform_point_4x3``."""
    from gftorf_tpu_torch.ops.transforms import (transform_point_4x3,
                                                 transform_point_4x4)

    gen = torch.Generator().manual_seed(rows)
    p = torch.randn(rows, 3, generator=gen) * 4
    m = torch.randn(4, 4, generator=gen)
    pn, mn = p.numpy(), m.numpy()
    chain = pn[:, :1] * mn[:1]
    for k in (1, 2):
        chain = _fma(pn[:, k:k + 1], mn[k:k + 1], chain)
    chain = chain + mn[3]
    assert np.array_equal(transform_point_4x4(p, m).numpy(), chain)
    assert np.array_equal(transform_point_4x3(p, m).numpy(), chain[:, :3])


def test_spans_name_the_backward_once():
    names = [n for n, _ in trace.SPANS]
    assert names.count("preprocess.backward") == 1
    assert dict(trace.SPANS)["preprocess.backward"] == "preprocess, binning"
