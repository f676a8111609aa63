"""Shared inputs for the port's parity tests (tests/test_torch_*.py).

Every scene is made from a seed with numpy and handed to both packages,
the JAX package as jnp arrays and the port as CPU torch tensors.
"""

import jax.numpy as jnp
import numpy as np
import torch

from gftorf_tpu.ops.transforms import projection_matrix, world_to_view
from gftorf_tpu.render.binning import bin_gaussians as j_bin
from gftorf_tpu.render.composite import TileFeatures
from gftorf_tpu.render.pallas_composite import (
    _bg_to_tiles as j_bg_to_tiles,
    _default_origins as j_origins,
    pack_gaussian_features as j_pack,
)
from gftorf_tpu.render.preprocess import preprocess as j_pre
from gftorf_tpu.render.settings import CameraSpec as JCamera
from gftorf_tpu.render.settings import RasterConfig as JConfig
from gftorf_tpu_torch.render.settings import CameraSpec as TCamera
from gftorf_tpu_torch.render.settings import RasterConfig as TConfig

FOV_X, FOV_Y = 0.9, 0.7
ZNEAR, ZFAR, DEPTH_RANGE = 0.1, 50.0, 10.0


def scene_arrays(seed, n=300, sh_degree=3, dynamic_half=True):
    """GaussianParams fields (numpy float32) for n Gaussians in the frustum
    of ``camera_arrays``: z in [1, 8], scales 0.02-0.15, SH color and
    phasor coefficients, opacity logits, and half of them dynamic."""
    rng = np.random.default_rng(seed)
    m = (sh_degree + 1) ** 2
    z = rng.uniform(1.0, 8.0, n)
    xyz = np.stack([rng.uniform(-0.45, 0.45, n) * z,
                    rng.uniform(-0.35, 0.35, n) * z, z], -1)
    quat = rng.normal(size=(n, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    opac = rng.uniform(0.2, 0.95, n)
    sh_p = 0.2 * rng.normal(size=(n, m, 2))
    sh_p[:, 0, 1] += 1.0
    seg = np.zeros((n, 3))
    if dynamic_half:
        seg[: n // 2, 0] = 1.0
    arrays = dict(
        xyz=xyz,
        sh_color=0.3 * rng.normal(size=(n, m, 3)),
        sh_phase=sh_p[..., 0],
        sh_amp=sh_p[..., 1],
        scaling=np.log(rng.uniform(0.02, 0.15, (n, 3))),
        rotation=quat,
        opacity=np.log(opac / (1.0 - opac))[:, None],
        seg_color=seg,
        phase_offset=np.zeros(1),
        dc_offset=np.zeros(1),
    )
    return {k: v.astype(np.float32) for k, v in arrays.items()}


def camera_arrays(seed=0, jitter=0.0):
    """(view_t, proj_t) of a camera near the origin looking down +z."""
    rng = np.random.default_rng(1000 + seed)
    angle = jitter * rng.normal(size=3)
    rx, ry = angle[0], angle[1]
    R = np.array([[np.cos(ry), 0, np.sin(ry)], [0, 1, 0],
                  [-np.sin(ry), 0, np.cos(ry)]]) @ np.array(
        [[1, 0, 0], [0, np.cos(rx), -np.sin(rx)], [0, np.sin(rx), np.cos(rx)]])
    t = jitter * rng.normal(size=3)
    return world_to_view(R, t), projection_matrix(ZNEAR, ZFAR, FOV_X, FOV_Y)


def cameras(width, height, seed=0, jitter=0.0):
    """The same camera for both packages: (jax CameraSpec, torch CameraSpec)."""
    view_t, proj_t = camera_arrays(seed, jitter)
    args = (view_t, proj_t, width, height, FOV_X, FOV_Y, ZNEAR, ZFAR,
            DEPTH_RANGE)
    return JCamera.create(*args), TCamera.create(*args, device="cpu")


def deform_arrays(seed, depth, width, xyz_multires=10, t_multires=10,
                  sh_degree=3):
    """Deform-MLP leaves (numpy float32) in the JAX ``DeformParams`` layout:
    hidden (in, W) weights and (W,) biases, heads (W, out) by name. Heads
    are drawn large enough that every output is far from zero."""
    rng = np.random.default_rng(seed)
    in_dim = 3 + 6 * xyz_multires + 1 + 2 * t_multires
    skip = depth // 2
    hw, hb = [], []
    prev = in_dim
    for i in range(depth):
        if i == skip + 1:
            prev = width + in_dim
        hw.append(rng.normal(size=(prev, width)) * np.sqrt(2.0 / (prev + width)))
        hb.append(0.05 * rng.normal(size=width))
        prev = width
    m = (sh_degree + 1) ** 2
    outs = dict(xyz=3, rot=4, r=m, g=m, b=m, a=m)
    head_w = {k: 0.05 * rng.normal(size=(width, o)) for k, o in outs.items()}
    head_b = {k: 0.01 * rng.normal(size=o) for k, o in outs.items()}
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return ([f32(w) for w in hw], [f32(b) for b in hb],
            {k: f32(v) for k, v in head_w.items()},
            {k: f32(v) for k, v in head_b.items()})


def statics(scene_type, cfg_color, cfg_tof, depth, width, sched=None,
            flat_stream=False, **kw):
    """The same static configuration for both packages: (jax StepStatic,
    torch StepStatic). ``kw`` sets any StepStatic field (the loss switches
    default to the eval path's values); ``sched`` is a dict of SchedStatic
    fields, with ``weights`` a dict of LossWeights fields. ``flat_stream``
    sets the flag of both RasterConfigs in both packages: the port then
    composites the flat stream, while the JAX package, on the CPU, renders
    dense whatever the flag says (the same function)."""
    from gftorf_tpu.models.deform import DeformConfig as JDeform
    from gftorf_tpu.train.step import LossWeights as JWeights
    from gftorf_tpu.train.step import SchedStatic as JSched
    from gftorf_tpu.train.step import StepStatic as JStatic
    from gftorf_tpu_torch.models.deform import DeformConfig as TDeform
    from gftorf_tpu_torch.train.step import LossWeights as TWeights
    from gftorf_tpu_torch.train.step import SchedStatic as TSched
    from gftorf_tpu_torch.train.step import StepStatic as TStatic

    shared = dict(
        scene_type=scene_type, active_sh_degree=3, total_num_views=64,
        render_regions=("static", "dynamic"), dynamic_on=True,
        use_quad=False, num_phasor_channels=2, optimize_phase_offset=False,
        optimize_dc_offset=False, scene_extent=2.0,
        sync_phase=False, use_wl1c=False, use_wl1p=False, wl1p_e=0.1,
        color_on=True, depth_on=False, dd_on=False, oe_on=False,
        scale_on=False, mlp_reg_on=False, flow_on=False, random_bg=False,
    )
    shared.update(kw)
    sched = dict(sched or {})
    weights = sched.pop("weights", None)
    jsched = JSched(**sched, **({} if weights is None
                                else {"weights": JWeights(**weights)}))
    tsched = TSched(**sched, **({} if weights is None
                                else {"weights": TWeights(**weights)}))
    cfg_color = dict(cfg_color, flat_stream=flat_stream)
    cfg_tof = dict(cfg_tof, flat_stream=flat_stream)
    j = JStatic(config_color=JConfig(**cfg_color), config_tof=JConfig(**cfg_tof),
                deform=JDeform(depth=depth, width=width), sched=jsched,
                **shared)
    t = TStatic(config_color=TConfig(**cfg_color), config_tof=TConfig(**cfg_tof),
                deform=TDeform(depth=depth, width=width), sched=tsched,
                **shared)
    return j, t


def to_jax(arrays):
    return {k: jnp.asarray(v) for k, v in arrays.items()}


def to_torch(arrays):
    return {k: torch.tensor(v) for k, v in arrays.items()}


def assert_close(port, ref, atol, rtol, name=""):
    np.testing.assert_allclose(
        port.detach().cpu().numpy() if torch.is_tensor(port) else port,
        np.asarray(ref), atol=atol, rtol=rtol, err_msg=name)


def packed_tile_inputs(seed, n=240, tile_w=16, max_per_tile=256, flow=True,
                       gates=True, width=64, height=48):
    """JAX-preprocessed, binned and gathered tile inputs, as numpy, with
    the configs (``jcfg``, ``tcfg``), the JAX ``TileFeatures`` and the
    (7, H, W) bg map they came from."""
    a = scene_arrays(seed, n)
    jcam, _ = cameras(width, height, seed=seed)
    kw = dict(height=height, width=width, tile_h=16, tile_w=tile_w,
              max_per_tile=max_per_tile, need_dd=gates,
              need_distribution=gates)
    jcfg = JConfig(**kw)
    opac = 1.0 / (1.0 + np.exp(-a["opacity"][:, 0]))
    pre = j_pre(
        jnp.asarray(a["xyz"]), jnp.exp(jnp.asarray(a["scaling"])),
        jnp.asarray(a["rotation"]), jnp.asarray(opac), jnp.asarray(a["sh_color"]),
        jnp.stack([jnp.asarray(a["sh_phase"]), jnp.asarray(a["sh_amp"])], -1),
        np.float32(0.05), np.float32(0.02), jnp.zeros((n, 2)), jcam, jcfg, 3,
    )
    b = j_bin(pre.rect, pre.depth_view, pre.valid, jcfg, jcfg.capacity_for(n))
    rng = np.random.default_rng(seed + 50)
    flow_p = rng.normal(size=(n, 6)).astype(np.float32) if flow else None
    packed = j_pack(pre, None if flow_p is None else jnp.asarray(flow_p))
    T, L = b.gauss_id.shape
    idc = jnp.maximum(b.gauss_id, 0)
    feat_tl = jnp.take(packed, idc.reshape(-1), axis=0).reshape(T, L, 24)
    bg = rng.uniform(-1, 1, (7, height, width)).astype(np.float32)
    feats = TileFeatures(
        gauss_id=b.gauss_id,
        mean2d=jnp.take(pre.mean2d, idc, axis=0),
        conic=jnp.take(pre.conic, idc, axis=0),
        opacity=jnp.take(pre.opacity, idc, axis=0),
        rgb=jnp.take(pre.rgb, idc, axis=0),
        phasor=jnp.take(pre.phasor, idc, axis=0),
        dist=jnp.take(pre.dist, idc, axis=0),
        dist_ndc=jnp.take(pre.dist_ndc, idc, axis=0),
        flow=None if flow_p is None else jnp.take(jnp.asarray(flow_p), idc,
                                                   axis=0),
    )
    return dict(
        jcfg=jcfg, tcfg=TConfig(**kw), feats=feats, bg=bg,
        feat_tl=np.asarray(feat_tl),
        bg_tiles=np.asarray(j_bg_to_tiles(jnp.asarray(bg), T, jcfg)),
        counts=np.asarray(b.tile_count),
        origins=np.asarray(j_origins(T, jcfg)),
    )


def packed_stream_inputs(seed, n=120, tile_w=16, flow=True, gates=True,
                         width=64, height=48, crowd=False):
    """JAX-preprocessed Gaussians binned into the aligned flat stream by
    the JAX package (``bin_gaussians_flat``), their packed features
    gathered into it (padding rows zero), as numpy: ``feat_fl``,
    ``bg_tiles``, ``chunk_tile``, ``origins``, the (7, H, W) ``bg`` map,
    the configs, and the port's ``tile_start`` / ``tile_count`` of the same
    rects (tests/test_torch_flat_binning.py holds the two binnings equal).
    With ``crowd`` two thirds of the Gaussians crowd the image centre, so
    the tiles there span several FLAT_ALIGN blocks of the stream."""
    from gftorf_tpu.render.binning import bin_gaussians_flat as j_bin_flat
    from gftorf_tpu_torch.render.binning import bin_gaussians_flat as t_bin_flat

    a = scene_arrays(seed, n)
    if crowd:
        a["xyz"][: 2 * n // 3, :2] *= 0.08
        a["scaling"][: 2 * n // 3] -= 1.5
    jcam, _ = cameras(width, height, seed=seed)
    kw = dict(height=height, width=width, tile_h=16, tile_w=tile_w,
              need_dd=gates, need_distribution=gates)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw, flat_stream=True)
    opac = 1.0 / (1.0 + np.exp(-a["opacity"][:, 0]))
    pre = j_pre(
        jnp.asarray(a["xyz"]), jnp.exp(jnp.asarray(a["scaling"])),
        jnp.asarray(a["rotation"]), jnp.asarray(opac), jnp.asarray(a["sh_color"]),
        jnp.stack([jnp.asarray(a["sh_phase"]), jnp.asarray(a["sh_amp"])], -1),
        np.float32(0.05), np.float32(0.02), jnp.zeros((n, 2)), jcam, jcfg, 3,
    )
    capacity = jcfg.capacity_for(n)
    fb = j_bin_flat(pre.rect, pre.depth_view, pre.valid, jcfg, capacity)
    tb = t_bin_flat(torch.tensor(np.asarray(pre.rect)),
                    torch.tensor(np.asarray(pre.depth_view)),
                    torch.tensor(np.asarray(pre.valid)), tcfg, capacity)
    rng = np.random.default_rng(seed + 50)
    flow_p = rng.normal(size=(n, 6)).astype(np.float32) if flow else None
    packed = np.asarray(j_pack(pre, None if flow_p is None else jnp.asarray(flow_p)))
    ids = np.asarray(fb.gauss_flat)
    feat_fl = np.where((ids >= 0)[:, None], packed[np.maximum(ids, 0)], 0.0)
    bg = rng.uniform(-1, 1, (7, height, width)).astype(np.float32)
    T = jcfg.num_tiles
    return dict(
        jcfg=jcfg, tcfg=tcfg, bg=bg, packed=packed, gauss_flat=ids,
        feat_fl=feat_fl.astype(np.float32),
        bg_tiles=np.asarray(j_bg_to_tiles(jnp.asarray(bg), T, jcfg)),
        chunk_tile=np.asarray(fb.chunk_tile),
        origins=np.asarray(j_origins(T, jcfg)),
        tile_start=tb.tile_start.numpy(), tile_count=tb.tile_count.numpy(),
    )


# ---------------------------------------------------------------------------
# Training state, frames and step comparisons (tests/test_torch_train_step*.py)


def train_state_arrays(seed, n_alive, capacity, depth, width, sorted_layout=True):
    """A whole training state as numpy, the same for both packages.

    ``n_alive`` Gaussians of ``scene_arrays`` (the first half dynamic) in a
    ``capacity`` of rows; dead rows are zeros. With ``sorted_layout`` the
    rows are [dynamic+alive | static+alive | dead] (the Trainer's layout),
    else they are shuffled. Densify stats hold earlier accumulations, Adam
    moments are zero (the first step then exposes each gradient as
    mu = 0.1 g), and the deform MLP moves the dynamic half a little."""
    a = scene_arrays(seed, n_alive)
    pad = capacity - n_alive
    params = {k: (v if k in ("phase_offset", "dc_offset") else
                  np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)]))
              for k, v in a.items()}
    rng = np.random.default_rng(seed + 7)
    alive = np.arange(capacity) < n_alive
    aux = dict(
        alive=alive,
        max_radii2d=(rng.uniform(0, 6, capacity) * alive).astype(np.float32),
        xyz_grad_accum=(rng.uniform(0, 1e-3, capacity) * alive).astype(np.float32),
        denom=(rng.integers(0, 50, capacity) * alive).astype(np.float32),
    )
    if not sorted_layout:
        perm = rng.permutation(capacity)
        params = {k: v if k in ("phase_offset", "dc_offset") else v[perm]
                  for k, v in params.items()}
        aux = {k: v[perm] for k, v in aux.items()}
    hw, hb, head_w, head_b = deform_arrays(seed + 1, depth, width)
    head_w["xyz"] *= 0.2
    deform = (hw, hb, head_w, head_b)

    def zeros(tree):
        hw_, hb_, w_, b_ = tree
        return ([np.zeros_like(x) for x in hw_], [np.zeros_like(x) for x in hb_],
                {k: np.zeros_like(v) for k, v in w_.items()},
                {k: np.zeros_like(v) for k, v in b_.items()})

    zp = {k: np.zeros_like(v) for k, v in params.items()}
    return dict(params=params, aux=aux, adam=(zp, dict(zp), 0), deform=deform,
                deform_adam=(zeros(deform), zeros(deform), 0))


def jax_train_state(arrays):
    """(GaussianModelState, DeformParams, deform AdamState) of the JAX
    package from ``train_state_arrays``."""
    from gftorf_tpu.models.deform import DeformParams
    from gftorf_tpu.models.gaussians import (
        AdamState, GaussianAux, GaussianModelState, GaussianParams)

    def jp(d):
        return GaussianParams(**{k: jnp.asarray(v) for k, v in d.items()})

    def jd(leaves):
        hw, hb, w, b = leaves
        return DeformParams(tuple(map(jnp.asarray, hw)), tuple(map(jnp.asarray, hb)),
                            {k: jnp.asarray(v) for k, v in w.items()},
                            {k: jnp.asarray(v) for k, v in b.items()})

    mu, nu, step = arrays["adam"]
    model = GaussianModelState(
        params=jp(arrays["params"]),
        aux=GaussianAux(**{k: jnp.asarray(v) for k, v in arrays["aux"].items()}),
        adam=AdamState(mu=jp(mu), nu=jp(nu), step=jnp.int32(step)),
    )
    dmu, dnu, dstep = arrays["deform_adam"]
    return (model, jd(arrays["deform"]),
            AdamState(mu=jd(dmu), nu=jd(dnu), step=jnp.int32(dstep)))


def torch_train_state(arrays, deform_config, iteration=0):
    """The port's TrainingState (on the CPU) from ``train_state_arrays``."""
    from gftorf_tpu_torch.weights import training_state_from_numpy

    return training_state_from_numpy(
        arrays["params"], arrays["aux"], arrays["adam"], arrays["deform"],
        arrays["deform_adam"], iteration, deform_config, device="cpu")


def frame_pair(seed, fid, size_color, size_tof, cam_seeds, flow=False):
    """One FrameData for both packages: (jax, torch). Ground truth is
    numpy from ``seed``; cameras come from ``cameras`` (jittered), the ToF
    intrinsics from the ToF camera's focal lengths. With ``flow`` both
    flow maps are set and flagged present."""
    from gftorf_tpu.train.step import FrameData as JFrame
    from gftorf_tpu_torch.train.step import FrameData as TFrame

    rng = np.random.default_rng(seed)
    (wc, hc), (wt, ht) = size_color, size_tof
    jcc, tcc = cameras(wc, hc, seed=cam_seeds[0], jitter=0.05)
    jct, tct = cameras(wt, ht, seed=cam_seeds[1], jitter=0.05)
    gt = dict(
        gt_image=rng.uniform(0, 1, (3, hc, wc)),
        gt_phasor=rng.normal(size=(3, ht, wt)),
        gt_quad=rng.normal(size=(4, ht, wt)),
        gt_distance=rng.uniform(1, 8, (1, ht, wt)),
        forward_flow=rng.normal(size=(2, ht, wt)) if flow else np.zeros((2, ht, wt)),
        backward_flow=rng.normal(size=(2, ht, wt)) if flow else np.zeros((2, ht, wt)),
    )
    gt = {k: v.astype(np.float32) for k, v in gt.items()}

    def k_of(cam, w, h):
        return np.array([[float(cam.focal_x), 0, w / 2], [0, float(cam.focal_y), h / 2],
                         [0, 0, 1]], np.float32)

    k_tof, k_col = k_of(tct, wt, ht), k_of(tcc, wc, hc)
    j = JFrame(
        frame_id=jnp.int32(fid), cam_color=jcc, cam_tof=jct,
        **{k: jnp.asarray(v) for k, v in gt.items()},
        has_forward_flow=jnp.asarray(flow), has_backward_flow=jnp.asarray(flow),
        phase_offset=jnp.float32(0.1), dc_offset=jnp.float32(0.02),
        intrinsics_tof=jnp.asarray(k_tof), intrinsics_color=jnp.asarray(k_col),
    )
    t = TFrame(
        frame_id=torch.tensor(fid, dtype=torch.int32), cam_color=tcc,
        cam_tof=tct, **{k: torch.tensor(v) for k, v in gt.items()},
        has_forward_flow=torch.tensor(flow), has_backward_flow=torch.tensor(flow),
        phase_offset=torch.tensor(0.1), dc_offset=torch.tensor(0.02),
        intrinsics_tof=torch.tensor(k_tof), intrinsics_color=torch.tensor(k_col),
    )
    return j, t


def stack_frames(pairs):
    """Stacked datasets (jax, torch) from a list of ``frame_pair``s."""
    import jax

    jf = jax.tree.map(lambda *xs: jnp.stack(xs), *[p[0] for p in pairs])

    def stack(*xs):
        if isinstance(xs[0], tuple):
            return type(xs[0])(*(stack(*col) for col in zip(*xs)))
        return torch.stack(xs)

    return jf, stack(*[p[1] for p in pairs])


def clone_tree(x):
    """A deep copy of nested tuples/dicts of tensors (to check purity)."""
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, dict):
        return {k: clone_tree(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return type(x)(*(clone_tree(v) for v in x)) if hasattr(x, "_fields") \
            else tuple(clone_tree(v) for v in x)
    return x


def assert_tree_equal(a, b, where=""):
    """Bitwise equality of two nested tuples/dicts of tensors."""
    if torch.is_tensor(a):
        assert torch.equal(a, b), f"{where} changed"
    elif isinstance(a, dict):
        for k in a:
            assert_tree_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, tuple):
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{where}[{i}]")


# Step tolerances. The first Adam step from zero moments gives
# mu = 0.1 g and nu = 0.001 g^2, so mu holds each gradient: it is held at
# atol 1e-4 * max|leaf| (gradients summed in another order through the
# compositor's suffix sums) and rtol 1e-3; nu at rtol 2e-3 with the atol
# that the same gradient error gives it (|d nu| <= 2e-4 * max|nu|). The new
# parameters move by about +-lr each, so a gradient element that is tiny in
# both packages may flip its sign: they are held at atol 2 lr.
METRIC_RTOL = 1e-5
MU_ATOL_FRAC, MU_RTOL = 1e-4, 1e-3
NU_ATOL_FRAC, NU_RTOL = 2e-4, 2e-3


def _close_frac(port, ref, atol_frac, rtol, name):
    ref = np.asarray(ref)
    port = np.asarray(port)
    atol = atol_frac * float(np.abs(ref).max()) if ref.size else 0.0
    np.testing.assert_allclose(port, ref, atol=atol, rtol=rtol, err_msg=name)


def assert_step_matches(jout, tout, lrs, deform_lr):
    """One train_step's outputs of both packages: the packed metrics, both
    Adam states (mu, nu, step), the densify stats and the new parameters
    (see the tolerances above). ``lrs`` and ``deform_lr`` are the port's
    learning rates of the step (train/step.py::_gaussian_lrs_at,
    _deform_lr_at). Returns the two metric vectors."""
    from gftorf_tpu.train.step import METRIC_NAMES
    from gftorf_tpu_torch.weights import deform_dict_to_numpy

    jmodel, jdeform, jdadam, jpacked = jout
    tmodel, tdeform, tdadam, tpacked = tout
    jm, tm = np.asarray(jpacked), tpacked.numpy()
    for i, name in enumerate(METRIC_NAMES):
        np.testing.assert_allclose(tm[i], jm[i], rtol=METRIC_RTOL, atol=0,
                                   err_msg=f"metric {name}")

    def leaves(tree):
        hw, hb, w, b = tree
        return ([(f"hidden_w{i}", x) for i, x in enumerate(hw)]
                + [(f"hidden_b{i}", x) for i, x in enumerate(hb)]
                + [(f"head_w.{k}", w[k]) for k in sorted(w)]
                + [(f"head_b.{k}", b[k]) for k in sorted(b)])

    for which in ("mu", "nu"):
        frac, rtol = ((MU_ATOL_FRAC, MU_RTOL) if which == "mu"
                      else (NU_ATOL_FRAC, NU_RTOL))
        jd = getattr(jdadam, which)
        td = deform_dict_to_numpy(getattr(tdadam, which))
        jd_leaves = leaves((jd.hidden_w, jd.hidden_b, jd.head_w, jd.head_b))
        for (name, ref), (_, port) in zip(jd_leaves, leaves(td)):
            _close_frac(port, ref, frac, rtol, f"deform {which} {name}")
        for name in tmodel.params._fields:
            ref = getattr(getattr(jmodel.adam, which), name)
            port = getattr(getattr(tmodel.adam, which), name).numpy()
            _close_frac(port, ref, frac, rtol, f"gaussian {which} {name}")
    assert int(tmodel.adam.step) == int(jmodel.adam.step)
    assert int(tdadam.step) == int(jdadam.step)

    for name in ("denom", "max_radii2d", "alive"):
        np.testing.assert_array_equal(getattr(tmodel.aux, name).numpy(),
                                      np.asarray(getattr(jmodel.aux, name)), name)
    _close_frac(tmodel.aux.xyz_grad_accum.numpy(), jmodel.aux.xyz_grad_accum,
                MU_ATOL_FRAC, MU_RTOL, "xyz_grad_accum")

    for name in tmodel.params._fields:
        lr = getattr(lrs, name)
        lr = lr.numpy() if torch.is_tensor(lr) else np.float32(lr)
        port = getattr(tmodel.params, name).numpy()
        ref = np.asarray(getattr(jmodel.params, name))
        assert np.all(np.abs(port - ref) <= 2 * lr + 1e-7 * np.abs(ref)), name
    jd_new = leaves((jdeform.hidden_w, jdeform.hidden_b, jdeform.head_w,
                     jdeform.head_b))
    for (name, ref), (_, port) in zip(jd_new, leaves(deform_dict_to_numpy(tdeform))):
        ref = np.asarray(ref)
        assert np.all(np.abs(port - ref) <= 2 * deform_lr + 1e-7 * np.abs(ref)), name
    return jm, tm


def run_step_pair(jstatic, tstatic, arrays, pairs, idx, it, seed=0):
    """One train_step of each package from the same state on the same
    stacked frames; returns (jax outputs, port outputs). Also checks that
    the port's step left its input state bitwise unchanged."""
    import jax

    from gftorf_tpu.train.step import train_step as j_step
    from gftorf_tpu_torch.train.step import train_step as t_step

    jframes, tframes = stack_frames(pairs)
    jmodel, jdeform, jdadam = jax_train_state(arrays)
    jout = j_step(jstatic, jmodel, jdeform, jdadam, jframes, jnp.int32(idx),
                  jnp.int32(it), jax.random.PRNGKey(seed))
    state = torch_train_state(arrays, tstatic.deform)
    before = clone_tree((state.model, state.deform, state.deform_adam, tframes))
    tout = t_step(tstatic, state.model, state.deform, state.deform_adam,
                  tframes, idx, it, torch.Generator().manual_seed(seed))
    assert_tree_equal(before, (state.model, state.deform, state.deform_adam,
                               tframes), "input")
    return jout, tout


# ---------------------------------------------------------------------------
# Multi-device steps (tests/test_torch_sharded_train*.py)

# Tolerances of the JAX package's own sharded-step test
# (tests/test_sharded_train.py): loss rtol 1e-4, parameters and deform
# weights atol 2e-5 rtol 1e-3, xyz_grad_accum atol 1e-5 rtol 1e-3, denom
# exact; and Adam's mu (0.1 x the gradient after the first step from zero
# moments) at the single-device tolerances above, which a gradient
# counted once per rank fails.
SHARD_LOSS_RTOL = 1e-4
SHARD_PARAM_ATOL, SHARD_PARAM_RTOL = 2e-5, 1e-3
SHARD_ACCUM_ATOL = 1e-5


def sharded_step_runs(jstatic, tstatic, arrays, pairs, idx, it, meshes, out_dir):
    """One step from ``arrays`` under each (data, shard) of ``meshes``, by
    both packages (the port's meshes of one size in one set of gloo CPU
    ranks, tests/torch_dist_ranks.py), and the port's single-device step at
    each camera of ``idx`` (one per data slice): returns (jax {mesh:
    outputs}, port {mesh: [outputs of each rank]}, port {camera: outputs})."""
    import dataclasses

    import jax

    from gftorf_tpu.train.step import train_step as j_step
    from gftorf_tpu_torch.train.step import train_step as t_step
    from torch_dist_ranks import run_ranks

    jframes, tframes = stack_frames(pairs)
    jmodel, jdeform, jdadam = jax_train_state(arrays)
    jax_out, port_out = {}, {}
    for world in sorted({d * s for d, s in meshes}):
        group = [m for m in meshes if m[0] * m[1] == world]
        ranks = run_ranks("step", world, dict(
            arrays=arrays, static=tstatic, frames=tframes, idx=list(idx),
            it=it, meshes=group), f"{out_dir}/world{world}")
        for mesh in group:
            port_out[mesh] = [r[mesh] for r in ranks]
            jax_out[mesh] = j_step(
                dataclasses.replace(jstatic, mesh_shape=mesh), jmodel, jdeform,
                jdadam, jframes, jnp.asarray(idx[: mesh[0]], jnp.int32),
                jnp.int32(it), jax.random.PRNGKey(0))
    single = {}
    for i in sorted(set(idx[: max(d for d, _ in meshes)])):
        state = torch_train_state(arrays, tstatic.deform)
        single[i] = t_step(tstatic, state.model, state.deform,
                           state.deform_adam, tframes, i, it)
    return jax_out, port_out, single


def _step_leaves(out):
    """(name, numpy array) of a step's outputs of either package: the
    Gaussian parameters, densify stats, Adam mu, the deform MLP's weights
    and mu (JAX layout), and the metrics."""
    from gftorf_tpu_torch.weights import deform_dict_to_numpy

    model, deform, deform_adam, packed = out
    np_ = lambda x: x.numpy() if torch.is_tensor(x) else np.asarray(x)  # noqa: E731
    if isinstance(deform, dict):
        deform = deform_dict_to_numpy(deform)
        dmu = deform_dict_to_numpy(deform_adam.mu)
    else:
        deform = (deform.hidden_w, deform.hidden_b, deform.head_w, deform.head_b)
        mu = deform_adam.mu
        dmu = (mu.hidden_w, mu.hidden_b, mu.head_w, mu.head_b)

    def mlp(tree, tag):
        hw, hb, w, b = tree
        return ([(f"{tag}.hidden_w{i}", np_(x)) for i, x in enumerate(hw)]
                + [(f"{tag}.hidden_b{i}", np_(x)) for i, x in enumerate(hb)]
                + [(f"{tag}.head_w.{k}", np_(w[k])) for k in sorted(w)]
                + [(f"{tag}.head_b.{k}", np_(b[k])) for k in sorted(b)])

    fields = model.params._fields
    return dict(
        [(f"params.{k}", np_(getattr(model.params, k))) for k in fields]
        + [(f"mu.{k}", np_(getattr(model.adam.mu, k))) for k in fields]
        + [(f"aux.{k}", np_(getattr(model.aux, k))) for k in model.aux._fields]
        + mlp(deform, "deform") + mlp(dmu, "deform_mu")
        + [("metrics", np_(packed))])


def assert_sharded_step_close(port, ref, what, same_mesh=True):
    """A sharded step of the port against a reference step's outputs (the
    JAX package's under the same mesh, or with ``same_mesh`` False the
    port's single device, whose ``num_rendered`` and ``rendered_max``
    count the whole image where a mesh reports its deepest band's count
    times the shards) at the tolerances above."""
    from gftorf_tpu.train.step import METRIC_NAMES

    p, r = _step_leaves(port), _step_leaves(ref)
    pm, rm = dict(zip(METRIC_NAMES, p["metrics"])), dict(zip(METRIC_NAMES, r["metrics"]))
    np.testing.assert_allclose(pm["loss"], rm["loss"], rtol=SHARD_LOSS_RTOL,
                               err_msg=f"{what}: loss")
    counts = ("visible", "num_points", "dup_overflow", "tile_overflow", "tile_max")
    if same_mesh:
        counts += ("num_rendered", "rendered_max")
    for name in counts:
        assert pm[name] == rm[name], (what, name, pm[name], rm[name])
    for name, ref_v in r.items():
        got = p[name]
        if name.startswith(("params.", "deform.")):
            np.testing.assert_allclose(got, ref_v, atol=SHARD_PARAM_ATOL,
                                       rtol=SHARD_PARAM_RTOL,
                                       err_msg=f"{what}: {name}")
        elif name.startswith(("mu.", "deform_mu.")):
            _close_frac(got, ref_v, MU_ATOL_FRAC, MU_RTOL, f"{what}: {name}")
        elif name == "aux.xyz_grad_accum":
            np.testing.assert_allclose(got, ref_v, atol=SHARD_ACCUM_ATOL,
                                       rtol=SHARD_PARAM_RTOL,
                                       err_msg=f"{what}: {name}")
        elif name.startswith("aux."):
            np.testing.assert_array_equal(got, ref_v, f"{what}: {name}")


def assert_ranks_equal(outs, what):
    """Every rank's outputs bitwise equal to rank 0's."""
    first = _step_leaves(outs[0])
    for r, out in enumerate(outs[1:], 1):
        for name, v in _step_leaves(out).items():
            np.testing.assert_array_equal(v, first[name], f"{what}: rank {r} {name}")


def mean_of_single_steps(single, idx):
    """The Gaussians' Adam mu and the loss that a step averaging the
    cameras ``idx`` gives after one update from zero moments: the means of
    the single-camera steps' (mu is linear in the gradient; the deform
    MLP's is not, its gradient is clipped by norm first)."""
    from gftorf_tpu.train.step import METRIC_NAMES

    leaves = [_step_leaves(single[i]) for i in idx]
    out = {k: np.mean([lv[k] for lv in leaves], 0) for k in leaves[0]
           if k.startswith("mu.")}
    out["loss"] = np.mean([dict(zip(METRIC_NAMES, lv["metrics"]))["loss"]
                           for lv in leaves])
    return out


SHARDED_CHECKS = ("ranks", "jax", "single")


def check_sharded_step(runs, mesh, idx, check):
    """One check of one mesh's step (tests/test_torch_sharded_train*.py):
    "ranks", every rank's state bitwise equal; "jax", the port's step
    against the JAX package's under the mesh; "single", against the
    port's single device: the step itself for a shard-only mesh, the mean
    of the single-camera steps' mu and losses for a (data > 1) mesh,
    which averages them."""
    from gftorf_tpu.train.step import METRIC_NAMES

    jax_out, port_out, single = runs
    outs = port_out[mesh]
    if check == "ranks":
        assert len(outs) == mesh[0] * mesh[1]
        assert_ranks_equal(outs, f"mesh {mesh}")
    elif check == "jax":
        assert_sharded_step_close(outs[0], jax_out[mesh], f"mesh {mesh} vs JAX")
    elif mesh[0] == 1:
        assert_sharded_step_close(outs[0], single[idx[0]],
                                  f"mesh {mesh} vs one device", same_mesh=False)
    else:
        want = mean_of_single_steps(single, idx[: mesh[0]])
        got = _step_leaves(outs[0])
        loss = dict(zip(METRIC_NAMES, got["metrics"]))["loss"]
        np.testing.assert_allclose(loss, want.pop("loss"), rtol=SHARD_LOSS_RTOL,
                                   err_msg=f"mesh {mesh}: loss vs one device")
        for name, ref in want.items():
            _close_frac(got[name], ref, MU_ATOL_FRAC, MU_RTOL,
                        f"mesh {mesh} vs one device: {name}")


def torf_step_case(depth=4, width=32):
    """The two-camera ToRF case of the sharded step tests: (jax static,
    port static, state arrays, frame pairs, camera of each data slice,
    iteration). Color 64x48 with 16x32 tiles, ToF 48x32 with 16x16 tiles
    (three tile rows, so four shards leave a band empty), the shuffled row
    layout with both gather buckets, the depth, depth-distortion,
    opacity-entropy, scale and deform-regularizer terms on, iteration 300
    where the deform Adam steps. The buckets (191 rendered rows, 127
    deformed rows) divide by no shard count, so a sharded step pads the
    rows of its render and of its deform MLP."""
    sched = dict(
        warm_up=100, position_lr_init=1.6e-4, position_lr_final=1.6e-6,
        deform_lr_init=8e-4, deform_lr_final=1.6e-6, scaling_lr=0.001,
        dd_window=(0, 20000), oe_window=(0, 20000), scale_window=(0, 20000),
        weights=dict(color=1.0, tof=1.0, dssim=0.2, depth=0.1, dd=0.05,
                     flow=0.0, oe=0.01, scale=0.1, mlp_reg=0.01))
    rc = dict(width=64, height=48, tile_h=16, tile_w=32, max_per_tile=512,
              need_dd=False, need_distribution=False)
    rt = dict(width=48, height=32, tile_h=16, tile_w=16, max_per_tile=512,
              need_dd=True, need_distribution=False)
    jstatic, tstatic = statics(
        "torf", rc, rt, depth, width, sched=sched, render_regions=("dynamic",),
        color_on=True, depth_on=True, dd_on=True, oe_on=True, scale_on=True,
        mlp_reg_on=True, deform_clip=0.5,
        bg_color=(0.1, 0.2, 0.3, 0.05, 0.1, 0.15, 0.2),
        compact_layout=False, render_bucket=191, deform_bucket=127)
    arrays = train_state_arrays(11, 160, 224, depth, width, sorted_layout=False)
    pairs = [frame_pair(60 + fid, fid, (64, 48), (48, 32), (fid, fid + 50))
             for fid in (3, 5)]
    return jstatic, tstatic, arrays, pairs, (1, 0), 300


def ftorf_step_case(depth=4, width=32):
    """The single-camera F-ToRF case: 64x48 with 16x16 tiles (three tile
    rows), quad ToF, the flow loss gated at run time (``flow_frame`` None,
    as the Trainer gates a data-parallel batch) on an integration frame
    (id 8, camera 1) and a lerp frame (id 6, camera 0), the sorted layout
    with the static-slice buckets, iteration 300. The deform bucket (95
    rows, two samples each) divides by no shard count; the render bucket
    (192) divides by both."""
    sched = dict(
        warm_up=100, flow_start=100, position_lr_init=1.6e-4,
        position_lr_final=1.6e-6, deform_lr_init=8e-4, deform_lr_final=1.6e-6,
        scaling_lr=0.001,
        weights=dict(color=0.0, tof=1.0, dssim=0.2, depth=0.0, dd=0.0,
                     flow=0.5, oe=0.0, scale=0.0, mlp_reg=0.01))
    rc = dict(width=64, height=48, tile_h=16, tile_w=16, max_per_tile=512,
              need_dd=False, need_distribution=False)
    jstatic, tstatic = statics(
        "ftorf", rc, rc, depth, width, sched=sched, single_camera=True,
        use_quad=True, use_wl1p=True, color_on=False, flow_on=True,
        flow_frame=None, mlp_reg_on=True, active_sh_degree=2,
        tof_inverse_permutation=(2, 0, 3, 1), tof_permutation=(1, 3, 0, 2),
        bg_color=(0.1, 0.2, 0.3, 0.05, 0.1, 0.15, 0.2), deform_clip=0.5,
        compact_layout=True, render_bucket=192, deform_bucket=95)
    arrays = train_state_arrays(13, 160, 224, depth, width)
    pairs = [frame_pair(80 + fid, fid, (64, 48), (64, 48), (fid, fid), flow=True)
             for fid in (6, 8)]
    return jstatic, tstatic, arrays, pairs, (1, 0), 300
