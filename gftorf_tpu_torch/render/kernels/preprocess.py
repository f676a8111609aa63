"""Per-Gaussian preprocess on the card: csrc/preprocess.cu, bound with ctypes.

``render/preprocess.py::preprocess`` sends a CUDA tensor here and a CPU
tensor to ``preprocess_plain``, the eager body these kernels replace
(the notes in csrc/preprocess.cu say why, and what bounds them).

 - ``preprocess_forward_cuda``: one launch per render; writes the fields
   of ``PreprocessOutputs`` that it computes, each its own tensor, so
   binning and ``pack_gaussian_features`` read what they read before.
 - ``preprocess_backward_cuda``: one launch per differentiated render
   (and a one-block second pass that sums the offsets' gradients when
   ``phase_offset`` or ``dc_offset`` needs one, counted apart in
   ``.sum_launches``).
 - ``PreprocessKernel``: the ``torch.autograd.Function`` around the two.

Every wrapper counts its launches in ``.launches``. The structs below
mirror ``Params``, ``Outputs`` and ``Grads`` of csrc/preprocess_row.cuh
field for field.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gftorf_tpu_torch.render.kernels.dense import check_tensors
from gftorf_tpu_torch.utils import debug_nans
from gftorf_tpu_torch.utils.trace import span

_PTR, _F, _I, _LL = ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_longlong

# The largest SH degree the kernels are built for, and their block size
# (csrc/preprocess.cu's THREADS: one thread a Gaussian).
MAX_DEGREE = 3
THREADS = 256


class _Params(ctypes.Structure):
    _fields_ = [(n, _PTR) for n in (
        "means3d", "scales", "rotations", "opacities", "shs", "shs_p",
        "means2d_ndc", "phasors_pre", "cov3d_pre", "view", "proj", "campos",
        "tan_fovx", "tan_fovy", "focal_x", "focal_y", "znear", "zfar",
        "depth_range", "phase_offset", "dc_offset")] + [
        (n, _F) for n in ("phase_offset_value", "dc_offset_value",
                          "scale_modifier")] + [
        (n, _I) for n in ("P", "sh_m", "shp_m", "shp_c", "pp_c", "width",
                          "height", "tile_w", "tile_h", "grid_w", "grid_h",
                          "use_vdp")]


OUTPUT_FIELDS = ("mean2d", "depth", "conic", "rgb", "phasor", "dist",
                 "dist_ndc", "radius", "rect", "tiles", "valid")


class _Outputs(ctypes.Structure):
    _fields_ = [(n, _PTR) for n in OUTPUT_FIELDS]


# The differentiable outputs, in the order of the forward's results.
COTANGENTS = ("mean2d", "depth", "conic", "rgb", "phasor", "dist", "dist_ndc")
GRAD_FIELDS = ("d_means3d", "d_scales", "d_rotations", "d_shs", "d_shs_p",
               "d_means2d_ndc", "d_phasors_pre", "d_cov3d_pre")


class _Grads(ctypes.Structure):
    _fields_ = ([(n, _PTR) for n in COTANGENTS]
                + [("s_" + n, _LL) for n in COTANGENTS]
                + [(n, _PTR) for n in GRAD_FIELDS + ("partials", "d_offsets")])


@functools.cache
def _lib() -> ctypes.CDLL:
    from gftorf_tpu_torch.render.kernels.build import library

    lib = library("preprocess")
    fn = lib.gftorf_preprocess_forward
    fn.argtypes = [_PTR, _PTR, _I, _PTR]
    fn.restype = _I
    fn = lib.gftorf_preprocess_backward
    fn.argtypes = [_PTR, _PTR, _I, _PTR, _PTR]
    fn.restype = _I
    fn = lib.gftorf_preprocess_occupancy
    fn.argtypes = [_I, _I, _PTR]
    fn.restype = _I
    return lib


def _ptr(x):
    return None if x is None else x.data_ptr()


def _offset(x, dev):
    """(device pointer, value) of a scalar offset: a tensor on ``dev`` is
    read by the kernel, a number or a CPU tensor passed by value."""
    if isinstance(x, torch.Tensor):
        if x.numel() != 1:
            raise ValueError(f"an offset must hold one value, got {tuple(x.shape)}")
        if x.device == dev:
            check_tensors({"offset": (x, torch.float32, tuple(x.shape))}, dev)
            return x.data_ptr(), 0.0
        if x.device.type != "cpu":
            raise ValueError(f"an offset on {x.device} for a render on {dev}")
    return None, float(x)


def _check_cuda(dev) -> None:
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")


def _params(means3d, scales, rotations, opacities, shs, shs_p, phase_offset,
            dc_offset, means2d_ndc, phasors_precomp, cov3d_precomp, camera,
            config, degree):
    """(the checked kernel arguments of one render, the tensors they point
    into that must outlive the launch). The camera's matrices may be
    stored transposed (``CameraSpec.create``): the kernel reads
    contiguous copies."""
    P = means3d.shape[0]
    dev = means3d.device
    _check_cuda(dev)
    if not 0 <= degree <= MAX_DEGREE:
        raise ValueError(f"active_sh_degree={degree}: the preprocess kernels "
                         f"take SH degrees 0-{MAX_DEGREE}")
    k = (degree + 1) ** 2
    cam = {name: getattr(camera, name).contiguous() for name in camera._fields}
    expect = {
        "means3d": (means3d, torch.float32, (P, 3)),
        "opacities": (opacities, torch.float32, (P,)),
        "means2d_ndc": (means2d_ndc, torch.float32, (P, 2)),
        "viewmatrix": (cam["viewmatrix"], torch.float32, (4, 4)),
        "projmatrix": (cam["projmatrix"], torch.float32, (4, 4)),
        "campos": (cam["campos"], torch.float32, (3,)),
    }
    for name in ("tan_fovx", "tan_fovy", "focal_x", "focal_y", "znear",
                 "zfar", "depth_range"):
        x = cam[name]
        if x.numel() != 1:
            raise ValueError(f"camera.{name} must hold one value")
        expect[name] = (x, torch.float32, tuple(x.shape))
    if cov3d_precomp is not None:
        expect["cov3d_precomp"] = (cov3d_precomp, torch.float32, (P, 6))
    else:
        expect["scales"] = (scales, torch.float32, (P, 3))
        expect["rotations"] = (rotations, torch.float32, (P, 4))
    sh_m = shp_m = shp_c = pp_c = 0
    if shs is not None:
        sh_m = shs.shape[1]
        expect["shs"] = (shs, torch.float32, (P, sh_m, 3))
        if sh_m < k:
            raise ValueError(f"shs holds {sh_m} coefficients, degree {degree} "
                             f"reads {k}")
    if shs_p is not None:
        shp_m, shp_c = shs_p.shape[1], shs_p.shape[2]
        expect["shs_p"] = (shs_p, torch.float32, (P, shp_m, shp_c))
        if shp_m < k or shp_c < 2:
            raise ValueError(f"shs_p {tuple(shs_p.shape)}: degree {degree} "
                             f"reads {k} coefficients of 2 channels")
    elif phasors_precomp is not None:
        pp_c = phasors_precomp.shape[1]
        expect["phasors_precomp"] = (phasors_precomp, torch.float32, (P, pp_c))
        if pp_c < 2:
            raise ValueError("phasors_precomp needs a phase and an amplitude column")
    check_tensors(expect, dev)
    po_ptr, po = _offset(phase_offset, dev)
    dc_ptr, dc = _offset(dc_offset, dev)
    params = _Params(
        means3d=means3d.data_ptr(),
        scales=None if cov3d_precomp is not None else scales.data_ptr(),
        rotations=None if cov3d_precomp is not None else rotations.data_ptr(),
        opacities=opacities.data_ptr(), shs=_ptr(shs), shs_p=_ptr(shs_p),
        means2d_ndc=means2d_ndc.data_ptr(),
        phasors_pre=None if shs_p is not None else _ptr(phasors_precomp),
        cov3d_pre=_ptr(cov3d_precomp), view=cam["viewmatrix"].data_ptr(),
        proj=cam["projmatrix"].data_ptr(), campos=cam["campos"].data_ptr(),
        tan_fovx=cam["tan_fovx"].data_ptr(), tan_fovy=cam["tan_fovy"].data_ptr(),
        focal_x=cam["focal_x"].data_ptr(), focal_y=cam["focal_y"].data_ptr(),
        znear=cam["znear"].data_ptr(), zfar=cam["zfar"].data_ptr(),
        depth_range=cam["depth_range"].data_ptr(), phase_offset=po_ptr,
        dc_offset=dc_ptr, phase_offset_value=po, dc_offset_value=dc,
        scale_modifier=float(config.scale_modifier), P=P, sh_m=sh_m,
        shp_m=shp_m, shp_c=shp_c, pp_c=pp_c, width=config.width,
        height=config.height, tile_w=config.tile_w, tile_h=config.tile_h,
        grid_w=config.grid_w, grid_h=config.grid_h,
        use_vdp=int(config.use_view_dependent_phase))
    return params, cam


def preprocess_forward_cuda(means3d, scales, rotations, opacities, shs, shs_p,
                            phase_offset, dc_offset, means2d_ndc, camera, config,
                            active_sh_degree, phasors_precomp=None,
                            cov3d_precomp=None):
    """Launch the forward kernel on the tensors' card. Returns (mean2d,
    depth_view, conic, rgb, phasor, dist, dist_ndc, radius, rect,
    tiles_touched, valid) as ``preprocess_plain`` computes them, ``rgb``
    zeros unless ``shs`` is given (``preprocess`` puts ``colors_precomp``
    in its place) and ``opacities`` (P,). Adds one to
    ``preprocess_forward_cuda.launches`` per launch."""
    params, _keep = _params(means3d, scales, rotations, opacities, shs,
                            shs_p, phase_offset, dc_offset, means2d_ndc,
                            phasors_precomp, cov3d_precomp, camera, config,
                            active_sh_degree)
    P, dev = params.P, means3d.device

    def f32(*shape):
        return torch.empty((P,) + shape, dtype=torch.float32, device=dev)

    outs = (f32(2), f32(), f32(3), f32(3), f32(7), f32(), f32(), f32(),
            torch.empty((P, 4), dtype=torch.int32, device=dev),
            torch.empty((P,), dtype=torch.int32, device=dev),
            torch.empty((P,), dtype=torch.bool, device=dev))
    if P == 0:
        return outs
    ptrs = _Outputs(*(x.data_ptr() for x in outs))
    with torch.cuda.device(dev):
        err = _lib().gftorf_preprocess_forward(
            ctypes.byref(params), ctypes.byref(ptrs), active_sh_degree,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"preprocess forward kernel launch failed: cudaError {err}")
    preprocess_forward_cuda.launches += 1
    debug_nans.check_output("the preprocess forward kernel", *outs[:8])
    return outs


preprocess_forward_cuda.launches = 0


def _cotangent(g, dev):
    """(tensor, row stride) the kernel reads a cotangent from: None stays
    None (zero); columns must be adjacent."""
    if g is None:
        return None, 0
    if g.dtype != torch.float32 or g.device != dev:
        raise ValueError(f"a cotangent of {g.dtype} on {g.device}, expected "
                         f"float32 on {dev}")
    if g.dim() > 1 and g.stride(-1) != 1:
        g = g.contiguous()
    return g, g.stride(0)


def preprocess_backward_cuda(means3d, scales, rotations, opacities, shs, shs_p,
                             phase_offset, dc_offset, means2d_ndc, camera,
                             config, active_sh_degree, cotangents, wanted,
                             phasors_precomp=None, cov3d_precomp=None):
    """Launch the backward kernel on the tensors' card: the gradients of
    the forward's inputs, given the cotangents of its seven differentiable
    outputs (``COTANGENTS`` order, None for zero). ``wanted`` names the
    gradients to compute, among ``means3d``, ``scales``, ``rotations``,
    ``shs``, ``shs_p``, ``means2d_ndc``, ``phasors_precomp``,
    ``cov3d_precomp``, ``phase_offset`` and ``dc_offset``; returns a dict
    of them (an offset's gradient shaped as the offset). Adds to
    ``preprocess_backward_cuda.launches`` and ``.sum_launches`` the
    launches of the backward kernel and of its second pass that the C
    entry reports."""
    params, _keep = _params(means3d, scales, rotations, opacities, shs,
                            shs_p, phase_offset, dc_offset, means2d_ndc,
                            phasors_precomp, cov3d_precomp, camera, config,
                            active_sh_degree)
    P, dev = params.P, means3d.device
    inputs = {"means3d": means3d, "scales": scales, "rotations": rotations,
              "shs": shs, "shs_p": shs_p, "means2d_ndc": means2d_ndc,
              "phasors_precomp": phasors_precomp, "cov3d_precomp": cov3d_precomp}
    # Inputs the forward did not read get no gradient.
    read = {"scales": cov3d_precomp is None, "rotations": cov3d_precomp is None,
            "phasors_precomp": shs_p is None}
    out = {name: torch.empty_like(x) for name, x in inputs.items()
           if name in wanted and x is not None and read.get(name, True)}
    # The offsets enter the phasor (phase_offset only through shs_p).
    offsets = {name: x for name, x, enters in (
        ("phase_offset", phase_offset, shs_p is not None),
        ("dc_offset", dc_offset, shs_p is not None or phasors_precomp is not None))
        if name in wanted and enters and isinstance(x, torch.Tensor)}
    if P == 0:
        out.update({n: torch.zeros_like(x) for n, x in offsets.items()})
        return out
    cots = [_cotangent(g, dev) for g in cotangents]
    fields = {n: _ptr(g) for n, (g, _) in zip(COTANGENTS, cots)}
    fields.update({"s_" + n: s for n, (_, s) in zip(COTANGENTS, cots)})
    fields.update({"d_" + n.replace("_precomp", "_pre"): x.data_ptr()
                   for n, x in out.items()})
    sums = None
    if offsets:
        blocks = -(-P // THREADS)
        partials = torch.empty((blocks, 2), dtype=torch.float32, device=dev)
        sums = torch.empty((2,), dtype=torch.float32, device=dev)
        fields.update(partials=partials.data_ptr(), d_offsets=sums.data_ptr())
    grads = _Grads(**fields)
    launched = (_I * 2)()
    with torch.cuda.device(dev):
        err = _lib().gftorf_preprocess_backward(
            ctypes.byref(params), ctypes.byref(grads), active_sh_degree,
            torch.cuda.current_stream(dev).cuda_stream, launched)
    preprocess_backward_cuda.launches += launched[0]
    preprocess_backward_cuda.sum_launches += launched[1]
    if err != 0:
        raise RuntimeError(f"preprocess backward kernel launch failed: cudaError {err}")
    for k, name in enumerate(("phase_offset", "dc_offset")):
        if name in offsets:
            out[name] = sums[k].reshape(offsets[name].shape)
    debug_nans.check_output("the preprocess backward kernel", *out.values())
    return out


preprocess_backward_cuda.launches = 0
preprocess_backward_cuda.sum_launches = 0


def occupancy(degree: int, backward: bool) -> dict:
    """Blocks per SM, registers, local bytes per thread and static shared
    bytes per block of one instance of csrc/preprocess.cu on the current
    card."""
    info = (ctypes.c_int * 4)()
    err = _lib().gftorf_preprocess_occupancy(degree, int(backward), info)
    if err != 0:
        raise RuntimeError(f"occupancy query failed: cudaError {err}")
    return dict(blocks_per_sm=info[0], registers=info[1], spill_bytes=info[2],
                shared_bytes=info[3])


# The forward's row and offset inputs, in ``PreprocessKernel.apply``'s
# order (the camera, config and degree that follow take no gradient).
_INPUTS = ("means3d", "scales", "rotations", "opacities", "shs",
                   "shs_p", "phase_offset", "dc_offset", "means2d_ndc",
                   "phasors_precomp", "cov3d_precomp")


class PreprocessKernel(torch.autograd.Function):
    """The two kernels as one autograd function.

    ``PreprocessKernel.apply(means3d, scales, rotations, opacities, shs,
    shs_p, phase_offset, dc_offset, means2d_ndc, phasors_precomp,
    cov3d_precomp, camera, config, active_sh_degree)`` returns
    ``preprocess_forward_cuda``'s eleven tensors. ``radius``, ``rect``,
    ``tiles_touched`` and ``valid`` are not differentiable. ``opacities``
    is only read for ``valid`` here: the opacity output is the input
    itself (``preprocess``), so its gradient never enters the kernel. The
    backward saves only the inputs and recomputes the rest."""

    @staticmethod
    def forward(ctx, means3d, scales, rotations, opacities, shs, shs_p,
                phase_offset, dc_offset, means2d_ndc, phasors_precomp,
                cov3d_precomp, camera, config, active_sh_degree):
        outs = preprocess_forward_cuda(
            means3d, scales, rotations, opacities, shs, shs_p, phase_offset,
            dc_offset, means2d_ndc, camera, config, active_sh_degree,
            phasors_precomp, cov3d_precomp)
        tensors = [x if isinstance(x, torch.Tensor) else None for x in
                   (means3d, scales, rotations, opacities, shs, shs_p,
                    phase_offset, dc_offset, means2d_ndc, phasors_precomp,
                    cov3d_precomp)]
        ctx.save_for_backward(*tensors)
        ctx.numbers = tuple(None if isinstance(x, torch.Tensor) else x
                            for x in (phase_offset, dc_offset))
        ctx.camera, ctx.config, ctx.degree = camera, config, active_sh_degree
        ctx.mark_non_differentiable(*outs[7:])
        ctx.set_materialize_grads(False)
        return outs

    @staticmethod
    def backward(ctx, *cotangents):
        with span("preprocess.backward"):
            saved = dict(zip(_INPUTS, ctx.saved_tensors))
            for name, number in zip(("phase_offset", "dc_offset"), ctx.numbers):
                if number is not None:
                    saved[name] = number
            wanted = {n for n, need in zip(_INPUTS, ctx.needs_input_grad)
                      if need}
            grads = preprocess_backward_cuda(
                saved["means3d"], saved["scales"], saved["rotations"],
                saved["opacities"], saved["shs"], saved["shs_p"],
                saved["phase_offset"], saved["dc_offset"],
                saved["means2d_ndc"], ctx.camera, ctx.config, ctx.degree,
                cotangents[:len(COTANGENTS)], wanted,
                saved["phasors_precomp"], saved["cov3d_precomp"])
        return tuple(grads.get(n) for n in _INPUTS) + (None, None, None)
