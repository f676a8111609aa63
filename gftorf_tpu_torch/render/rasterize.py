"""Top-level differentiable rasterizer: preprocess -> bin -> gather ->
composite.

Port of ``gftorf_tpu/render/rasterize.py::rasterize`` and its flat-stream
path ``_rasterize_flat``. ``config.flat_stream`` picks the layout on either
device (in place of the JAX package's ``use_pallas and flat_stream and
jax.default_backend() == "tpu"`` switch): the dense (T, max_per_tile)
block through the ``DenseComposite`` autograd function
(``render/kernels/dense.py``), or the aligned sorted stream through
``FlatComposite`` (``render/kernels/flat.py``), where tile depth is
unbounded and ``tile_overflow`` is 0. The tensors' device picks the
compositor: on a CUDA tensor the Hopper kernels, on a CPU tensor their
plain PyTorch versions. Gradients reach every input of ``preprocess``,
``means2d_ndc`` (the densification signal; the reference's dL_dmean2D)
and ``flow_precomp`` (through the flow columns only, with detached
weights). Binning and the ``pixels`` counts stay out of the graph.

Determinism: the backward of the instance gather ``packed[gauss_id]`` is
a segment sum in a fixed order (``segment_sum_rows``), not the float
atomics of PyTorch's own gather backward on CUDA, so a training step
gives the same bits on every run.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gftorf_tpu_torch.render.binning import (
    Binning,
    FlatBinning,
    bin_gaussians,
    bin_gaussians_flat,
)
from gftorf_tpu_torch.render.composite import tiles_to_image
from gftorf_tpu_torch.render.kernels.dense import (
    DenseComposite,
    _bg_to_tiles,
    _default_origins,
    pack_gaussian_features,
    unpack_outputs,
)
from gftorf_tpu_torch.render.kernels.flat import composite_packed_flat
from gftorf_tpu_torch.render.preprocess import PreprocessOutputs, preprocess
from gftorf_tpu_torch.render.settings import CameraSpec, RasterConfig, RenderOutputs


def segment_sum_rows(rows: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """(n, ...) sums of the (K, ...) ``rows`` grouped by ``ids`` (K,), in a
    fixed order: a stable sort by id, then one sequential sum per segment
    (``torch.segment_reduce``). Rows whose id is negative are dropped."""
    key = torch.where(ids >= 0, ids.long(), n)
    key_s, order = torch.sort(key, stable=True)
    bounds = torch.searchsorted(
        key_s, torch.arange(n + 1, dtype=torch.int64, device=key.device))
    return torch.segment_reduce(rows[order], "sum",
                                lengths=bounds[1:] - bounds[:-1], unsafe=True)


class _GatherRows(torch.autograd.Function):
    """Rows of ``src`` at ``ids`` (K,), where a negative id reads row 0 and
    gets no gradient. The backward is ``segment_sum_rows`` (the JAX
    package's gather transposes to a deterministic scatter-add; PyTorch's
    own uses float atomics on CUDA)."""

    @staticmethod
    def forward(ctx, src, ids):
        ctx.save_for_backward(ids)
        ctx.n = src.shape[0]
        return src[ids.clamp(min=0).long()]

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return segment_sum_rows(grad.contiguous(), ids, ctx.n), None


gather_rows = _GatherRows.apply


class CompositeInputs(NamedTuple):
    """What rasterize hands the compositor, with the stages that made it."""

    pre: PreprocessOutputs
    binning: Binning | FlatBinning  # per config.flat_stream
    feat: torch.Tensor  # gathered packed features: dense (T, L, 24), flat (K_pad, 24)
    bg_tiles: torch.Tensor  # (T, PIX, 12)
    origins: torch.Tensor  # (T, 2) int32


def composite_inputs(
    means3d, scales, rotations, opacities, shs, shs_p, phase_offset,
    dc_offset, means2d_ndc, bg_map, camera: CameraSpec, config: RasterConfig,
    active_sh_degree: int = 3, colors_precomp=None, phasors_precomp=None,
    cov3d_precomp=None, flow_precomp=None,
) -> CompositeInputs:
    """Preprocess, bin, and gather the packed (P, 24) features into what
    the compositor reads: the dense (T, L, 24) block (rasterize.py:85-89),
    or with ``config.flat_stream`` the (K_pad, 24) aligned stream
    (rasterize.py:140-154), whose padding rows are exact zeros (opacity 0:
    dead lanes) and get no gradient."""
    P = means3d.shape[0]
    pre = preprocess(
        means3d, scales, rotations, opacities, shs, shs_p,
        phase_offset, dc_offset, means2d_ndc, camera, config,
        active_sh_degree, colors_precomp, phasors_precomp, cov3d_precomp,
    )
    T = config.num_tiles
    binner = bin_gaussians_flat if config.flat_stream else bin_gaussians
    binning = binner(pre.rect.detach(), pre.depth_view.detach(), pre.valid,
                     config, config.capacity_for(P))
    packed = pack_gaussian_features(pre, flow=flow_precomp)  # (P, 24)
    if config.flat_stream:
        ids = binning.gauss_flat
        # A padding id reads row 0: the select makes its row zero.
        feat = torch.where((ids >= 0)[:, None], gather_rows(packed, ids), 0.0)
    else:
        feat = gather_rows(packed, binning.gauss_id.reshape(-1)).reshape(
            *binning.gauss_id.shape, 24)
    return CompositeInputs(
        pre=pre,
        binning=binning,
        feat=feat,
        bg_tiles=_bg_to_tiles(bg_map, T, config),
        origins=_default_origins(T, config, means3d.device),
    )


def rasterize(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    opacities: torch.Tensor,
    shs: Optional[torch.Tensor],
    shs_p: Optional[torch.Tensor],
    phase_offset,
    dc_offset,
    means2d_ndc: torch.Tensor,
    bg_map: torch.Tensor,
    camera: CameraSpec,
    config: RasterConfig,
    active_sh_degree: int = 3,
    colors_precomp: Optional[torch.Tensor] = None,
    phasors_precomp: Optional[torch.Tensor] = None,
    cov3d_precomp: Optional[torch.Tensor] = None,
    flow_precomp: Optional[torch.Tensor] = None,
) -> RenderOutputs:
    """Render one camera; same arguments and outputs as the JAX
    ``rasterize``, differentiable like it."""
    P = means3d.shape[0]
    args = (means3d, scales, rotations, opacities, shs, shs_p, phase_offset,
            dc_offset, means2d_ndc, bg_map, camera, config, active_sh_degree,
            colors_precomp, phasors_precomp, cov3d_precomp, flow_precomp)
    has_flow = flow_precomp is not None
    ci = composite_inputs(*args)
    binning = ci.binning
    if config.flat_stream:
        out = composite_packed_flat(
            ci.feat, binning.tile_start, binning.tile_count, ci.bg_tiles,
            ci.origins, config, has_flow)
        ids = binning.gauss_flat
        tile_overflow = torch.zeros((), dtype=torch.int32, device=ids.device)
    else:
        out = unpack_outputs(*DenseComposite.apply(
            ci.feat, ci.bg_tiles, binning.tile_count, ci.origins, config,
            has_flow))
        ids = binning.gauss_id.reshape(-1)
        tile_overflow = binning.tile_overflow

    # Per-Gaussian touched-pixel counts: a sum of integer-valued float32
    # counts below 2**24, exact (so deterministic) in any order. Empty
    # slots (id -1) add their count of 0 to Gaussian 0.
    pixels = torch.zeros(P, dtype=torch.float32, device=means3d.device)
    pixels.index_add_(0, ids.clamp(min=0).to(torch.int64),
                      out.contrib_pixels.reshape(-1))

    return RenderOutputs(
        color=tiles_to_image(out.color, config),
        phasor=tiles_to_image(out.phasor, config),
        depth=tiles_to_image(out.depth, config),
        acc=tiles_to_image(out.acc, config),
        depth_distortion=tiles_to_image(out.dd, config),
        distribution=tiles_to_image(out.distribution, config),
        pixels=pixels[:, None],
        radii=ci.pre.radius.detach().to(torch.int32),
        num_rendered=binning.num_rendered,
        dup_overflow=binning.dup_overflow,
        tile_overflow=tile_overflow,
        tile_max=binning.tile_max,
        rendered_worst=binning.num_rendered,
        flow=(None if flow_precomp is None
              else tiles_to_image(out.flow, config)),
    )
