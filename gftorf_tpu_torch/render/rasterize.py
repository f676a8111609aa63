"""Top-level rasterizer: preprocess -> bin -> gather -> composite.

Port of ``gftorf_tpu/render/rasterize.py::rasterize``, dense forward path.
The compositor is chosen by the tensors' device (in place of the JAX
package's ``jax.default_backend() == "tpu"`` switch): on a CUDA tensor it
is the Hopper kernel of ``render/kernels/dense.py``, on a CPU tensor its
plain PyTorch version.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gftorf_tpu_torch.render.binning import Binning, bin_gaussians
from gftorf_tpu_torch.render.composite import tiles_to_image
from gftorf_tpu_torch.render.kernels.dense import (
    _bg_to_tiles,
    _default_origins,
    composite_forward,
    pack_gaussian_features,
    unpack_outputs,
)
from gftorf_tpu_torch.render.preprocess import PreprocessOutputs, preprocess
from gftorf_tpu_torch.render.settings import CameraSpec, RasterConfig, RenderOutputs


class CompositeInputs(NamedTuple):
    """What rasterize hands the compositor, with the stages that made it."""

    pre: PreprocessOutputs
    binning: Binning
    feat_tl: torch.Tensor  # (T, L, 24) gathered packed features
    bg_tiles: torch.Tensor  # (T, PIX, 12)
    counts: torch.Tensor  # (T,) int32
    origins: torch.Tensor  # (T, 2) int32


def composite_inputs(
    means3d, scales, rotations, opacities, shs, shs_p, phase_offset,
    dc_offset, means2d_ndc, bg_map, camera: CameraSpec, config: RasterConfig,
    active_sh_degree: int = 3, colors_precomp=None, phasors_precomp=None,
    cov3d_precomp=None, flow_precomp=None,
) -> CompositeInputs:
    """Preprocess, bin, and gather the packed (P, 24) features into the
    (T, L, 24) block the compositor reads (rasterize.py:85-89)."""
    P = means3d.shape[0]
    pre = preprocess(
        means3d, scales, rotations, opacities, shs, shs_p,
        phase_offset, dc_offset, means2d_ndc, camera, config,
        active_sh_degree, colors_precomp, phasors_precomp, cov3d_precomp,
    )
    binning = bin_gaussians(pre.rect.detach(), pre.depth_view.detach(),
                            pre.valid, config, config.capacity_for(P))
    T, L = binning.gauss_id.shape
    idc = binning.gauss_id.clamp(min=0).to(torch.int64).reshape(-1)
    packed = pack_gaussian_features(pre, flow=flow_precomp)  # (P, 24)
    feat_tl = packed[idc].reshape(T, L, 24)
    return CompositeInputs(
        pre=pre,
        binning=binning,
        feat_tl=feat_tl,
        bg_tiles=_bg_to_tiles(bg_map, T, config),
        counts=binning.tile_count,
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
    ``rasterize`` (forward only in this slice)."""
    P = means3d.shape[0]
    ci = composite_inputs(
        means3d, scales, rotations, opacities, shs, shs_p, phase_offset,
        dc_offset, means2d_ndc, bg_map, camera, config, active_sh_degree,
        colors_precomp, phasors_precomp, cov3d_precomp, flow_precomp,
    )
    out_blk, contrib = composite_forward(ci.feat_tl, ci.bg_tiles, ci.counts,
                                         ci.origins, config)
    out = unpack_outputs(out_blk, contrib)

    # Per-Gaussian touched-pixel counts: a sum of integer-valued float32
    # counts below 2**24, exact (so deterministic) in any order.
    idc = ci.binning.gauss_id.clamp(min=0).to(torch.int64).reshape(-1)
    pixels = torch.zeros(P, dtype=torch.float32, device=means3d.device)
    pixels.index_add_(0, idc, contrib.reshape(-1))

    binning = ci.binning
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
        tile_overflow=binning.tile_overflow,
        tile_max=binning.tile_max,
        rendered_worst=binning.num_rendered,
        flow=(None if flow_precomp is None
              else tiles_to_image(out.flow, config)),
    )
