"""Multi-device rasterization over the ``shard`` axis of the mesh.

Counterpart of ``gftorf_tpu/parallel/sharded.py::rasterize_sharded``,
which runs inside ``shard_map``; here every rank of the shard group calls
it with the same (replicated) inputs and gets the same (replicated)
outputs:

 1. **Primitive sharding.** The P Gaussians are padded to ``per * n``
    rows (``per = ceil(P / n)``) and each rank preprocesses its ``per``
    rows; the packed (per, 24) compositor features and the binning keys
    (rect, depth, valid, radius) are all-gathered, so instance ids index
    the padded ``per * n`` layout.
 2. **Tile-row sharding.** The tile grid is split into bands of
    ``ceil(grid_h / n)`` rows. Each rank clips every rect to its band,
    bins into a local (rows * grid_w)-tile grid with 1/n of the
    duplicate capacity (at least 1024), and composites its band through
    the single-device stages (``render/rasterize.py``: ``bin_and_gather``,
    ``composite``, ``pixel_counts``), given the band's background slice
    and the tiles' global pixel origins, under the global image size (the
    inside-the-image test).
 3. **Reductions.** The (T, PIX, 32) output blocks are all-gathered back
    to the full image; the per-Gaussian touched-pixel counts are summed
    over the ranks, the radii all-gathered and cut to P; ``num_rendered``
    is summed, ``dup_overflow``, ``tile_overflow`` and ``tile_max`` are
    maxed, and ``rendered_worst`` is the deepest band's ``num_rendered``
    times n (what each band's 1/n capacity must hold, in the units of
    the global ``dup_factor``).

Gradients flow through both all-gathers (``collectives.all_gather_rows``)
back to each rank's own rows. JAX takes the flat path only on a TPU with
Pallas (``sharded.py:150-151``); the port takes it on either device, as
its single-device ``rasterize`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from gftorf_tpu_torch.parallel.collectives import (
    all_gather_rows,
    all_gather_stack,
    psum,
)
from gftorf_tpu_torch.render.composite import tiles_to_image
from gftorf_tpu_torch.render.kernels.dense import (
    _bg_to_tiles,
    pack_gaussian_features,
    unpack_outputs,
)
from gftorf_tpu_torch.render.preprocess import preprocess
from gftorf_tpu_torch.render.rasterize import bin_and_gather, composite, pixel_counts
from gftorf_tpu_torch.render.settings import CameraSpec, RasterConfig, RenderOutputs


def pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` with zero rows appended up to ``rows``."""
    pad = rows - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def band_origins(row0: int, rows: int, config: RasterConfig, device) -> torch.Tensor:
    """(rows * grid_w, 2) int32 global pixel origins (x, y) of the tiles of
    the band of ``rows`` tile rows that starts at tile row ``row0``."""
    t = torch.arange(rows * config.grid_w, dtype=torch.int32, device=device)
    return torch.stack([(t % config.grid_w) * config.tile_w,
                        (t // config.grid_w + row0) * config.tile_h], -1)


def rasterize_sharded(
    means3d, scales, rotations, opacities, shs, shs_p,
    phase_offset, dc_offset, means2d_ndc, bg_map,
    camera: CameraSpec, config: RasterConfig,
    group=None,
    active_sh_degree: int = 3,
    alive: Optional[torch.Tensor] = None,
    colors_precomp: Optional[torch.Tensor] = None,
    phasors_precomp: Optional[torch.Tensor] = None,
    flow_precomp: Optional[torch.Tensor] = None,
) -> RenderOutputs:
    """Render one camera over the ranks of ``group`` (the shard group; the
    default process group when None). The arguments and outputs are
    ``rasterize``'s, replicated on every rank; ``alive`` (P,) drops rows
    from binning like a failed cull."""
    group = dist.group.WORLD if group is None else group
    n, my = dist.get_world_size(group), dist.get_rank(group)
    P = means3d.shape[0]
    dev = means3d.device

    # ---- 1. primitive-sharded preprocess of my rows (sharded.py:79-101)
    per = -(-P // n)

    def my_rows(x):
        return None if x is None else pad_rows(x, per * n)[my * per:(my + 1) * per]

    pre = preprocess(
        my_rows(means3d), my_rows(scales), my_rows(rotations),
        my_rows(opacities.reshape(P)), my_rows(shs), my_rows(shs_p),
        phase_offset, dc_offset, my_rows(means2d_ndc), camera, config,
        active_sh_degree, my_rows(colors_precomp), my_rows(phasors_precomp),
    )
    valid = pre.valid if alive is None else pre.valid & my_rows(alive)
    packed = all_gather_rows(
        pack_gaussian_features(pre, flow=my_rows(flow_precomp)), group)
    # The binning keys in one gather: rect, valid and radius are small
    # integers, exact in float32.
    keys = all_gather_stack(torch.cat([
        pre.rect.float(), pre.depth_view.detach()[:, None],
        valid.float()[:, None], pre.radius.detach()[:, None]], -1),
        group).reshape(per * n, 7)
    rect = keys[:, :4].to(torch.int32)
    depth, valid_all, radius = keys[:, 4], keys[:, 5] > 0, keys[:, 6]

    # ---- 2. my band of tile rows (sharded.py:103-149)
    rows = -(-config.grid_h // n)
    row0 = my * rows
    local_rect = torch.stack([rect[:, 0], (rect[:, 1] - row0).clamp(0, rows),
                              rect[:, 2], (rect[:, 3] - row0).clamp(0, rows)], -1)
    local_cfg = dataclasses.replace(config, height=rows * config.tile_h)
    capacity = max(1024, config.capacity_for(P) // n)
    th = config.tile_h
    bg_p = torch.nn.functional.pad(bg_map, (0, 0, 0, rows * n * th - config.height))
    bg_tiles = _bg_to_tiles(bg_p[:, row0 * th:(row0 + rows) * th],
                            local_cfg.num_tiles, local_cfg)
    origins = band_origins(row0, rows, config, dev)
    has_flow = flow_precomp is not None
    binning, feat, ids = bin_and_gather(packed, local_rect, depth, valid_all,
                                        local_cfg, capacity)
    block, contrib, tile_overflow = composite(feat, binning, bg_tiles, origins,
                                              config, has_flow)

    # ---- 3. reductions (sharded.py:222-252)
    out = unpack_outputs(all_gather_rows(block, group), None)
    image_cfg = dataclasses.replace(config, height=rows * n * th)

    def image(tile_img):
        return tiles_to_image(tile_img, image_cfg)[:, :config.height]

    # ids index the padded rows: the counts are cut to P after the sum.
    pixels = psum(pixel_counts(ids, contrib, per * n), group)[:P]
    counts = all_gather_stack(torch.stack([
        binning.num_rendered.to(torch.int32),
        binning.dup_overflow.to(torch.int32), tile_overflow.to(torch.int32),
        binning.tile_max.to(torch.int32)]), group)
    return RenderOutputs(
        color=image(out.color),
        phasor=image(out.phasor),
        depth=image(out.depth),
        acc=image(out.acc),
        depth_distortion=image(out.dd),
        distribution=image(out.distribution),
        pixels=pixels[:, None],
        radii=radius[:P].to(torch.int32),
        num_rendered=counts[:, 0].sum().to(torch.int32),
        dup_overflow=counts[:, 1].amax() > 0,
        tile_overflow=counts[:, 2].amax(),
        tile_max=counts[:, 3].amax(),
        flow=image(out.flow) if has_flow else None,
        rendered_worst=(counts[:, 0].amax() * n).to(torch.int32),
    )
