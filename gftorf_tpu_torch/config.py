"""Configuration system mirroring the reference's three ParamGroups.

The port's own copy of ``gftorf_tpu/config.py``: the same dataclasses,
fields, defaults and JSON keys, so both packages load
configs/{torf,ftorf}.json to equal fields. Field names are kept verbatim
from the reference's arguments/__init__.py:50-207. Precedence: dataclass
defaults < JSON config < CLI overrides (same as train.py:624-626).

TPU-only knobs are accepted so that configs load, and are no-ops on the
GPU: ``deform_precision`` (MXU pass tiers; the port's deform MLP always
runs in fp32), ``use_pallas`` (the compositor is chosen by the tensors'
device) and the ``GFTORF_*_CHUNK`` environment variables (Pallas lane
chunks), which the port never reads: the dense ones and
``GFTORF_FLAT_FWD_CHUNK`` / ``GFTORF_FLAT_BWD_CHUNK`` alike (the flat
stream's alignment is fixed at 256, the JAX package's default).
``check_vmem_cap`` keeps its switch and changes its check (see TpuParams).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class ModelParams:
    """Data/model parameters (arguments/__init__.py:50-118)."""

    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    bg_color: List[float] = field(default_factory=lambda: [0.0] * 7)
    random_bg_color: bool = False
    data_device: str = "tpu"
    eval: bool = False

    dynamic: bool = False
    shuffle_frames: bool = False

    D: int = 8
    W: int = 256
    xyz_multires: int = 10
    t_multires: int = 10
    use_timenet: bool = False

    dataset_type: str = "real"
    total_num_views: int = 30
    train_views: str = ""
    total_num_spiral_views: int = 60

    tof_image_width: int = 320
    tof_image_height: int = 240
    tof_scale_factor: float = 1.0

    color_image_width: int = 320
    color_image_height: int = 240
    color_scale_factor: float = 1.0

    min_depth_fac: float = 0.05
    max_depth_fac: float = 0.55
    depth_range: float = 10.0  # c/f, twice the unambiguous ToF range
    phase_offset: float = -99.0

    dc_offset: float = 0.0
    tof_permutation: str = ""

    use_view_dependent_phase: bool = False

    init_method: str = "random"
    num_points: int = 100_000
    phase_resolution_stride: int = 2
    initial_opacity: float = 0.1
    initial_amplitude: float = 0.1

    quad_scale: float = -1.0

    init_static_dynamic_separation: bool = False
    init_static_first: bool = False

    isotropic_gaussians: bool = False
    xavier_init_dxyz: bool = False
    start_id: int = 0

    seed: int = 0


@dataclass
class PipelineParams:
    """(arguments/__init__.py:120-125)."""

    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False


@dataclass
class OptimizationParams:
    """(arguments/__init__.py:127-207)."""

    iterations: int = 30_000
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000

    acc_loss_iter_start: int = 0
    dd_loss_iter_start: int = 0
    dd_loss_iter_end: int = 0
    tof_iters: int = 2000
    warm_up: int = 2000
    flow_loss_iter_start: int = 2000

    lambda_color: float = 0.0
    lambda_tof: float = 1.0
    num_phasor_channels: int = 2
    lambda_depth: float = 0.0

    lambda_acc: float = 0.0
    lambda_dd: float = 0.0
    use_wl1c: bool = False
    use_wl1p: bool = False
    wl1p_e: float = 0.1
    lambda_flow: float = 0.01

    use_opacity_entropy_loss: bool = False
    oe_loss_iter_start: int = 2000
    oe_loss_iter_end: int = 20000
    lambda_oe: float = 0.01

    use_scale_loss: bool = False
    scale_loss_iter_start: int = 0
    scale_loss_iter_end: int = 20000
    lambda_scale: float = 0.1

    deform_lr_init: float = 0.0008
    deform_lr_final: float = 0.0000016

    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016

    feature_phase_lr_init: float = 0.0
    feature_phase_lr_final: float = 0.0

    feature_amp_lr_init: float = 0.00016
    feature_amp_lr_final: float = 0.00016

    feature_seg_lr: float = 0.0
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    min_opacity: float = 0.01

    optimize_offset_start: int = 4000
    optimize_phase_offset: bool = False
    phase_offset_lr: float = 0.000001
    optimize_dc_offset: bool = False
    dc_offset_lr: float = 0.000001

    use_quad: bool = False
    optimize_sync_iters: int = -1
    lambda_mlp_reg: float = 0.0


@dataclass
class TpuParams:
    """TPU-framework-specific knobs (no reference counterpart)."""

    max_per_tile: int = 1024
    # Hard ceiling for automatic max_per_tile growth on tile overflow.
    max_per_tile_limit: int = 16384
    dup_factor: int = 12
    # Hard ceiling for automatic dup_factor growth on duplicate-list
    # overflow (the reference sizes the list exactly every step,
    # rasterizer_impl.cu:311; we grow-and-replay on overflow instead).
    dup_factor_limit: int = 96
    # Trust region on the deform MLP output, as a fraction of the scene
    # extent (0 = off). Guards against the early-training divergence
    # where d_xyz explodes and evacuates the frustum.
    deform_clip: float = 0.5
    tile_chunk: int = 64
    capacity: int = 0  # 0 -> auto: next power-of-two >= 2*num_points
    capacity_growth: float = 1.5
    # Steps to lag metric fetches behind dispatch (0 = synchronous).
    metrics_lag: int = 1
    # --debug image-dump cadence (reference dumps every camera visit).
    debug_interval: int = 200
    mesh_shards: int = 1  # devices for tile/primitive sharding
    mesh_data: int = 1  # devices for camera data-parallelism
    use_pallas: bool = True
    # Flat sorted-stream compositor (render/kernels/flat.py): each tile's
    # instances are one segment of the depth-sorted duplicate stream, so
    # tile depth is unbounded (no truncation at max_per_tile). The Trainer
    # copies it into RasterConfig.flat_stream. The port takes the path on
    # either device (the Hopper kernels csrc/flat_{forward,backward}.cu on
    # the card, their plain versions on the CPU), where the JAX package
    # takes it only on a TPU.
    flat_stream: bool = False
    # What the Trainer does when a scene's deepest tile outgrows
    # max_per_tile_limit:
    #   "flat"     — switch to the exact flat-stream compositor (no
    #                tile-depth bound) and switch back once the scene
    #                thins out. Default: the reference rasterizer is
    #                never lossy (rasterizer_impl.cu:311 sizes buffers
    #                exactly). Available on CUDA (the JAX package: on a
    #                TPU); on the CPU the Trainer truncates, as the JAX
    #                package does there.
    #   "truncate" — keep the dense kernels and drop the deepest
    #                instances with a one-time warning (explicit opt-in).
    tile_overflow_fallback: str = "flat"
    # Verify at Trainer start-up that the card would launch every instance
    # of the dense backward kernel the step launches at the tile shape
    # (CUDA only): the Trainer asks the card for each instance's blocks
    # per SM and raises if it would refuse one
    # (render/kernels/dense.py::check_backward_fits); no kernel runs. The
    # JAX package's check is a compile of its Pallas kernel at the
    # VMEM-calibrated ceiling (render/vmem_check.py); the Hopper kernels
    # stage instances through shared memory in batches and have no
    # tile-depth ceiling, so the port clamps nothing.
    check_vmem_cap: bool = True
    # Gather alive rows into a next-pow2 bucket before rasterization so
    # per-Gaussian preprocess cost tracks the live count, not capacity.
    compact_render: bool = True
    # Adaptive buffer shrinking: every `shrink_window` resolved steps the
    # Trainer compares the occupancy high-water marks (deepest tile,
    # instances rendered) against the current max_per_tile / dup_factor
    # and shrinks any capacity sitting >2x above its 1.35x-margined need
    # (gather + kernel-lane volume scale with these). Overflow from an
    # over-eager shrink is lossless — the grow-and-replay path restores
    # exactness at the cost of one recompile. 0 disables.
    shrink_window: int = 200
    max_per_tile_floor: int = 256
    dup_factor_floor: int = 2
    # MXU pass tier of the JAX package's deform-MLP matmuls. A no-op in
    # the port: its deform MLP always runs in fp32, the reference's own
    # MLP precision.
    deform_precision: str = "default"
    # Compositing tile shape (the reference is pinned at 16x16, config.h
    # BLOCK_X/Y). The port's kernel runs one thread per pixel, so a tile
    # holds at most 1024 pixels.
    tile_h: int = 16
    tile_w: int = 32
    test_iterations: List[int] = field(default_factory=list)
    save_iterations: List[int] = field(default_factory=list)
    checkpoint_iterations: List[int] = field(default_factory=list)


@dataclass
class Config:
    model: ModelParams = field(default_factory=ModelParams)
    opt: OptimizationParams = field(default_factory=OptimizationParams)
    pipe: PipelineParams = field(default_factory=PipelineParams)
    tpu: TpuParams = field(default_factory=TpuParams)

    @staticmethod
    def from_json(path: str, overrides: Optional[dict] = None) -> "Config":
        with open(path) as f:
            data = json.load(f)
        return Config.from_dict(data, overrides)

    @staticmethod
    def from_dict(data: dict, overrides: Optional[dict] = None) -> "Config":
        cfg = Config()
        merged = dict(data)
        if overrides:
            merged.update({k: v for k, v in overrides.items() if v is not None})
        known = set()
        for group in (cfg.model, cfg.opt, cfg.pipe, cfg.tpu):
            names = {f.name for f in dataclasses.fields(group)}
            known |= names
            for k, v in merged.items():
                if k in names:
                    setattr(group, k, v)
        return cfg

    def to_dict(self) -> dict:
        out = {}
        for group in (self.model, self.opt, self.pipe, self.tpu):
            out.update(dataclasses.asdict(group))
        return out

    def save(self, folder: str, name: str = "cfg_args_full.json") -> None:
        os.makedirs(folder, exist_ok=True)
        with open(os.path.join(folder, name), "w") as f:
            json.dump(self.to_dict(), f, indent=4)
