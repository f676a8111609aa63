"""Host-side training orchestration (the reference train.py:39-482 loop).

Port of ``gftorf_tpu/train/loop.py::Trainer``. The inner step is
``train_step``; this loop handles everything with host-visible control
flow: camera sampling, the densify / prune / opacity-reset cadence, SH
warm-up, capacity growth and shrinking, the flat-stream fallback, and
checkpoints.

Where the port differs from a line-by-line copy:

- Random draws. The JAX Trainer derives every draw from
  ``fold_in(key, it)``, so a replayed step draws what it drew the first
  time. Here each dispatch gets a fresh ``torch.Generator`` seeded from
  (seed, it), and densify's split noise one seeded from
  (seed, 1_000_000 + it), so replays and densify's capacity-growth retries
  redraw the same numbers. The deform MLP is initialised from seed + 1.
- The metrics pipeline. ``train_step`` returns its metrics on the device;
  on CUDA they are copied without blocking into pinned host memory behind a
  recorded event, and read ``metrics_lag`` steps later by waiting on that
  event, so no step waits for its own results. The host reads the device
  only at events (buckets, densify, reset, drain). Rollback records hold
  references to the pre-step state: ``train_step`` leaves its inputs
  unchanged, so nothing is copied.
- Tile depth. The Hopper kernels stage instances through shared memory in
  batches, so tile depth has no ceiling there: the JAX Trainer's VMEM clamp
  of ``max_per_tile_limit`` (``max_feasible_tile_cap``) has no counterpart.
  Its compile check (``check_bwd_cap``) becomes ``check_backward_fits`` at
  start-up on CUDA: the card's occupancy query of each dense backward
  instance the step launches, which raises where a launch would be
  refused.
- The flat-stream fallback (a scene's deepest tile outgrowing
  ``max_per_tile_limit``) is available on CUDA, where the JAX package
  needs a TPU; on the CPU the port truncates with a warning as JAX does on
  the CPU.
- The A/B toggles ``GFTORF_COMPACT_LAYOUT``, ``GFTORF_STATIC_FLOW`` and
  ``GFTORF_SSIM_IMPL`` are read once, here at init.
- The mesh. The JAX Trainer is one controller over every device of its
  (data, shard) mesh. Here each rank of a ``torch.distributed`` process
  group runs this same host loop (``TpuParams.mesh_data`` x
  ``mesh_shards`` ranks, ``parallel/mesh.py``): every rank seeds the same
  host RNG, so all draw the same ``data`` cameras per iteration and each
  trains its data slice's; every host decision (grow-and-replay, shrink,
  the flat fallback, densify, prune, sort) reads values that the step
  reduced to the same bits on every rank, so the ranks stay in lockstep.
  Each data slice's random background comes from (seed, it, slice), and
  slice 0's is the single-device draw. Only rank 0 writes
  (``is_writer``): the start-up artifacts and, through its callers, the
  log, evaluations, saves and checkpoints, while the others wait at
  ``barrier``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import random
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from gftorf_tpu_torch.config import Config
from gftorf_tpu_torch.data.scene import Scene
from gftorf_tpu_torch.models.deform import DeformConfig, deform_params, init_deform
from gftorf_tpu_torch.models.gaussians import (
    AdamState,
    DensifyHyper,
    densify_and_prune,
    get_motion_mask,
    grow_capacity,
    prune_only,
    reset_opacity_state,
    sort_layout,
)
from gftorf_tpu_torch.parallel.mesh import cached_mesh
from gftorf_tpu_torch.render.settings import RasterConfig
from gftorf_tpu_torch.train.step import (
    METRIC_NAMES,
    SchedStatic,
    StepStatic,
    train_step,
)
from gftorf_tpu_torch.utils.checkpoint import (
    load_pytree,
    save_pytree,
    tree_leaves,
    tree_unflatten,
)
from gftorf_tpu_torch.utils.runtime import resolve_device
from gftorf_tpu_torch.utils.trace import span
from gftorf_tpu_torch.weights import (
    deform_adam_from_numpy,
    deform_dict_from_numpy,
    deform_dict_to_numpy,
)

# Offset of densify's split-noise seeds from the step seeds (loop.py:713).
DENSIFY_SEED_OFFSET = 1_000_000
# A data slice's random-background seed adds its index at this bit.
DATA_SLICE_SEED_SHIFT = 56


class Trainer:
    """The training loop over one ``Scene`` on one device (``device=None``
    means the CUDA card), or on one rank of a mesh: with
    ``mesh_data * mesh_shards`` > 1, or under a process group of more than
    one rank, every rank of the (initialised) ``torch.distributed`` group
    constructs its own Trainer with the same config and calls the same
    methods in the same order."""

    def __init__(self, cfg: Config, scene: Optional[Scene] = None,
                 startup_artifacts: bool = True, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # The mesh (loop.py:213-229): every rank of the process group.
        data_ax = max(1, cfg.tpu.mesh_data)
        shard_ax = max(1, cfg.tpu.mesh_shards)
        multi = dist.is_initialized() and dist.get_world_size() > 1
        if data_ax * shard_ax > 1 and not multi:
            raise RuntimeError(
                f"mesh_data*mesh_shards={data_ax * shard_ax}: run one rank per "
                "mesh place under torch.distributed.run (the train CLI's "
                "--distributed)")
        self.mesh = cached_mesh(data_ax, shard_ax) if multi else None
        self.mesh_shape = (data_ax, shard_ax) if data_ax * shard_ax > 1 else None
        self.data_ax = data_ax
        self.is_writer = self.mesh is None or self.mesh.rank == 0
        # Seed before the Scene: its random point-cloud init draws from the
        # global np.random, and the camera pick from random (loop.py:65-75).
        m, opt = cfg.model, cfg.opt
        random.seed(m.seed)
        np.random.seed(m.seed)
        self.seed = m.seed
        self.scene = scene or Scene(cfg, device=self.device)

        self.opt = opt
        self.iteration = 0
        self.active_sh_degree = 0
        self.lambda_color = opt.lambda_color
        self.opacity_reset_interval = opt.opacity_reset_interval

        # Init-time sanity artifacts (cameras.json, scene_bounds.png,
        # scene/__init__.py:63-83), drawn without a plotting library; a
        # file that cannot be written must not stop training.
        if m.model_path and startup_artifacts and self.is_writer:
            from gftorf_tpu_torch.data.scene import (
                write_scene_bounds_png,
                write_scene_metadata,
            )

            try:
                write_scene_metadata(self.scene, m.model_path)
                write_scene_bounds_png(self.scene, m.model_path)
            except OSError as e:
                print(f"[warn] scene metadata/bounds write failed: {e}",
                      flush=True)

        # The A/B toggles (ROADMAP, Port conventions), read once.
        self.compact_layout = os.environ.get("GFTORF_COMPACT_LAYOUT", "1") != "0"
        self.static_flow = os.environ.get("GFTORF_STATIC_FLOW", "1") != "0"
        self.ssim_impl = os.environ.get("GFTORF_SSIM_IMPL", "banded")

        # Rows sorted [dynamic+alive | static+alive | dead], re-established
        # at every event that changes the alive/motion partition.
        self.model = sort_layout(self.scene.model_state)
        self.deform_cfg = DeformConfig(
            depth=m.D, width=m.W, xyz_multires=m.xyz_multires,
            t_multires=m.t_multires, sh_degree=m.sh_degree,
            xavier_init_dxyz=m.xavier_init_dxyz,
            isotropic=m.isotropic_gaussians,
        )
        self.deform = deform_params(init_deform(
            self.deform_cfg, torch.Generator().manual_seed(m.seed + 1),
            device=self.device))
        self.deform_adam = AdamState(
            mu={k: torch.zeros_like(v) for k, v in self.deform.items()},
            nu={k: torch.zeros_like(v) for k, v in self.deform.items()},
            step=torch.zeros((), dtype=torch.int32, device=self.device))

        self.viewpoint_stack: list = []
        self.ema_loss = 0.0
        self.history: list = []
        self.metrics_lag = max(0, cfg.tpu.metrics_lag)
        self._pending: list = []
        # Host seconds of each step() call whose record is still pending.
        self._step_s: dict = {}
        self.tile_cap = cfg.tpu.max_per_tile
        self.tile_cap_limit = max(self.tile_cap, cfg.tpu.max_per_tile_limit)
        # Active compositor layout: flat_stream may flip on (the fallback)
        # and back; _flat_auto marks an automatic switch.
        self.flat_stream = bool(cfg.tpu.flat_stream)
        self._flat_auto = False
        self._flat_fallback_ok = (self.device.type == "cuda"
                                  and cfg.tpu.tile_overflow_fallback == "flat")
        self.dd_possible = (opt.lambda_dd != 0.0
                            and opt.dd_loss_iter_end > opt.dd_loss_iter_start + 1)
        self.backward_fits: dict = {}
        if self.device.type == "cuda" and cfg.tpu.check_vmem_cap:
            self.check_backward_fits()
        self._tile_limit_warned = False
        self.dup_factor = cfg.tpu.dup_factor
        self.dup_factor_limit = max(self.dup_factor, cfg.tpu.dup_factor_limit)
        self._dup_limit_warned = False
        # Adaptive shrinking (see TpuParams.shrink_window).
        self.shrink_window = cfg.tpu.shrink_window
        self.tile_cap_floor = cfg.tpu.max_per_tile_floor
        self.dup_factor_floor = cfg.tpu.dup_factor_floor
        self._occ_steps = 0
        self._occ_tile_max = 0
        self._occ_rendered_max = 0


        if self.scene.scene_type == "torf":
            self.render_regions = ("dynamic",)
        elif m.init_static_first:
            self.render_regions = ("static",)
        else:
            self.render_regions = ("static", "dynamic")

        self.deform_bucket = 0
        self.render_bucket = 0
        self._update_deform_bucket()

    # ------------------------------------------------------------------
    def check_backward_fits(self) -> None:
        """Raise unless the card launches every instance of the dense
        backward kernel that this Trainer's steps launch
        (``render/kernels/dense.py::check_backward_fits``, the counterpart
        of the JAX Trainer's ``check_bwd_cap``, render/vmem_check.py); keep
        each instance's occupancy, registers and spill bytes in
        ``backward_fits``. No kernel runs."""
        from gftorf_tpu_torch.render.kernels import dense

        t = self.cfg.tpu
        self.backward_fits = dense.check_backward_fits(
            t.tile_h, t.tile_w, self.dd_possible, self.device)

    def barrier(self) -> None:
        """Wait for every rank of the mesh (nothing on one device)."""
        if self.mesh is not None:
            dist.barrier()

    def check_ranks_agree(self) -> str:
        """A SHA-1 digest of this rank's state (the checkpoint tree and the
        host capacities); under a mesh every rank must call it, and it
        raises unless every rank holds the same digest."""
        h = hashlib.sha1(repr((self.iteration, self.tile_cap, self.dup_factor,
                               self.flat_stream)).encode())
        for leaf in tree_leaves(self._checkpoint_tree()):
            leaf = leaf.detach().cpu().numpy() if torch.is_tensor(leaf) else leaf
            h.update(np.ascontiguousarray(leaf).tobytes())
        digest = h.hexdigest()
        if self.mesh is not None:
            every = [None] * dist.get_world_size()
            dist.all_gather_object(every, digest)
            if len(set(every)) != 1:
                raise RuntimeError(f"the ranks' states differ: digests {every}")
        return digest

    def _rng(self, offset: int, data_slice: int = 0) -> torch.Generator:
        """The generator of one draw: seeded from (seed, offset, data
        slice), so the same offset (an iteration) always draws the same
        numbers; slice 0 draws what one device draws."""
        return torch.Generator(device=self.device).manual_seed(
            (self.seed << 32) + offset + (data_slice << DATA_SLICE_SEED_SHIFT))

    def _update_deform_bucket(self):
        """Compaction buckets: next pow2 over the live counts (+5 %
        headroom); the deform MLP evaluates the dynamic+alive rows, the
        render path the alive rows. Both counts change only at densify and
        prune events, where this is called."""
        cap = int(self.model.aux.alive.shape[0])

        def bucket(count):
            b = 1024
            while b < int(count * 1.05) + 1:
                b *= 2
            return 0 if b >= cap else b

        alive = self.model.aux.alive
        if self.cfg.model.dynamic:
            self.deform_bucket = bucket(int(
                (get_motion_mask(self.model.params) & alive).sum()))
        else:
            self.deform_bucket = 0
        self.render_bucket = (bucket(int(alive.sum()))
                              if self.cfg.tpu.compact_render else 0)

    # ------------------------------------------------------------------
    def _raster_config(self, tof: bool) -> RasterConfig:
        cfg = self.scene.raster_config(tof, self.cfg.model.sh_degree)
        return dataclasses.replace(cfg, max_per_tile=self.tile_cap,
                                   dup_factor=self.dup_factor,
                                   flat_stream=self.flat_stream)

    def _static_for(self, iteration: int,
                    flow_frame: Optional[bool] = None) -> StepStatic:
        m, opt = self.cfg.model, self.opt
        scene = self.scene
        dynamic_on = m.dynamic and iteration > opt.warm_up
        regions = self.render_regions
        if dynamic_on and scene.scene_type == "ftorf":
            regions = ("static", "dynamic")
        flow_on = (scene.scene_type == "ftorf" and opt.lambda_flow != 0.0
                   and dynamic_on)
        return StepStatic(
            scene_type=scene.scene_type,
            # The loss reads depth_distortion from the ToF render only, and
            # never the first-sample distribution.
            config_color=dataclasses.replace(
                self._raster_config(False), need_dd=False,
                need_distribution=False),
            config_tof=dataclasses.replace(
                self._raster_config(True), need_dd=self.dd_possible,
                need_distribution=False),
            deform=self.deform_cfg,
            active_sh_degree=self.active_sh_degree,
            total_num_views=m.total_num_views,
            render_regions=regions,
            dynamic_on=dynamic_on,
            sync_phase=(opt.use_quad and opt.warm_up < iteration
                        <= opt.optimize_sync_iters),
            use_quad=opt.use_quad,
            use_wl1c=opt.use_wl1c,
            use_wl1p=opt.use_wl1p,
            wl1p_e=opt.wl1p_e,
            num_phasor_channels=opt.num_phasor_channels,
            # strict <: a tof_iters flip at the final iteration never
            # takes effect
            color_on=(opt.lambda_color != 0.0
                      or 0 < opt.tof_iters < opt.iterations),
            depth_on=opt.lambda_depth != 0.0,
            dd_on=self.dd_possible,
            oe_on=opt.use_opacity_entropy_loss,
            scale_on=opt.use_scale_loss,
            mlp_reg_on=opt.lambda_mlp_reg != 0.0,
            flow_on=flow_on,
            flow_frame=flow_frame if flow_on else None,
            optimize_phase_offset=opt.optimize_phase_offset,
            optimize_dc_offset=opt.optimize_dc_offset,
            random_bg=m.random_bg_color,
            bg_color=tuple(m.bg_color),
            tof_permutation=scene.tof_permutation,
            tof_inverse_permutation=scene.tof_inverse_permutation,
            scene_extent=scene.scene_extent,
            single_camera=scene.cameras_identical,
            deform_sync=iteration <= opt.optimize_sync_iters,
            frozen_gauss=iteration >= opt.densify_until_iter,
            # Initial values: the step applies the tof_iters flip and the
            # reset-interval halving itself.
            sched=SchedStatic.from_opt(opt, opt.lambda_color,
                                       opt.opacity_reset_interval),
            mesh_shape=self.mesh_shape,
            deform_bucket=self.deform_bucket,
            render_bucket=self.render_bucket,
            compact_layout=self.compact_layout,
            deform_clip=self.cfg.tpu.deform_clip,
            ssim_impl=self.ssim_impl,
        )

    def _pick_camera(self) -> int:
        m = self.cfg.model
        while True:
            if not self.viewpoint_stack:
                self.viewpoint_stack = list(range(self.scene.num_train))
            idx = self.viewpoint_stack.pop(
                random.randint(0, len(self.viewpoint_stack) - 1))
            if self.scene.data.train_cameras[idx].frame_id >= m.start_id:
                return idx

    # ------------------------------------------------------------------
    def _dispatch(self, it: int, idx: int, static: StepStatic) -> dict:
        """Dispatch one step and record it in the pending pipeline."""
        prev = (self.model, self.deform, self.deform_adam)
        cams = self.scene.data.train_cameras
        if self.data_ax > 1:  # one camera per data slice (loop.py:661-666)
            fid = [cams[i].frame_id for i in idx]
            rng = [self._rng(it, k) for k in range(self.data_ax)]
        else:
            fid, rng = cams[idx].frame_id, self._rng(it)
        self.model, self.deform, self.deform_adam, packed = train_step(
            static, self.model, self.deform, self.deform_adam,
            self.scene.train_frames, idx, it, rng, frame_id=fid)
        event = None
        if packed.is_cuda:
            host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
            host.copy_(packed, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            packed = host
        rec = {"it": it, "idx": idx, "static": static, "packed": packed,
               "event": event, "prev": prev}
        self._pending.append(rec)
        return rec

    @staticmethod
    def _metrics_of(rec) -> dict:
        with span("trainer.wait"):
            if rec.get("event") is not None:
                rec["event"].synchronize()
            return dict(zip(METRIC_NAMES,
                            (float(v) for v in np.asarray(rec["packed"]))))

    def _resolve_one(self) -> dict:
        """Read the oldest pending record's metrics; react to overflow."""
        rec = self._pending.pop(0)
        metrics = self._metrics_of(rec)
        if metrics["compact_overflow"] > 0:
            # The render bucket is sized from the alive count at every
            # event that changes it: truncated rows mean a tracking bug.
            raise RuntimeError(
                f"render compaction truncated rows at iter {rec['it']} "
                f"({metrics['compact_overflow']}, bucket at dispatch: "
                f"{rec['static'].render_bucket}): bucket tracking bug")
        if self._overflowed(metrics):
            metrics = self._grow_and_replay(rec, metrics)
        else:
            # Every ceiling already reached: the loud warnings fire here.
            if metrics["tile_overflow"] > 0:
                self._warn_tile_limit(rec["it"], metrics["tile_overflow"])
            if metrics["dup_overflow"] > 0:
                self._warn_dup_limit(rec["it"])
        self._note_occupancy(metrics)

        loss = metrics["loss"]
        self.ema_loss = 0.4 * loss + 0.6 * self.ema_loss
        out = {
            "iteration": rec["it"],
            "idx": int(np.atleast_1d(rec["idx"])[0]),
            "loss": loss,
            "l1_p": metrics["l1_p"],
            "ema_loss": self.ema_loss,
            # None until step() returns, where this is its own record.
            "iter_time": self._step_s.pop(rec["it"], None),
            "num_points": int(metrics["num_points"]),
            "visible": int(metrics["visible"]),
            "dup_overflow": bool(metrics["dup_overflow"]),
            "tile_overflow": int(metrics["tile_overflow"]),
        }
        self.history.append(out)
        return out

    def _note_occupancy(self, metrics: dict) -> None:
        """Track buffer high-water marks and shrink capacities sitting far
        above need (TpuParams.shrink_window), with 1.5x hysteresis. An
        over-eager shrink corrects itself through grow-and-replay."""
        if self.shrink_window <= 0:
            return
        self._occ_steps += 1
        self._occ_tile_max = max(self._occ_tile_max, int(metrics["tile_max"]))
        self._occ_rendered_max = max(self._occ_rendered_max,
                                     int(metrics["rendered_max"]))
        if self._occ_steps < self.shrink_window:
            return
        shrunk = []
        tile_target = self._tile_cap_need(self._occ_tile_max)
        # An auto-engaged flat fallback disengages once the deepest tile
        # fits the dense ceiling with the same 1.5x hysteresis.
        if (self.flat_stream and self._flat_auto
                and tile_target * 3 <= self.tile_cap_limit * 2):
            print(f"[iter {self.iteration}] occupancy tracking: deepest "
                  f"tile {self._occ_tile_max} fits the dense ceiling "
                  f"{self.tile_cap_limit}; flat-stream fallback off "
                  f"(max_per_tile -> {tile_target})", flush=True)
            self.flat_stream = False
            self._flat_auto = False
            self.tile_cap = tile_target
            self._occ_steps = self._occ_tile_max = self._occ_rendered_max = 0
            return
        # The flat stream has no tile-depth capacity to shrink.
        if not self.flat_stream and tile_target * 3 <= self.tile_cap * 2:
            shrunk.append(f"max_per_tile {self.tile_cap} -> {tile_target} "
                          f"(deepest tile {self._occ_tile_max})")
            self.tile_cap = tile_target
        dup_target = self._dup_factor_need(self._occ_rendered_max)
        if dup_target * 3 <= self.dup_factor * 2:
            shrunk.append(f"dup_factor {self.dup_factor} -> {dup_target} "
                          f"(max rendered {self._occ_rendered_max})")
            self.dup_factor = dup_target
        if shrunk:
            print(f"[iter {self.iteration}] occupancy tracking: "
                  + "; ".join(shrunk), flush=True)
        self._occ_steps = self._occ_tile_max = self._occ_rendered_max = 0

    _CAP_MARGIN = 1.35

    def _tile_cap_need(self, tile_max: int) -> int:
        """128-aligned max_per_tile for an observed deepest tile."""
        return max(self.tile_cap_floor,
                   -(-int(tile_max * self._CAP_MARGIN) // 128) * 128)

    def _dup_factor_need(self, rendered_max: int) -> int:
        """dup_factor for an observed instance total (counted before the
        clip, so it is the true need even on overflow)."""
        p_rows = self.render_bucket or int(self.model.aux.alive.shape[0])
        return max(self.dup_factor_floor,
                   -(-int(rendered_max * self._CAP_MARGIN) // p_rows))

    def _overflowed(self, metrics: dict) -> bool:
        """True when a recoverable capacity was exceeded this step; a tile
        overflow at the ceiling is recoverable while the flat-stream
        fallback is available."""
        tile_fixable = (self.tile_cap < self.tile_cap_limit
                        or (not self.flat_stream and self._flat_fallback_ok))
        return ((metrics["tile_overflow"] > 0 and tile_fixable)
                or (metrics["dup_overflow"] > 0
                    and self.dup_factor < self.dup_factor_limit))

    def _grow_and_replay(self, rec: dict, metrics: dict) -> dict:
        """Grow whichever capacity overflowed (to 1.35x the measured need)
        and replay from the pre-step state with the same (it, idx, seed)
        sequence, so the corrected run equals a run that started with the
        larger capacity."""
        replay = [rec] + self._pending
        self._pending = []
        while True:
            grew = self.grow_capacities(metrics)
            if not grew:
                break
            print(f"[iter {rec['it']}] capacity overflow -> "
                  f"{', '.join(grew)}, replaying", flush=True)
            self.model, self.deform, self.deform_adam = rec["prev"]
            for r in replay:
                with span("trainer.replay"):
                    self._dispatch(r["it"], r["idx"],
                                   self.with_capacities(r["static"]))
            rec = self._pending.pop(0)
            replay = [rec] + self._pending
            self._pending = []
            metrics = self._metrics_of(rec)
            if not self._overflowed(metrics):
                self._pending = replay[1:]
                break
        if metrics["tile_overflow"] > 0:
            self._warn_tile_limit(rec["it"], metrics["tile_overflow"])
        if metrics["dup_overflow"] > 0:
            self._warn_dup_limit(rec["it"])
        return metrics

    def grow_capacities(self, metrics: dict) -> list:
        """Grow whichever capacity overflowed in ``metrics`` (a step's or a
        render's ``tile_overflow``, ``tile_max``, ``dup_overflow`` and
        ``rendered_max``) to 1.35x the measured need, or take the flat
        stream past the dense ceiling where it is available; returns what
        grew (empty at every ceiling)."""
        grew = []
        if metrics["tile_overflow"] > 0:
            if self.tile_cap < self.tile_cap_limit:
                self.tile_cap = min(
                    max(self._tile_cap_need(int(metrics["tile_max"])),
                        self.tile_cap + 128),
                    self.tile_cap_limit)
                grew.append(f"max_per_tile={self.tile_cap} (dropped "
                            f"{int(metrics['tile_overflow'])} instances)")
            elif not self.flat_stream and self._flat_fallback_ok:
                # Past the dense ceiling the exact flat stream renders
                # the scene: tile depth is not a kernel dimension there.
                self.flat_stream = True
                self._flat_auto = True
                grew.append(
                    f"flat_stream=True (deepest tile "
                    f"{int(metrics['tile_max'])} exceeds the dense "
                    f"ceiling {self.tile_cap_limit}; exact stream "
                    f"fallback)")
        if (metrics["dup_overflow"] > 0
                and self.dup_factor < self.dup_factor_limit):
            self.dup_factor = min(
                max(self._dup_factor_need(int(metrics["rendered_max"])),
                    self.dup_factor + 1),
                self.dup_factor_limit)
            grew.append(f"dup_factor={self.dup_factor}")
        return grew

    def with_capacities(self, static: StepStatic) -> StepStatic:
        """``static`` with the current max_per_tile, dup_factor and
        flat_stream on both RasterConfigs."""
        caps = dict(max_per_tile=self.tile_cap, dup_factor=self.dup_factor,
                    flat_stream=self.flat_stream)
        return dataclasses.replace(
            static, config_color=dataclasses.replace(static.config_color, **caps),
            config_tof=dataclasses.replace(static.config_tof, **caps))

    def _warn_tile_limit(self, it: int, dropped: float) -> None:
        """One-time warning when the tile cap ceiling truncates renders."""
        if self._tile_limit_warned:
            return
        self._tile_limit_warned = True
        print(f"[iter {it}] WARNING: tile overflow ({int(dropped)} instances"
              f" dropped) at max_per_tile_limit={self.tile_cap_limit};"
              " renders are truncated until the scene thins out"
              " (raise --max_per_tile_limit to keep exactness)", flush=True)

    def _warn_dup_limit(self, it: int) -> None:
        """One-time warning when the duplicate-list ceiling drops
        instances."""
        if self._dup_limit_warned:
            return
        self._dup_limit_warned = True
        print(f"[iter {it}] WARNING: duplicate-list overflow at "
              f"dup_factor_limit={self.dup_factor_limit}; renders drop "
              "instances until the scene thins out (raise "
              "--dup_factor_limit to keep exactness)", flush=True)

    def drain(self) -> list:
        """Resolve every pending step (before host-side events that read
        metrics or change the model state)."""
        outs = []
        while self._pending:
            outs.append(self._resolve_one())
        return outs

    def step(self) -> list:
        """Advance one iteration; returns the records resolved by it
        (none while the pipeline fills, several at a drain point). A
        record's ``iter_time`` is the host seconds of the ``step()`` call
        that dispatched its iteration, events, replays and waits included,
        so over a run they sum to the time spent in ``step()``."""
        t0 = time.perf_counter()
        with span("trainer.step"):
            outs = self._advance()
        seconds = time.perf_counter() - t0
        own = next((o for o in outs if o["iteration"] == self.iteration), None)
        if own is None:  # resolved in a later call, or by drain()
            self._step_s[self.iteration] = seconds
        else:
            own["iter_time"] = seconds
        return outs

    def _advance(self) -> list:
        self.iteration += 1
        it = self.iteration
        m, opt = self.cfg.model, self.opt

        if it % 1000 == 0 and self.active_sh_degree < m.sh_degree:
            self.active_sh_degree += 1

        if self.data_ax > 1:
            # The slices' frames may differ in flow-frame-ness: the step
            # gates the flow channels on each slice's frame at run time.
            idx = [self._pick_camera() for _ in range(self.data_ax)]
            static = self._static_for(it)
        elif self.static_flow:
            idx = self._pick_camera()
            fid = self.scene.data.train_cameras[idx].frame_id
            static = self._static_for(it, flow_frame=fid % 4 == 0)
        else:
            idx = self._pick_camera()
            static = self._static_for(it)
        self._dispatch(it, idx, static)

        outs = []
        # Densification (train.py:441-464): events see replay-corrected
        # state, so the pipeline drains first.
        if it < opt.densify_until_iter:
            if it > opt.densify_from_iter and it % opt.densification_interval == 0:
                outs += self.drain()
                self._densify(10.0 if it > self.opacity_reset_interval else 0.0)
            if it % self.opacity_reset_interval == 0:
                outs += self.drain()
                self._reset_opacity()
        elif opt.use_opacity_entropy_loss and it % opt.densification_interval == 0:
            outs += self.drain()
            with span("trainer.prune"):
                self.model = sort_layout(prune_only(self.model,
                                                    opt.min_opacity))
                self._update_deform_bucket()

        # tof_iters event (train.py:476-478)
        if it == opt.tof_iters:
            outs += self.drain()
            self.lambda_color = 1.0
            self.opacity_reset_interval = int(self.opacity_reset_interval / 2)

        while len(self._pending) > self.metrics_lag:
            outs.append(self._resolve_one())
        return outs

    def _densify(self, size_thr: float):
        with span("trainer.densify"):
            opt = self.opt
            hyper = DensifyHyper(grad_threshold=opt.densify_grad_threshold,
                                 min_opacity=opt.min_opacity,
                                 percent_dense=opt.percent_dense)
            for _ in range(4):
                new_state, dropped = densify_and_prune(
                    self.model, self._rng(DENSIFY_SEED_OFFSET + self.iteration),
                    hyper, self.scene.scene_extent, size_thr)
                dropped = int(dropped)
                if dropped == 0:
                    break
                # Grow and run again (the same seed draws the same noise for
                # a capacity).
                cap = self.model.aux.alive.shape[0]
                new_cap = int(cap * self.cfg.tpu.capacity_growth) + dropped
                self.model = grow_capacity(self.model,
                                           -(-new_cap // 1024) * 1024)
            else:
                print(f"[iter {self.iteration}] densification still dropping "
                      f"{dropped} points after 4 capacity growths; accepting "
                      "truncated densify", flush=True)
            self.model = sort_layout(new_state)
            self._update_deform_bucket()

    def _reset_opacity(self):
        with span("trainer.reset"):
            motion = get_motion_mask(self.model.params)
            if self.render_regions == ("static",):
                mask = ~motion
            elif self.render_regions == ("dynamic",):
                mask = motion
            else:
                mask = None
            self.model = reset_opacity_state(self.model, mask)

    # ------------------------------------------------------------------
    def _checkpoint_tree(self) -> dict:
        """The JAX Trainer's checkpoint tree, {"model", "deform",
        "deform_adam"}, with the deform MLP in the JAX layout."""
        a = self.deform_adam
        return {
            "model": self.model,
            "deform": deform_dict_to_numpy(self.deform),
            "deform_adam": AdamState(mu=deform_dict_to_numpy(a.mu),
                                     nu=deform_dict_to_numpy(a.nu), step=a.step),
        }

    def save_checkpoint(self, path: str):
        """Write the checkpoint (rank 0 of a mesh; every rank calls it and
        waits for the write)."""
        if not self.is_writer:
            self.barrier()
            return
        save_pytree(path, self._checkpoint_tree(), meta={
            "iteration": self.iteration,
            "active_sh_degree": self.active_sh_degree,
            "lambda_color": self.lambda_color,
            "opacity_reset_interval": self.opacity_reset_interval,
            # Grown capacities and an engaged flat fallback survive resume.
            "tile_cap": self.tile_cap,
            "dup_factor": self.dup_factor,
            "flat_stream": self.flat_stream,
            "flat_auto": self._flat_auto,
        })
        self.barrier()

    def load_checkpoint(self, path: str):
        """Resume from a checkpoint written by either package."""
        like = self._checkpoint_tree()
        leaves, meta = load_pytree(path)
        n = sum(1 for _ in tree_leaves(like))
        if len(leaves) != n:
            raise ValueError(f"{path}: {len(leaves)} leaves, this Trainer's "
                             f"state has {n}")
        tree = tree_unflatten(like, leaves)
        dev = self.device

        # The capacity may differ from this Trainer's (a grown one).
        self.model = _map2(
            lambda t, arr: torch.as_tensor(np.array(arr), dtype=t.dtype, device=dev),
            like["model"], tree["model"])
        self.deform = deform_dict_from_numpy(tree["deform"], self.deform_cfg, dev)
        ad = tree["deform_adam"]
        self.deform_adam = deform_adam_from_numpy(ad.mu, ad.nu, int(ad.step),
                                                  self.deform_cfg, dev)
        self.iteration = meta["iteration"]
        self.active_sh_degree = meta["active_sh_degree"]
        self.lambda_color = meta["lambda_color"]
        self.opacity_reset_interval = meta["opacity_reset_interval"]
        self.tile_cap = min(int(meta.get("tile_cap", self.tile_cap)),
                            self.tile_cap_limit)
        self.dup_factor = min(int(meta.get("dup_factor", self.dup_factor)),
                              self.dup_factor_limit)
        # An auto-engaged fallback resumes engaged where it is available;
        # only an automatic switch may switch back.
        if meta.get("flat_stream") and (self._flat_fallback_ok
                                        or self.cfg.tpu.flat_stream):
            self.flat_stream = True
            self._flat_auto = (bool(meta.get("flat_auto", False))
                               and not self.cfg.tpu.flat_stream)
        self.model = sort_layout(self.model)
        self._update_deform_bucket()


def _map2(fn, like, tree):
    """``fn(like_leaf, leaf)`` over two trees of one NamedTuple structure."""
    if isinstance(like, tuple):
        return type(like)(*(_map2(fn, a, b) for a, b in zip(like, tree)))
    return fn(like, tree)
