"""The compositor's layout (the dense (T, max_per_tile) block or the flat
stream) and capacities (``max_per_tile``, ``dup_factor``): the JAX
Trainer's policy (gftorf_tpu/train/loop.py), which the Trainer and serving
(``render_sets.render_frame``) both drive. An overflow below a ceiling
grows the capacity to 1.35x the measured need, and the caller renders
again. Past ``max_per_tile_limit`` the exact flat stream renders the scene
where it is available, on CUDA (the JAX package needs a TPU); the CPU
truncates with a warning, as JAX does there. Every ``shrink_window``
resolved steps a capacity sitting 1.5x above its need shrinks, and an
automatic flat fallback whose deepest tile fits the dense ceiling with
that headroom turns off; an over-eager shrink corrects itself by growth.
"""

from __future__ import annotations

import dataclasses

from gftorf_tpu_torch.config import TpuParams

CAP_MARGIN = 1.35


class Occupancy:
    """The active layout, the capacities, their ceilings and floors, and
    the shrink window's high-water marks, for one Trainer on ``device``."""

    def __init__(self, tpu: TpuParams, device):
        self.tile_cap = tpu.max_per_tile
        self.tile_cap_limit = max(self.tile_cap, tpu.max_per_tile_limit)
        self.tile_cap_floor = tpu.max_per_tile_floor
        self.dup_factor = tpu.dup_factor
        self.dup_factor_limit = max(self.dup_factor, tpu.dup_factor_limit)
        self.dup_factor_floor = tpu.dup_factor_floor
        # flat_stream may flip on (the fallback) and back; flat_auto marks
        # an automatic switch, the only kind that switches back.
        self._configured_flat = bool(tpu.flat_stream)
        self.flat_stream = self._configured_flat
        self.flat_auto = False
        self.flat_fallback_ok = (device.type == "cuda"
                                 and tpu.tile_overflow_fallback == "flat")
        self.shrink_window = tpu.shrink_window
        self._steps = self._tile_max = self._rendered_max = 0
        self._tile_warned = self._dup_warned = False

    def _tile_need(self, tile_max: int) -> int:
        """128-aligned max_per_tile for an observed deepest tile."""
        return max(self.tile_cap_floor,
                   -(-int(tile_max * CAP_MARGIN) // 128) * 128)

    def _dup_need(self, rendered_max: int, rows: int) -> int:
        """dup_factor for an observed instance total (counted before the
        clip, so the true need even on overflow) over ``rows`` rows."""
        return max(self.dup_factor_floor,
                   -(-int(rendered_max * CAP_MARGIN) // rows))

    def overflowed(self, metrics: dict) -> bool:
        """True when a step's or a render's ``metrics`` exceeded a capacity
        that can grow, or the dense ceiling where the fallback can engage."""
        tile_fixable = (self.tile_cap < self.tile_cap_limit
                        or (not self.flat_stream and self.flat_fallback_ok))
        return ((metrics["tile_overflow"] > 0 and tile_fixable)
                or (metrics["dup_overflow"] > 0
                    and self.dup_factor < self.dup_factor_limit))

    def grow(self, metrics: dict, rows: int) -> list:
        """Grow what overflowed in ``metrics`` to 1.35x its need (``rows``:
        the render rows), or engage the flat stream at the dense ceiling;
        returns what grew (empty at every ceiling)."""
        grew = []
        if metrics["tile_overflow"] > 0:
            if self.tile_cap < self.tile_cap_limit:
                self.tile_cap = min(
                    max(self._tile_need(int(metrics["tile_max"])),
                        self.tile_cap + 128),
                    self.tile_cap_limit)
                grew.append(f"max_per_tile={self.tile_cap} (dropped "
                            f"{int(metrics['tile_overflow'])} instances)")
            elif not self.flat_stream and self.flat_fallback_ok:
                self.flat_stream = self.flat_auto = True
                grew.append(
                    f"flat_stream=True (deepest tile "
                    f"{int(metrics['tile_max'])} exceeds the dense "
                    f"ceiling {self.tile_cap_limit}; exact stream "
                    f"fallback)")
        if (metrics["dup_overflow"] > 0
                and self.dup_factor < self.dup_factor_limit):
            self.dup_factor = min(
                max(self._dup_need(int(metrics["rendered_max"]), rows),
                    self.dup_factor + 1),
                self.dup_factor_limit)
            grew.append(f"dup_factor={self.dup_factor}")
        return grew

    def note(self, it: int, metrics: dict, rows: int) -> None:
        """Track a resolved step's high-water marks; at the end of a shrink
        window shrink the capacities, or turn an automatic fallback off."""
        if self.shrink_window <= 0:
            return
        self._steps += 1
        self._tile_max = max(self._tile_max, int(metrics["tile_max"]))
        self._rendered_max = max(self._rendered_max,
                                 int(metrics["rendered_max"]))
        if self._steps < self.shrink_window:
            return
        shrunk = []
        tile_target = self._tile_need(self._tile_max)
        if (self.flat_stream and self.flat_auto
                and tile_target * 3 <= self.tile_cap_limit * 2):
            print(f"[iter {it}] occupancy tracking: deepest "
                  f"tile {self._tile_max} fits the dense ceiling "
                  f"{self.tile_cap_limit}; flat-stream fallback off "
                  f"(max_per_tile -> {tile_target})", flush=True)
            self.flat_stream = self.flat_auto = False
            self.tile_cap = tile_target
            self._steps = self._tile_max = self._rendered_max = 0
            return
        # The flat stream has no tile-depth capacity to shrink.
        if not self.flat_stream and tile_target * 3 <= self.tile_cap * 2:
            shrunk.append(f"max_per_tile {self.tile_cap} -> {tile_target} "
                          f"(deepest tile {self._tile_max})")
            self.tile_cap = tile_target
        dup_target = self._dup_need(self._rendered_max, rows)
        if dup_target * 3 <= self.dup_factor * 2:
            shrunk.append(f"dup_factor {self.dup_factor} -> {dup_target} "
                          f"(max rendered {self._rendered_max})")
            self.dup_factor = dup_target
        if shrunk:
            print(f"[iter {it}] occupancy tracking: "
                  + "; ".join(shrunk), flush=True)
        self._steps = self._tile_max = self._rendered_max = 0

    def warn_truncation(self, it: int, metrics: dict) -> None:
        """Warn once for each ceiling at which ``metrics`` was truncated."""
        if metrics["tile_overflow"] > 0 and not self._tile_warned:
            self._tile_warned = True
            print(f"[iter {it}] WARNING: tile overflow "
                  f"({int(metrics['tile_overflow'])} instances dropped) at "
                  f"max_per_tile_limit={self.tile_cap_limit}; renders are "
                  "truncated until the scene thins out (raise "
                  "--max_per_tile_limit to keep exactness)", flush=True)
        if metrics["dup_overflow"] > 0 and not self._dup_warned:
            self._dup_warned = True
            print(f"[iter {it}] WARNING: duplicate-list overflow at "
                  f"dup_factor_limit={self.dup_factor_limit}; renders drop "
                  "instances until the scene thins out (raise "
                  "--dup_factor_limit to keep exactness)", flush=True)

    def apply(self, static):
        """A StepStatic with the current max_per_tile, dup_factor and
        flat_stream on both RasterConfigs."""
        caps = dict(max_per_tile=self.tile_cap, dup_factor=self.dup_factor,
                    flat_stream=self.flat_stream)
        return dataclasses.replace(
            static, config_color=dataclasses.replace(static.config_color, **caps),
            config_tof=dataclasses.replace(static.config_tof, **caps))

    def meta(self) -> dict:
        """The checkpoint's keys: grown capacities and an engaged fallback
        survive resume."""
        return {"tile_cap": self.tile_cap, "dup_factor": self.dup_factor,
                "flat_stream": self.flat_stream, "flat_auto": self.flat_auto}

    def load_meta(self, meta: dict) -> None:
        """Resume a checkpoint's meta (either package's) within these
        ceilings; an engaged fallback resumes where it is available, and
        only an automatic switch may switch back."""
        self.tile_cap = min(int(meta.get("tile_cap", self.tile_cap)),
                            self.tile_cap_limit)
        self.dup_factor = min(int(meta.get("dup_factor", self.dup_factor)),
                              self.dup_factor_limit)
        if meta.get("flat_stream") and (self.flat_fallback_ok
                                        or self._configured_flat):
            self.flat_stream = True
            self.flat_auto = (bool(meta.get("flat_auto", False))
                              and not self._configured_flat)
