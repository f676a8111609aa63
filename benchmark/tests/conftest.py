"""Shared set-up of the benchmark's tests: ``benchmark/`` and the checkout's
root on ``sys.path``, and the cells cut to a toy size for the CPU."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

SMALL = dict(num_points=600, D=2, W=32, total_num_views=8,
             tof_image_width=64, tof_image_height=48)


def small_cell(name: str, **traffic):
    """The cell ``name`` at a toy size: 600 points, a D=2 W=32 MLP, 8
    frames at 64x48 (torf colour 128x96), a short warm-up that still holds
    a densify event."""
    from harness import spec

    cell = spec.load(name)
    torf = cell.config_name == "torf"
    cfg = dict(cell.config, **SMALL,
               color_image_width=128 if torf else 64,
               color_image_height=96 if torf else 48)
    scene = dict(cell.scene, num_frames=8, width=64, height=48, supersample=1)
    tr = dict(cell.traffic)
    if tr["kind"] == "train":
        tr.update(warm_up_iterations=8, trace_iterations=4, checked_within=1)
        if tr["densify"]:
            tr["start_iteration"] = 3095
    else:
        tr.update(checked_frames=3, trace_frames=10)
    tr.update(traffic)
    return cell._replace(config=cfg, scene=scene, traffic=tr)


@pytest.fixture(scope="session")
def scene_cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench_scenes"))
