"""The cells' scenes, written once per checkout into ``build/benchmark/``
by the writer of the configuration's layout.

The scenes are deterministic, so a scene written by one run serves every
later run of the same configuration in the same checkout.
A scene is written into ``<name>.partial`` and renamed when complete, so
a run that was cut leaves nothing that a later run would take for a
scene."""

from __future__ import annotations

import json
import os
import shutil
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, "build", "benchmark")


def scene_dir(cell, cache: str = CACHE):
    """The directory of the cell's scene, written if it is not there yet,
    from the parameters of the config file's ``scene``, and the seconds
    spent writing it (a checkout's first run writes it once, and set-up
    leaves that out)."""
    scene = cell.scene
    out = os.path.join(cache, "scenes", cell.config_name)
    stamp = os.path.join(out, "scene.json")
    if os.path.isfile(stamp):
        with open(stamp) as f:
            if json.load(f) == scene:
                return out, 0.0
    t0 = time.perf_counter()
    partial = out + ".partial"
    shutil.rmtree(partial, ignore_errors=True)
    shutil.rmtree(out, ignore_errors=True)
    cell.layout.write(partial, **scene)
    with open(os.path.join(partial, "scene.json"), "w") as f:
        json.dump(scene, f)
    os.rename(partial, out)
    return out, time.perf_counter() - t0
