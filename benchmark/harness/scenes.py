"""The cells' scenes, written once per checkout into ``build/benchmark/``.

The analytic scenes are deterministic, so a scene written by one run
serves every later run of the same configuration in the same checkout.
A scene is written into ``<name>.partial`` and renamed when complete, so
a run that was cut leaves nothing that a later run would take for a
scene."""

from __future__ import annotations

import json
import os
import shutil
import time

from traffic import analytic

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, "build", "benchmark")


def scene_dir(config_name: str, scene: dict, cache: str = CACHE):
    """The directory of a configuration's scene, written if it is not
    there yet, from the parameters of the config file's ``scene``, and the
    seconds spent writing it (a checkout's first run writes it once, and
    set-up leaves that out)."""
    out = os.path.join(cache, "scenes", config_name)
    stamp = os.path.join(out, "scene.json")
    if os.path.isfile(stamp):
        with open(stamp) as f:
            if json.load(f) == scene:
                return out, 0.0
    t0 = time.perf_counter()
    partial = out + ".partial"
    shutil.rmtree(partial, ignore_errors=True)
    shutil.rmtree(out, ignore_errors=True)
    args = {k: v for k, v in scene.items() if k != "writer"}
    getattr(analytic, scene["writer"])(partial, **args)
    with open(os.path.join(partial, "scene.json"), "w") as f:
        json.dump(scene, f)
    os.rename(partial, out)
    return out, time.perf_counter() - t0
