"""A cell as ``BENCHMARK.json`` names it, resolved to its files: the
configuration (``configs/<config>.json``), the traffic mix
(``traffic/<traffic>.json``), the cell's own limits
(``workloads/<cell>.json``), the per-layer readers
(``metrics/<metric>.py``) and the scene layout that the configuration
names (``layouts/<layout>.py``)."""

from __future__ import annotations

import importlib.util
import json
import os
import re
from types import ModuleType
from typing import Callable, Dict, List, NamedTuple

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
# Keys of a config file that describe it and are no program setting.
META_KEYS = ("source", "reduced", "assumed", "scene", "layout")
# The layout of a config file that names none.
DEFAULT_LAYOUT = "tof"
LAYOUTS = os.path.join(HERE, "layouts")


class Cell(NamedTuple):
    name: str
    chips: int
    config_name: str
    config: dict  # the program's settings
    scene: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    layout: ModuleType  # the scene's writer, start state and reference


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load(cell: str, root: str = ROOT) -> Cell:
    """The cell ``cell`` of ``root/BENCHMARK.json`` with its files."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise SystemExit(f"no workload {cell!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    raw = _json(os.path.join(root, conf["file"]))
    here = os.path.join(root, "benchmark")
    traffic = _json(os.path.join(here, "traffic", entry["traffic"] + ".json"))
    limits = _json(os.path.join(here, "workloads", cell + ".json"))["limits"]

    def mine(metric):
        return cell in metric.get("workloads", [cell])

    return Cell(
        name=cell, chips=int(entry["chips"]), config_name=conf["name"],
        config={k: v for k, v in raw.items() if k not in META_KEYS},
        scene=raw["scene"], traffic=traffic, limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if mine(m)],
        per_layer=[m for m in bench["per_layer"] if mine(m)],
        layout=layout(raw.get("layout", DEFAULT_LAYOUT), conf["file"]))


def layout(name: str, config_file: str) -> ModuleType:
    """The module ``layouts/<name>.py``, which ``config_file`` names under
    ``"layout"``. A name with no such module stops the run before set-up."""
    path = os.path.join(LAYOUTS, f"{name}.py")
    if not (re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name)
            and os.path.isfile(path)):
        raise SystemExit(f'{config_file}: "layout" is {name!r}, and there is '
                         f"no layout module {path}")
    return importlib.import_module(f"layouts.{name}")


def reader(name: str, root: str = ROOT) -> Callable:
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(root, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
