"""The benchmark's command: one cell, one seed, one process.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the last line of standard output holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics read from a
profiled window; both hold ``correct``, decided against the plain
reference once the window has closed, and end with the numbers compared
and their limits (``checks``), which also close standard error."""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

from harness import checks, scenes, spec
from traffic import peaks

FORBIDDEN = ("jax", "jaxlib", "flax", "gftorf_tpu")
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton"}


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    """Modules of JAX or of the JAX package loaded in this process, by
    whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, cache=None) -> dict:
    """Run one cell and return the result line's dict (with ``checks``)."""
    import torch

    from harness import serve, train

    runner = {"train": train.run, "serve": serve.run}[cell.traffic["kind"]]
    r = runner(cell, seed, seconds, trace, device, t_start,
               cache=cache or scenes.CACHE)
    metrics = {}
    if trace:
        reading = r["reading"]
        for m in cell.per_layer:
            value = spec.reader(m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = {"busy_s": reading.busy_s, "window_s": reading.window_s}
        breakdown = reading.breakdown()
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": r[m["name"]], "unit": m["unit"]}
        extra, breakdown = {}, None
    r.pop("reading", None)
    numbers = r["reference"]()
    correct = checks.judge(numbers, cell.limits) and r["failed"] == 0
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                    else "cpu"),
           "count": cell.chips, "memory_peak_bytes": r["memory_peak_bytes"]}
    dev.update(extra)
    line = {"setup_s": r["setup_s"], "scene_write_s": r["scene_write_s"],
            "correct": bool(correct), "attempted": r["attempted"],
            "failed": r["failed"], "metrics": metrics, "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    # Last in the line: each number compared and its limit (a number that
    # is not finite is written as null).
    line["checks"] = {k: {"value": v if math.isfinite(v) else None,
                          "limit": cell.limits.get(k)}
                      for k, v in numbers.items()}
    return line


def main(argv=None, t_start: float = 0.0) -> int:
    args = parse(argv)
    cell = spec.load(args.workload)
    root = spec.ROOT
    for env, sub in CACHES.items():
        os.environ[env] = os.path.join(root, "build", "benchmark", sub)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                    t_start)
    # Once the window has closed and the reference has run: no module of
    # JAX or of the JAX package may be in this process.
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    print(f"setup_s {line.pop('setup_s')!r}", file=sys.stderr)
    written = line.pop("scene_write_s")
    if written:
        print(f"the scene was written in {written!r} s, left out of setup_s",
              file=sys.stderr)
    print(f"card: {power_limit()}; peaks: {peaks.PEAK_FP32_PER_S:.4g} fp32 "
          f"FLOP/s, {peaks.PEAK_BYTES_PER_S:.4g} B/s", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line, allow_nan=False), flush=True)
    sys.stderr.flush()
    return 0 if all(math.isfinite(float(m["value"]))
                    for m in line["metrics"].values()) else 1
