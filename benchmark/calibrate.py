"""Readings that set the limits of ``correct``, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ... [--control] [--fault NAME]

For each seed a whole run of the cell with a short window (``--seconds``)
in this one process, printing the numbers the program's run gives against
the reference (the lower readings). With ``--control``, also the numbers
of the reference put in the program's place with every float32 matrix
product in TF32 (``reference/lower.py``), against the reference in float32
(the upper readings). With ``--fault NAME``: every run with a fault of
``harness/faults.py`` planted. One JSON line a seed, with the seconds the
run and the reference took; the benchmark's own runs do not run this."""

import argparse
import json
import os
import sys
import time

os.environ["OMP_NUM_THREADS"] = "1"
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402

from harness import faults, spec  # noqa: E402


def readings(cell, seed: int, seconds: float, control: bool, device) -> dict:
    """One seed's numbers (and the control's, with ``control``)."""
    from harness import serve, train

    runner = {"train": train.run, "serve": serve.run}[cell.traffic["kind"]]
    t = time.perf_counter()
    r = runner(cell, seed, seconds, False, device, t)
    t_ref = time.perf_counter()
    got = r["reference"](control=control)
    numbers, low = got if control else (got, None)
    out = {"workload": cell.name, "seed": seed, "numbers": numbers,
           "run_s": t_ref - t, "reference_s": time.perf_counter() - t_ref}
    if control:
        out["control"] = low
    return out


def run(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--warm", type=int, default=None,
                    help="warm-up iterations of a training cell, in place of "
                         "its traffic's")
    ap.add_argument("--fault", default=None,
                    help="plant a fault of harness/faults.py first")
    args = ap.parse_args(argv)
    cell = spec.load(args.workload)
    if args.warm is not None:
        cell = cell._replace(traffic=dict(cell.traffic,
                                          warm_up_iterations=args.warm))
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.fault:
        getattr(faults, args.fault)(setattr)
    for seed in args.seeds:
        line = readings(cell, seed, args.seconds, args.control, device)
        line["fault"] = args.fault
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    run()
