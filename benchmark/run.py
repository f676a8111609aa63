"""The benchmark of gftorf_tpu_torch on the CUDA card: one cell a process.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. ``BENCHMARK.json`` names the cells; each
one's configuration, traffic, limits and per-layer readers are files under
``benchmark/`` (see ``benchmark/harness/main.py``)."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# One process with few threads: the host's other cores stay free, and the
# start-up's CPU tensor work does not contend with itself.
os.environ["OMP_NUM_THREADS"] = "1"
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
