"""Builds the port's CUDA kernels and loads them with ctypes.

Each ``gftorf_tpu_torch/csrc/<name>.cu`` is compiled by nvcc for Hopper
(``sm_90a``) into a shared library with a plain C interface, at first
use, under ``build/kernels/`` at the root of the checkout. The library's
file name carries a hash of its source, the headers it may include and
the flags, so an edited source is rebuilt and an unchanged one is
reused. ``build`` starts one nvcc per missing library, all at once, and
waits for them together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# --fmad=false: no multiply-add contraction, so the kernels round each
# operation as the plain PyTorch versions do (see the notes in csrc/).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return path


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives; its name hashes the
    source, the shared headers (``csrc/*.cuh``) and the flags."""
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def build(names: Iterable[str]) -> Dict[str, dict]:
    """Compile every named kernel whose library is missing, in parallel.

    Returns name -> {"seconds", "log"} for the libraries built now (the
    log holds ptxas' register and shared-memory report); raises with the
    compiler's output when a build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, target, time.perf_counter())
    done = {}
    for name, (proc, tmp, target, t0) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, target)
        done[name] = {"seconds": time.perf_counter() - t0, "log": log}
    return done


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if it is missing."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
