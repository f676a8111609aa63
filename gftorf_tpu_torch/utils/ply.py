"""Minimal PLY reader (binary little-endian or ascii) and writer (binary
little-endian), replacing plyfile.

The port's own copy of ``gftorf_tpu/utils/ply.py``: a single
'vertex' element with scalar properties, in the layouts the reference's
storePly/save_ply write (dataset_readers.py:127-150,
gaussian_model.py:340-367), so trained models from either package load.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

_DTYPES = {
    "float": np.float32,
    "float32": np.float32,
    "double": np.float64,
    "float64": np.float64,
    "uchar": np.uint8,
    "uint8": np.uint8,
    "int": np.int32,
    "int32": np.int32,
    "short": np.int16,
    "ushort": np.uint16,
    "char": np.int8,
}
_NAMES = {np.dtype(np.float32): "float", np.dtype(np.float64): "double",
          np.dtype(np.uint8): "uchar", np.dtype(np.int32): "int"}


def write_ply(path: str, props: Dict[str, np.ndarray]) -> None:
    """Write a vertex-only PLY. props: ordered name -> (N,) array."""
    names = list(props.keys())
    n = len(next(iter(props.values())))
    rec = np.empty(n, dtype=[(name, np.asarray(props[name]).dtype)
                             for name in names])
    for name in names:
        arr = np.asarray(props[name])
        if arr.shape != (n,):
            raise ValueError(f"{name}: shape {arr.shape}, expected ({n},)")
        rec[name] = arr
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
        header += [f"property {_NAMES[rec.dtype[name]]} {name}" for name in names]
        header.append("end_header")
        f.write(("\n".join(header) + "\n").encode("ascii"))
        rec.tofile(f)


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read the vertex element of a PLY into name -> (N,) arrays."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"not a ply file: {path}")
        fmt = None
        n = None
        props: List[Tuple[str, np.dtype]] = []
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in header")
            tok = line.decode("ascii").strip().split()
            if not tok:
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                in_vertex = tok[1] == "vertex"
                if in_vertex:
                    n = int(tok[2])
            elif tok[0] == "property" and in_vertex:
                if tok[1] == "list":
                    raise ValueError("list properties unsupported")
                props.append((tok[2], np.dtype(_DTYPES[tok[1]])))
            elif tok[0] == "end_header":
                break
        if fmt not in ("binary_little_endian", "ascii"):
            raise ValueError(f"unsupported ply format {fmt}")
        dtype = np.dtype([(name, dt) for name, dt in props])
        if fmt == "ascii":
            data = np.loadtxt(f, dtype=dtype, max_rows=n)
        else:
            data = np.fromfile(f, dtype=dtype, count=n)
    return {name: data[name] for name, _ in props}
