"""ctypes bindings of the host geometry library (native/kdtree.cpp).

The port's own copy of roitr_tpu/native: a 3-D KD-tree kNN and exact
farthest point sampling (and PCA normals, which the port estimates with
scipy or on the device instead), in C++ behind a plain C interface. g++
builds it at first use into `build/roitr_torch/` at the root of the
checkout (the file name carries a hash of the source and flags, so an
edited source is rebuilt), as kernels/build.py does for the CUDA sources.
Nothing is built at import. A failed build raises: there is no silent
fall back; data/pyramid.py takes its scipy path only when asked for it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "kdtree.cpp"
BUILD_DIR = _HERE.parents[1] / "build" / "roitr_torch"
# the JAX package's Makefile flags, so both libraries round alike
CXX_FLAGS = ("-O3", "-march=native", "-ffast-math", "-fPIC", "-shared", "-std=c++17", "-Wall")

_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256()
    h.update(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode() + b" link without -ffast-math")
    return BUILD_DIR / f"libroitr_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless a current one exists; raises on failure."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    obj = so.with_suffix(f".{os.getpid()}.o")
    cxx = os.environ.get("CXX", "g++")
    # compiled with the flags above but linked without -ffast-math: that
    # would link crtfastmath, whose constructor turns on flush-to-zero for
    # the whole process that loads the library (numpy and torch included)
    for cmd in ([cxx, *CXX_FLAGS, "-c", str(SOURCE), "-o", str(obj)],
                [cxx, "-shared", str(obj), "-o", str(tmp)]):
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"native library build failed ({' '.join(cmd)}: exit "
                               f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    obj.unlink()
    os.replace(tmp, so)
    return so


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.roitr_knn.argtypes = [f32p, ctypes.c_int32, f32p, ctypes.c_int32, ctypes.c_int32, i32p,
                              f32p]
    lib.roitr_knn.restype = None
    lib.roitr_fps.argtypes = [f32p, ctypes.c_int32, ctypes.c_int32, i32p]
    lib.roitr_fps.restype = None
    _lib = lib
    return lib


def knn(points: np.ndarray, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """(idx (m, k) int32, dist (m, k) float32), ascending by distance; slots
    past the number of points hold -1 / 1e30."""
    lib = get_lib()
    points = np.ascontiguousarray(points, np.float32)
    queries = np.ascontiguousarray(queries, np.float32)
    m = queries.shape[0]
    idx = np.empty((m, k), np.int32)
    dist = np.empty((m, k), np.float32)
    lib.roitr_knn(points, points.shape[0], queries, m, k, idx, dist)
    return idx, dist


def fps(points: np.ndarray, num_samples: int) -> np.ndarray:
    """Exact farthest point sampling (seed index 0), (num_samples,) int32."""
    lib = get_lib()
    points = np.ascontiguousarray(points, np.float32)
    out = np.empty((num_samples,), np.int32)
    lib.roitr_fps(points, points.shape[0], num_samples, out)
    return out

