"""Build of the CUDA kernels: one nvcc per source into a shared library
with a plain C interface, loaded with ctypes.

The libraries go to `build/roitr_torch/` at the root of the checkout, at
first use. Each file name carries a hash of its source and flags, so an
edited source is rebuilt and an unchanged one is reused. All sources are
compiled at once, one nvcc process each. ptxas's register, shared-memory
and spill report of each build is kept beside the library
(`<name>-<hash>.log`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "roitr_torch"
SOURCES = ("fps", "geo_embedding", "rpe_attention", "sinkhorn")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source that has no current library, all in
    parallel; returns {name: ptxas report}. Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        so = _target(name)
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{out}")
            continue
        so.with_suffix(".log").write_text(out)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: _target(name).with_suffix(".log").read_text() for name in names}


def function(name: str, symbol: str, argtypes: Sequence,
             restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """C entry point `symbol` of source `name` (built first if needed),
    declared to return `restype`: by default the int cudaError_t of its
    launch."""
    lib = _loaded.get(name)
    if lib is None:
        so = _target(name)
        if not so.exists():
            build([name])
        lib = ctypes.CDLL(str(so))
        _loaded[name] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn
