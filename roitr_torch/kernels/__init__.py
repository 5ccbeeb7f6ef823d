"""Hand-written Hopper kernels of the port, one module per TPU kernel.

Layout mirrors roitr_tpu/ops/pallas/: each `*_kernel.py` holds the ctypes
wrappers of one CUDA source's kernels (sources in roitr_torch/csrc/), a
forward and, where the TPU kernel had one, a backward, each beside its
plain PyTorch version, and the `torch.autograd.Function` that joins them.
A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. `launch_counts` counts the kernel launches
of each wrapper (never the plain runs), so a run can show which kernels
its path went through.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch

launch_counts: Dict[str, int] = {
    "fps": 0,
    "geo_embedding": 0,
    "rpe_attention": 0,
    "sinkhorn": 0,
    "sinkhorn_bwd": 0,
    "rpe_attention_bwd": 0,
    "geo_embedding_bwd": 0,
}
# the kernels that inference runs; training adds the three backward kernels
FORWARD_KERNELS = ("fps", "geo_embedding", "rpe_attention", "sinkhorn")


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_cuda(t: torch.Tensor, name: str, dtype: torch.dtype, shape: Sequence[int],
               device: torch.device) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of this dtype and shape
    on `device`."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def check_launch(err: int, kernel: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch. The C entry
    points return cudaErrorInvalidValue (1) for shapes their kernel does not
    take, before launching anything."""
    if err == 1:
        raise RuntimeError(f"{kernel} kernel refused its arguments (cudaErrorInvalidValue): "
                           "a shape outside what the kernel takes")
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {err}")


def route(t: torch.Tensor) -> str:
    """"plain" for a CPU tensor, "cuda" for a CUDA tensor; raises otherwise."""
    if t.device.type == "cpu":
        return "plain"
    if t.device.type == "cuda":
        return "cuda"
    raise ValueError(f"no kernel for device {t.device}")
