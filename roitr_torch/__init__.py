"""roitr_torch: RoITr point-cloud matching in PyTorch with hand-written
CUDA kernels for Hopper (H100).

A port of the JAX package `roitr_tpu`, which stays the reference it is
tested against. Entry points run on the card unless the caller passes
device="cpu", where every kernel is replaced by its plain PyTorch version.
"""

from roitr_torch.config import Config, load_config

__all__ = ["Config", "load_config"]
