"""roitr_torch.ops: see the modules; each mirrors roitr_tpu/ops/ of the same name."""
