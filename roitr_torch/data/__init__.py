"""roitr_torch.data: see the modules; each mirrors roitr_tpu/data/ of the same name."""
