"""roitr_torch.models: see the modules; each mirrors roitr_tpu/models/ of the same name."""
