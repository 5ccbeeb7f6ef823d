"""roitr_torch.utils: see the modules; each mirrors roitr_tpu/utils/ of the same name."""
