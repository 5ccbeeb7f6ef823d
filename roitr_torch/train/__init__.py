"""Training orchestration: the Trainer and its checkpoints."""
