"""Training step and optimizer of the port (one pair, a list of pairs or a packed
batch a step, one card)."""
