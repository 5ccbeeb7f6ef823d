"""Training step and optimizer of the port (batch 1, one card)."""
