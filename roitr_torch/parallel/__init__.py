"""Training step and optimizer of the port (one pair, a list of pairs or a packed
batch a step), and data parallelism over cards, one process a card
(parallel/distributed.py)."""
