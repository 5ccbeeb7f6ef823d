"""Rank functions of the data-parallel cell for test_portbench_faults.py:
with the exchange between ranks left out (each rank keeps its own
gradient and metrics), and with a module named `jax` loaded in a rank.
A module of its own so that spawned ranks can import it by name."""

from portbench.drivers import train_dp


def rank_without_exchange(rank, world, job):
    from roitr_torch.parallel import train_step

    def kept(flat, n):
        return n

    train_step.all_reduce_weighted_ = kept
    return train_dp._rank(rank, world, job)


def rank_loading_jax(rank, world, job):
    """A sound rank that holds a module named `jax` during its window, as
    if a module only the ranks import had loaded it."""
    import sys
    import types

    sys.modules.setdefault("jax", types.ModuleType("jax"))
    return train_dp._rank(rank, world, job)
