"""The control on the card at a small size: the reference computed with
TF32 in the program's place must fail the cell's limits (the readings at
the cells' own sizes are in PERF.md)."""

import pytest

from portbench import judge
from portbench.tests.helpers import SEED, TINY, bench


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["3dmatch.match", "3dmatch.train", "4dmatch.train"])
def test_tf32_control_fails_the_limits(cell, monkeypatch):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    from portbench import control, harness

    real = harness.make_context
    monkeypatch.setattr(harness, "make_context",
                        lambda b, c, s, d, o=None: real(b, c, s, d, TINY))
    numbers = control.readings(bench(), cell, SEED)
    limits = real(bench(), cell, SEED, "cuda").spec["limits"]
    assert not judge.verdict(numbers, limits)
