"""roitr_torch.eval: the Tester (eval/tester.py). The registration
evaluators are a later slice of the port; the JAX package's read the
Tester's dumps unchanged."""

from roitr_torch.eval.tester import Tester, get_trainer  # noqa: F401
