"""roitr_torch.eval: the Tester (eval/tester.py), which dumps one file a
test pair, and the non-rigid evaluator of those dumps
(eval/fdmatch_eval.py). The registration evaluators of the rigid
benchmarks are a later slice of the port; the JAX package's read the
Tester's dumps unchanged."""

from roitr_torch.eval.fdmatch_eval import (  # noqa: F401
    compute_inlier_ratio,
    compute_nrfmr,
    evaluate_fdmatch,
)
from roitr_torch.eval.tester import Tester, get_trainer, list_dumps, load_dump  # noqa: F401
