"""roitr_torch.eval: the Tester (eval/tester.py), which dumps one file a
test pair; the registration evaluation of the rigid benchmarks over those
dumps (eval/registration.py: registration recall, inlier ratio and
feature-match recall, with eval/trajectory.py, eval/benchmark.py and
RANSAC in numpy, eval/ransac.py, or on a card, eval/ransac_torch.py); and
the non-rigid evaluator (eval/fdmatch_eval.py: NFMR, IR)."""

from roitr_torch.eval.benchmark import benchmark, evaluate_registration  # noqa: F401
from roitr_torch.eval.fdmatch_eval import (  # noqa: F401
    compute_inlier_ratio,
    compute_nrfmr,
    evaluate_fdmatch,
)
from roitr_torch.eval.ransac import (  # noqa: F401
    get_inlier_ratio_correspondence,
    ransac_pose_estimation_correspondences,
)
from roitr_torch.eval.ransac_torch import (  # noqa: F401
    ransac_pose_estimation_correspondences_torch,
)
from roitr_torch.eval.registration import (  # noqa: F401
    benchmark_registration,
    benchmark_registration_rotated,
)
from roitr_torch.eval.tester import Tester, get_trainer, list_dumps, load_dump  # noqa: F401
