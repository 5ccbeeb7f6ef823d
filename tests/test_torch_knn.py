"""The kNN kernel's wrapper on the CPU (kernels/knn_kernel.py), no card.

The `supported_k` gate mirrors csrc/knn.cu's list sizes, and the launch
plan (batch, columns, lanes a query from the rows and the SMs) and its
argument checks run without a card. The CPU route (the tiled search) is
held to JAX in test_torch_ops.py and test_torch_train.py, and the kernel to
the tiled search on the card in test_torch_cuda.py.
"""

import re
from pathlib import Path

import pytest

from roitr_torch.kernels import knn_kernel
from roitr_torch.kernels.knn_kernel import CAPACITIES, Plan, launch_plan, supported_k

H100_SMS = 132


def test_supported_k_mirrors_the_source():
    src = (Path(knn_kernel.__file__).parents[1] / "csrc" / "knn.cu").read_text()
    listed = re.search(r"constexpr int kCapacities\[\] = \{([^}]*)\};", src).group(1)
    assert tuple(int(c) for c in listed.split(",")) == CAPACITIES
    assert supported_k(1) and supported_k(3) and supported_k(33) and supported_k(38)
    assert not supported_k(39) and not supported_k(0)


# (queries, keys, k, exclude_self) -> the plan on a 132-SM card: the main
# path's searches at the 32768 bucket, packed prep at 1024, short clouds
@pytest.mark.parametrize("q_shape,k_shape,k,exclude_self,plan", [
    ((2, 32768, 3), (2, 32768, 3), 33, False, Plan(2, 32768, 32768, 33, 33, 0)),
    ((32768, 3), (32768, 3), 8, True, Plan(1, 32768, 32768, 9, 8, 0)),
    ((2, 8192, 3), (2, 32768, 3), 16, True, Plan(2, 8192, 32768, 17, 16, 1)),
    ((2048, 3), (2048, 3), 16, True, Plan(1, 2048, 2048, 17, 16, 4)),
    ((8, 1024, 3), (8, 1024, 3), 8, True, Plan(8, 1024, 1024, 9, 8, 2)),
    ((512, 3), (128, 3), 3, False, Plan(1, 512, 128, 3, 3, 1)),
    ((20, 3), (10, 3), 16, True, Plan(1, 20, 10, 10, 16, 0)),
    ((20, 3), (10, 3), 16, False, Plan(1, 20, 10, 10, 10, 0)),
])
def test_knn_launch_plan(q_shape, k_shape, k, exclude_self, plan):
    assert launch_plan(q_shape, k_shape, k, exclude_self, H100_SMS) == plan


@pytest.mark.parametrize("q_shape,k_shape,k,exclude_self,match", [
    ((10, 2), (10, 3), 3, False, "must end in 3"),
    ((3,), (10, 3), 3, False, "must end in 3"),
    ((2, 10, 3), (3, 10, 3), 3, False, "batch axes"),
    ((10, 3), (10, 3), 0, False, "below 1"),
    ((40, 3), (40, 3), 38, True, "kernel takes 1 to 38"),
    ((10, 3), (0, 3), 3, False, "kernel takes 1 to 38"),
])
def test_knn_launch_plan_refuses(q_shape, k_shape, k, exclude_self, match):
    with pytest.raises(ValueError, match=match):
        launch_plan(q_shape, k_shape, k, exclude_self, H100_SMS)
