"""GeoTransformer's path on the card: the kNN kernel's 38-entry lists (the
radius searches' limits, 36 and 38) against the tiled search bit for bit,
and one `Matcher.match` against the benchmark's plain reference
(portbench/reference/geotransformer.py) on the same card. Needs a CUDA
card; skips without one. On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_geotransformer_cuda.py

Tolerances of the request, against the fp32 reference with TF32 off: grid
stages bit for bit (both sides sum barycentres in fp64 and round once);
descriptors within 1e-4 of the array's largest magnitude (products summed
in other orders; the TF32 control reads about 1e-2, PERF.md §2);
correspondences the same set but for 2% (near-ties of the top-k under that
rounding) and confidences within 1e-4 of the largest. The transform is
held to be rigid: the registration over random-weight correspondences
turns rounding into another hypothesis (PERF.md §2, `lgr_gap`), so its
agreement is held on well-posed correspondences in
test_torch_geotransformer.py.
"""

import numpy as np
import pytest
import torch

from roitr_torch import kernels
from roitr_torch.kernels.knn_kernel import knn, knn_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _clouds(seed, b, n, counts, ties):
    """(b, n, 3) clouds of 2 cm spacing on a 3 m square, pad rows zero;
    `ties`: coordinates on a 1/64 grid with a quarter repeated."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((b, n, 3), np.float32)
    for i, c in enumerate(counts):
        p = (rng.rand(c, 3) * np.array([3.0, 3.0, 0.3])).astype(np.float32)
        if ties:
            p = np.round(p * 64.0).astype(np.float32) / 64.0
            p[c // 2:c // 2 + c // 4] = p[:c // 4]
        pts[i, :c] = p
    return pts


# (batch, queries, keys, k, key counts, queries are the keys, ties): the
# stage-1 neighbours of a 30000 + 26000 pair, a strided search into them,
# the deepest stage's, a tie-heavy cloud, and clouds shorter than the list
CASES = {
    "stage1-38": (2, 30000, 30000, 38, (30000, 26000), True, False),
    "subsampling-38": (2, 5000, 30000, 38, (30000, 26000), False, False),
    "stage2-36": (2, 5000, 5000, 36, (5000, 4100), True, False),
    "stage4-38-ties": (2, 400, 400, 38, (400, 310), True, True),
    "short-38": (2, 50, 30, 38, (30, 7), False, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_knn_38_matches_the_tiled_search(dev, case):
    b, q, n, k, counts, same, ties = CASES[case]
    keys = torch.from_numpy(_clouds(1, b, n, counts, ties)).to(dev)
    queries = keys if same else torch.from_numpy(_clouds(2, b, q, (q,) * b, ties)).to(dev)
    count = torch.tensor(counts, device=dev)
    before = kernels.launch_counts["knn"]
    idx, d2 = knn(queries, keys, count, k, squared=True)
    torch.cuda.synchronize()
    assert kernels.launch_counts["knn"] == before + 1
    ref_idx, ref_d2 = knn_plain(queries, keys, count, k)
    assert idx.shape == ref_idx.shape == (b, q, min(k, n))
    rows = (idx != ref_idx).any(-1) | (d2.view(torch.int32) != ref_d2.view(torch.int32)).any(-1)
    assert not rows.any(), f"{int(rows.sum())} of {rows.numel()} rows differ"


def test_match_on_the_card_against_the_reference(dev):
    from portbench import pools
    from portbench.drivers.geo_match import geo_numbers
    from portbench.models import geotransformer as bench_model
    from portbench.reference import geotransformer as reference
    from roitr_torch.config import Config
    from roitr_torch.ops.grid import GRID_SEARCHES, NUM_STAGES
    from roitr_torch.serving import Matcher

    values = {"geo_embedding_storage": "fp32", "fine_matching_confidence_threshold": 0.0,
              "neighbor_limits": [38, 36, 36, 38]}
    fields = dict(vars(Config()), num_stages=NUM_STAGES, transformer_input_dim=1024)
    fields.update(values)
    ref_cfg = reference.config(fields)
    state = bench_model.make_state_dict(ref_cfg, 2200000123, dev)
    src, tgt = pools.request_pool(2200000123, {"points": [20000, 30000], "pool": 2,
                                               "overlap": 0.7})[1]
    cfg = Config(model="geotransformer", **{k: tuple(v) if isinstance(v, list) else v
                                            for k, v in values.items()})
    matcher = Matcher(cfg, state, device="cuda", descriptors=True, prep="device")
    before = kernels.launch_counts["knn"]
    prog = matcher.match(src, tgt)
    assert kernels.launch_counts["knn"] == before + GRID_SEARCHES
    ref = reference.match(reference.build(ref_cfg, state, dev), ref_cfg, src, tgt, dev)
    numbers = geo_numbers([prog], [ref], cfg.acceptance_radius)
    assert numbers["node_mismatch"] == 0.0
    assert numbers["desc_err"] < 1e-4
    assert numbers["corr_mismatch"] < 0.02
    assert numbers["conf_err"] < 1e-4
    rot = prog["transform"][:3, :3].astype(np.float64)
    assert np.allclose(rot @ rot.T, np.eye(3), atol=1e-5) and np.linalg.det(rot) > 0.999
