"""Shared inputs for the port's parity tests (tests/test_torch_*.py).

The same seeded numpy pair goes through the JAX package and the port; the
port is initialised from a seed and its state_dict converted into JAX
params with the JAX package's own converter.
"""

import contextlib

import numpy as np
import pytest
import torch

from roitr_torch.data.preprocess import estimate_normals_np, normal_redirect_np
from roitr_torch.data.synthetic import make_flow_pair_arrays, make_pair_arrays

TINY = dict(
    benchmark="3DMatch",
    num_est_coarse_corr=16,
    point_per_patch=16,
    sinkhorn_iters=10,
    max_gt_corr_candidates=64,
    buckets=(256, 512),
    points_limit=512,
    normal_knn=9,
)


def _with_normals(arr, bucket: int):
    """Host normals of the raw source and of the target, as the datasets
    estimate them (a rigid pair's raw source is its source), and unit
    features."""
    for side, key in (("src", "src_raw_points"), ("tgt", "tgt_points")):
        pts = arr[key]
        cnt = int(arr[f"{side}_count"])
        nrm = np.zeros_like(pts)
        nrm[:cnt] = normal_redirect_np(pts[:cnt], estimate_normals_np(pts[:cnt], 9),
                                       np.zeros(3, np.float32))
        arr[f"{side}_normals"] = nrm
        arr[f"{side}_feats"] = np.ones((bucket, 1), np.float32)
    return arr


def pair_arrays(seed: int, bucket: int = 256, n_valid: int = 224, m_valid: int = 192):
    """Seeded synthetic pair with host normals (numpy dict)."""
    return _with_normals(make_pair_arrays(np.random.RandomState(seed), bucket, n_valid, m_valid),
                         bucket)


def flow_pair_arrays(seed: int, bucket: int = 256, n_valid: int = 224, m_valid: int = 192):
    """Seeded synthetic non-rigid pair (make_flow_pair_arrays) with host
    normals (numpy dict)."""
    return _with_normals(make_flow_pair_arrays(np.random.RandomState(seed), bucket, n_valid,
                                               m_valid), bucket)


def torch_pair(arr, device="cpu"):
    from roitr_torch.models.roitr import PairInputs

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    c = lambda a: torch.tensor(int(a), dtype=torch.int64, device=device)
    return PairInputs(
        src_points=t(arr["src_points"]), src_raw_points=t(arr["src_raw_points"]),
        src_normals=t(arr["src_normals"]), src_feats=t(arr["src_feats"]),
        src_count=c(arr["src_count"]), tgt_points=t(arr["tgt_points"]),
        tgt_normals=t(arr["tgt_normals"]), tgt_feats=t(arr["tgt_feats"]),
        tgt_count=c(arr["tgt_count"]), rot=t(arr["rot"]), trans=t(arr["trans"]))


def jax_pair(arr):
    import jax.numpy as jnp

    from roitr_tpu.models.roitr import PairInputs

    return PairInputs(
        src_points=jnp.asarray(arr["src_points"]), src_raw_points=jnp.asarray(arr["src_raw_points"]),
        src_normals=jnp.asarray(arr["src_normals"]), src_feats=jnp.asarray(arr["src_feats"]),
        src_count=jnp.int32(arr["src_count"]), tgt_points=jnp.asarray(arr["tgt_points"]),
        tgt_normals=jnp.asarray(arr["tgt_normals"]), tgt_feats=jnp.asarray(arr["tgt_feats"]),
        tgt_count=jnp.int32(arr["tgt_count"]), rot=jnp.asarray(arr["rot"]),
        trans=jnp.asarray(arr["trans"]))


def jax_packed_pair(arrays):
    """JAX's packed PairInputs of seeded pair arrays (one bucket), with the
    JAX package's host pyramids: what its loader's `pack` yields, device
    leaves as jnp arrays."""
    import jax.numpy as jnp

    from roitr_tpu.data.packing import pack_pairs
    from roitr_tpu.data.pyramid import build_cloud_pyramid

    pairs = [jax_pair(a)._replace(
        src_count=np.int32(a["src_count"]), tgt_count=np.int32(a["tgt_count"]),
        src_pyramid=build_cloud_pyramid(a["src_raw_points"], int(a["src_count"])),
        tgt_pyramid=build_cloud_pyramid(a["tgt_points"], int(a["tgt_count"])))
        for a in arrays]
    packed = pack_pairs(pairs)
    return packed._replace(**{k: jnp.asarray(getattr(packed, k)) for k in (
        "src_points", "src_raw_points", "src_normals", "src_feats", "src_count", "tgt_points",
        "tgt_normals", "tgt_feats", "tgt_count", "rot", "trans")})


def port_and_params(seed: int = 0, **cfg_kw):
    """(port cfg, port model on the CPU, JAX cfg, JAX params with the same
    weights)."""
    from roitr_torch.config import Config as TorchConfig
    from roitr_torch.models.roitr import RoITr as TorchRoITr
    from roitr_tpu.config import Config as JaxConfig
    from roitr_tpu.utils.convert import torch_state_dict_to_params

    kw = {**TINY, **cfg_kw}
    tcfg, jcfg = TorchConfig(**kw), JaxConfig(**kw)
    model = TorchRoITr(tcfg, device="cpu", seed=seed)
    params = torch_state_dict_to_params(model.state_dict(),
                                        transformer_architecture=tuple(tcfg.transformer_architecture),
                                        enc_blocks=tuple(tcfg.enc_blocks))
    return tcfg, model, jcfg, params


def _rows(src, tgt, conf):
    """{(src xyz, tgt xyz): confidence} of kept correspondences."""
    keys = np.concatenate([src, tgt], axis=1)
    return {tuple(k): c for k, c in zip(keys.tolist(), np.asarray(conf).tolist())}


def same_correspondences(got, want, tag):
    """Kept correspondences as sets, as tests/test_torch_pipeline.py's
    Matcher test compares them. With random weights the OT plan is near
    uniform, so a row's top-k picks among partners whose logits differ by
    ~1e-7, and the packed forward's larger products (B * N rows) round some
    of those near-ties the other way (a mutual top-k test may then keep
    one row more or less): the (src, tgt) pairs may differ in at most 2% of
    their union, and the shared pairs' confidences agree within tolerance."""
    g, w = _rows(*got), _rows(*want)
    assert len(set(g) ^ set(w)) <= 0.02 * len(set(g) | set(w)), tag
    shared = sorted(set(g) & set(w))
    np.testing.assert_allclose([g[k] for k in shared], [w[k] for k in shared], rtol=1e-4,
                               atol=1e-5, err_msg=tag)


@contextlib.contextmanager
def one_thread():
    """torch on one intra-op thread for the block. The suite runs several
    test processes on one machine; the port's many small CPU ops are no
    slower on one thread alone and far faster than several threads each
    contending for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """one_thread for a whole test module (import it into the module)."""
    with one_thread():
        yield
