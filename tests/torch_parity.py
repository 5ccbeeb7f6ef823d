"""Shared inputs for the port's parity tests (tests/test_torch_*.py).

The same seeded numpy pair goes through the JAX package and the port; the
port is initialised from a seed and its state_dict converted into JAX
params with the JAX package's own converter.
"""

import numpy as np
import torch

from roitr_torch.data.preprocess import estimate_normals_np, normal_redirect_np
from roitr_torch.data.synthetic import make_pair_arrays

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


def pair_arrays(seed: int, bucket: int = 256, n_valid: int = 224, m_valid: int = 192):
    """Seeded synthetic pair with host normals (numpy dict)."""
    rng = np.random.RandomState(seed)
    arr = make_pair_arrays(rng, bucket, n_valid, m_valid)
    for side in ("src", "tgt"):
        pts = arr[f"{side}_points"]
        cnt = int(arr[f"{side}_count"])
        nrm = np.zeros_like(pts)
        nrm[:cnt] = normal_redirect_np(pts[:cnt], estimate_normals_np(pts[:cnt], 9),
                                       np.zeros(3, np.float32))
        arr[f"{side}_normals"] = nrm
        arr[f"{side}_feats"] = np.ones((bucket, 1), np.float32)
    return arr


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
