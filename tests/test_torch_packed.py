"""Packed batches of the port on the CPU: B same-bucket pairs as one flat
cloud a side (roitr_torch/data/packing.py, RoITr `_forward_packed`).

- The batched `rpe_attention_plain` equals B per-pair calls; the RPE
  attention's backward refuses a pair axis (packed training is the next
  slice).
- The packed forward (B = 3, mixed counts, host pyramids) equals the port's
  single-pair forwards pair by pair, as tests/test_packed_batch.py holds
  the JAX package's: fp32 outputs within rtol 1e-4 / atol 1e-5, index
  outputs exactly, kept fine correspondences as sets (slots that no mask
  keeps may point anywhere; near-ties of random weights, see
  `same_correspondences`).
- The same packed pair through JAX's `_forward_packed`, same weights
  (`torch_state_dict_to_params`): fp32 rtol 1e-4 / atol 1e-5, indices
  exactly. The JAX forward runs op by op (a jitted program rounds
  differently, tests/test_torch_pipeline.py), once, at the 256 bucket, in
  the module's fixture.
- Device prep of a packed batch (segmented normals, device pyramids)
  equals device prep pair by pair.
- `Matcher.match_batch` in each mode and prep equals `match` pair by pair.

fp32 embedding storage in both packages, every fine correspondence kept
(`fine_matching_confidence_threshold=0.0`).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from roitr_torch.data.packing import attach_pyramids, pack_pairs
from roitr_torch.kernels.rpe_attention_kernel import rpe_attention, rpe_attention_plain
from roitr_torch.ops.pyramid import device_prep_packed, device_prep_pair
from roitr_torch.serving import Matcher
from roitr_tpu.data.packing import pack_pairs as jax_pack_pairs
from roitr_tpu.data.pyramid import build_cloud_pyramid as jax_build_cloud_pyramid
from roitr_tpu.models.roitr import RoITr as JaxRoITr

from torch_parity import (  # noqa: F401 (one_torch_thread: an autouse fixture)
    jax_pair,
    one_torch_thread,
    pair_arrays,
    port_and_params,
    same_correspondences,
    torch_pair,
)

TOL = dict(rtol=1e-4, atol=1e-5)
BUCKET = 256
COUNTS = ((240, 200), (180, 256), (130, 90))
CFG = dict(geo_embedding_storage="fp32", fine_matching_confidence_threshold=0.0)
CORR_KEYS = ("tgt_corr_points", "src_corr_points", "corr_scores", "corr_masks")


def _arrays():
    return [pair_arrays(20 + i, BUCKET, n, m) for i, (n, m) in enumerate(COUNTS)]


def _kept(out):
    keep = out["corr_masks"]
    return out["src_corr_points"][keep], out["tgt_corr_points"][keep], out["corr_scores"][keep]


def _assert_pair_equal(got, want, tag):
    """One pair's outputs: every key but the fine correspondences by value,
    those as the sets of kept rows."""
    assert set(got) == set(want), tag
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape, (tag, key, g.shape, w.shape)
        if key in CORR_KEYS:
            continue
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, err_msg=f"{tag}: {key}", **TOL)
        else:
            np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64),
                                          err_msg=f"{tag}: {key}")
    same_correspondences(_kept(got), _kept(want), tag)


@pytest.fixture(scope="module")
def forwards():
    """The port's packed forward, its single-pair forwards and JAX's packed
    forward of the same three pairs with host pyramids."""
    tcfg, model, jcfg, params = port_and_params(0, **CFG)
    arrays = _arrays()
    pairs = [attach_pyramids(torch_pair(a), tcfg.enc_strides, tcfg.enc_nsample) for a in arrays]
    np_out = lambda out: {k: v.numpy() for k, v in out.items()}
    with torch.no_grad():
        packed = np_out(model(pack_pairs(pairs), with_gt=True))
        singles = [np_out(model(p, with_gt=True)) for p in pairs]
    jpairs = [jax_pair(a)._replace(
        src_pyramid=jax_build_cloud_pyramid(a["src_raw_points"], int(a["src_count"])),
        tgt_pyramid=jax_build_cloud_pyramid(a["tgt_points"], int(a["tgt_count"])))
        for a in arrays]
    jpacked = jax_pack_pairs([p._replace(src_count=np.int32(p.src_count),
                                         tgt_count=np.int32(p.tgt_count)) for p in jpairs])
    jpacked = jpacked._replace(**{k: jnp.asarray(getattr(jpacked, k)) for k in (
        "src_points", "src_raw_points", "src_normals", "src_feats", "src_count", "tgt_points",
        "tgt_normals", "tgt_feats", "tgt_count", "rot", "trans")})
    want = JaxRoITr(jcfg).apply({"params": params}, jpacked, train=False, with_gt=True)
    return dict(model=model, pairs=pairs, packed=packed, singles=singles,
                jax={k: np.asarray(v) for k, v in want.items()})


def test_batched_rpe_attention_plain_equals_per_pair_calls():
    gen = torch.Generator().manual_seed(0)
    b, n, d, h = 3, 24, 32, 4
    q, k, v = (torch.randn(b, n, d, generator=gen) for _ in range(3))
    qwp = torch.randn(b, n, h, d, generator=gen) * 0.1
    embed = torch.randn(b, n, n, d, generator=gen)
    mask = (torch.arange(n)[None, :] < torch.tensor([24, 17, 5])[:, None]).float()
    got = rpe_attention_plain(q, k, v, qwp, embed, mask, with_lse=True)
    for i in range(b):
        want = rpe_attention_plain(q[i], k[i], v[i], qwp[i], embed[i], mask[i], with_lse=True)
        for g, w in zip(got, want):
            torch.testing.assert_close(g[i], w, rtol=1e-6, atol=1e-6)


def test_rpe_attention_backward_refuses_a_pair_axis():
    args = [torch.randn(2, 8, 16, requires_grad=True) for _ in range(3)]
    args += [torch.randn(2, 8, 4, 16), torch.randn(2, 8, 8, 16), torch.ones(2, 8)]
    hidden, ae = rpe_attention(*args)
    with pytest.raises(NotImplementedError, match="packed training"):
        (hidden.sum() + ae.sum()).backward()


def test_packed_forward_equals_single_pair_forwards(forwards):
    packed = forwards["packed"]
    for i, single in enumerate(forwards["singles"]):
        _assert_pair_equal({k: v[i] for k, v in packed.items()}, single, f"pair {i}")


def test_packed_forward_matches_jax(forwards):
    got, want = forwards["packed"], forwards["jax"]
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
    for i in range(len(COUNTS)):
        _assert_pair_equal({k: v[i] for k, v in got.items()},
                           {k: v[i] for k, v in want.items()}, f"pair {i}")


def test_packed_device_prep_equals_device_prep_per_pair(forwards):
    """Normals estimated on the device and pyramids built there, packed and
    pair by pair (device_prep_pair builds the same exact pyramid)."""
    model = forwards["model"]
    cfg = model.cfg
    pairs = [p._replace(src_pyramid=None, tgt_pyramid=None) for p in forwards["pairs"]]
    with torch.no_grad():
        packed = model(device_prep_packed(pack_pairs(pairs, require_pyramids=False), cfg),
                       with_gt=True)
        for i, p in enumerate(pairs):
            single = model(device_prep_pair(p, cfg, pyramid=True), with_gt=True)
            _assert_pair_equal({k: v[i].numpy() for k, v in packed.items()},
                               {k: v.numpy() for k, v in single.items()}, f"pair {i}")


def _clouds():
    return [(a["src_points"][:int(a["src_count"])], a["tgt_points"][:int(a["tgt_count"])])
            for a in _arrays()]


def _corr_equal(got, want, tag):
    assert set(got) == set(want), tag
    same_correspondences(*((r["src_corr_pts"], r["tgt_corr_pts"], r["confidence"])
                            for r in (got, want)), tag)


@pytest.mark.parametrize("prep,mode", [("host", "packed"), ("host", "map"), ("host", "auto"),
                                       ("device", "packed"), ("device", "map")])
def test_match_batch_equals_match(forwards, prep, mode):
    """Three pairs in batches of 2: a full batch and a tail of one pair,
    which runs as a batch of one (no padding): packed forwards of 2 and 1
    pairs, or three single-pair forwards in map mode."""
    model = forwards["model"]
    cfg = model.cfg.replace(host_pyramid=prep == "host")
    matcher = Matcher(cfg, model.state_dict(), device="cpu", prep=prep)
    clouds = _clouds()
    shapes = []
    hook = matcher.model.register_forward_pre_hook(
        lambda _, args: shapes.append(tuple(args[0].src_count.shape)))
    try:
        got = matcher.match_batch(clouds, batch_size=2, mode=mode)
    finally:
        hook.remove()
    assert shapes == ([(), (), ()] if mode == "map" else [(2,), (1,)]), shapes
    assert len(got) == len(clouds)
    for i, (src, tgt) in enumerate(clouds):
        _corr_equal(got[i], matcher.match(src, tgt), f"{prep} {mode} pair {i}")


def test_match_batch_checks_its_arguments(forwards):
    model = forwards["model"]
    with pytest.raises(ValueError, match="host_pyramid"):
        Matcher(model.cfg, model.state_dict(), device="cpu").match_batch(_clouds())
    matcher = Matcher(model.cfg, model.state_dict(), device="cpu", prep="device")
    with pytest.raises(ValueError, match="mode"):
        matcher.match_batch(_clouds(), mode="vmap")
