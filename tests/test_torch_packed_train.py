"""Packed and batched training of the port on the CPU against the JAX
package: a packed batch of B pairs (data/packing.py) through
`RoITr._forward_packed(train=True)`, the per-pair losses and their mean,
the gradient of the mean, `train_step` / `eval_step` on a packed pair and
on a list of pairs, the loader's `BucketBatcher` / `iterate_batches`, and
`Trainer` with `batch_size` 2.

- JAX's side is `_forward_packed(train=True)` and `jax.vmap` of
  `overall_loss` / `evaluate` over the pairs, as its train step has them,
  on the same packed pair (JAX's host pyramids, bit-equal to the port's)
  and the same weights. The forward runs op by op (a jitted JAX program
  rounds differently from itself, tests/test_torch_train_model.py), the
  backward jitted (`jax.vjp`, then `jax.jit` of the vjp function), once, in
  the module's fixture, at the 256 bucket with the cut architecture
  (("self", "cross"), enc_blocks (2, 1, 1, 2)) and fp32 embedding storage.
- The GT patch sampler is saturated (num_gt_coarse_corr >=
  max_gt_corr_candidates, as JAX's test_packed_train_step_grads does): every
  eligible GT pair is a patch and the two packages' Gumbel draws decide
  only the patches' order, which the comparison sorts away.
- Tolerances: indices exactly; outputs and per-pair losses within rtol
  1e-4 / atol 1e-5; every parameter's gradient within rtol 1e-3 /
  atol 1e-5 and cosine >= 0.9999 over all (as
  tests/test_torch_train_model.py); the packed gradient against the mean of
  the single-pair gradients within JAX's test_packed_train_step_grads
  tolerance (rtol 2e-3, atol 5e-5 of the largest entry); kept fine
  correspondences as sets, apart only at near-ties (`_same_fine`).
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from roitr_torch.config import Config
from roitr_torch.data.loader import BucketBatcher, iterate_batches
from roitr_torch.data.packing import attach_pyramids, pack_pairs
from roitr_torch.data.pyramid import build_cloud_pyramid
from roitr_torch.data.synthetic import SyntheticPairs
from roitr_torch.losses import evaluate, overall_loss
from roitr_torch.parallel.train_step import eval_step, make_optimizer, train_step
from roitr_torch.train.trainer import Trainer
from roitr_torch.utils.convert import params_to_state_dict
from roitr_tpu import losses as jlosses
from roitr_tpu.data.loader import iterate_batches as jax_iterate_batches
from roitr_tpu.data.packing import pack_pairs as jax_pack_pairs
from roitr_tpu.models.roitr import RoITr as JaxRoITr

from torch_parity import (  # noqa: F401 (one_torch_thread: an autouse fixture)
    _rows,
    jax_packed_pair,
    one_torch_thread,
    pair_arrays,
    port_and_params,
    torch_pair,
)

TOL = dict(rtol=1e-4, atol=1e-5)
ARCH = dict(transformer_architecture=("self", "cross"), enc_blocks=(2, 1, 1, 2))
# num_gt_coarse_corr 64 = TINY's max_gt_corr_candidates: the sampler saturates
CFG = dict(geo_embedding_storage="fp32", num_gt_coarse_corr=64,
           fine_matching_confidence_threshold=0.0, **ARCH)
BUCKET = 256
COUNTS = ((240, 200), (190, 236))
SEEDS = (41, 46)
LOSS_KEYS = ("loss", "c_loss", "f_loss", "o_loss")
PER_PATCH = ("src_node_corr_knn_points", "tgt_node_corr_knn_points",
             "src_node_corr_knn_masks", "tgt_node_corr_knn_masks", "matching_scores")
FINE = ("tgt_corr_points", "src_corr_points", "corr_scores", "corr_masks")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(got, want, key=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (key, got.shape, want.shape)
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, err_msg=key, **TOL)
    else:
        np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64), err_msg=key)


def _arrays():
    return [pair_arrays(s, BUCKET, n, m) for s, (n, m) in zip(SEEDS, COUNTS)]


def _port_pairs(cfg):
    return [attach_pyramids(torch_pair(a), cfg.enc_strides, cfg.enc_nsample) for a in _arrays()]


def _grads(model):
    return {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().clone()
            for k, p in model.named_parameters()}


def _per_pair(cfg, out, rot, trans):
    """[{loss..., PIR, IR}] of each pair of a packed output."""
    res = []
    for i in range(rot.shape[0]):
        o = {k: v[i] for k, v in out.items()}
        res.append({**overall_loss(cfg, o, rot[i], trans[i]), **evaluate(cfg, o, rot[i],
                                                                           trans[i])})
    return res


@pytest.fixture(scope="module")
def runs():
    """The port's packed train forward and the gradient of its mean loss,
    and JAX's, same weights and pairs."""
    tcfg, model, jcfg, params = port_and_params(0, **CFG)
    pairs = _port_pairs(tcfg)
    packed = pack_pairs(pairs)
    out = model(packed, train=True, with_gt=True, generator=torch.Generator().manual_seed(0))
    per_pair = _per_pair(tcfg, out, packed.rot, packed.trans)
    torch.stack([m["loss"] for m in per_pair]).mean().backward()
    grads = {k: v.numpy() for k, v in _grads(model).items()}
    model.zero_grad(set_to_none=True)

    jpacked = jax_packed_pair(_arrays())

    def jloss(p):
        o = JaxRoITr(jcfg).apply({"params": p}, jpacked, train=True, with_gt=True,
                                 rngs={"sampling": jax.random.PRNGKey(0)})
        lm = lambda oo, r, t: {**jlosses.overall_loss(jcfg, oo, r, t),  # noqa: E731
                               **jlosses.evaluate(jcfg, oo, r, t)}
        metrics = jax.vmap(lm)(o, jpacked.rot, jpacked.trans)
        return jnp.mean(metrics["loss"]), (o, metrics)

    # the forward op by op (its outputs are held at rtol 1e-4), the backward
    # jitted (one compile in place of hundreds of small ones)
    loss, vjp, (jout, jmetrics) = jax.vjp(jloss, params, has_aux=True)
    (jgrads,) = jax.jit(lambda f, ct: f(ct))(vjp, jnp.ones_like(loss))
    jgrads = params_to_state_dict(jax.tree_util.tree_map(np.asarray, jgrads),
                                  transformer_architecture=ARCH["transformer_architecture"],
                                  enc_blocks=ARCH["enc_blocks"])
    return dict(cfg=tcfg, model=model, pairs=pairs, packed=packed,
                out={k: _np(v) for k, v in out.items()},
                per_pair=[{k: float(v.detach()) for k, v in m.items()} for m in per_pair], grads=grads,
                jout={k: np.asarray(v) for k, v in jout.items()},
                jmetrics={k: np.asarray(v) for k, v in jmetrics.items()},
                jgrads={k: np.asarray(v) for k, v in jgrads.items()})


def _patch_order(out):
    """Patches sorted by their content (the points of a patch name its node
    pair): the two packages draw different Gumbel noise."""
    p = out["tgt_node_corr_knn_points"].shape[0]
    keys = np.concatenate([out[k].reshape(p, -1).astype(np.float64) for k in PER_PATCH[:4]],
                          axis=1)
    return np.lexsort(keys.T[::-1])


def _kept(out):
    keep = out["corr_masks"]
    return out["src_corr_points"][keep], out["tgt_corr_points"][keep], out["corr_scores"][keep]


def _same_fine(got, want, tag):
    """Kept fine correspondences as {(src xyz, tgt xyz): confidence}. The
    train forward keeps few (two GT patches a pair at this bucket), so
    same_correspondences' 2% allows none apart; a row may differ only at a
    near-tie: the other package kept, instead, a row that shares its source
    or its target point and whose confidence is within 1e-6 of it (a top-k
    over nearly uniform plans, whose scores the two packages round apart
    within the 1e-4 tolerance). Shared rows agree within tolerance."""
    g, w = _rows(*_kept(got)), _rows(*_kept(want))
    only_g, only_w = set(g) - set(w), set(w) - set(g)
    assert len(only_g) == len(only_w), (tag, len(only_g), len(only_w))
    for k in only_g:
        assert any((k[:3] == j[:3] or k[3:] == j[3:]) and abs(g[k] - w[j]) <= 1e-6
                   for j in only_w), (tag, k, g[k])
    shared = sorted(set(g) & set(w))
    assert len(shared) > 0, tag
    np.testing.assert_allclose([g[k] for k in shared], [w[k] for k in shared], err_msg=tag,
                               **TOL)


def test_packed_train_forward_matches_jax(runs):
    got, want = runs["out"], runs["jout"]
    assert set(got) == set(want)
    for i in range(len(COUNTS)):
        g, w = {k: v[i] for k, v in got.items()}, {k: v[i] for k, v in want.items()}
        idx = w["gt_node_corr_indices"]
        assert w["gt_node_corr_masks"].sum() > 0
        # JAX's _gt_overlap_map drops a valid (0, 0) pair (ROADMAP Queue 3)
        assert not w["gt_node_corr_masks"][(idx == 0).all(1)].any(), f"pair {i}"
        for key in sorted(set(want) - set(PER_PATCH) - set(FINE)):
            _assert_same(g[key], w[key], f"pair {i}: {key}")
        og, ow = _patch_order(g), _patch_order(w)
        for key in PER_PATCH:
            _assert_same(g[key][og], w[key][ow], f"pair {i}: {key}")
        _same_fine(g, w, f"pair {i}")


def test_packed_train_losses_match_jax(runs):
    """Per-pair losses (rtol 1e-4) and PIR; IR counts fine correspondences,
    whose near-ties either package may take (within 0.02)."""
    for i, m in enumerate(runs["per_pair"]):
        for k in LOSS_KEYS + ("PIR",):
            np.testing.assert_allclose(m[k], runs["jmetrics"][k][i], rtol=1e-4, atol=1e-6,
                                       err_msg=f"pair {i}: {k}")
        assert abs(m["IR"] - float(runs["jmetrics"]["IR"][i])) <= 0.02
        assert m["c_loss"] > 0


def test_packed_gradients_match_jax(runs):
    got, want = runs["grads"], runs["jgrads"]
    assert set(got) == set(want)
    for k in sorted(want):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-5, err_msg=k)
    g = np.concatenate([got[k].ravel() for k in sorted(want)]).astype(np.float64)
    w = np.concatenate([want[k].ravel() for k in sorted(want)]).astype(np.float64)
    assert np.linalg.norm(w) > 0
    assert np.dot(g, w) / (np.linalg.norm(g) * np.linalg.norm(w)) >= 0.9999


def test_packed_gradient_is_the_mean_of_single_pair_gradients(runs):
    """JAX's test_packed_train_step_grads contract, with the sampler NOT
    saturated (num_gt_coarse_corr 8): the packed forward draws pair b's
    Gumbel noise b-th from its generator, so single-pair forwards drawing
    from one generator of the same seed, in pair order, sample the same
    patches."""
    cfg, _, _, _ = port_and_params(0, **{**CFG, "num_gt_coarse_corr": 8})
    model = copy.deepcopy(runs["model"])
    model.cfg = cfg
    pairs = runs["pairs"]
    packed = pack_pairs(pairs)
    out = model(packed, train=True, with_gt=True, generator=torch.Generator().manual_seed(3))
    packed_losses = [m["loss"] for m in _per_pair(cfg, out, packed.rot, packed.trans)]
    torch.stack(packed_losses).mean().backward()
    g_packed = _grads(model)
    model.zero_grad(set_to_none=True)
    gen = torch.Generator().manual_seed(3)
    for i, pair in enumerate(pairs):
        o = model(pair, train=True, with_gt=True, generator=gen)
        loss = overall_loss(cfg, o, pair.rot, pair.trans)["loss"]
        np.testing.assert_allclose(float(loss.detach()), float(packed_losses[i].detach()),
                                   rtol=2e-4)
        (loss / len(pairs)).backward()
    g_single = _grads(model)
    for k in g_packed:
        a, b = g_single[k].numpy(), g_packed[k].numpy()
        scale = max(np.abs(a).max(), np.abs(b).max(), 1e-8)
        np.testing.assert_allclose(b, a, rtol=2e-3, atol=max(5e-5 * scale, 1e-7), err_msg=k)


def _step_setup(runs, **cfg_kw):
    model = copy.deepcopy(runs["model"])
    model.cfg = runs["cfg"].replace(**cfg_kw)
    return model, make_optimizer(model.cfg, model, steps_per_epoch=4)


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def test_train_step_on_a_packed_pair_and_a_list(runs):
    """A packed step's metrics are the fixture's per-pair means (the same
    forward); a list of the same pairs, drawing from a generator of the
    same seed, gives the same means within the packed-vs-single rounding;
    both update the parameters."""
    means = {k: np.mean([m[k] for m in runs["per_pair"]]) for k in runs["per_pair"][0]}
    for batch in (runs["packed"], runs["pairs"]):
        model, opt = _step_setup(runs)
        before = _params(model)
        metrics = train_step(model, opt, batch, torch.Generator().manual_seed(0))
        assert metrics["grads_finite"] == 1.0
        for k in LOSS_KEYS + ("PIR",):
            np.testing.assert_allclose(metrics[k], means[k], rtol=1e-4, atol=1e-6, err_msg=k)
        assert abs(metrics["IR"] - means["IR"]) <= 0.02
        assert any(not torch.equal(v, before[k]) for k, v in model.state_dict().items())


@pytest.mark.parametrize("kind", ["packed", "list"])
def test_train_step_guard_when_one_pair_is_not_finite(runs, kind):
    """One pair's matching scores made NaN (its f_loss, so its loss): the
    step skips the update (parameters held, the schedule counts the step)
    and reports grads_finite 0, as JAX's guard over the mean loss does."""
    model, opt = _step_setup(runs)
    before = _params(model)
    calls = []

    def poison(_, args, out):
        calls.append(1)
        scores = out["matching_scores"]
        if kind == "packed":
            nan = torch.tensor([1.0, float("nan")]).reshape(2, 1, 1, 1)
            return {**out, "matching_scores": scores * nan}
        return {**out, "matching_scores": scores * float("nan")} if len(calls) == 2 else out

    hook = model.register_forward_hook(poison)
    try:
        batch = runs["packed"] if kind == "packed" else runs["pairs"]
        metrics = train_step(model, opt, batch, torch.Generator().manual_seed(0))
    finally:
        hook.remove()
    assert metrics["grads_finite"] == 0.0 and not np.isfinite(metrics["loss"])
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert opt.scheduler.last_epoch == 1


def test_train_step_iter_size_on_packed_pairs(runs):
    """iter_size 2: the first packed step holds the parameters, the second
    updates them once."""
    model, opt = _step_setup(runs, iter_size=2)
    before = _params(model)
    train_step(model, opt, runs["packed"], torch.Generator().manual_seed(0))
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    assert opt.scheduler.last_epoch == 0
    train_step(model, opt, runs["packed"], torch.Generator().manual_seed(1))
    assert any(not torch.equal(v, before[k]) for k, v in model.state_dict().items())
    assert opt.scheduler.last_epoch == 1


def test_eval_step_means(runs):
    """eval_step of a packed pair and of a list equals the mean of the
    single pairs' (JAX's test_packed_eval_step_means tolerance for the
    packed one, rtol 2e-4 / atol 2e-5; the list runs the single forwards)."""
    model, pairs = runs["model"], runs["pairs"]
    singles = [eval_step(model, p) for p in pairs]
    want = {k: np.mean([m[k] for m in singles]) for k in singles[0]}
    packed, listed = eval_step(model, runs["packed"]), eval_step(model, pairs)
    assert set(packed) == set(listed) == set(want)
    for k in want:
        np.testing.assert_allclose(listed[k], want[k], rtol=1e-6, atol=1e-7, err_msg=k)
        if k != "IR":
            np.testing.assert_allclose(packed[k], want[k], rtol=2e-4, atol=2e-5, err_msg=k)
    assert abs(packed["IR"] - want["IR"]) <= 0.02


# ---- the loader --------------------------------------------------------------

def _items():
    """Seven items in two buckets (128 and 256), with host pyramids."""
    items = []
    for i, bucket in enumerate((256, 128, 256, 256, 128, 256, 128)):
        a = pair_arrays(60 + i, bucket, bucket - 20 - i, bucket - 30 - i)
        a["src_pyramid"] = build_cloud_pyramid(a["src_raw_points"], int(a["src_count"]))
        a["tgt_pyramid"] = build_cloud_pyramid(a["tgt_points"], int(a["tgt_count"]))
        items.append(a)
    return items


def _ids(points):
    """Item ids of a batch's pairs from their first source point."""
    return [int(round(float(p[0, 0]) * 1e6)) for p in points]


def _tag(items):
    for i, a in enumerate(items):
        a["src_points"] = a["src_points"].copy()
        a["src_points"][0, 0] = i * 1e-6
    return items


def _leaves(pair):
    """{name: numpy array} of a PairInputs' leaves, its pyramids' fields
    included, indices widened to int64."""
    out = {}
    for name, v in pair._asdict().items():
        if name.endswith("pyramid"):
            out.update({f"{name}.{f}": _np(x) for f, x in v._asdict().items()})
        elif v is not None:
            out[name] = _np(v)
    return {k: v.astype(np.int64) if v.dtype.kind in "iu" else v for k, v in out.items()}


def _assert_leaves_equal(got, want, tag):
    g, w = _leaves(got), _leaves(want)
    assert set(g) == set(w), tag
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=f"{tag}: {k}")


@pytest.mark.parametrize("pack", [0, 2])
def test_loader_batches_match_jax(pack):
    """Shuffled batches of 2 from two buckets: JAX's and the port's full
    batches hold the same pairs in the same order; each bucket's tail holds
    its one remaining pair once (JAX repeats it to fill the batch); with
    pack 2 every leaf of a packed batch, pyramids included, equals the
    port's pack_pairs of its pairs and, for a full batch, JAX's pack_pairs;
    every item of the epoch is seen exactly once."""
    from roitr_torch.data.loader import dict_to_pair
    from roitr_tpu.data.loader import dict_to_pair as jax_dict_to_pair

    items = _tag(_items())
    got = list(iterate_batches(items, 2, shuffle=True, seed=5, pack=pack))
    want = list(jax_iterate_batches(items, 2, shuffle=True, seed=5, pack=pack))
    assert len(got) == len(want) == 4  # 256: two full; 128: one full and a tail
    seen = []
    for g, w in zip(got, want):
        if pack:
            b = int(g.src_count.shape[0])
            g_ids = _ids(g.src_points.reshape(b, -1, 3).numpy())
            w_ids = _ids(np.asarray(w.src_points)[0].reshape(2, -1, 3))
            _assert_leaves_equal(g, pack_pairs([dict_to_pair(items[j]) for j in g_ids]),
                                 f"port batch {g_ids}")
            if b == 2:
                _assert_leaves_equal(g, jax_pack_pairs([jax_dict_to_pair(items[j])
                                                        for j in w_ids]), f"JAX batch {w_ids}")
        else:
            g_ids = _ids([p.src_points.numpy() for p in (g if isinstance(g, list) else [g])])
            w_ids = _ids(np.asarray(w.src_points))
        if len(g_ids) == 2:
            assert g_ids == w_ids
        else:  # a tail: JAX repeats its one pair
            assert w_ids == g_ids * 2
        seen += g_ids
    assert sorted(seen) == list(range(len(items)))


def test_bucket_batcher_checks_pack():
    with pytest.raises(ValueError, match="multiple of pack"):
        BucketBatcher(3, pack=2)


def test_iterate_batches_batch_size_one_is_pair_by_pair():
    items = _tag(_items())
    got = [_ids([p.src_points.numpy()])[0] for p in iterate_batches(items, shuffle=True, seed=2)]
    want = np.arange(len(items))
    np.random.RandomState(2).shuffle(want)
    assert got == list(want)


# ---- the Trainer ---------------------------------------------------------------

TRAINER_CFG = dict(num_est_coarse_corr=8, num_gt_coarse_corr=8, point_per_patch=8,
                   sinkhorn_iters=5, max_gt_corr_candidates=16, buckets=(128,), normal_knn=9,
                   batch_size=2, packed_batch=True, host_pyramid=True, max_epoch=1,
                   verbose=False, training_max_iter=3, val_max_iter=2)


class _WithPyramids:
    """A dataset whose items carry both clouds' host pyramids (what
    data/tdmatch.py yields under cfg.host_pyramid)."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        d = dict(self.dataset[i])
        d["src_pyramid"] = build_cloud_pyramid(d["src_raw_points"], int(d["src_count"]))
        d["tgt_pyramid"] = build_cloud_pyramid(d["tgt_points"], int(d["tgt_count"]))
        return d


def test_trainer_packed_one_epoch(tmp_path, monkeypatch):
    """Three pairs in packs of two: a packed step of two and a tail of one;
    one packed validation step of two; meters weighted by pairs."""
    monkeypatch.chdir(tmp_path)
    cfg = Config(**TRAINER_CFG)
    trainer = Trainer(cfg, _WithPyramids(SyntheticPairs(4, 128, seed=0, normal_knn=9)),
                      _WithPyramids(SyntheticPairs(2, 128, seed=50, normal_knn=9)), device="cpu",
                      time_steps=True)
    shapes = []
    hook = trainer.model.register_forward_pre_hook(
        lambda _, args: shapes.append(tuple(args[0].src_count.shape)))
    w0 = _params(trainer.model)
    try:
        bests = trainer.train()
    finally:
        hook.remove()
    assert shapes == [(2,), (1,), (2,)], shapes
    assert trainer.step == 2 and np.isfinite(bests["loss"])
    assert any(not torch.equal(v, w0[k]) for k, v in trainer.model.state_dict().items())
    with pytest.raises(ValueError, match="packed_batch requires host_pyramid"):
        Trainer(cfg.replace(host_pyramid=False), SyntheticPairs(1, 128),
                SyntheticPairs(1, 128), device="cpu")
