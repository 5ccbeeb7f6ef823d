"""The pieces of the port's training path against the JAX package on the
CPU: the GT geometry (apply_transform, masked_min_dist,
node_correspondences, node_occlusion_score), GT patch sampling, the losses
and evaluator on fixed outputs, the optimizer against the optax chain, the
NaN guard, and the Trainer with its checkpoints. The whole model's
training forward and gradients are in test_torch_train_model.py.

Tolerances: indices exactly; fp32 values within rtol 1e-4 / atol 1e-5;
parameters after optimizer steps within rtol 1e-5 / atol 1e-7 (one fp32
update formula in two libraries).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from roitr_torch.config import Config
from roitr_torch.data.loader import dict_to_pair, iterate_batches
from roitr_torch.data.synthetic import SyntheticPairs
from roitr_torch.losses import evaluate, gt_overlap_map, overall_loss
from roitr_torch.models.matching import gt_coarse_corr_generator
from roitr_torch.ops import neighbors
from roitr_torch.ops.geometry import apply_transform
from roitr_torch.ops.neighbors import masked_min_dist
from roitr_torch.ops.partition import (
    node_correspondences,
    node_occlusion_score,
    point_to_node_partition,
)
from roitr_torch.parallel.train_step import make_optimizer, train_step
from roitr_torch.train.checkpoint import init_best_metrics, load_checkpoint, update_bests
from roitr_torch.train.trainer import Trainer
from roitr_tpu import losses as jlosses
from roitr_tpu.config import Config as JaxConfig
from roitr_tpu.models.matching import gt_coarse_corr_generator as jax_gt_coarse_corr_generator
from roitr_tpu.ops import geometry as jgeom
from roitr_tpu.ops import neighbors as jneighbors
from roitr_tpu.ops import partition as jpartition
from roitr_tpu.parallel.train_step import make_optimizer as jax_make_optimizer

from torch_parity import (  # noqa: F401 (one_torch_thread: an autouse fixture)
    one_torch_thread,
    pair_arrays,
    port_and_params,
    torch_pair,
)

TOL = dict(rtol=1e-4, atol=1e-5)
BUCKET = dict(bucket=512, n_valid=480, m_valid=400)
TRAIN_KW = dict(geo_embedding_storage="fp32", num_gt_coarse_corr=64,
                transformer_architecture=("self", "cross"), enc_blocks=(2, 1, 1, 2))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(got, want, key=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, key
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, err_msg=key, **TOL)
    else:
        np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64), err_msg=key)


# ---- GT geometry ------------------------------------------------------------

@pytest.fixture(scope="module")
def gt_case():
    """A synthetic pair with 16 nodes a cloud (random valid points) and the
    port's partition of each cloud (itself exact against JAX)."""
    arr = pair_arrays(11, bucket=256, n_valid=230, m_valid=200)
    rng = np.random.RandomState(0)
    case = dict(arr=arr)
    for side, cnt in (("src", 230), ("tgt", 200)):
        pts = torch.from_numpy(arr[f"{side}_points"])
        nodes = pts[torch.from_numpy(rng.choice(cnt, 16, replace=False))]
        part = point_to_node_partition(pts, nodes, 16, torch.tensor(cnt), torch.tensor(14))
        padded = torch.cat([pts, pts.new_zeros((1, 3))])
        case[side] = dict(nodes=nodes, part=part, padded=padded,
                          knn_points=padded[part.node_knn_indices], count=cnt)
    return case


def test_apply_transform(rng):
    pts = rng.randn(5, 7, 3).astype(np.float32)
    rot = np.linalg.qr(rng.randn(3, 3))[0].astype(np.float32)
    trans = rng.randn(3, 1).astype(np.float32)
    got = apply_transform(*(torch.from_numpy(x) for x in (pts, rot, trans)))
    _assert_same(got, jgeom.apply_transform(*(jnp.asarray(x) for x in (pts, rot, trans))))


@pytest.mark.parametrize("tile_elems", [None, 4096])
def test_masked_min_dist(rng, monkeypatch, tile_elems):
    """One tile, and many tiles of the query axis."""
    if tile_elems:
        monkeypatch.setattr(neighbors, "_TILE_ELEMS", tile_elems)
    q, keys = rng.randn(300, 3).astype(np.float32), rng.randn(257, 3).astype(np.float32)
    got = masked_min_dist(torch.from_numpy(q), torch.from_numpy(keys), torch.tensor(200))
    _assert_same(got, jneighbors.masked_min_dist(jnp.asarray(q), jnp.asarray(keys), 200))


@pytest.mark.parametrize("max_candidates,chunk", [(128, 32), (256, 2048)])
def test_node_correspondences(gt_case, max_candidates, chunk):
    s, t, arr = gt_case["src"], gt_case["tgt"], gt_case["arr"]
    args = [t["nodes"], s["nodes"], t["knn_points"], s["knn_points"],
            torch.from_numpy(arr["rot"]), torch.from_numpy(arr["trans"])]
    kw = dict(ref_masks=t["part"].node_masks, src_masks=s["part"].node_masks,
              ref_knn_masks=t["part"].node_knn_masks, src_knn_masks=s["part"].node_knn_masks)
    got = node_correspondences(*args, 0.2, max_candidates=max_candidates, chunk=chunk, **kw)
    want = jpartition.node_correspondences(
        *(jnp.asarray(_np(a)) for a in args), 0.2, max_candidates=max_candidates, chunk=chunk,
        **{k: jnp.asarray(_np(v)) for k, v in kw.items()})
    assert int(got.masks.sum()) > 10
    for key, g, w in zip(("indices", "overlaps", "masks"), got, want):
        _assert_same(g, w, key)


def test_node_occlusion_score(gt_case):
    s, t, arr = gt_case["src"], gt_case["tgt"], gt_case["arr"]
    args = [t["part"].node_knn_indices, s["part"].node_knn_indices, t["padded"], s["padded"],
            torch.tensor(t["count"]), torch.tensor(s["count"]), torch.from_numpy(arr["rot"]),
            torch.from_numpy(arr["trans"])]
    kw = dict(ref_masks=t["part"].node_masks, src_masks=s["part"].node_masks,
              ref_knn_masks=t["part"].node_knn_masks, src_knn_masks=s["part"].node_knn_masks)
    got = node_occlusion_score(*args, **kw)
    want = jpartition.node_occlusion_score(*(jnp.asarray(_np(a)) for a in args),
                                           **{k: jnp.asarray(_np(v)) for k, v in kw.items()})
    assert float(got[0].max()) > 0
    for g, w in zip(got, want):
        _assert_same(g, w)


def test_gt_coarse_corr_generator_given_jax_gumbel(rng):
    """Handed JAX's own Gumbel draw, the port selects the same correspondences."""
    c = 200
    idx = rng.randint(0, 30, size=(c, 2)).astype(np.int32)
    ov = rng.rand(c).astype(np.float32)
    masks = rng.rand(c) > 0.3
    key = jax.random.PRNGKey(7)
    want = jax_gt_coarse_corr_generator(key, jnp.asarray(idx), jnp.asarray(ov),
                                        jnp.asarray(masks), 64, 0.1)
    noise = np.asarray(jax.random.gumbel(key, (c,)))
    got = gt_coarse_corr_generator(torch.from_numpy(idx).long(), torch.from_numpy(ov),
                                   torch.from_numpy(masks), 64, 0.1,
                                   gumbel=torch.from_numpy(noise.copy()))
    for key_, g, w in zip(("ref", "src", "overlaps", "masks"), got, want):
        _assert_same(g, w, key_)


def test_gt_coarse_corr_generator_draws_from_the_generator():
    idx = torch.arange(40).reshape(20, 2)
    ov = torch.full((20,), 0.5)
    masks = torch.ones(20, dtype=torch.bool)
    a = gt_coarse_corr_generator(idx, ov, masks, 8, 0.1, generator=torch.Generator().manual_seed(3))
    b = gt_coarse_corr_generator(idx, ov, masks, 8, 0.1, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a.ref_indices, b.ref_indices)
    with pytest.raises(ValueError, match="generator"):
        gt_coarse_corr_generator(idx, ov, masks, 8, 0.1)


# ---- losses and evaluator on fixed outputs -------------------------------

def _fixed_outputs(seed):
    """A forward's dict with seeded values: 12 tgt / 10 src nodes (9 / 8
    valid), 30 GT slots (20 valid, unique, none at (0, 0)), 6 patches of 8
    points, 16 coarse and 48 fine correspondences."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    unit = lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True)
    flat = rng.permutation(np.arange(1, 9 * 8))[:20]
    idx = np.zeros((30, 2), np.int32)
    idx[:20] = np.stack([flat // 8, flat % 8], axis=1)
    masks = np.arange(30) < 20
    ov = np.where(masks, rng.rand(30) * 0.9 + 0.05, 0.0).astype(np.float32)
    rot = np.linalg.qr(rng.randn(3, 3))[0].astype(np.float32)
    trans = f(3, 1)
    tgt_pts = f(6, 8, 3) * 0.05
    src_pts = (tgt_pts + f(6, 8, 3) * 0.02 - trans.reshape(3)) @ rot
    out = {
        "tgt_node_feats": unit(f(12, 16)), "src_node_feats": unit(f(10, 16)),
        "tgt_node_count": np.int32(9), "src_node_count": np.int32(8),
        "gt_node_corr_indices": idx, "gt_node_corr_overlaps": ov, "gt_node_corr_masks": masks,
        "tgt_node_corr_knn_points": tgt_pts, "src_node_corr_knn_points": src_pts.astype(np.float32),
        "tgt_node_corr_knn_masks": rng.rand(6, 8) > 0.2,
        "src_node_corr_knn_masks": rng.rand(6, 8) > 0.2,
        "matching_scores": -np.abs(f(6, 9, 9)) * 3,
        "tgt_node_corr_indices": rng.randint(0, 9, 16).astype(np.int32),
        "src_node_corr_indices": rng.randint(0, 8, 16).astype(np.int32),
        "node_corr_masks": rng.rand(16) > 0.3,
        "tgt_corr_points": f(48, 3) * 0.1,
        "corr_masks": rng.rand(48) > 0.4,
    }
    out["src_corr_points"] = ((out["tgt_corr_points"] + f(48, 3) * 0.05 - trans.reshape(3))
                              @ rot).astype(np.float32)
    return out, rot, trans


@pytest.mark.parametrize("seed", [0, 1])
def test_losses_and_evaluate_match_jax(seed):
    arrs, rot, trans = _fixed_outputs(seed)
    assert not arrs["gt_node_corr_masks"][(arrs["gt_node_corr_indices"] == 0).all(1)].any()
    cfg, jcfg = Config(), JaxConfig()
    tout = {k: torch.from_numpy(np.asarray(v)) for k, v in arrs.items()}
    for k in ("tgt_node_feats", "matching_scores"):
        tout[k].requires_grad_(True)
    jout = {k: jnp.asarray(v) for k, v in arrs.items()}
    trot, ttrans = torch.from_numpy(rot), torch.from_numpy(trans)
    got = {**overall_loss(cfg, tout, trot, ttrans), **evaluate(cfg, tout, trot, ttrans)}
    want = {**jlosses.overall_loss(jcfg, jout, rot, trans),
            **jlosses.evaluate(jcfg, jout, rot, trans)}
    assert set(got) == set(want)
    for k in got:
        _assert_same(got[k], want[k], k)
    assert 0 < float(got["PIR"]) < 1 and 0 < float(got["IR"]) < 1
    got["loss"].backward()

    def jloss(tf, ms):
        return jlosses.overall_loss(jcfg, {**jout, "tgt_node_feats": tf, "matching_scores": ms},
                                    rot, trans)["loss"]

    g_tf, g_ms = jax.grad(jloss, argnums=(0, 1))(jout["tgt_node_feats"], jout["matching_scores"])
    _assert_same(tout["tgt_node_feats"].grad, g_tf, "d tgt_node_feats")
    _assert_same(tout["matching_scores"].grad, g_ms, "d matching_scores")


def test_gt_overlap_map_keeps_a_valid_zero_pair():
    """Invalid GT slots point at (0, 0) with overlap 0. JAX's `.at[].set`
    lets a later invalid slot overwrite a valid (0, 0) overlap (the last
    write wins on the CPU); the port's accumulating put keeps it."""
    idx = np.array([[0, 0], [1, 2], [0, 0]], np.int32)
    ov = np.array([0.5, 0.3, 0.0], np.float32)
    masks = np.array([True, True, False])
    feats = dict(tgt_node_feats=np.zeros((3, 4), np.float32),
                 src_node_feats=np.zeros((3, 4), np.float32))
    out = {**feats, "gt_node_corr_indices": idx, "gt_node_corr_overlaps": ov,
           "gt_node_corr_masks": masks}
    got = gt_overlap_map({k: torch.from_numpy(v) for k, v in out.items()})
    want = jlosses._gt_overlap_map({k: jnp.asarray(v) for k, v in out.items()})
    assert float(got[0, 0]) == 0.5 and float(want[0, 0]) == 0.0
    assert float(got[1, 2]) == float(want[1, 2]) == np.float32(0.3)


# ---- optimizer ----------------------------------------------------------------

@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_optimizer_steps_match_optax(optimizer):
    """Eight mini-steps of the same gradients, iter_size 2, 6 steps an epoch:
    four updates, the learning rate decays after the third (transition
    6 // 2 = 3 updates), coupled L2 throughout."""
    rng = np.random.RandomState(0)
    cfg_kw = dict(optimizer=optimizer, lr=1e-2, weight_decay=1e-2, iter_size=2,
                  scheduler_gamma=0.5, momentum=0.9)
    shapes = {"a": (4, 3), "b": (5,)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()} for _ in range(8)]

    module = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                                     for k, v in init.items()})
    opt = make_optimizer(Config(**cfg_kw), module, steps_per_epoch=6)
    tx = jax_make_optimizer(JaxConfig(**cfg_kw), 6)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    for g in grads:
        for k, p in module.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step(True)
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in module.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    assert opt.scheduler.get_last_lr()[0] == pytest.approx(1e-2 * 0.5)


def test_nan_guard_advances_the_moments_and_holds_the_parameters():
    """A step with a non-finite gradient: zero gradients go through the
    update (L2 and the Adam moments move, the schedule counts it), then the
    parameters are put back, as the JAX train step's guard does."""
    cfg = Config(lr=1e-2, weight_decay=1e-1)
    w0 = np.arange(6, dtype=np.float32).reshape(2, 3) / 5
    module = torch.nn.ParameterDict({"w": torch.nn.Parameter(torch.from_numpy(w0.copy()))})
    opt = make_optimizer(cfg, module, steps_per_epoch=1)
    module["w"].grad = torch.full((2, 3), float("nan"))
    assert opt.step(False)
    np.testing.assert_array_equal(module["w"].detach().numpy(), w0)
    tx = jax_make_optimizer(JaxConfig(lr=1e-2, weight_decay=1e-1), 1)
    jw = {"w": jnp.asarray(w0)}
    _, state = tx.update({"w": jnp.zeros((2, 3))}, tx.init(jw), jw)
    adam = state[1]
    inner = opt.inner.state[module["w"]]
    np.testing.assert_allclose(inner["exp_avg"].numpy(), np.asarray(adam.mu["w"]), rtol=1e-6)
    np.testing.assert_allclose(inner["exp_avg_sq"].numpy(), np.asarray(adam.nu["w"]), rtol=1e-6)
    assert opt.scheduler.last_epoch == 1


def test_train_step_guard_on_a_non_finite_gradient():
    tcfg, model, _, _ = port_and_params(0, **TRAIN_KW)
    opt = make_optimizer(tcfg, model, steps_per_epoch=4)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.fine_proj.bias.register_hook(lambda g: g * float("nan"))
    metrics = train_step(model, opt, torch_pair(pair_arrays(5, **BUCKET)),
                         torch.Generator().manual_seed(0))
    assert metrics["grads_finite"] == 0.0 and np.isfinite(metrics["loss"])
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert opt.scheduler.last_epoch == 1


# ---- Trainer and checkpoints --------------------------------------------------

TRAINER_CFG = dict(num_est_coarse_corr=8, num_gt_coarse_corr=8, point_per_patch=8,
                   sinkhorn_iters=5, max_gt_corr_candidates=16, buckets=(128,), normal_knn=9,
                   batch_size=1, max_epoch=1, verbose=False, training_max_iter=2,
                   val_max_iter=2, num_workers=0)


def test_update_bests():
    best = init_best_metrics()
    improved = update_bests(best, {"loss": 1.0, "PIR": 0.5, "IR": 0.2, "c_loss": 0.6,
                                   "f_loss": 0.4, "o_loss": 0.0})
    assert all(improved.values())
    improved = update_bests(best, {"loss": 2.0, "PIR": 0.6, "IR": 0.1, "c_loss": 0.7,
                                   "f_loss": 0.5, "o_loss": 0.0})
    assert improved["PIR"] and not improved["loss"] and not improved["IR"]
    assert best["loss"] == 1.0 and best["PIR"] == 0.6


def test_iterate_batches_order_and_cut():
    ds = list(range(10))
    order = [int(p.src_count) for p in iterate_batches(
        [_item(i) for i in ds], shuffle=True, seed=3, max_items=4)]
    want = np.arange(10)
    np.random.RandomState(3).shuffle(want)
    assert order == [i + 1 for i in want[:4]]


def _item(i):
    z = np.zeros((4, 3), np.float32)
    return dict(src_points=z, src_raw_points=z, src_normals=z, src_feats=z[:, :1],
                src_count=i + 1, tgt_points=z, tgt_normals=z, tgt_feats=z[:, :1], tgt_count=1,
                rot=np.eye(3, dtype=np.float32), trans=np.zeros((3, 1), np.float32))


def test_trainer_one_epoch_and_resume(tmp_path, monkeypatch):
    """Two steps and a validation pass on the CPU: the per-epoch and
    per-best checkpoints and the scalar stream are written; a Trainer
    resumed from the epoch's checkpoint holds the same weights, optimizer
    state, step, epoch and bests."""
    monkeypatch.chdir(tmp_path)
    cfg = Config(**TRAINER_CFG)
    trainer = Trainer(cfg, SyntheticPairs(4, 128, seed=0, normal_knn=9),
                      SyntheticPairs(2, 128, seed=50, normal_knn=9), device="cpu",
                      time_steps=True)
    w0 = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    bests = trainer.train()
    assert np.isfinite(bests["loss"])
    assert trainer.step == 2 and len(trainer.step_times) == 2
    assert set(trainer.step_times[0]) == {"forward_ms", "backward_ms", "optimizer_ms"}
    assert any(not torch.equal(v, w0[k]) for k, v in trainer.model.state_dict().items())
    ckpts = os.listdir(os.path.join("snapshot", cfg.exp_dir, "checkpoints"))
    assert "model_0.pth" in ckpts and "model_best_loss.pth" in ckpts
    events = os.path.join("snapshot", cfg.exp_dir, "events.jsonl")
    assert os.path.exists(events) and '"phase": "val"' in open(events).read()

    path = os.path.join("snapshot", cfg.exp_dir, "checkpoints", "model_0.pth")
    ckpt = load_checkpoint(path)
    assert ckpt["epoch"] == 0 and ckpt["step"] == 2
    resumed = Trainer(cfg.replace(pretrain=path), SyntheticPairs(4, 128, seed=0, normal_knn=9),
                      SyntheticPairs(2, 128, seed=50, normal_knn=9), device="cpu")
    assert resumed.start_epoch == 1 and resumed.step == 2
    assert resumed.best_metrics == trainer.best_metrics
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    a, b = trainer.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert a["scheduler"]["last_epoch"] == b["scheduler"]["last_epoch"] == 2
    for pid, st in a["inner"]["state"].items():
        for name, t in st.items():
            assert torch.equal(t, b["inner"]["state"][pid][name]), (pid, name)


def test_trainer_refuses_batches(tmp_path, monkeypatch):
    """Batches of two pairs (a list a step, not packed) train and validate,
    the step counting optimizer steps and the learning rate falling once an
    epoch of two batches (JAX's optimizer is given the epoch's pairs, 4, so
    its rate would not fall until the second epoch's end: ROADMAP Queue 3);
    dp_size 2 without a process group raises, naming the torchrun command
    that runs it (tests/test_torch_ddp.py trains at world 2)."""
    monkeypatch.chdir(tmp_path)
    cfg = Config(**{**TRAINER_CFG, "batch_size": 2, "training_max_iter": 4,
                    "scheduler_gamma": 0.5})
    trainer = Trainer(cfg, SyntheticPairs(5, 128, seed=0, normal_knn=9),
                      SyntheticPairs(2, 128, seed=50, normal_knn=9), device="cpu")
    lr = lambda: trainer.optimizer.inner.param_groups[0]["lr"]  # noqa: E731
    assert lr() == cfg.lr
    for epoch, want in ((0, 0.5), (1, 0.25)):
        metrics = trainer.train_epoch(epoch)
        assert trainer.step == 2 * (epoch + 1) and np.isfinite(metrics["loss"])
        assert lr() == pytest.approx(cfg.lr * want, rel=1e-12)
    assert np.isfinite(trainer.eval_epoch(1)["loss"])
    with pytest.raises(RuntimeError, match="dp_size=2 .*torchrun --nproc_per_node=2"):
        Trainer(cfg.replace(dp_size=2), SyntheticPairs(1, 128), SyntheticPairs(1, 128),
                device="cpu")


class _TwoBuckets:
    """Pairs of two buckets: items 0-4 of the 128 bucket, 5-9 of the 192."""

    def __init__(self):
        self.parts = (SyntheticPairs(5, 128, seed=0, normal_knn=9),
                      SyntheticPairs(5, 192, seed=10, normal_knn=9))

    def __len__(self):
        return 10

    def __getitem__(self, i):
        return self.parts[i // 5][i % 5]


def test_trainer_lr_falls_once_an_epoch_with_two_buckets(tmp_path, monkeypatch):
    """Two buckets of 5 pairs at batch 2: an epoch is 6 batches (each
    bucket's ragged tail a batch of its own), and the rate falls exactly
    once an epoch, at its end. A staircase counting updates against
    ceil(10 / 2) = 5 a transition would fall after the 5th batch and drift
    a batch further each epoch."""
    monkeypatch.chdir(tmp_path)
    cfg = Config(**{**TRAINER_CFG, "batch_size": 2, "training_max_iter": 10,
                    "scheduler_gamma": 0.5, "buckets": (128, 192)})
    trainer = Trainer(cfg, _TwoBuckets(), SyntheticPairs(1, 128, seed=50, normal_knn=9),
                      device="cpu")
    opt = trainer.optimizer
    rates = []
    step = opt.step

    def record(grads_finite):  # the rate each update is made with
        rates.append(opt.inner.param_groups[0]["lr"])
        return step(grads_finite)

    monkeypatch.setattr(opt, "step", record)
    for epoch in range(2):
        trainer.train_epoch(epoch)
    assert trainer.step == 12
    assert rates == [cfg.lr] * 6 + [cfg.lr * 0.5] * 6
    assert opt.inner.param_groups[0]["lr"] == pytest.approx(cfg.lr * 0.25, rel=1e-12)
    # resumed after epoch 1, the staircase stands where it stood
    trainer._save("model_1", 1)
    path = os.path.join(trainer.ckpt_dir, "model_1.pth")
    resumed = Trainer(cfg.replace(pretrain=path), _TwoBuckets(),
                      SyntheticPairs(1, 128, seed=50, normal_knn=9), device="cpu")
    assert resumed.start_epoch == 2 and resumed.optimizer.epochs == 2
    assert resumed.optimizer.inner.param_groups[0]["lr"] == pytest.approx(cfg.lr * 0.25)
    assert resumed.optimizer.scheduler.lr_lambdas[0](resumed.optimizer.scheduler.last_epoch) \
        == pytest.approx(0.25)


def test_lr_at_batch_one_and_iter_size_four_is_jax_s():
    """Batch 1, iter_size 4 (the 4DMatch training config): the Trainer's
    optimizer counts updates against the epoch's pairs // iter_size, as
    JAX's optax.exponential_decay(transition_steps=pairs // iter_size,
    staircase) does, over three epochs of 8 pairs; the epoch index it is
    told leaves that staircase alone."""
    pairs, cfg_kw = 8, dict(lr=1e-2, iter_size=4, scheduler_gamma=0.5)
    module = torch.nn.ParameterDict({"w": torch.nn.Parameter(torch.zeros(3))})
    opt = make_optimizer(Config(**cfg_kw), module, steps_per_epoch=pairs)
    schedule = optax.exponential_decay(1e-2, transition_steps=pairs // 4, decay_rate=0.5,
                                       staircase=True)
    updates = 0
    for epoch in range(3):
        for _ in range(pairs):
            module["w"].grad = torch.ones(3)
            lr = opt.inner.param_groups[0]["lr"]
            if opt.step(True):
                assert lr == pytest.approx(float(schedule(updates)), rel=1e-6), updates
                updates += 1
        opt.set_epoch(epoch + 1)
    assert updates == 6


def test_trainer_needs_a_card_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(Config(**TRAINER_CFG), SyntheticPairs(1, 128), SyntheticPairs(1, 128))


def test_dict_to_pair_roundtrip():
    item = SyntheticPairs(1, 128, seed=4, normal_knn=9)[0]
    pair = dict_to_pair(item)
    assert pair.src_points.dtype == torch.float32 and pair.src_count.dtype == torch.int64
    np.testing.assert_array_equal(pair.rot.numpy(), item["rot"])
    assert int(pair.tgt_count) == int(item["tgt_count"])
