"""Data parallelism over processes (roitr_torch/parallel/distributed.py) on
the CPU: two ranks in one gloo group, spawned once for the whole file
(tests/ddp_ranks.py `ddp_checks`), held against the port's one-process
path, which the other test files hold against JAX; and the loader's
stride against JAX's loader.

- One step, one pair a rank: the parameters equal those of the
  one-process step on the list of both pairs within atol 1e-7 (the
  reduction changes only the order of a sum of two gradients; Adam's first
  update is lr * g / (|g| + eps) with lr 1e-4), and are bit-equal across
  ranks. The one-process step draws pair 0's Gumbel noise, then pair 1's,
  from one generator: a forward pre-hook records the generator's state at
  each pair's forward, and rank r starts its step from the state recorded
  for pair r.
- Uneven ranks: rank 0 holds two batches, rank 1 one; both take two steps
  (rank 1 joins the second with no pairs), and the second step's update is
  rank 0's pair alone, as the one-process step of that pair.
- A non-finite loss on rank 1's pair skips the update on both ranks.
- A Trainer at world 2 over three pairs (2 + 1): bit-equal parameters, the
  same validation metrics on both ranks and equal (rtol 1e-6: only the
  order of the sums differs) to the one-process eval_step mean over the
  same pairs, one checkpoint written a name (by rank 0 only), the lr
  halved at the epoch's end (scheduler_gamma 0.5: at world > 1 the rate
  falls once an epoch, ROADMAP's deliberate differences), and a resumed
  world-2 run.
- The same step against JAX's own data parallelism: its train step
  (roitr_tpu/parallel `make_train_step`) jitted over a dp_size 2 `data`
  mesh of the test process's host devices, on the same two pairs and
  weights, with an optimizer that keeps the gradient it is given as its
  state. The GT sampler is saturated (num_gt_coarse_corr 64 =
  max_gt_corr_candidates, as tests/test_torch_packed_train.py has it), so
  the two packages' different Gumbel draws only order the patches. The
  reduced losses within rtol 1e-4, PIR exactly, IR within 0.02 (a
  near-tie of the fine matching either package may take), and every
  parameter's reduced gradient within rtol 1e-3 / atol 1e-5 and cosine
  >= 0.9999 over all, as that file holds the one-process gradient. JAX's
  program compiles (about two minutes on one core) in a thread while the
  ranks run.
- The Tester at world 2 writes dumps byte-equal to world 1's, one pair a
  forward; with packed_batch a rank packs only its own pairs, so the
  dumps are held to world 1's with the packed Tester's near-tie tolerance
  (tests/torch_parity.py `same_correspondences`).
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from roitr_torch.config import Config
from roitr_torch.data.loader import iterate_batches
from roitr_torch.data.pyramid import build_cloud_pyramid
from roitr_torch.data.synthetic import SyntheticPairs
from roitr_torch.eval.tester import Tester as PortTester
from roitr_torch.models.roitr import RoITr
from roitr_torch.parallel.distributed import spawn
from roitr_torch.parallel.train_step import eval_step, make_optimizer, train_step
from roitr_torch.train.trainer import Trainer
from roitr_tpu.data.loader import iterate_batches as jax_iterate_batches

from ddp_ranks import TESTERS, ddp_checks, flat_params, config_for_tester, write_tester_dumps
from torch_parity import (  # noqa: F401 (one_torch_thread: an autouse fixture)
    TINY,
    jax_pair,
    one_torch_thread,
    pair_arrays,
    port_and_params,
    same_correspondences,
)

# a light model whose train losses are not zero at the 256 bucket; 16 GT
# patches of up to 64 candidates, so that the Gumbel draws choose them
DDP_CFG = dict(TINY, num_gt_coarse_corr=16, buckets=(256,), sinkhorn_iters=5,
               transformer_architecture=("self", "cross"), enc_blocks=(1, 1, 1, 1),
               batch_size=1, max_epoch=1, verbose=False, num_workers=0)


# JAX's mesh step: the cut architecture, fp32 embedding storage, and the GT
# sampler saturated (num_gt_coarse_corr 64 = TINY's max_gt_corr_candidates)
MESH_ARCH = dict(transformer_architecture=("self", "cross"), enc_blocks=(1, 1, 1, 1))
MESH_CFG = dict(geo_embedding_storage="fp32", num_gt_coarse_corr=64, buckets=(256,),
                **MESH_ARCH)
MESH_PAIRS = ((41, 240, 200), (46, 190, 236))  # seed, source and target points
# the compile is the cost: with LLVM's optimisations and XLA's fusion
# emitters off it is about a fifth shorter (tests/test_torch_bf16.py)
COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True,
           "xla_cpu_use_fusion_emitters": False, "xla_cpu_parallel_codegen_split_count": 1}


def _jax_mesh_step(arrays):
    """JAX's train step over a dp_size 2 `data` mesh (the batch sharded,
    the state replicated) on `arrays`, with the port's seed-0 weights:
    (its metrics, its reduced gradient by the port's parameter names, the
    port's (name, size) of each parameter in order)."""
    import jax
    import jax.numpy as jnp
    import optax

    from roitr_torch.utils.convert import params_to_state_dict
    from roitr_tpu.data.synthetic import stack_pairs
    from roitr_tpu.models.roitr import RoITr as JaxRoITr
    from roitr_tpu.parallel import (
        TrainState,
        batch_sharding,
        make_mesh,
        make_train_step,
        replicated,
        shard_batch,
    )

    _, model, jcfg, params = port_and_params(0, **MESH_CFG)
    zeros = lambda tree: jax.tree_util.tree_map(jnp.zeros_like, tree)  # noqa: E731
    # updates nothing; its state is the gradient the step hands it
    keep = optax.GradientTransformation(zeros, lambda g, state, params=None: (zeros(g), g))
    step = make_train_step(jcfg, JaxRoITr(jcfg), keep)
    mesh = make_mesh(2)
    rep, sharded = replicated(mesh), batch_sharding(mesh)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=keep.init(params))
    batch = stack_pairs([jax_pair(a) for a in arrays])
    key = jax.random.PRNGKey(0)
    compiled = jax.jit(step, in_shardings=(rep, sharded, rep), out_shardings=(rep, rep)).lower(
        state, batch, key).compile(compiler_options=COMPILE)
    new, metrics = compiled(jax.device_put(state, rep), shard_batch(mesh, batch), key)
    grads = params_to_state_dict(jax.tree_util.tree_map(np.asarray, new.opt_state), **MESH_ARCH)
    return ({k: float(v) for k, v in metrics.items()},
            {k: np.asarray(v) for k, v in grads.items()},
            [(k, p.numel()) for k, p in model.named_parameters()])


def _dump(base, name, i):
    return os.path.join(base, "snapshot", name, "3DMatch", f"{i}.pth")


@pytest.fixture(scope="module")
def ddp(tmp_path_factory):
    """The one-process references, then the spawned group's results."""
    base = str(tmp_path_factory.mktemp("ddp"))
    cfg = Config(**DDP_CFG)
    pairs = [SyntheticPairs(3, 256, seed=10, normal_knn=9)[i] for i in range(3)]
    from roitr_torch.data.loader import dict_to_pair

    model = RoITr(cfg, device="cpu", seed=cfg.seed)
    opt = make_optimizer(cfg, model, steps_per_epoch=4)
    states = []
    model.register_forward_pre_hook(
        lambda m, args, kw: states.append(kw["generator"].get_state().numpy().copy()),
        with_kwargs=True)
    gen = torch.Generator().manual_seed(7)
    ref_metrics = train_step(model, opt, [dict_to_pair(p) for p in pairs[:2]], gen)
    ref = [flat_params(model)]
    train_step(model, opt, dict_to_pair(pairs[2]), gen)
    ref.append(flat_params(model))

    mesh_pairs = [pair_arrays(seed, 256, n, m) for seed, n, m in MESH_PAIRS]
    cwd = os.getcwd()
    with ThreadPoolExecutor(1) as pool:
        jax_mesh = pool.submit(_jax_mesh_step, mesh_pairs)
        try:
            results = spawn(ddp_checks, 2, "gloo",
                            args=(base, DDP_CFG, pairs, [[states[0], states[2]], [states[1]]],
                                  {**TINY, **MESH_CFG}, mesh_pairs),
                            timeout_s=400)
            for name, kw in (("world1", {}), ("packed1", TESTERS["packed2"])):
                write_tester_dumps(config_for_tester(DDP_CFG, name, **kw), base)
        finally:
            os.chdir(cwd)
        mesh = jax_mesh.result()
    return dict(base=base, ref=ref, ref_metrics=ref_metrics, ranks=results, jax_mesh=mesh)


def test_dp_size_must_equal_the_world(ddp):
    for r in ddp["ranks"]:
        assert r["device"] == "cpu"
        assert "dp_size=3 but the process group has 2 ranks" in r["dp_mismatch"]


def test_one_step_one_pair_a_rank_matches_one_process(ddp):
    r0, r1 = ddp["ranks"]
    assert r0["digests"][0] == r1["digests"][0]
    np.testing.assert_allclose(r0["flats"][0], ddp["ref"][0], rtol=0, atol=1e-7)
    for r in (r0, r1):
        m = r["metrics"][0]
        assert m["pairs"] == 2 and m["grads_finite"] == 1.0 and m["loss"] > 0
        for k, v in ddp["ref_metrics"].items():
            assert m[k] == pytest.approx(v, rel=1e-6, abs=1e-7), k


def test_one_step_one_pair_a_rank_matches_jax_mesh_step(ddp):
    jmetrics, jgrads, names = ddp["jax_mesh"]
    r0, r1 = (r["mesh"] for r in ddp["ranks"])
    assert r0["grad_digest"] == r1["grad_digest"] and r0["metrics"] == r1["metrics"]
    m = r0["metrics"]
    assert m["pairs"] == 2 and m["grads_finite"] == jmetrics["grads_finite"] == 1.0
    for k in ("loss", "c_loss", "f_loss", "o_loss"):
        np.testing.assert_allclose(m[k], jmetrics[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert m["c_loss"] > 0 and m["PIR"] == pytest.approx(jmetrics["PIR"], abs=1e-7)
    assert abs(m["IR"] - jmetrics["IR"]) <= 0.02
    sizes = [n for _, n in names]
    got = dict(zip([k for k, _ in names], np.split(r0["grad"], np.cumsum(sizes)[:-1])))
    assert set(got) <= set(jgrads)
    for k, g in got.items():
        np.testing.assert_allclose(g, jgrads[k].ravel(), rtol=1e-3, atol=1e-5, err_msg=k)
    g = r0["grad"].astype(np.float64)
    w = np.concatenate([jgrads[k].ravel() for k in got]).astype(np.float64)
    assert np.linalg.norm(w) > 0
    assert np.dot(g, w) / (np.linalg.norm(g) * np.linalg.norm(w)) >= 0.9999


def test_train_step_timings_in_a_process_group(ddp):
    for r in ddp["ranks"]:
        t = r["mesh"]["timings"]
        assert set(t) == {"forward_ms", "backward_ms", "allreduce_ms", "optimizer_ms"}
        assert all(v >= 0.0 for v in t.values())


def test_uneven_ranks_step_together_and_weigh_by_pairs(ddp):
    r0, r1 = ddp["ranks"]
    assert len(r0["metrics"]) == len(r1["metrics"]) == 2
    assert r0["digests"][1] == r1["digests"][1]
    assert r0["metrics"][1]["pairs"] == r1["metrics"][1]["pairs"] == 1
    np.testing.assert_allclose(r0["flats"][1], ddp["ref"][1], rtol=0, atol=1e-7)


def test_a_non_finite_loss_skips_the_update_on_every_rank(ddp):
    for r in ddp["ranks"]:
        nan = r["nan"]
        assert nan["unchanged"] and nan["updates"] == 1
        assert nan["metrics"]["grads_finite"] == 0.0 and not np.isfinite(nan["metrics"]["loss"])


def test_trainer_at_world_two(ddp):
    t0, t1 = (r["trainer"] for r in ddp["ranks"])
    assert t0["digest"] == t1["digest"] and t0["steps"] == t1["steps"] == 2
    assert t0["best"] == t1["best"]
    # one-process validation of the same three pairs with the trained weights
    cfg = Config(**DDP_CFG)
    model = RoITr(cfg, device="cpu", seed=0)
    torch.nn.utils.vector_to_parameters(torch.from_numpy(t0["flat"]), model.parameters())
    from roitr_torch.data.loader import dict_to_pair

    val = SyntheticPairs(3, 256, seed=50, normal_knn=9)
    per_pair = [eval_step(model, dict_to_pair(val[i])) for i in range(3)]
    for k, v in t0["best"].items():
        assert v == pytest.approx(np.mean([m[k] for m in per_pair]), rel=1e-6, abs=1e-7), k
    names = ["model_0.pth"] + [f"model_best_{k}.pth" for k in
                               ("loss", "c_loss", "f_loss", "o_loss", "PIR", "IR")]
    assert t0["ckpts"] == t1["ckpts"] == sorted(names)
    assert sorted(t0["saves"]) == sorted(names) and t1["saves"] == []
    assert t0["logger"] and not t1["logger"]
    lr = Config(**DDP_CFG).lr
    assert t0["lr"] == t1["lr"] == (lr, pytest.approx(lr * 0.5, rel=1e-12))
    for t in (t0, t1):
        assert t["resumed_equal"] and t["resumed_start"] == 1 and t["resumed_steps"] == 4
    assert t0["resumed_digest"] == t1["resumed_digest"]


def test_tester_at_world_two_dumps_world_one_s_bytes(ddp):
    for i in range(4):
        with open(_dump(ddp["base"], "world2", i), "rb") as a, \
                open(_dump(ddp["base"], "world1", i), "rb") as b:
            assert a.read() == b.read(), i


def test_packed_tester_at_world_two(ddp):
    """Rank r packs pairs r and r + 2; world 1 packs 0 with 1 and 2 with 3."""
    corr = ("src_corr_pts", "tgt_corr_pts", "confidence")
    for i in range(4):
        got, want = (torch.load(_dump(ddp["base"], name, i), weights_only=False)
                     for name in ("packed2", "packed1"))
        assert set(got) == set(want), i
        for key, w in want.items():
            assert got[key].dtype == w.dtype, (i, key)
            if key not in corr:
                torch.testing.assert_close(got[key], w, rtol=1e-4, atol=1e-5, msg=f"{i} {key}")
        same_correspondences(*((d[k].numpy() for k in corr) for d in (got, want)), f"pair {i}")


def test_dp_size_without_a_process_group_raises(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = Config(**DDP_CFG, dp_size=2)
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node=2"):
        Trainer(cfg, SyntheticPairs(1, 128), SyntheticPairs(1, 128), device="cpu")
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node=2"):
        PortTester(cfg.replace(mode="test"), dataset=SyntheticPairs(1, 128), device="cpu",
               state_dict={})


def _items():
    """Seven tagged items in two buckets (128 and 256), with host pyramids."""
    items = []
    for i, bucket in enumerate((256, 128, 256, 256, 128, 256, 128)):
        a = pair_arrays(60 + i, bucket, bucket - 20 - i, bucket - 30 - i)
        a["src_points"][0, 0] = i * 1e-6
        a["src_pyramid"] = build_cloud_pyramid(a["src_raw_points"], int(a["src_count"]))
        a["tgt_pyramid"] = build_cloud_pyramid(a["tgt_points"], int(a["tgt_count"]))
        items.append(a)
    return items


def _ids(points):
    return [int(round(float(p[0, 0]) * 1e6)) for p in points]


@pytest.mark.parametrize("pack", [0, 2])
def test_loader_strides_as_jax(pack):
    """Each of two processes' shuffled batches of 2, cut at 3 pairs, hold
    JAX's pairs in JAX's order (JAX repeats a tail's pair to fill a batch;
    the port emits it once), and the two strides cover the epoch's first
    pairs once."""
    items = _items()
    seen = []
    for rank in (0, 1):
        kw = dict(shuffle=True, seed=5, pack=pack, max_items=3, process_index=rank,
                  process_count=2)
        got = list(iterate_batches(items, 2, **kw))
        want = list(jax_iterate_batches(items, 2, **kw))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if pack:
                b = int(g.src_count.shape[0])
                g_ids = _ids(g.src_points.reshape(b, -1, 3).numpy())
                w_ids = _ids(np.asarray(w.src_points)[0].reshape(2, -1, 3))
            else:
                g_ids = _ids([p.src_points.numpy() for p in (g if isinstance(g, list) else [g])])
                w_ids = _ids(np.asarray(w.src_points))
            assert w_ids == (g_ids if len(g_ids) == 2 else g_ids * 2)
            seen += g_ids
    order = np.arange(len(items))
    np.random.RandomState(5).shuffle(order)
    assert sorted(seen) == sorted(order[:6].tolist())
