"""The frozen reference against the program (roitr_torch) on the CPU, where
the program runs its kernels' plain versions: a request and a training
update, at a 1024 bucket, judged by the benchmark's own comparison."""

import pytest
import torch

from portbench import judge, pools
from portbench.reference import ops, pipeline
from portbench.tests.helpers import context
from portbench.weights import make_state_dict


@pytest.mark.parametrize("cell", ["3dmatch.match", "4dmatch.train"])
def test_request_matches_program(cell):
    from roitr_torch.serving import Matcher

    ctx = context(cell)
    state = make_state_dict(ctx.ref_cfg, ctx.seed, "cpu")
    traffic = dict(ctx.traffic, overlap=0.7)
    src, tgt = pools.request_pool(ctx.seed, dict(traffic, pool=2))[0]
    prog = Matcher(ctx.port_cfg, state, device="cpu", descriptors=True, prep="device").match(src, tgt)
    ref = pipeline.match(pipeline.build(ctx.ref_cfg, state, "cpu"), ctx.ref_cfg, src, tgt, "cpu")
    numbers = judge.match_numbers([prog], [ref])
    assert numbers["node_mismatch"] == 0.0
    assert numbers["desc_err"] < 1e-5
    assert numbers["corr_mismatch"] < 0.02
    assert numbers["conf_err"] < 1e-5


@pytest.mark.parametrize("cell", ["3dmatch.train", "4dmatch.train"])
def test_training_update_matches_program(cell):
    from roitr_torch.data.loader import dict_to_pair
    from roitr_torch.data.preprocess import estimate_normals_np, normal_redirect_np
    from roitr_torch.models.roitr import RoITr
    from roitr_torch.parallel.train_step import make_optimizer, train_step

    ctx = context(cell)
    cfg = ctx.port_cfg
    state = make_state_dict(ctx.ref_cfg, ctx.seed, "cpu")
    prog_items = pools.train_items(ctx.seed, ctx.traffic, cfg.buckets, lambda p: normal_redirect_np(
        p, estimate_normals_np(p, cfg.normal_knn), (0.0, 0.0, 0.0)))
    ref_items = pools.train_items(ctx.seed, ctx.traffic, cfg.buckets,
                                  lambda p: ops.estimate_normals_host(p, cfg.normal_knn))
    n = max(cfg.iter_size, 1)
    model = RoITr(cfg, device="cpu")
    model.load_state_dict(state)
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    opt = make_optimizer(cfg, model, steps_per_epoch=cfg.training_max_iter)
    gen = torch.Generator().manual_seed(7)
    losses = [train_step(model, opt, dict_to_pair(prog_items[i]), gen)["loss"] for i in range(n)]
    grads = {k: float(torch.linalg.norm(opt.inner.state[p]["exp_avg"] / (1.0 - 0.9)))
             for k, p in params.items()}
    deltas = {k: float(torch.linalg.norm(p.detach() - start[k])) for k, p in params.items()}
    ref = pipeline.follow_training(pipeline.build(ctx.ref_cfg, state, "cpu"), ctx.ref_cfg,
                                   ref_items[:n], torch.Generator().manual_seed(7), 1, "cpu")
    numbers = judge.train_numbers({"losses": losses, "grad_norms": grads, "delta_norms": deltas},
                                  ref)
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad_gap"] < 1e-4
    assert numbers["delta_gap"] < 1e-2
