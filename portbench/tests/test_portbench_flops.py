"""flops.py's products against torch's FlopCounterMode on the reference:
a request (normals and the forward) and a training step (forward with
ground truth, the losses, the backward) of clouds that fill a 1024 bucket,
so that the reference's padded shapes are the valid ones; and the
geometric transformer at node counts that differ between the clouds."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops, pools, roofline
from portbench.reference import model as ref_model
from portbench.reference import ops, pipeline
from portbench.tests.helpers import context
from portbench.weights import make_state_dict

FULL = [1024, 1024]  # clouds that fill the bucket: no padding


@pytest.mark.parametrize("cell", ["3dmatch.match", "4dmatch.train"])
def test_request_products(cell):
    ctx = context(cell)
    model = pipeline.build(ctx.ref_cfg, make_state_dict(ctx.ref_cfg, ctx.seed, "cpu"), "cpu")
    src, tgt = pools.request_pool(ctx.seed, dict(ctx.traffic, pool=2, points=FULL))[0]
    assert len(src) == len(tgt) == 1024
    with FlopCounterMode(display=False) as counter:
        pipeline.match(model, ctx.ref_cfg, src, tgt, "cpu")
    want = flops.request_flops(ctx.ref_cfg, (1024, 1024))
    assert counter.get_total_flops() == pytest.approx(want, rel=0.01)


@pytest.mark.parametrize("cell", ["3dmatch.train", "4dmatch.train"])
def test_train_step_products(cell):
    ctx = context(cell)
    model = pipeline.build(ctx.ref_cfg, make_state_dict(ctx.ref_cfg, ctx.seed, "cpu"), "cpu")
    item = pools.train_items(ctx.seed, dict(ctx.traffic, points=FULL), [1024],
                             lambda p: ops.estimate_normals_host(p, 33))[0]
    assert int(item["src_count"]) == int(item["tgt_count"]) == 1024
    pair = pipeline.train_inputs(item, "cpu")
    with FlopCounterMode(display=False) as counter:
        out = model(pair, train=True, with_gt=True, generator=torch.Generator().manual_seed(1))
        value = ref_model.loss(ctx.ref_cfg, out, pair["rot"], pair["trans"])
        torch.autograd.grad(value, [p for p in model.parameters()], allow_unused=True)
    want = flops.train_step_flops(ctx.ref_cfg, (1024, 1024))
    assert counter.get_total_flops() == pytest.approx(want, rel=0.02)


def test_valid_sizes_of_uneven_clouds():
    cfg = context("3dmatch.match").ref_cfg
    assert roofline.level_sizes(cfg, 20000) == [20000, 5000, 1250, 312]
    assert roofline.level_sizes(cfg, 30000) == [30000, 7500, 1875, 468]
    assert roofline.level_sizes(cfg, 3) == [3, 1, 1, 1]
    # the pair's order does not matter; padding to the bucket is no work
    assert flops.request_flops(cfg, (20000, 30000)) == flops.request_flops(cfg, (30000, 20000))
    assert flops.request_flops(cfg, (20000, 30000)) < flops.request_flops(cfg, (32768, 32768))


@pytest.mark.parametrize("cell", ["3dmatch.match", "4dmatch.train"])
def test_geometric_transformer_at_uneven_node_counts(cell):
    """The global transformer over 10 and 16 unpadded nodes, forward only:
    flops._global less its two coarse projections."""
    ctx = context(cell)
    cfg = ctx.ref_cfg
    d = 256 * cfg.factor
    torch.manual_seed(0)
    gt = ref_model.GeometricTransformer(d, cfg.num_heads, cfg.transformer_architecture)
    ns, nt = 10, 16
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        gt(torch.randn(ns, 3), torch.randn(nt, 3), torch.randn(ns, d), torch.randn(nt, d),
           torch.tensor(ns), torch.tensor(nt), torch.ones(ns, dtype=torch.bool),
           torch.ones(nt, dtype=torch.bool))
    want = sum(fl for fl, _ in flops._global(cfg, ns, nt)) - 2.0 * (ns + nt) * d * d
    assert counter.get_total_flops() == pytest.approx(want, rel=1e-6)
