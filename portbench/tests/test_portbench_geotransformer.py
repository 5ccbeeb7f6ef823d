"""The GeoTransformer cell's benchmark files: imports that hold neither the
program nor JAX, a program without a `model` field refused at set-up, the
work counts on hand-computed cases, and the comparison reading nothing
when the program's outputs are the reference's own."""

import dataclasses
import subprocess
import sys
import types

import numpy as np
import pytest

from portbench import geotransformer_work as work
from portbench.harness import ROOT
from portbench.tests.helpers import SEED, context


def test_imports_load_neither_the_program_nor_jax():
    code = ("import sys\n"
            "import portbench.models.geotransformer, portbench.drivers.geo_match\n"
            "import portbench.geotransformer_work, portbench.reference.geotransformer\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules}\n"
            "             & {'roitr_torch', 'roitr_tpu', 'jax', 'jaxlib', 'flax'})\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-S", "-c", code], cwd=ROOT, capture_output=True,
                         text=True, env={"PYTHONPATH": f"{ROOT}:{':'.join(sys.path[1:])}"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_program_config_refuses_a_config_without_model(monkeypatch):
    import roitr_torch.config

    from portbench.models import geotransformer

    @dataclasses.dataclass(frozen=True)
    class OldConfig:
        num_heads: int = 4

    values = {"num_heads": 4, "voxel_size": 0.025}
    assert geotransformer.program_config(values).model == "geotransformer"
    monkeypatch.setattr(roitr_torch.config, "Config", OldConfig)
    with pytest.raises(RuntimeError, match="no `model` field"):
        geotransformer.program_config(values)


def test_work_on_a_two_stage_case():
    cfg = types.SimpleNamespace(voxel_size=0.025, num_stages=2, base_radius=2.5,
                                neighbor_limits=[38, 1])
    ref = np.array([[0.0, 0.0, 0.0], [0.01, 0.0, 0.0], [1.0, 1.0, 1.0]], np.float32)
    src = np.array([[0.0, 0.02, 0.0], [0.5, 0.5, 0.5]], np.float32)
    pyr = work.pair_pyramid(cfg, ref, src)
    # stage 2 (0.05 m voxels): the reference's first two points share one
    assert pyr["lengths"] == [(3, 2), (2, 2)]
    # stage 1 at 0.0625 m: points 0 and 1 see each other and themselves, the
    # rest themselves; stage 2 at 0.125 m with limit 1: each node itself;
    # stage 2 nodes in stage 1: the first reference node sees 2, the rest 1
    assert pyr["neighbors"] == [2 + 2 + 1 + 1 + 1, 4] and pyr["subsampling"] == [2 + 1 + 1 + 1]
    assert pyr["upsampling"] == {}
    # every query against every key of its cloud, 3 products each, x2 flops
    assert work.search_flops(pyr, 2) == 6 * (3 * 3 + 2 * 2) + 6 * (2 * 2 + 2 * 2) + 6 * (
        2 * 3 + 2 * 2)
    # KPConv: 15 kernel points x 5 entries x 4 wide, then 3 queries x 15 x 4 x 8
    assert work._kpconv(3, 5, 15, 4, 8) == 2.0 * 15 * 5 * 4 + 2.0 * 3 * 15 * 4 * 8
    # the RPE attention's hidden states at n 2, d 4, h 2: the fp32 embedding, q, k,
    # v, q W_p and the mask in, (n, d) out; q.k, (q W_p).e, A v; one softmax
    assert work.rpe_hidden_work(2, 4, 2) == {"bytes": 64 + (24 + 16 + 2) * 4 + 32,
                                             "products": 2.0 * (2 * 16 + 32),
                                             "other": 32.0}


def test_reference_numbers_read_nothing_against_the_reference_itself():
    from portbench import models, pools
    from portbench.drivers import geo_match
    from portbench.reference import geotransformer as reference

    ctx = context("geotransformer_3dmatch.match", SEED)
    model = ctx.model.build_reference(ctx.ref_cfg, models.weights(ctx), "cpu")
    pool = pools.request_pool(ctx.seed, ctx.traffic)
    sample = pools.check_sample(ctx.seed, list(range(len(pool))), pool, ctx.traffic["check"])
    outputs = [reference.match(model, ctx.ref_cfg, *pool[i], "cpu") for i in sample]
    numbers = geo_match.reference_numbers(ctx, {"sample": sample, "outputs": outputs}, model,
                                          "cpu")
    assert numbers == {"node_mismatch": 0.0, "desc_err": 0.0, "corr_mismatch": 0.0,
                       "conf_err": 0.0, "lgr_gap": 0.0, "requests_checked": 2.0}
    moved = dict(outputs[0], transform=np.eye(4, dtype=np.float32))
    assert geo_match.geo_numbers([moved], outputs[:1], 0.1)["lgr_gap"] > 0.5
