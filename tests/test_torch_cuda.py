"""Each CUDA kernel of the port against its plain PyTorch version on the
card, at small and odd shapes and at the training shapes, plus a small
forward, a Matcher call and one train step on the card. Needs a CUDA card;
skips without one (the decision is taken in a fixture, never at import).
On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: the tests' conftest imports JAX, which the port's card
machine does not need to have.)

Tolerances, each against the plain version on the same card and inputs:
FPS indices exactly; fp32 outputs within 1e-4 of the largest reference
value (the kernels sum in another order than the library); bf16 outputs
within one bf16 step at that value; Sinkhorn within 1e-4 on valid entries.
The backward kernels: fp32 gradients within 1e-4 of the largest reference
value, bf16 embedding gradients within one bf16 step; Sinkhorn's under a
cotangent on valid entries, its ds within 1e-4 and its dmu / dnu (the
marginals' cotangents, summed over every reverse step) within 1e-3 of the
largest value: against a float64 loop at (128, 65, 65) x 100 the fp32
plain loop itself is about 1e-4 off there, and so is the kernel
(`chip_smoke.py` prints both); the geometric embedding's
backward is given the plain version's own argmax map, whose mismatches
with the kernel's map are counted apart (near-ties within rounding).
"""

import numpy as np
import pytest
import torch

from roitr_torch import kernels
from roitr_torch.kernels.fps_kernel import fps_pairs, fps_plain
from roitr_torch.kernels.geo_embedding_kernel import (
    fused_geo_embedding,
    geo_embedding_bwd,
    geo_embedding_bwd_plain,
    geo_embedding_plain,
)
from roitr_torch.kernels.rpe_attention_kernel import (
    fused_rpe_self_attention,
    rpe_attention_bwd,
    rpe_attention_bwd_onepass_plain,
    rpe_attention_bwd_plain,
    rpe_attention_plain,
)
from roitr_torch.kernels.sinkhorn_kernel import (
    sinkhorn_bwd,
    sinkhorn_bwd_plain,
    sinkhorn_iterate,
    sinkhorn_plain,
)
from roitr_torch.ops.sinkhorn import sinkhorn_inputs

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _launched(name, fn):
    """fn() on the card; asserts it launched kernel `name` exactly once."""
    before = kernels.launch_counts[name]
    out = fn()
    torch.cuda.synchronize()
    assert kernels.launch_counts[name] == before + 1, name
    return out


def _close(got, ref, frac=1e-4):
    err = float((got.float() - ref.float()).abs().max())
    top = float(ref.float().abs().max())
    assert err <= frac * max(top, 1e-6), (err, top)


@pytest.mark.parametrize("n,counts,m", [
    (384, (384, 301), 96),          # both clouds short of the bucket
    (1000, (997, 3), 250),          # odd bucket; a cloud with fewer points than samples
    (20000, (20000, 15000), 512),   # many picks, each across the 8 blocks of a cloud
    (120000, (120000, 90000), 64),  # coordinates read from global memory
    (470000, (470000, 300000), 16), # running distances in the global scratch buffer
])
def test_fps_kernel_exact(dev, n, counts, m):
    rng = np.random.RandomState(n)
    pts = np.zeros((2, n, 3), np.float32)
    for b, c in enumerate(counts):
        pts[b, :c] = rng.rand(c, 3)
    p = torch.from_numpy(pts).to(dev)
    c = torch.tensor(counts, dtype=torch.int32, device=dev)
    got = _launched("fps", lambda: fps_pairs(p, c, m))
    assert torch.equal(got, fps_plain(p, c, m))


@pytest.mark.parametrize("r,k,hidden", [
    (300, 3, 64), (4096, 3, 256), (77, 1, 32), (130, 2, 256),
    (777, 3, 512),   # 4DMatch width (two column tiles), ragged rows
    (301, 3, 40),    # hidden / 2 = 20: a K-slice half past the frequencies
    (65, 2, 42),     # rows of 84 / 168 bytes: the epilogue's scalar stores
    (515, 1, 256),   # k = 1 at full width
])
def test_geo_embedding_kernel(dev, r, k, hidden):
    g = torch.Generator().manual_seed(r)
    d = (torch.rand(r, generator=g) * 20).to(dev)
    a = (torch.rand(r, k, generator=g) * 12).to(dev)
    a[::16] = a[::16, :1]  # tied rows: a padded neighbour repeats the first
    wd, wa = ((torch.randn(hidden, hidden, generator=g) / 8).to(dev) for _ in range(2))
    bd, ba = ((torch.randn(hidden, generator=g) / 8).to(dev) for _ in range(2))
    ref, ref_map = geo_embedding_plain(d, a, wd, bd, wa, ba, with_argmax=True)
    got = _launched("geo_embedding", lambda: fused_geo_embedding(d, a, wd, bd, wa, ba))
    _close(got, ref)
    got16 = _launched("geo_embedding", lambda: fused_geo_embedding(d, a, wd, bd, wa, ba,
                                                                  out_dtype=torch.bfloat16))
    assert got16.dtype == torch.bfloat16
    _close(got16, ref, frac=1 / 128)
    got, amap = _launched("geo_embedding", lambda: fused_geo_embedding(
        d, a, wd, bd, wa, ba, with_argmax=True))
    _close(got, ref)
    assert float((amap != ref_map).float().mean()) <= 1e-3
    assert torch.equal(amap[::16], ref_map[::16])  # ties: torch.argmax's first k exactly


@pytest.mark.parametrize("n,d,h,dtype,valid", [
    (24, 32, 4, torch.float32, 20),
    (64, 256, 4, torch.bfloat16, 64),
    (100, 64, 2, torch.bfloat16, 37),
    (40, 64, 8, torch.bfloat16, 33),     # the 8-head build
    (20, 64, 16, torch.float32, 18),     # the 16-head build
    (9, 32, 4, torch.float32, 1),    # one valid key: the positional softmax is empty for it
    (8, 32, 4, torch.float32, 0),    # no valid key: zeros
])
def test_rpe_attention_kernel(dev, n, d, h, dtype, valid):
    g = torch.Generator().manual_seed(n)
    q2, k2, v2 = (torch.randn(n, d, generator=g).to(dev) for _ in range(3))
    qwp = (torch.randn(n, h, d, generator=g) * 0.3).to(dev)
    embed = torch.randn(n, n, d, generator=g).to(dev, dtype)
    mask = (torch.arange(n) < valid).float().to(dev)
    ref_h, ref_ae = rpe_attention_plain(q2, k2, v2, qwp, embed, mask)
    hid, ae = _launched("rpe_attention",
                        lambda: fused_rpe_self_attention(q2, k2, v2, qwp, embed, mask))
    if valid == 0:
        assert not hid.any() and not ae.any()
    else:
        _close(hid, ref_h)
        _close(ae, ref_ae)


@pytest.mark.parametrize("p,m,n,iters", [(5, 11, 9, 20), (256, 64, 64, 100), (3, 1, 1, 10)])
def test_sinkhorn_kernel(dev, p, m, n, iters):
    g = torch.Generator().manual_seed(p)
    scores = torch.randn(p, m, n, generator=g).to(dev)
    rm = (torch.rand(p, m, generator=g) > 0.2).to(dev)
    cm = (torch.rand(p, n, generator=g) > 0.2).to(dev)
    rm[:, 0] = cm[:, 0] = True
    rm[-1] = False  # a fully masked patch slot stays finite
    padded, mu, nu, _ = sinkhorn_inputs(scores, rm, cm, torch.tensor(1.3, device=dev))
    ref = sinkhorn_plain(padded, mu, nu, iters)
    got = _launched("sinkhorn", lambda: sinkhorn_iterate(padded, mu, nu, iters))
    assert torch.isfinite(got).all()
    valid = ref > -1e5
    assert float((got - ref)[valid].abs().max()) <= 1e-4


@pytest.mark.parametrize("p,m,n,iters", [(5, 11, 9, 20), (128, 64, 64, 100), (3, 1, 1, 10)])
def test_sinkhorn_bwd_kernel(dev, p, m, n, iters):
    g = torch.Generator().manual_seed(p)
    scores = torch.randn(p, m, n, generator=g).to(dev)
    rm = (torch.rand(p, m, generator=g) > 0.2).to(dev)
    cm = (torch.rand(p, n, generator=g) > 0.2).to(dev)
    rm[:, 0] = cm[:, 0] = True
    rm[-1] = False
    padded, mu, nu, _ = sinkhorn_inputs(scores, rm, cm, torch.tensor(1.3, device=dev))
    cot = torch.randn(padded.shape, generator=g).to(dev) * (padded > -1e5)
    ref = sinkhorn_bwd_plain(padded, mu, nu, cot, iters)
    got = _launched("sinkhorn_bwd", lambda: sinkhorn_bwd(padded, mu, nu, cot, iters))
    for name, a, b in zip(("ds", "dmu", "dnu"), got, ref):
        assert torch.isfinite(a).all(), name
        _close(a, b, frac=1e-4 if name == "ds" else 1e-3)


@pytest.mark.parametrize("n,d,h,dtype,valid", [
    (24, 32, 4, torch.float32, 20),
    (21, 32, 4, torch.bfloat16, 21),
    (100, 64, 2, torch.bfloat16, 37),
    (40, 64, 8, torch.float32, 33),
    (20, 64, 16, torch.float32, 18),
    (9, 32, 4, torch.float32, 1),
    (512, 256, 4, torch.bfloat16, 480),   # the training shape
    (1024, 256, 4, torch.bfloat16, 1000),
    (777, 256, 4, torch.bfloat16, 777),   # ragged against the key tile
    (512, 512, 4, torch.bfloat16, 480),   # 4DMatch width: two warps a key
    (128, 256, 16, torch.bfloat16, 120),  # 16 heads at full width: four warps a key
    (64, 512, 16, torch.float32, 60),     # a key across the whole block
    (512, 256, 4, torch.bfloat16, 1),     # one valid key
])
def test_rpe_attention_bwd_kernel(dev, n, d, h, dtype, valid):
    g = torch.Generator().manual_seed(n + 1)
    q2, k2, v2, ghid = (torch.randn(n, d, generator=g).to(dev) for _ in range(4))
    qwp = (torch.randn(n, h, d, generator=g) * 0.3).to(dev)
    gae = torch.randn(n, h, d, generator=g).to(dev)
    embed = torch.randn(n, n, d, generator=g).to(dev, dtype)
    mask = (torch.arange(n) < valid).float().to(dev)
    args = (q2, k2, v2, qwp, embed, mask, ghid, gae)
    ref = rpe_attention_bwd_plain(*args)
    got = _launched("rpe_attention_bwd", lambda: rpe_attention_bwd(*args))
    for name, a, b in zip(("dq", "dk", "dv", "dqwp", "demb"), got, ref):
        assert a.dtype == b.dtype, name
        _close(a, b, frac=1 / 128 if a.dtype == torch.bfloat16 else 1e-4)


@pytest.mark.parametrize("n,d,h,dtype,valid", [
    (24, 32, 4, torch.float32, 20),
    (512, 256, 4, torch.bfloat16, 480),
    (9, 32, 4, torch.float32, 1),     # row 0's positional softmax is empty: +inf
    (20, 64, 16, torch.bfloat16, 18),
])
def test_rpe_attention_kernel_lse(dev, n, d, h, dtype, valid):
    """The forward's log-sum-exps against the plain ones (1e-4 of the
    largest finite value; +inf exactly where no key is kept); hidden and ae
    bit-equal with and without them."""
    g = torch.Generator().manual_seed(n + 3)
    q2, k2, v2 = (torch.randn(n, d, generator=g).to(dev) for _ in range(3))
    qwp = (torch.randn(n, h, d, generator=g) * 0.3).to(dev)
    embed = torch.randn(n, n, d, generator=g).to(dev, dtype)
    mask = (torch.arange(n) < valid).float().to(dev)
    args = (q2, k2, v2, qwp, embed, mask)
    got = _launched("rpe_attention", lambda: fused_rpe_self_attention(*args, with_lse=True))
    ref = rpe_attention_plain(*args, with_lse=True)
    for a, b in zip(got[2:], ref[2:]):
        assert torch.equal(torch.isposinf(a), torch.isposinf(b))
        fin = torch.isfinite(b)
        assert torch.isfinite(a[fin]).all()
        _close(a[fin], b[fin])
    plain_out = _launched("rpe_attention", lambda: fused_rpe_self_attention(*args))
    for a, b in zip(plain_out, got[:2]):
        assert torch.equal(a, b)


def test_rpe_attention_bwd_kernel_repeat_and_onepass(dev):
    """At the training shape: two launches give bit-equal gradients (no
    atomics), and the kernel agrees with its CPU emulation's algorithm
    (rpe_attention_bwd_onepass_plain) as with the two-pass plain version."""
    n, d, h = 512, 256, 4
    g = torch.Generator().manual_seed(11)
    q2, k2, v2, ghid = (torch.randn(n, d, generator=g).to(dev) for _ in range(4))
    qwp = (torch.randn(n, h, d, generator=g) * 0.3).to(dev)
    gae = torch.randn(n, h, d, generator=g).to(dev)
    embed = torch.randn(n, n, d, generator=g).to(dev, torch.bfloat16)
    mask = (torch.arange(n) < 470).float().to(dev)
    fwd = fused_rpe_self_attention(q2, k2, v2, qwp, embed, mask, with_lse=True)
    args = (q2, k2, v2, qwp, embed, mask, ghid, gae, *fwd)
    got = _launched("rpe_attention_bwd", lambda: rpe_attention_bwd(*args))
    again = _launched("rpe_attention_bwd", lambda: rpe_attention_bwd(*args))
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    emu = rpe_attention_bwd_onepass_plain(*args)
    for a, b in zip(got, emu):
        _close(a, b, frac=1 / 128 if a.dtype == torch.bfloat16 else 1e-4)


@pytest.mark.parametrize("r,k,hidden,gdtype", [
    (300, 3, 64, torch.float32), (4096, 3, 256, torch.bfloat16), (77, 1, 32, torch.float32),
    (130, 2, 256, torch.bfloat16), (262144, 3, 256, torch.bfloat16),
    (777, 3, 512, torch.float32),    # 4DMatch width: two column tiles, ragged rows
    (1000, 2, 512, torch.bfloat16),
    (301, 3, 40, torch.bfloat16),    # hidden / 2 = 20: a j-tile past the frequencies
    (65, 2, 42, torch.float32),      # rows of 84 / 168 bytes: no cp.async, scalar loads
    (515, 1, 256, torch.bfloat16),   # k = 1 at full width
])
def test_geo_embedding_bwd_kernel(dev, r, k, hidden, gdtype):
    g = torch.Generator().manual_seed(r + 7)
    d = (torch.rand(r, generator=g) * 20).to(dev)
    a = (torch.rand(r, k, generator=g) * 12).to(dev)
    a[::16] = a[::16, :1]  # tie rows: every k equal, the first must win
    wd, wa = ((torch.randn(hidden, hidden, generator=g) / 8).to(dev) for _ in range(2))
    bd, ba = ((torch.randn(hidden, generator=g) / 8).to(dev) for _ in range(2))
    cot = torch.randn(r, hidden, generator=g).to(dev, gdtype)
    out, amap = _launched("geo_embedding", lambda: fused_geo_embedding(
        d, a, wd, bd, wa, ba, out_dtype=gdtype, with_argmax=True))
    ref_out, ref_map = geo_embedding_plain(d, a, wd, bd, wa, ba, gdtype, with_argmax=True)
    _close(out, ref_out, frac=1 / 128 if gdtype == torch.bfloat16 else 1e-4)
    assert float((amap != ref_map).float().mean()) <= 1e-3
    assert (amap[::16] == 0).all()
    ref = geo_embedding_bwd_plain(d, a, ref_map, cot, hidden)
    got = _launched("geo_embedding_bwd", lambda: geo_embedding_bwd(d, a, ref_map, cot, hidden))
    for a_, b_ in zip(got, ref):
        _close(a_, b_)


@pytest.mark.parametrize("r,k,hidden,gdtype", [
    (20000, 3, 256, torch.bfloat16),  # 66 chunks in the chunk-ordered reduction
    (300, 127, 64, torch.float32),    # the largest k the int8 map holds
    (99, 5, 42, torch.bfloat16),
])
def test_geo_embedding_bwd_kernel_last_k_and_repeat(dev, r, k, hidden, gdtype):
    """A map that sends every element of some rows to the last k, and two
    launches that give bit-equal gradients (no atomics in the reduction)."""
    g = torch.Generator().manual_seed(r + k)
    d = (torch.rand(r, generator=g) * 20).to(dev)
    a = (torch.rand(r, k, generator=g) * 12).to(dev)
    amap = torch.randint(0, k, (r, hidden), generator=g).to(torch.int8)
    amap[::3] = k - 1
    amap = amap.to(dev)
    cot = torch.randn(r, hidden, generator=g).to(dev, gdtype)
    ref = geo_embedding_bwd_plain(d, a, amap, cot, hidden)
    got = _launched("geo_embedding_bwd", lambda: geo_embedding_bwd(d, a, amap, cot, hidden))
    for a_, b_ in zip(got, ref):
        _close(a_, b_)
    again = _launched("geo_embedding_bwd", lambda: geo_embedding_bwd(d, a, amap, cot, hidden))
    for a_, b_ in zip(got, again):
        assert torch.equal(a_, b_)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    before = dict(kernels.launch_counts)
    pts = torch.rand(2, 64, 3, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        fps_pairs(pts.transpose(0, 1).contiguous().transpose(0, 1), torch.tensor([64, 64]), 8)
    with pytest.raises(TypeError, match="dtype"):
        fps_pairs(pts.double(), torch.tensor([64, 64]), 8)
    with pytest.raises(ValueError, match="num_samples"):
        fps_pairs(pts, torch.tensor([64, 64]), 65)
    x = torch.rand(16, 32, device=dev)
    with pytest.raises(RuntimeError, match="rpe_attention kernel refused"):  # 3 heads, D 32
        fused_rpe_self_attention(x, x, x, torch.rand(16, 3, 32, device=dev),
                                 torch.rand(16, 16, 32, device=dev), torch.ones(16, device=dev))
    big = torch.zeros(1, 300, 300, device=dev)  # 360 KB: more than a block's shared memory
    with pytest.raises(RuntimeError, match="sinkhorn kernel refused"):
        sinkhorn_iterate(big, torch.zeros(1, 300, device=dev), torch.zeros(1, 300, device=dev), 1)
    with pytest.raises(RuntimeError, match="sinkhorn_bwd kernel refused"):  # 100 x (65+65) floats
        sinkhorn_bwd(torch.zeros(1, 65, 65, device=dev), torch.zeros(1, 65, device=dev),
                     torch.zeros(1, 65, device=dev), torch.zeros(1, 65, 65, device=dev), 1000)
    with pytest.raises(RuntimeError, match="rpe_attention_bwd kernel refused"):
        rpe_attention_bwd(x, x, x, torch.rand(16, 3, 32, device=dev),
                          torch.rand(16, 16, 32, device=dev), torch.ones(16, device=dev), x,
                          torch.rand(16, 3, 32, device=dev))
    w, b = torch.rand(32, 32, device=dev), torch.rand(32, device=dev)
    with pytest.raises(RuntimeError, match="geo_embedding kernel refused"):  # k > 127: int8 map
        fused_geo_embedding(torch.rand(4, device=dev), torch.rand(4, 128, device=dev), w, b, w, b)
    with pytest.raises(TypeError, match="dtype"):
        geo_embedding_bwd(torch.rand(8, device=dev), torch.rand(8, 3, device=dev),
                          torch.zeros(8, 32, dtype=torch.int8, device=dev),
                          torch.rand(8, 32, device=dev).half(), 32)
    with pytest.raises(ValueError, match="even"):
        geo_embedding_bwd(torch.rand(8, device=dev), torch.rand(8, 3, device=dev),
                          torch.zeros(8, 33, dtype=torch.int8, device=dev),
                          torch.rand(8, 33, device=dev), 33)
    assert kernels.launch_counts == before
    # a refusal leaves no error behind for the next launch
    small = torch.zeros(1, 5, 5, device=dev)
    _launched("sinkhorn", lambda: sinkhorn_iterate(small, torch.zeros(1, 5, device=dev),
                                                   torch.zeros(1, 5, device=dev), 1))


def _tiny_cfg():
    from roitr_torch.config import Config

    return Config(benchmark="3DMatch", num_est_coarse_corr=16, point_per_patch=16,
                  sinkhorn_iters=20, buckets=(256, 512), points_limit=512)


def test_forward_on_card_matches_cpu(dev):
    """Same seeded weights and pair on the card (kernels) and on the CPU
    (plain versions), bf16 embedding storage: FPS nodes exactly, node
    descriptors cos >= 0.999, point descriptors cos >= 0.999 on 99%."""
    from torch_parity import pair_arrays, torch_pair
    from roitr_torch.models.roitr import RoITr

    cfg = _tiny_cfg()
    arr = pair_arrays(5, bucket=512, n_valid=480, m_valid=400)
    kernels.reset_launch_counts()
    with torch.no_grad():
        og = RoITr(cfg, device=dev, seed=0)(torch_pair(arr, dev))
        torch.cuda.synchronize()
        assert all(kernels.launch_counts[k] > 0 for k in kernels.FORWARD_KERNELS), \
            kernels.launch_counts
        oc = RoITr(cfg, device="cpu", seed=0)(torch_pair(arr))
    og = {k: v.cpu() for k, v in og.items()}
    for key in ("src_nodes", "tgt_nodes", "src_node_count", "tgt_node_count"):
        assert torch.equal(og[key], oc[key]), key
    cos = torch.nn.functional.cosine_similarity
    for side, count in (("src", 480), ("tgt", 400)):
        nc = int(oc[f"{side}_node_count"])
        node_cos = cos(og[f"{side}_node_feats"][:nc], oc[f"{side}_node_feats"][:nc])
        assert float(node_cos.min()) >= 0.999
        pc = cos(og[f"{side}_point_feats"][:count], oc[f"{side}_point_feats"][:count])
        assert float((pc >= 0.999).float().mean()) >= 0.99
    for k, v in og.items():
        if v.is_floating_point():
            assert torch.isfinite(v).all(), k


def test_matcher_on_card(dev):
    from roitr_torch.data.synthetic import make_pair_arrays
    from roitr_torch.models.roitr import RoITr
    from roitr_torch.serving import Matcher

    cfg = _tiny_cfg()
    matcher = Matcher(cfg, RoITr(cfg, device="cpu", seed=1).state_dict(), descriptors=True)
    assert matcher.device.type == "cuda"
    arr = make_pair_arrays(np.random.RandomState(2), 700, 700, 450)
    kernels.reset_launch_counts()
    out = matcher.match(arr["src_points"], arr["tgt_points"][:450])
    assert all(kernels.launch_counts[k] > 0 for k in kernels.FORWARD_KERNELS), \
        kernels.launch_counts
    assert out["src_point_desc"].shape == (512, 256)  # capped at points_limit
    assert out["tgt_point_desc"].shape == (450, 256)
    for v in out.values():
        assert np.isfinite(v).all()


def test_train_step_on_card(dev):
    """One train step on the card: every kernel, the three backward kernels
    included, launches; loss and gradients finite; the parameters move."""
    from torch_parity import pair_arrays, torch_pair
    from roitr_torch.models.roitr import RoITr
    from roitr_torch.parallel.train_step import make_optimizer, train_step

    cfg = _tiny_cfg().replace(num_gt_coarse_corr=32)
    model = RoITr(cfg, device=dev, seed=0)
    opt = make_optimizer(cfg, model, steps_per_epoch=1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    kernels.reset_launch_counts()
    metrics = train_step(model, opt, torch_pair(pair_arrays(3, 512, 480, 400), dev),
                         torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    assert all(v > 0 for v in kernels.launch_counts.values()), kernels.launch_counts
    assert metrics["grads_finite"] == 1.0 and np.isfinite(metrics["loss"])
    assert any(not torch.equal(v, before[k]) for k, v in model.state_dict().items())


def _grad_step(model, pair):
    from roitr_torch.losses import overall_loss

    model.zero_grad(set_to_none=True)
    out = model(pair, train=True, with_gt=True, generator=torch.Generator().manual_seed(0))
    losses = overall_loss(model.cfg, out, pair.rot, pair.trans)
    losses["loss"].backward()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu().double()
             for k, p in model.named_parameters()}
    return {k: float(v.detach()) for k, v in losses.items()}, grads


@pytest.mark.parametrize("ppp,iters", [(128, 100), (64, 400)])
def test_train_step_beyond_the_sinkhorn_kernels(dev, ppp, iters):
    """Patches (point_per_patch 128) or trajectories (400 iterations) that
    the Sinkhorn backward kernel does not take: the train step runs the
    plain loop on the card, launches neither Sinkhorn kernel, every other
    kernel as before, and agrees with the CPU step (losses 1e-3 relative,
    gradients: cosine >= 0.9999 over all, each parameter within 1e-2 of
    max(|CPU|, 1e-3 of the largest), as chip_smoke.py holds the 4096 step)."""
    from torch_parity import pair_arrays, torch_pair
    from roitr_torch.models.roitr import RoITr
    from roitr_torch.ops.sinkhorn import kernel_takes

    cfg = _tiny_cfg().replace(num_gt_coarse_corr=32, point_per_patch=ppp, sinkhorn_iters=iters,
                              geo_embedding_storage="fp32")
    assert not kernel_takes(ppp + 1, ppp + 1, iters, differentiable=True)
    arr = pair_arrays(4, 512, 480, 400)
    kernels.reset_launch_counts()
    lg, gg = _grad_step(RoITr(cfg, device=dev, seed=0), torch_pair(arr, dev))
    torch.cuda.synchronize()
    launched = dict(kernels.launch_counts)
    assert launched["sinkhorn"] == launched["sinkhorn_bwd"] == 0, launched
    assert all(v > 0 for k, v in launched.items() if not k.startswith("sinkhorn")), launched
    lc, gc = _grad_step(RoITr(cfg, device="cpu", seed=0), torch_pair(arr))
    for k in lc:
        assert abs(lg[k] - lc[k]) <= 1e-3 * max(abs(lc[k]), 1e-6), (k, lg[k], lc[k])
    norms = {k: float(v.norm()) for k, v in gc.items()}
    floor = 1e-3 * max(norms.values())
    for k in gc:
        assert torch.isfinite(gg[k]).all(), k
        assert float((gg[k] - gc[k]).norm()) <= 1e-2 * max(norms[k], floor), k
    fg = torch.cat([v.flatten() for v in gg.values()])
    fc = torch.cat([v.flatten() for v in gc.values()])
    assert float(fg @ fc / (fg.norm() * fc.norm())) >= 0.9999


def test_model_layers_beyond_the_kernels_take_the_plain_path(dev):
    """17 heads, and 128 angle neighbours: the layers run the plain versions
    on the card (no launch). The attention layer agrees with the CPU,
    gradients included (1e-4 of the largest value; for the gradients, of
    the largest over all the layer's parameters, since some are zero up to
    rounding: the key bias's, by softmax invariance); the embedding off the
    diagonal (there the x^2 - 2xy + y^2 distance of a point to itself is
    rounding noise, whose square root differs between the two devices), and
    its weights' gradients are finite."""
    from roitr_torch.models.attention import GlobalRPESelfAttention
    from roitr_torch.models.embeddings import GeometricStructureEmbedding

    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.randn(40, 34).astype(np.float32))
    e = torch.from_numpy(rng.randn(40, 40, 34).astype(np.float32))
    pts = torch.from_numpy(rng.rand(130, 3).astype(np.float32))
    results = {}
    for device in (dev, torch.device("cpu")):
        torch.manual_seed(0)
        att = GlobalRPESelfAttention(34, 17).to(device)
        torch.manual_seed(1)
        geo = GeometricStructureEmbedding(8, angle_k=128).to(device)
        before = dict(kernels.launch_counts)
        hidden, pos = att(x.to(device), e.to(device))
        emb = geo(pts.to(device))
        (hidden.sum() + (pos ** 2).sum() + (emb ** 2).sum()).backward()
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert kernels.launch_counts == before
        off_diagonal = ~torch.eye(130, dtype=torch.bool, device=device)
        grads = torch.cat([p.grad.flatten() for p in att.parameters() if p.grad is not None])
        results[device.type] = [t.detach().cpu() for t in (hidden, pos, emb[off_diagonal],
                                                           grads)]
        assert all(torch.isfinite(p.grad).all() and p.grad.any() for p in geo.parameters())
    for a, b in zip(results["cuda"], results["cpu"]):
        _close(a, b)


# ---- the Sinkhorn line kernels (rows and columns of at most 65) and the
# general ones past them: the trajectory the forward writes under
# differentiation, and the backward that reads it

def _sinkhorn_patches(dev, p, m, n, seed):
    """Scores, masks with a fully masked last patch slot, and a cotangent on
    valid entries, as test_sinkhorn_bwd_kernel makes them."""
    g = torch.Generator().manual_seed(seed)
    scores = torch.randn(p, m, n, generator=g).to(dev)
    rm = (torch.rand(p, m, generator=g) > 0.2).to(dev)
    cm = (torch.rand(p, n, generator=g) > 0.2).to(dev)
    rm[:, 0] = cm[:, 0] = True
    rm[-1] = False
    padded, mu, nu, _ = sinkhorn_inputs(scores, rm, cm, torch.tensor(1.3, device=dev))
    cot = torch.randn(padded.shape, generator=g).to(dev) * (padded > -1e5)
    return padded, mu, nu, cot


@pytest.mark.parametrize("p,m,n,iters", [(5, 11, 9, 20), (128, 64, 64, 100), (3, 1, 1, 10),
                                         (4, 80, 70, 20), (3, 50, 100, 15)])
def test_sinkhorn_trajectory_and_the_backward_from_it(dev, p, m, n, iters):
    """The forward's output does not change when it also writes the
    trajectory, which agrees with `_trajectory` on valid rows and columns
    within 1e-4; the backward from it agrees with the plain version (ds
    1e-4, dmu / dnu 1e-3 of the largest value) and equals, bit for bit, the
    backward that writes its own trajectory first, and itself when run
    again. (4, 80, 70) and (3, 50, 100) have lines past 65: the general
    kernels, still on the card."""
    from roitr_torch.kernels.sinkhorn_kernel import _trajectory, line_kernel_takes

    padded, mu, nu, cot = _sinkhorn_patches(dev, p, m, n, p + m)
    assert line_kernel_takes(m + 1, n + 1) == (max(m, n) < 65)
    out = _launched("sinkhorn", lambda: sinkhorn_iterate(padded, mu, nu, iters))
    out2, traj_u, traj_v = _launched(
        "sinkhorn", lambda: sinkhorn_iterate(padded, mu, nu, iters, with_traj=True))
    assert torch.equal(out, out2)
    assert traj_u.shape == (p, iters, m + 1) and traj_v.shape == (p, iters, n + 1)
    rows, cols = mu > -1e5, nu > -1e5
    for t, (u, v) in enumerate(_trajectory(padded, mu, nu, iters)):
        assert float((traj_u[:, t] - u)[rows].abs().max()) <= 1e-4, t
        assert float((traj_v[:, t] - v)[cols].abs().max()) <= 1e-4, t
    ref = sinkhorn_bwd_plain(padded, mu, nu, cot, iters)
    got = _launched("sinkhorn_bwd",
                    lambda: sinkhorn_bwd(padded, mu, nu, cot, iters, traj=(traj_u, traj_v)))
    for name, a, b in zip(("ds", "dmu", "dnu"), got, ref):
        assert torch.isfinite(a).all(), name
        _close(a, b, frac=1e-4 if name == "ds" else 1e-3)
    made = _launched("sinkhorn_bwd", lambda: sinkhorn_bwd(padded, mu, nu, cot, iters))
    again = _launched("sinkhorn_bwd",
                      lambda: sinkhorn_bwd(padded, mu, nu, cot, iters, traj=(traj_u, traj_v)))
    for a, b, c in zip(got, made, again):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(out, _launched("sinkhorn", lambda: sinkhorn_iterate(padded, mu, nu, iters)))


def test_sinkhorn_function_hands_its_trajectory_to_the_backward(dev):
    """Under differentiation the OT runs one forward launch (writing the
    trajectory) and one backward launch (reading it), and its gradients
    agree with the plain loop's on the card (1e-4 of the largest value);
    under no_grad it runs one forward launch and keeps no graph."""
    from roitr_torch.kernels.sinkhorn_kernel import sinkhorn

    padded, mu, nu, cot = _sinkhorn_patches(dev, 16, 64, 64, 7)
    before = dict(kernels.launch_counts)
    s = padded.clone().requires_grad_(True)
    (sinkhorn(s, mu, nu, 100) * cot).sum().backward()
    torch.cuda.synchronize()
    assert kernels.launch_counts["sinkhorn"] == before["sinkhorn"] + 1
    assert kernels.launch_counts["sinkhorn_bwd"] == before["sinkhorn_bwd"] + 1
    ref = padded.clone().requires_grad_(True)
    (sinkhorn(ref, mu, nu, 100, kernel=False) * cot).sum().backward()
    _close(s.grad, ref.grad)
    with torch.no_grad():
        out = _launched("sinkhorn", lambda: sinkhorn(s, mu, nu, 100))
    assert out.grad_fn is None


def test_estimate_normals_on_card_matches_cpu(dev):
    """Device normals at the 32768 bucket (30000 valid points) on the card
    and on the CPU: the same exact kNN and closed-form PCA, so dot > 0.999
    on at least 99.9% of points (a neighbour at a near-tie distance may
    differ), unit length, and zero pad rows."""
    from roitr_torch.data.synthetic import make_surface_cloud
    from roitr_torch.ops.normals import estimate_normals

    pts = np.zeros((32768, 3), np.float32)
    pts[:30000] = make_surface_cloud(np.random.RandomState(3), 30000)
    got = estimate_normals(torch.from_numpy(pts).to(dev), torch.tensor(30000, device=dev))
    ref = estimate_normals(torch.from_numpy(pts), torch.tensor(30000))
    got = got.cpu()
    dots = (got[:30000] * ref[:30000]).sum(-1)
    assert float((dots > 0.999).double().mean()) >= 0.999, float(dots.min())
    assert torch.allclose(got[:30000].norm(dim=-1), torch.ones(30000), atol=1e-5)
    assert not got[30000:].any()


def test_tester_on_card_matches_cpu(dev, tmp_path, monkeypatch):
    """The Tester with device prep on one pair at the 4096 bucket, full
    width, on the card and on the CPU: geometry keys exactly, node
    descriptors cos >= 0.999, and the four forward kernels launched."""
    import os
    import pickle

    from roitr_torch.config import Config
    from roitr_torch.data.synthetic import make_pair_arrays
    from roitr_torch.eval.tester import Tester as PortTester
    from roitr_torch.models.roitr import RoITr

    monkeypatch.chdir(tmp_path)
    arr = make_pair_arrays(np.random.RandomState(8), 4096, 3900, 3600)
    os.makedirs("indoor/test/s")
    torch.save(torch.from_numpy(arr["src_points"][:3900].copy()), "indoor/test/s/cloud_bin_0.pth")
    torch.save(torch.from_numpy(arr["tgt_points"][:3600].copy()), "indoor/test/s/cloud_bin_1.pth")
    with open("test.pkl", "wb") as f:
        pickle.dump({"rot": [arr["rot"]], "trans": [arr["trans"]], "overlap": [0.5],
                     "src": ["test/s/cloud_bin_0.pth"], "tgt": ["test/s/cloud_bin_1.pth"]}, f)
    cfg = Config(benchmark="3DMatch", mode="test", root="indoor", test_info="test.pkl",
                 buckets=(4096,), device_prep=True, num_workers=0)
    state_dict = RoITr(cfg, device="cpu", seed=0).state_dict()
    kernels.reset_launch_counts()
    PortTester(cfg.replace(exp_dir="card"), state_dict=state_dict, device=dev).test()
    assert all(kernels.launch_counts[k] > 0 for k in kernels.FORWARD_KERNELS), \
        kernels.launch_counts
    PortTester(cfg.replace(exp_dir="cpu"), state_dict=state_dict, device="cpu").test()
    a = torch.load("snapshot/card/3DMatch/0.pth", weights_only=False)
    b = torch.load("snapshot/cpu/3DMatch/0.pth", weights_only=False)
    assert set(a) == set(b)
    for k in ("src_raw_pcd", "src_pcd", "tgt_pcd", "src_nodes", "tgt_nodes", "rot", "trans"):
        assert torch.equal(a[k], b[k]), k
    cos = torch.nn.functional.cosine_similarity
    for k in ("src_node_desc", "tgt_node_desc"):
        assert float(cos(a[k].double(), b[k].double(), dim=-1).min()) >= 0.999, k
    for v in a.values():
        assert torch.isfinite(v).all()


def test_matcher_device_prep_on_card(dev):
    """Matcher(prep="device") estimates the normals on the card, launches
    the forward kernels and returns finite output of the valid counts."""
    from roitr_torch.data.synthetic import make_pair_arrays
    from roitr_torch.models.roitr import RoITr
    from roitr_torch.serving import Matcher

    cfg = _tiny_cfg()
    matcher = Matcher(cfg, RoITr(cfg, device="cpu", seed=1).state_dict(), descriptors=True,
                      prep="device")
    arr = make_pair_arrays(np.random.RandomState(4), 512, 500, 430)
    kernels.reset_launch_counts()
    out = matcher.match(arr["src_points"][:500], arr["tgt_points"][:430])
    assert all(kernels.launch_counts[k] > 0 for k in kernels.FORWARD_KERNELS), \
        kernels.launch_counts
    assert out["src_point_desc"].shape == (500, 256)
    assert out["tgt_point_desc"].shape == (430, 256)
    for v in out.values():
        assert np.isfinite(v).all()


@pytest.mark.parametrize("b,n,d,h,dtype,valid", [
    (8, 16, 256, 4, torch.bfloat16, (16, 15, 12, 9, 16, 4, 1, 13)),  # coarse level of 1024
    (3, 40, 64, 8, torch.float32, (40, 0, 23)),  # a pair with no valid key
    (2, 100, 64, 2, torch.bfloat16, (100, 37)),
])
def test_rpe_attention_kernel_pair_axis(dev, b, n, d, h, dtype, valid):
    """One launch for B pairs: against the plain version with the pair
    axis, and bit-equal to B per-pair launches; the log-sum-exps too."""
    g = torch.Generator().manual_seed(b * n)
    q2, k2, v2 = (torch.randn(b, n, d, generator=g).to(dev) for _ in range(3))
    qwp = (torch.randn(b, n, h, d, generator=g) * 0.1).to(dev)
    embed = torch.randn(b, n, n, d, generator=g).to(dev, dtype)
    mask = (torch.arange(n)[None, :] < torch.tensor(valid)[:, None]).float().to(dev)
    args = (q2, k2, v2, qwp, embed, mask)
    got = _launched("rpe_attention", lambda: fused_rpe_self_attention(*args, with_lse=True))
    ref = rpe_attention_plain(*args, with_lse=True)
    for a, r in zip(got[:2], ref[:2]):
        _close(a, r)
    for a, r in zip(got[2:], ref[2:]):
        ok = torch.isfinite(r)
        assert torch.equal(torch.isfinite(a), ok)
        _close(a[ok], r[ok])
    for i in range(b):
        one = fused_rpe_self_attention(*(t[i] for t in args), with_lse=True)
        assert all(torch.equal(x[i], y) for x, y in zip(got, one)), i


def test_rpe_attention_kernel_batch_of_one_is_the_pair_entry(dev):
    """(1, N, D) inputs give bit for bit what the one-pair entry gives."""
    g = torch.Generator().manual_seed(3)
    n, d, h = 64, 256, 4
    q2, k2, v2 = (torch.randn(n, d, generator=g).to(dev) for _ in range(3))
    qwp = (torch.randn(n, h, d, generator=g) * 0.1).to(dev)
    embed = torch.randn(n, n, d, generator=g).to(dev, torch.bfloat16)
    mask = (torch.arange(n) < 50).float().to(dev)
    args = (q2, k2, v2, qwp, embed, mask)
    one = fused_rpe_self_attention(*args, with_lse=True)
    batched = fused_rpe_self_attention(*(t[None] for t in args), with_lse=True)
    assert all(torch.equal(x[0], y) for x, y in zip(batched, one))


def test_fps_kernel_two_b_clouds(dev):
    """The packed device prep's FPS: both sides of 8 pairs, 16 clouds of the
    1024 bucket with mixed counts, in one launch."""
    rng = np.random.RandomState(16)
    counts = rng.randint(600, 1025, size=16)
    pts = np.zeros((16, 1024, 3), np.float32)
    for i, c in enumerate(counts):
        pts[i, :c] = rng.rand(c, 3)
    p = torch.from_numpy(pts).to(dev)
    c = torch.from_numpy(counts.astype(np.int32)).to(dev)
    got = _launched("fps", lambda: fps_pairs(p, c, 256))
    assert torch.equal(got, fps_plain(p, c, 256))


@pytest.mark.parametrize("prep", ["host", "device"])
def test_match_batch_packed_on_card(dev, prep):
    """Matcher.match_batch, packed, 8 pairs of 600-1000 points in the 1024
    bucket on the card against match of each pair on the card: each forward
    kernel launched once a layer for the batch (no FPS under host pyramids).
    The packed forward against the single-pair forward: node descriptors
    within cos 0.9999, at most 5% of the coarse correspondences apart, and
    on the shared ones the OT scores within 1e-4. The packed forward's
    products (B * N rows) round apart from the single-pair forward's, and
    with random weights the OT plan is near uniform, so fine top-k picks at
    near-ties (~1e-7) go either way: each result's kept correspondences
    within 5% of their union plus point_per_patch * fine_matching_topk for
    each coarse correspondence the two forwards do not share. The 5% comes
    from tools/torch_packed_near_ties.py on an H100 80GB HBM3 (16 data
    seeds x 8 pairs, both preps): at most 2.9% apart, median 1.5%, no
    coarse correspondence apart, OT scores within 9.6e-6."""
    from roitr_torch.config import Config
    from roitr_torch.data.packing import pack_pairs
    from roitr_torch.data.synthetic import make_pair_arrays
    from roitr_torch.models.roitr import RoITr
    from roitr_torch.ops.pyramid import device_prep_packed, device_prep_pair
    from roitr_torch.serving import Matcher
    from roitr_torch.utils.packing import to_device

    cfg = Config(benchmark="3DMatch", buckets=(1024,), points_limit=1024,
                 host_pyramid=prep == "host", fine_matching_confidence_threshold=0.0)
    matcher = Matcher(cfg, RoITr(cfg, device="cpu", seed=1).state_dict(), prep=prep)
    rng = np.random.RandomState(9)
    clouds = []
    for _ in range(8):
        n, m = rng.randint(600, 1001, size=2)
        arr = make_pair_arrays(rng, 1024, n, m)
        clouds.append((arr["src_points"][:n], arr["tgt_points"][:m]))
    kernels.reset_launch_counts()
    got = matcher.match_batch(clouds, batch_size=8, mode="packed")
    want = {"fps": 3 if prep == "device" else 0, "geo_embedding": 2, "rpe_attention": 6,
            "sinkhorn": 1}
    assert {k: kernels.launch_counts[k] for k in want} == want, kernels.launch_counts

    est = (prep == "device",) * 2
    pairs = [matcher._prepare(src, tgt, None, None)[0] for src, tgt in clouds]
    # {(tgt node, src node): slot} of the kept coarse correspondences
    corr = lambda o: {(int(t), int(s)): j for j, (t, s, k) in enumerate(zip(
        o["tgt_node_corr_indices"], o["src_node_corr_indices"], o["node_corr_masks"])) if k}
    cos = torch.nn.functional.cosine_similarity
    with torch.no_grad():
        batch = to_device(pack_pairs(pairs, require_pyramids=prep == "host"), dev)
        packed = matcher.model(device_prep_packed(batch, cfg, est,
                                                  pyramid=batch.src_pyramid is None))
        flips, total = [], 0
        for i, pair in enumerate(pairs):
            one = matcher.model(device_prep_pair(to_device(pair, dev), cfg, est))
            mine = {k: v[i] for k, v in packed.items()}
            a, b = corr(mine), corr(one)
            flips.append(len(a.keys() ^ b.keys()))
            total += len(b)
            for key in a.keys() & b.keys():
                x, y = mine["matching_scores"][a[key]], one["matching_scores"][b[key]]
                err = torch.where(y > -1e5, (x - y).abs(), torch.zeros_like(y))
                assert float(err.max()) <= 1e-4, (i, key)
            for side in ("src", "tgt"):
                nc = int(one[f"{side}_node_count"])
                assert float(cos(mine[f"{side}_node_feats"][:nc],
                                 one[f"{side}_node_feats"][:nc]).min()) >= 0.9999
    assert sum(flips) <= 0.05 * total, flips
    per_flip = cfg.point_per_patch * cfg.fine_matching_topk
    for i, (src, tgt) in enumerate(clouds):
        ref = matcher.match(src, tgt)
        assert np.isfinite(got[i]["confidence"]).all()
        g, w = (set(map(tuple, np.concatenate([r["src_corr_pts"], r["tgt_corr_pts"]], 1)
                        .tolist())) for r in (got[i], ref))
        assert len(g ^ w) <= 0.05 * len(g | w) + flips[i] * per_flip, (i, len(g ^ w), flips)


@pytest.mark.parametrize("b,n,d,h,dtype,valid", [
    (8, 16, 256, 4, torch.bfloat16, (16, 15, 12, 9, 16, 4, 1, 13)),  # coarse level of 1024
    (8, 16, 256, 4, torch.float32, (16, 15, 12, 9, 16, 4, 1, 13)),
    (3, 64, 256, 4, torch.bfloat16, (64, 1, 37)),  # a pair with one valid key
    (3, 64, 64, 8, torch.float32, (64, 0, 23)),    # a pair with no valid key
    (2, 512, 256, 4, torch.bfloat16, (512, 430)),  # the 32768 bucket's coarse level
    (2, 512, 256, 4, torch.float32, (512, 430)),
])
def test_rpe_attention_bwd_kernel_pair_axis(dev, b, n, d, h, dtype, valid):
    """One launch of the backward for B pairs, given the forward's saved
    outputs as training gives them: against the plain backward with the pair
    axis (fp32 within 1e-4 of the largest value, a bf16 embedding gradient
    within one bf16 step), and bit-equal to B one-pair launches."""
    g = torch.Generator().manual_seed(b * n + d)
    q2, k2, v2, ghid = (torch.randn(b, n, d, generator=g).to(dev) for _ in range(4))
    qwp = (torch.randn(b, n, h, d, generator=g) * 0.3).to(dev)
    gae = torch.randn(b, n, h, d, generator=g).to(dev)
    embed = torch.randn(b, n, n, d, generator=g).to(dev, dtype)
    mask = (torch.arange(n)[None, :] < torch.tensor(valid)[:, None]).float().to(dev)
    args = (q2, k2, v2, qwp, embed, mask, ghid, gae)
    fwd = fused_rpe_self_attention(*args[:6], with_lse=True)
    got = _launched("rpe_attention_bwd", lambda: rpe_attention_bwd(*args, *fwd))
    ref = rpe_attention_bwd_plain(*args)
    for name, a, r in zip(("dq", "dk", "dv", "dqwp", "demb"), got, ref):
        assert a.dtype == r.dtype and a.shape == r.shape, name
        _close(a, r, frac=1 / 128 if a.dtype == torch.bfloat16 else 1e-4)
    for i in range(b):
        one = rpe_attention_bwd(*(t[i] for t in args), *(f[i] for f in fwd))
        assert all(torch.equal(x[i], y) for x, y in zip(got, one)), i


def test_rpe_attention_bwd_kernel_batch_of_one_is_the_pair_entry(dev):
    """(1, N, ...) inputs give bit for bit what the one-pair entry gives."""
    g = torch.Generator().manual_seed(5)
    n, d, h = 64, 256, 4
    q2, k2, v2, ghid = (torch.randn(n, d, generator=g).to(dev) for _ in range(4))
    qwp = (torch.randn(n, h, d, generator=g) * 0.1).to(dev)
    gae = torch.randn(n, h, d, generator=g).to(dev)
    embed = torch.randn(n, n, d, generator=g).to(dev, torch.bfloat16)
    mask = (torch.arange(n) < 50).float().to(dev)
    args = (q2, k2, v2, qwp, embed, mask, ghid, gae)
    one = rpe_attention_bwd(*args)
    batched = rpe_attention_bwd(*(t[None] for t in args))
    assert all(torch.equal(x[0], y) for x, y in zip(batched, one))


@pytest.mark.parametrize("b,n", [(8, 16), (2, 64)])
def test_geo_embedding_bwd_kernel_packed_rows(dev, b, n):
    """Row 7 at a packed batch's B * N^2 flat rows (the coarse level of the
    1024 bucket, B 8; and B 2 at N 64), bf16 cotangent as training gives it,
    the plain version's own map: within 1e-4 of the largest value, and two
    launches bit-equal. Its error against a float64 reduction stays within
    the 66-chunk case's 2.15e-05 of the largest value (ROADMAP Queue 3
    "Watch"): the chunk count follows R."""
    r, k, hidden = b * n * n, 3, 256
    g = torch.Generator().manual_seed(r)
    d = (torch.rand(r, generator=g) * 20).to(dev)
    a = (torch.rand(r, k, generator=g) * 12).to(dev)
    wd, wa = ((torch.randn(hidden, hidden, generator=g) / 8).to(dev) for _ in range(2))
    bd, ba = ((torch.randn(hidden, generator=g) / 8).to(dev) for _ in range(2))
    cot = torch.randn(r, hidden, generator=g).to(dev, torch.bfloat16)
    _, amap = geo_embedding_plain(d, a, wd, bd, wa, ba, torch.bfloat16, with_argmax=True)
    got = _launched("geo_embedding_bwd", lambda: geo_embedding_bwd(d, a, amap, cot, hidden))
    again = geo_embedding_bwd(d, a, amap, cot, hidden)
    ref = geo_embedding_bwd_plain(d, a, amap, cot, hidden)
    ref64 = geo_embedding_bwd_plain(d.double(), a.double(), amap, cot.double(), hidden)
    for x, y, z in zip(got, again, ref):
        _close(x, z)
        assert torch.equal(x, y)
    err64 = max(float((x.double() - w).abs().max()) for x, w in zip(got, ref64))
    assert err64 <= 2.15e-05 * max(float(w.abs().max()) for w in ref64)


def _packed_grad_step(model, pairs):
    """The packed forward of `pairs`, the mean of its per-pair losses and
    its backward: (per-pair losses, {name: gradient on the CPU})."""
    from roitr_torch.data.packing import pack_pairs
    from roitr_torch.losses import overall_loss

    model.zero_grad(set_to_none=True)
    packed = pack_pairs(pairs)
    out = model(packed, train=True, with_gt=True, generator=torch.Generator().manual_seed(0))
    losses = [overall_loss(model.cfg, {k: v[i] for k, v in out.items()}, packed.rot[i],
                           packed.trans[i]) for i in range(len(pairs))]
    torch.stack([ls["loss"] for ls in losses]).mean().backward()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu().double()
             for k, p in model.named_parameters()}
    return [{k: float(v.detach()) for k, v in ls.items()} for ls in losses], grads


@pytest.mark.parametrize("ppp,iters", [(16, 20), (64, 400)])
def test_packed_train_step_on_card_matches_cpu(dev, ppp, iters):
    """A packed train step of 3 pairs (512 bucket, host pyramids) on the
    card against the CPU's, same weights and Gumbel draws: each RPE
    attention layer's forward and backward launch once for the 3 pairs, the
    Sinkhorn kernels once for all patches (none at 400 iterations, past the
    backward kernel's envelope: the plain loop on the card); per-pair losses
    within 1e-3 relative, gradients as test_train_step_beyond_the_sinkhorn_kernels
    holds them."""
    from torch_parity import pair_arrays, torch_pair
    from roitr_torch.data.packing import attach_pyramids
    from roitr_torch.models.roitr import RoITr

    cfg = _tiny_cfg().replace(num_gt_coarse_corr=32, point_per_patch=ppp, sinkhorn_iters=iters,
                              geo_embedding_storage="fp32")
    arrs = [pair_arrays(7 + i, 512, n, m) for i, (n, m) in enumerate(((480, 400), (350, 512),
                                                                      (420, 300)))]
    pairs = lambda device: [attach_pyramids(torch_pair(a, device), cfg.enc_strides,  # noqa: E731
                                            cfg.enc_nsample) for a in arrs]
    card_pairs = pairs(dev)
    kernels.reset_launch_counts()
    lg, gg = _packed_grad_step(RoITr(cfg, device=dev, seed=0), card_pairs)
    torch.cuda.synchronize()
    launched = dict(kernels.launch_counts)
    layers = len(cfg.transformer_architecture)
    want = {"fps": 0, "geo_embedding": 2, "rpe_attention": layers, "rpe_attention_bwd": layers,
            "geo_embedding_bwd": 2, "sinkhorn": int(iters < 380),
            "sinkhorn_bwd": int(iters < 380)}
    assert launched == want, launched
    lc, gc = _packed_grad_step(RoITr(cfg, device="cpu", seed=0), pairs("cpu"))
    for i, (a, b) in enumerate(zip(lg, lc)):
        for k in b:
            assert abs(a[k] - b[k]) <= 1e-3 * max(abs(b[k]), 1e-6), (i, k, a[k], b[k])
    norms = {k: float(v.norm()) for k, v in gc.items()}
    floor = 1e-3 * max(norms.values())
    for k in gc:
        assert torch.isfinite(gg[k]).all(), k
        assert float((gg[k] - gc[k]).norm()) <= 1e-2 * max(norms[k], floor), k
    fg = torch.cat([v.flatten() for v in gg.values()])
    fc = torch.cat([v.flatten() for v in gc.values()])
    assert float(fg @ fc / (fg.norm() * fc.norm())) >= 0.9999
