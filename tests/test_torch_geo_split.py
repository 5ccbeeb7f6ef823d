"""Numerics of the geometric embedding kernel's tensor-core product, on the CPU.

csrc/geo_embedding.cu takes its products on bf16 tensor cores with each fp32
operand split into hi = bf16(x) and lo = bf16(x - hi), summing
hi.hi + hi.lo + lo.hi in fp32. `geo_embedding_split_plain` emulates that;
here it is held against a float64 reference at the card's check: within
1e-4 of the largest |ref|, and at most 1e-3 of the argmax map differing.
One bf16 product (no lo terms) misses that tolerance, which is why the
kernel takes three. Inputs as chip_smoke.py draws them: weights U(+-1/16),
a quarter of the rows with a repeated angle neighbour (a tie the map must
resolve to the first k).

The backward takes its products the same way, the basis split, the
cotangent split only when it is fp32 (a bf16 cotangent is exact in bf16):
`geo_embedding_bwd_split_plain` is held within 1e-4 of the largest |ref|
of a float64 reference for both cotangent dtypes, given the float64
forward's map; one product (the basis's hi part alone) misses that, which
is why the kernel takes two for a bf16 cotangent.
"""

import numpy as np
import pytest
import torch

from roitr_torch.kernels.geo_embedding_kernel import (
    geo_embedding_bwd_plain,
    geo_embedding_bwd_split_plain,
    geo_embedding_plain,
    geo_embedding_split_plain,
    sinusoidal_basis,
    split_bf16,
)

R, K, H = 4096, 3, 256


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(4)
    d = (rng.rand(R) * 40).astype(np.float32)
    a = (rng.rand(R, K) * 12).astype(np.float32)
    tied = rng.rand(R) < 0.25
    a[tied, 1] = a[tied, 0]  # a padded neighbour repeats an earlier one
    wd, wa = ((rng.rand(2, H, H) * 2 - 1) / 16).astype(np.float32)
    bd, ba = ((rng.rand(2, H) * 2 - 1) / 16).astype(np.float32)
    args = [torch.from_numpy(x) for x in (d, a, wd, bd, wa, ba)]
    ref, ref_map = geo_embedding_plain(*(t.double() for t in args), out_dtype=torch.float64,
                                       with_argmax=True)
    return args, torch.from_numpy(tied), ref, ref_map


def test_split_bf16_carries_sixteen_bits():
    x = torch.from_numpy(np.random.RandomState(0).randn(10000).astype(np.float32))
    hi, lo = split_bf16(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, x.to(torch.bfloat16))
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max()
    assert float(rel) <= 2.0 ** -16


def test_split_product_holds_the_fp32_tolerance(inputs):
    args, tied, ref, ref_map = inputs
    out, amap = geo_embedding_split_plain(*args, with_argmax=True)
    top = float(ref.abs().max())
    assert float((out.double() - ref).abs().max()) <= 1e-4 * top
    assert float((amap != ref_map).double().mean()) <= 1e-3
    assert not (amap[tied] == 1).any()  # the repeated neighbour never beats the first
    out16 = geo_embedding_split_plain(*args, out_dtype=torch.bfloat16)
    assert float((out16.double() - ref).abs().max()) <= top / 128


def test_one_bf16_product_misses_the_fp32_tolerance(inputs):
    args, _, ref, _ = inputs
    d, a, wd, bd, wa, ba = args
    bf = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    y = bf(sinusoidal_basis(d, H)) @ bf(wd) + bd
    ya = bf(sinusoidal_basis(a, H)) @ bf(wa)
    one = y + ya.amax(dim=-2) + ba
    assert float((one.double() - ref).abs().max()) > 1e-4 * float(ref.abs().max())


@pytest.fixture(scope="module")
def cotangent():
    return torch.from_numpy(np.random.RandomState(5).randn(R, H).astype(np.float32))


def _bwd_reference(inputs, g):
    args, _, _, ref_map = inputs
    d, a = args[:2]
    return geo_embedding_bwd_plain(d.double(), a.double(), ref_map, g.double(), H)


@pytest.mark.parametrize("gdtype", [torch.bfloat16, torch.float32])
def test_bwd_split_products_hold_the_fp32_tolerance(inputs, cotangent, gdtype):
    args, _, _, ref_map = inputs
    g = cotangent.to(gdtype)
    got = geo_embedding_bwd_split_plain(args[0], args[1], ref_map, g, H)
    for name, x, y in zip(("dwd", "dbd", "dwa"), got, _bwd_reference(inputs, g)):
        assert x.dtype == torch.float32, name
        assert float((x.double() - y).abs().max()) <= 1e-4 * float(y.abs().max()), name


def test_bwd_one_bf16_product_misses_the_fp32_tolerance(inputs, cotangent):
    args, _, _, ref_map = inputs
    g = cotangent.to(torch.bfloat16)
    bf = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    dwd_ref, _, dwa_ref = _bwd_reference(inputs, g)
    dwd = bf(sinusoidal_basis(args[0], H)).t() @ g.float()
    e_a = bf(sinusoidal_basis(args[1], H))
    dwa = sum(e_a[:, q].t() @ (g.float() * (ref_map == q)) for q in range(K))
    assert float((dwd.double() - dwd_ref).abs().max()) > 1e-4 * float(dwd_ref.abs().max())
    assert float((dwa.double() - dwa_ref).abs().max()) > 1e-4 * float(dwa_ref.abs().max())
