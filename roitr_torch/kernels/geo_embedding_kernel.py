"""Fused geometric structure embedding (csrc/geo_embedding.cu).

Replaces roitr_tpu/ops/pallas/geo_embedding_kernel.py `_kernel` via
`_pallas_forward` / `fused_geo_embedding`:

    out = [sin(d w), cos(d w)] @ Wd + bd + max_k([sin(a_k w), cos(a_k w)] @ Wa) + ba

for every flattened node pair, with the interleaved sinusoidal basis of
models/embeddings.py. The kernel never builds the (R, k, H) basis and
writes the output once, in the storage dtype.
"""

from __future__ import annotations

import ctypes
import math

import torch

from roitr_torch.kernels import check_cuda, check_launch, launch_counts, ptr, route, stream_ptr


def div_term(hidden: int, device=None) -> torch.Tensor:
    """Frequencies exp(-2i log(1e4) / hidden) of the sinusoidal basis, fp32
    (reference positional_encoding.py:38-62)."""
    return torch.exp(torch.arange(0, hidden, 2, dtype=torch.float32, device=device)
                     * (-math.log(10000.0) / hidden))


def sinusoidal_basis(x: torch.Tensor, hidden: int) -> torch.Tensor:
    """x (*,) -> (*, hidden) interleaved [sin0, cos0, sin1, cos1, ...]."""
    om = x[..., None] * div_term(hidden, x.device)
    return torch.stack([torch.sin(om), torch.cos(om)], dim=-1).reshape(x.shape + (hidden,))


def geo_embedding_plain(d_idx, a_idx, wd, bd, wa, ba, out_dtype=torch.float32):
    """d_idx (R,), a_idx (R, k), wd/wa (H, H) (in, out), bd/ba (H,) ->
    (R, H) in out_dtype; fp32 math (roitr_tpu `_xla_forward`)."""
    hidden = wd.shape[1]
    y = sinusoidal_basis(d_idx, hidden) @ wd + bd
    ya = sinusoidal_basis(a_idx, hidden) @ wa  # (R, k, H)
    return (y + torch.amax(ya, dim=-2) + ba).to(out_dtype)


def fused_geo_embedding(d_idx, a_idx, wd, bd, wa, ba, out_dtype=torch.float32):
    """Same function and arguments as geo_embedding_plain; one kernel
    launch on the card."""
    if route(d_idx) == "plain":
        return geo_embedding_plain(d_idx, a_idx, wd, bd, wa, ba, out_dtype)
    from roitr_torch.kernels.build import function

    dev = d_idx.device
    r, k = a_idx.shape
    hidden = wd.shape[1]
    if hidden % 2 or k < 1 or tuple(wd.shape) != (hidden, hidden):
        raise ValueError(f"geo_embedding: hidden {hidden} must be even, wd square, k >= 1 "
                         f"(got wd {tuple(wd.shape)}, k {k})")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"geo_embedding: out_dtype {out_dtype} not fp32 or bf16")
    div = div_term(hidden, dev)
    # even/odd rows of the (in, out) weights: e @ W == sin @ W[0::2] + cos @ W[1::2]
    wde, wdo = wd[0::2].contiguous(), wd[1::2].contiguous()
    wae, wao = wa[0::2].contiguous(), wa[1::2].contiguous()
    h2 = hidden // 2
    args = [(d_idx, "d_idx", (r,)), (a_idx, "a_idx", (r, k)), (div, "div", (h2,)),
            (wde, "wd[0::2]", (h2, hidden)), (wdo, "wd[1::2]", (h2, hidden)),
            (bd, "bd", (hidden,)), (wae, "wa[0::2]", (h2, hidden)),
            (wao, "wa[1::2]", (h2, hidden)), (ba, "ba", (hidden,))]
    for t, name, shape in args:
        check_cuda(t, name, torch.float32, shape, dev)
    out = torch.empty((r, hidden), dtype=out_dtype, device=dev)
    fn = function("geo_embedding", "roitr_geo_embedding",
                  [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    err = fn(*(ptr(t) for t, _, _ in args), ptr(out), r, k, hidden,
             int(out_dtype == torch.bfloat16), stream_ptr(dev))
    check_launch(err, "geo_embedding")
    launch_counts["geo_embedding"] += 1
    return out
