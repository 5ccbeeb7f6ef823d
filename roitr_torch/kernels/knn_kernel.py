"""Exact masked k-nearest-neighbour search (csrc/knn.cu).

Replaces no TPU kernel: the JAX package searches with `lax.top_k` and
`lax.approx_min_k`, which XLA computes (roitr_tpu/ops/neighbors.py). The
plain versions are the port's tiled PyTorch searches: distances for a tile
of queries at a time, so the (Q, N) matrix never exists whole (at the 32768
bucket it would be 4 GB), pad keys at 1e10, and ops/topk.py's top-k, whose
ties go to the lower index as in `lax.top_k`. The kernel keeps each query's
k best (d^2, index) pairs in registers instead, in that order, from the
same distances bit for bit, and applies exclude_self, the phantom slots
and the square root itself (`masked_knn`'s semantics, ops/neighbors.py).
`knn` and `min_dist` are the entries, which ops/neighbors.py calls; on the
card they raise for more neighbours than `supported_k` takes.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from roitr_torch.kernels import check_cuda, check_launch, launch_counts, ptr, route, stream_ptr
from roitr_torch.ops.geometry import pairwise_sq_dist, prefix_mask
from roitr_torch.ops.topk import topk

_INF = 1e10
# distance entries per query tile of the plain search (fp32 distances +
# int64 sort keys)
_TILE_ELEMS = 1 << 25
# list sizes the kernel is compiled for (csrc/knn.cu kCapacities)
CAPACITIES = (1, 3, 9, 17, 33, 38)
# lanes a query double while a search gives each SM fewer than this many
# threads, so a plan lands at 192-384 threads an SM: the fastest group size
# of each row of a sweep on the H100 (248 an SM at 16384 x 32768 keys and
# at 2048 x 2048, PERF.md); and the fewest keys a lane then gets
_THREADS_PER_SM = 192
_KEYS_PER_LANE = 64
_MAX_GROUP_LOG2 = 5  # a group is at most a warp


def supported_k(kk: int) -> bool:
    """Whether the kernel takes a search of kk neighbours (k, or k + 1
    under exclude_self): at most its largest list."""
    return 1 <= kk <= CAPACITIES[-1]


def knn_plain(queries: torch.Tensor, keys: torch.Tensor, key_count, k: int,
              exclude_self: bool = False):
    """The tiled search: `masked_knn`'s (idx, d^2) before the square root.
    queries (..., Q, 3), keys (..., N, 3), key_count scalar or (B,)."""
    q, n = queries.shape[-2], keys.shape[-2]
    batch = queries.shape[:-2]
    kk = min(k + 1 if exclude_self else k, n)
    count = torch.as_tensor(key_count, device=keys.device)
    key_invalid = torch.arange(n, device=keys.device) >= count[..., None]  # (..., N)
    inf = torch.tensor(_INF, dtype=torch.float32, device=keys.device)
    tile = max(1, _TILE_ELEMS // max(n * batch.numel(), 1))
    idx_parts, d2_parts = [], []
    for s in range(0, q, tile):
        d2 = pairwise_sq_dist(queries[..., s:s + tile, :], keys)
        d2 = torch.where(key_invalid[..., None, :], inf, d2)
        d, i = topk(d2, kk, dim=-1, largest=False)
        idx_parts.append(i)
        d2_parts.append(d)
    idx = torch.cat(idx_parts, dim=-2)
    d2 = torch.cat(d2_parts, dim=-2)
    if exclude_self:
        idx, d2 = idx[..., 1:], d2[..., 1:]
        if idx.shape[-1] < k:
            pad = (*batch, q, k - idx.shape[-1])
            idx = torch.cat([idx, idx.new_zeros(pad)], dim=-1)
            d2 = torch.cat([d2, d2.new_full(pad, _INF)], dim=-1)
        rank = torch.arange(idx.shape[-1], device=idx.device)
        phantom = rank >= count[..., None, None] - 1
        idx = torch.where(phantom, torch.zeros_like(idx), idx)
        d2 = torch.where(phantom, inf, d2)
    return idx, d2


def min_dist_plain(queries: torch.Tensor, keys: torch.Tensor, key_count) -> torch.Tensor:
    """The tiled 1-NN search: queries (Q, 3), keys (N, 3) -> (Q,) squared
    distances by coordinate differences, min-reduced over query tiles."""
    q, n = queries.shape[0], keys.shape[0]
    key_invalid = ~prefix_mask(n, key_count, device=keys.device)
    inf = torch.tensor(_INF, dtype=torch.float32, device=keys.device)
    tile = max(1, _TILE_ELEMS // 4 // max(n, 1))
    parts = []
    for s in range(0, q, tile):
        t = queries[s:s + tile]
        d2 = sum((t[:, i, None] - keys[None, :, i]) ** 2 for i in range(3))  # (T, N)
        parts.append(torch.where(key_invalid[None, :], inf, d2).amin(dim=1))
    return torch.cat(parts)


class Plan(NamedTuple):
    """One launch: `batch` clouds of `q_len` queries over `n` keys, kk
    neighbours searched, `cols` columns out, 2^group_log2 lanes a query."""
    batch: int
    q_len: int
    n: int
    kk: int
    cols: int
    group_log2: int


def group_log2(rows: int, n: int, sms: int) -> int:
    """log2 of the lanes a query: doubled while the rows' threads leave the
    card short of `_THREADS_PER_SM` an SM, each lane keeps at least
    `_KEYS_PER_LANE` keys and the group fits a warp."""
    g = 0
    while (g < _MAX_GROUP_LOG2 and (rows << g) < sms * _THREADS_PER_SM
           and _KEYS_PER_LANE << (g + 1) <= n):
        g += 1
    return g


def launch_plan(q_shape, k_shape, k: int, exclude_self: bool, sms: int) -> Plan:
    """The launch for queries and keys of these shapes; raises for what
    the kernel does not take."""
    q_shape, k_shape = tuple(q_shape), tuple(k_shape)
    if len(q_shape) < 2 or q_shape[-1] != 3 or k_shape[-1:] != (3,):
        raise ValueError(f"knn: queries {q_shape} and keys {k_shape} must end in 3")
    if q_shape[:-2] != k_shape[:-2]:
        raise ValueError(f"knn: batch axes of queries {q_shape} and keys {k_shape} differ")
    if k < 1:
        raise ValueError(f"knn: k {k} below 1")
    n = k_shape[-2]
    kk = min(k + 1 if exclude_self else k, n)
    if not supported_k(kk):
        raise ValueError(f"knn: {kk} neighbours a query, the kernel takes 1 to "
                         f"{CAPACITIES[-1]}")
    batch, q_len = math.prod(q_shape[:-2]), q_shape[-2]
    return Plan(batch, q_len, n, kk, k if exclude_self else kk,
                group_log2(batch * q_len, n, sms))


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(queries, keys, key_count, plan: Plan, exclude_self: bool, form: int,
            squared: bool):
    """(idx (batch, q_len, cols) int64, dist (batch, q_len, cols) fp32)."""
    from roitr_torch.kernels.build import function

    dev = keys.device
    q = queries.reshape(plan.batch, plan.q_len, 3).contiguous()
    kv = keys.reshape(plan.batch, plan.n, 3).contiguous()
    check_cuda(q, "queries", torch.float32, (plan.batch, plan.q_len, 3), dev)
    check_cuda(kv, "keys", torch.float32, (plan.batch, plan.n, 3), dev)
    counts = torch.as_tensor(key_count, device=dev).to(torch.int32).reshape(-1)
    counts = counts.expand(plan.batch).contiguous()
    idx = torch.empty((plan.batch, plan.q_len, plan.cols), dtype=torch.int64, device=dev)
    dist = torch.empty((plan.batch, plan.q_len, plan.cols), dtype=torch.float32, device=dev)
    fn = function("knn", "roitr_knn", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                  + [ctypes.c_void_p] * 3)
    err = fn(ptr(q), ptr(kv), ptr(counts), plan.batch, plan.q_len, plan.n, plan.kk, plan.cols,
             int(exclude_self), form, plan.group_log2, int(squared), ptr(idx), ptr(dist),
             stream_ptr(dev))
    check_launch(err, "knn")
    launch_counts["knn"] += 1
    return idx, dist


def knn(queries: torch.Tensor, keys: torch.Tensor, key_count, k: int,
        exclude_self: bool = False, squared: bool = False):
    """`masked_knn` (ops/neighbors.py): (idx (..., Q, cols) int64, sqrt
    distances), cols k under exclude_self, else min(k, N). The plain search
    for CPU tensors; on the card the kernel, which raises past
    `supported_k`. `squared` returns d^2 instead, for the checks that hold
    the kernel's distances to the plain search's bit for bit."""
    if route(keys) == "plain":
        idx, d2 = knn_plain(queries, keys, key_count, k, exclude_self)
        return idx, d2 if squared else torch.sqrt(d2)
    plan = launch_plan(queries.shape, keys.shape, k, exclude_self,
                       _sms(keys.device.index or 0))
    shape = (*queries.shape[:-2], plan.q_len, plan.cols)
    idx, dist = _launch(queries, keys, key_count, plan, exclude_self, 0, squared)
    return idx.reshape(shape), dist.reshape(shape)


def min_dist(queries: torch.Tensor, keys: torch.Tensor, key_count,
             squared: bool = False) -> torch.Tensor:
    """`masked_min_dist` (ops/neighbors.py): queries (Q, 3), keys (N, 3)
    -> (Q,) sqrt distances to the nearest valid key, by coordinate
    differences. The plain search for CPU tensors; on the card the kernel
    with one neighbour. `squared` returns d^2 instead, for the bit-exact
    checks."""
    if route(keys) == "plain":
        d2 = min_dist_plain(queries, keys, key_count)
        return d2 if squared else torch.sqrt(d2)
    if queries.dim() != 2 or keys.dim() != 2:
        raise ValueError(f"min_dist: queries {tuple(queries.shape)} and keys "
                         f"{tuple(keys.shape)} must be (Q, 3) and (N, 3)")
    plan = launch_plan(queries.shape, keys.shape, 1, False, _sms(keys.device.index or 0))
    return _launch(queries, keys, key_count, plan, False, 1, squared)[1].reshape(plan.q_len)
