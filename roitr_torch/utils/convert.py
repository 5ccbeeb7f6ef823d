"""JAX params -> port state_dict converter.

`params_to_state_dict` is the inverse of the JAX package's
`torch_state_dict_to_params`: it maps the nested params dict of the JAX
model (numpy arrays) onto the reference RoITr `state_dict` key layout that
every `nn.Module` of this package yields. Dense kernels are transposed
(flax (in, out) -> torch (out, in)), LayerNorm `scale` becomes `weight`,
the raw `proj_p_kernel`/`proj_vp_kernel` of the factored global self
attention become `proj_p.weight`/`proj_vp.weight`, and `ot_alpha` becomes
`optimal_transport.alpha`. `ppf_params_to_state_dict` does the same for
the alternative PPF transformer (models/ppf_transformer.py).

Keys the reference checkpoint carries but the model never reads
(`OT.*`, `backbone.occ_proj.*`, `*.div_term`) are matched by
`SKIP_PATTERNS`: the port has no such entries, and `load_reference_state_dict`
drops them from a released checkpoint.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Sequence, Tuple

import numpy as np
import torch

SKIP_PATTERNS = (
    re.compile(r"^OT\."),
    re.compile(r"^backbone\.occ_proj\."),
    re.compile(r"\.div_term$"),
)

# (flax path, flax leaf, torch key, kind); kind: "kernel" (transpose),
# "leaf" (copied as is)
_Entry = Tuple[Tuple[str, ...], str, str, str]


def _dense(path, key) -> Iterator[_Entry]:
    yield path, "kernel", key + ".weight", "kernel"
    yield path, "bias", key + ".bias", "leaf"


def _layernorm(path, key) -> Iterator[_Entry]:
    yield path, "scale", key + ".weight", "leaf"
    yield path, "bias", key + ".bias", "leaf"


def _local_transformer(path, key) -> Iterator[_Entry]:
    """LocalPPFTransformer (reference ppftransformer.py:202-253)."""
    yield from _dense(path + ("embedding_proj",), key + ".embedding.proj")
    yield from _dense(path + ("in_proj",), key + ".in_proj")
    yield from _dense(path + ("out_proj",), key + ".out_proj")
    att = key + ".transformer"
    for name in ("proj_q", "proj_k", "proj_v", "proj_p", "proj_vp"):
        yield from _dense(path + ("attention", name), f"{att}.attention.{name}")
    yield from _dense(path + ("attention", "linear"), att + ".linear")
    yield from _layernorm(path + ("attention", "norm"), att + ".norm")


def _ffn(path, key) -> Iterator[_Entry]:
    yield from _dense(path + ("expand",), key + ".expand")
    yield from _dense(path + ("squeeze",), key + ".squeeze")
    yield from _layernorm(path + ("norm",), key + ".norm")


def _entries(transformer_architecture: Sequence[str],
             enc_blocks: Sequence[int]) -> Iterator[_Entry]:
    bb = ("backbone",)
    for lvl in range(1, 5):
        yield from _local_transformer(
            bb + (f"enc{lvl}_down", "transformer"), f"backbone.enc{lvl}.0.transformer")
        for b in range(1, enc_blocks[lvl - 1]):
            base = f"backbone.enc{lvl}.{b}"
            yield from _local_transformer(
                bb + (f"enc{lvl}_block{b}", "transformer"), base + ".transformer.transformer")
            yield from _layernorm(bb + (f"enc{lvl}_block{b}", "bn2"), base + ".bn2")
    yield from _dense(bb + ("dec4_up", "linear1"), "backbone.dec4.0.linear1.0")
    yield from _layernorm(bb + ("dec4_up", "norm1"), "backbone.dec4.0.linear1.1")
    yield from _dense(bb + ("dec4_up", "linear2"), "backbone.dec4.0.linear2.0")
    for lvl in (3, 2, 1):
        up = bb + (f"dec{lvl}_up",)
        yield from _dense(up + ("linear1",), f"backbone.dec{lvl}.0.linear1.0")
        yield from _layernorm(up + ("norm1",), f"backbone.dec{lvl}.0.linear1.1")
        yield from _dense(up + ("linear2",), f"backbone.dec{lvl}.0.linear2.0")
        yield from _layernorm(up + ("norm2",), f"backbone.dec{lvl}.0.linear2.1")
    for lvl in range(1, 5):
        base = f"backbone.dec{lvl}.1"
        yield from _local_transformer(
            bb + (f"dec{lvl}_block", "transformer"), base + ".transformer.transformer")
        yield from _layernorm(bb + (f"dec{lvl}_block", "bn2"), base + ".bn2")

    gt = "backbone.global_transformer"
    gp = bb + ("global_transformer",)
    yield from _dense(gp + ("embedding", "proj_d"), gt + ".embedding.proj_d")
    yield from _dense(gp + ("embedding", "proj_a"), gt + ".embedding.proj_a")
    yield from _dense(gp + ("in_proj",), gt + ".in_proj")
    yield from _dense(gp + ("out_proj",), gt + ".out_proj")
    for i, block in enumerate(transformer_architecture):
        lp = gp + (f"layers_{i}",)
        tk = f"{gt}.transformer.layers.{i}"
        if block == "self":
            for name in ("proj_q", "proj_k", "proj_v"):
                yield from _dense(lp + ("attention", name), f"{tk}.attention.attention.{name}")
            for name in ("proj_p", "proj_vp"):
                yield lp + ("attention",), f"{name}_kernel", \
                    f"{tk}.attention.attention.{name}.weight", "kernel"
                yield lp + ("attention",), f"{name}_bias", \
                    f"{tk}.attention.attention.{name}.bias", "leaf"
            yield from _dense(lp + ("linear",), tk + ".attention.linear")
            yield from _layernorm(lp + ("norm",), tk + ".attention.norm")
            yield from _dense(lp + ("pos_linear",), tk + ".attention.pos_linear")
            yield from _layernorm(lp + ("pos_norm",), tk + ".attention.pos_norm")
            yield from _ffn(lp + ("output",), tk + ".output")
            yield from _ffn(lp + ("pos_proj",), tk + ".pos_proj")
        elif block == "cross":
            for name in ("proj_q", "proj_k", "proj_v"):
                yield from _dense(lp + (name,), f"{tk}.attention.attention.{name}")
            yield from _dense(lp + ("linear",), tk + ".attention.linear")
            yield from _layernorm(lp + ("norm",), tk + ".attention.norm")
            yield from _ffn(lp + ("output",), tk + ".output")
        else:
            raise ValueError(f"unknown block type {block!r}")

    yield from _dense(("coarse_proj",), "coarse_proj")
    yield from _dense(("fine_proj",), "fine_proj")
    yield (), "ot_alpha", "optimal_transport.alpha", "leaf"


def _to_state_dict(params: Dict[str, Any], entries) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf, key, kind in entries:
        node = params
        for p in path:
            node = node[p]
        value = np.array(node[leaf], np.float32)  # a writable copy
        if kind == "kernel":
            value = value.T
        sd[key] = torch.from_numpy(np.array(value, order="C"))  # keeps 0-d leaves 0-d
    return sd


def params_to_state_dict(
    params: Dict[str, Any],
    transformer_architecture: Sequence[str] = ("self", "cross", "self", "cross", "self", "cross"),
    enc_blocks: Sequence[int] = (2, 3, 3, 3),
) -> Dict[str, torch.Tensor]:
    """JAX params (nested dict of arrays) -> port state_dict (CPU tensors).
    Any pytree of the params' structure maps the same way, such as the
    gradients of `jax.value_and_grad`."""
    return _to_state_dict(params, _entries(transformer_architecture, enc_blocks))


def _ppf_entries(blocks: Sequence[str], with_cross_pos_embed: bool) -> Iterator[_Entry]:
    """roitr_tpu/models/ppf_transformer.py's params -> the port's
    models/ppf_transformer.py keys."""
    yield from _dense(("embedding", "proj"), "embedding.proj")
    yield from _dense(("in_proj",), "in_proj")
    for i, block in enumerate(blocks):
        lp = (f"layers_{i}",)
        tk = f"transformer.layers.{i}"
        att = tk + ".attention.attention"
        if block == "self":
            for name in ("proj_q", "proj_k", "proj_v"):
                yield from _dense(lp + (name,), f"{att}.{name}")
            for name in ("proj_p", "proj_vp"):
                yield lp, f"{name}_kernel", f"{att}.{name}.weight", "kernel"
                yield lp, f"{name}_bias", f"{att}.{name}.bias", "leaf"
        elif block == "cross":
            names = ("proj_q", "proj_k", "proj_v")
            if with_cross_pos_embed:
                names += ("proj_pq", "proj_pk", "proj_vk")
            for name in names:
                yield from _dense(lp + ("attention", name), f"{att}.{name}")
        else:
            raise ValueError(f"unknown block type {block!r}")
        yield from _dense(lp + ("linear",), tk + ".attention.linear")
        yield from _layernorm(lp + ("norm",), tk + ".attention.norm")
        yield from _ffn(lp + ("output",), tk + ".output")
    yield from _dense(("out_proj",), "out_proj")


def ppf_params_to_state_dict(params: Dict[str, Any], blocks: Sequence[str],
                             with_cross_pos_embed: bool = False) -> Dict[str, torch.Tensor]:
    """JAX `PPFTransformer` params -> the state_dict of the port's
    models/ppf_transformer.py `PPFTransformer` of the same blocks."""
    return _to_state_dict(params, _ppf_entries(blocks, with_cross_pos_embed))


def load_reference_state_dict(sd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A reference checkpoint's state_dict -> the port's key set: strips
    DDP `module.` prefixes and drops the entries in SKIP_PATTERNS."""
    out = {}
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if not any(p.search(k) for p in SKIP_PATTERNS):
            out[k] = torch.as_tensor(v)
    return out
