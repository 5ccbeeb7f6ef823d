"""RoITr (haoyu94/RoITr): the reference's configuration, weights and model
from `portbench/reference/` and `portbench/weights.py`, and the program's
`roitr_torch.config.Config`."""

from __future__ import annotations

import dataclasses

from portbench import weights
from portbench.reference import pipeline


def reference_config(values):
    return pipeline.config(values)


def make_state_dict(ref_cfg, seed: int, device):
    return weights.make_state_dict(ref_cfg, seed, device)


def build_reference(ref_cfg, state_dict, device):
    return pipeline.build(ref_cfg, state_dict, device)


def program_config(values):
    """The program's Config from the file's values: the keys it has, lists
    as tuples."""
    from roitr_torch.config import Config

    fields = {f.name for f in dataclasses.fields(Config)}
    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in values.items() if k in fields}
    return Config(**kw)
