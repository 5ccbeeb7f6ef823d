"""A model for the tests of the model registry, registered only inside
them, as `portbench.models.toy` and as its traffic's driver
`portbench.drivers.toy`: a weight vector drawn from the seed; the program
sums it (plus the configuration's `offset`, a planted fault), the
reference sums it in float64. Each function of the model's records its
call in CALLS."""

from __future__ import annotations

import types

import torch

CALLS = []


def reference_config(values):
    CALLS.append("reference_config")
    return types.SimpleNamespace(**values)


def make_state_dict(ref_cfg, seed: int, device):
    CALLS.append("make_state_dict")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return {"w": torch.rand(ref_cfg.width, generator=gen, device=device)}


def build_reference(ref_cfg, state_dict, device):
    CALLS.append("build_reference")
    w = state_dict["w"].double()
    return lambda: float(w.sum())


def program_config(values):
    CALLS.append("program_config")
    return dict(values)


class Driver:
    train = False

    def __init__(self, ctx):
        self.ctx = ctx

    def setup(self) -> None:
        self.w = self.ctx.state_dict["w"]
        self.out, self.ran = None, []

    def bucket(self) -> int:
        return self.ctx.port_cfg["width"]

    def boundary(self) -> bool:
        return True

    def step(self, timings=None) -> int:
        self.out = float(self.w.sum()) + self.ctx.port_cfg["offset"]
        self.ran.append((self.bucket(), self.bucket()))
        return 1

    def payload(self) -> dict:
        return {"out": self.out}

    def close(self) -> None:
        self.w = None


def reference_numbers(ctx, payload, model, device) -> dict:
    return {"gap": abs(payload["out"] - model())}
