"""The reference's process: it receives a run's cell, seed and the
program's outputs over a pipe, makes the same weights and inputs from the
seed, runs the reference (fp32, TF32 off) and answers with the compared
numbers. It refuses to answer if the program or
JAX has been loaded into it."""

from __future__ import annotations

import traceback


def serve(conn) -> None:
    try:
        job = conn.recv()
        conn.send({"numbers": numbers(job)})
    except BaseException:  # reported to the parent, which raises it
        conn.send({"error": traceback.format_exc()})
    finally:
        conn.close()


def numbers(job: dict) -> dict:
    import importlib
    import types

    import torch

    from portbench.harness import loaded_forbidden
    from portbench.reference import pipeline
    from portbench.weights import make_state_dict

    device = torch.device(job["device"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = types.SimpleNamespace(cell=job["cell"], seed=job["seed"], values=job["values"],
                                traffic=job["traffic"], ref_cfg=pipeline.config(job["values"]))
    model = pipeline.build(ctx.ref_cfg, make_state_dict(ctx.ref_cfg, ctx.seed, device), device)
    driver = importlib.import_module(f"portbench.drivers.{ctx.traffic['driver']}")
    out = driver.reference_numbers(ctx, job["payload"], model, device)
    found = loaded_forbidden(extra=("roitr_torch",))
    if found:
        raise RuntimeError(f"the reference's process loaded {found}")
    return out
