"""The reference's process: it receives a run's cell, seed, model and the
program's outputs over a pipe, makes the same weights and inputs from the
seed through the model's module (`models/<model>.py`), runs the reference
(fp32, TF32 off) and answers with the compared numbers. It refuses to
answer if the program or JAX has been loaded into it."""

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

    from portbench import models
    from portbench.harness import loaded_forbidden

    device = torch.device(job["device"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    module = models.load(job["model"])
    ctx = types.SimpleNamespace(cell=job["cell"], seed=job["seed"], values=job["values"],
                                traffic=job["traffic"], device=device, model=module,
                                ref_cfg=module.reference_config(job["values"]))
    model = module.build_reference(ctx.ref_cfg, models.weights(ctx), device)
    driver = importlib.import_module(f"portbench.drivers.{ctx.traffic['driver']}")
    out = driver.reference_numbers(ctx, job["payload"], model, device)
    found = loaded_forbidden(extra=("roitr_torch",))
    if found:
        raise RuntimeError(f"the reference's process loaded {found}")
    return out
