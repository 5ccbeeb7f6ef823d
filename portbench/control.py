"""The control that a cell's limits must fail: the reference put in the
program's place and computed in the precision below the configuration's
(fp32 with TF32 off -> TF32 on), read against the fp32 reference by the
cell's own comparison; and, for training, a planted fault (`--fault
half_batch`: an update averages half of its pairs; `--fault no_exchange`:
a data-parallel update from rank 0's pair alone, as without the
all-reduce).

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] [--fault half_batch]

One process, no program: it prints one JSON line a seed with the numbers.
The serving sample is drawn as a run draws it, over the whole pool.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _tf32(on: bool) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def readings(bench: dict, cell: str, seed: int, fault: str = "", device="cuda") -> dict:
    import torch

    from portbench import harness, judge, models, pools
    from portbench.reference import ops, pipeline

    ctx = harness.make_context(bench, cell, seed, device)
    weights = models.weights(ctx)

    def fresh():
        return ctx.model.build_reference(ctx.ref_cfg, {k: v.clone() for k, v in weights.items()},
                                         device)

    if ctx.traffic["driver"] == "match":
        pool = pools.request_pool(seed, ctx.traffic)
        sample = pools.check_sample(seed, list(range(len(pool))), pool, ctx.traffic["check"])
        model = fresh()
        outs = {}
        for on in (False, True):
            _tf32(on)
            outs[on] = [pipeline.match(model, ctx.ref_cfg, *pool[i], device) for i in sample]
        _tf32(False)
        return judge.match_numbers(outs[True], outs[False])
    k = ctx.ref_cfg.normal_knn
    cfg = copy.copy(ctx.ref_cfg)
    dp = ctx.traffic["driver"] == "train_dp"
    if dp:  # one update from every rank's first pair, each rank's own noise
        world = int(ctx.traffic["ranks"])
        order = list(pools.epoch_order(seed, 0, ctx.traffic["pool"]))[:world]
        cfg.iter_size, updates = world, 1
        gens = lambda: [torch.Generator().manual_seed(pools.seed32(seed, 40 + r))  # noqa: E731
                        for r in range(world)]
    else:
        updates = ctx.traffic["follow_updates"]
        order = list(pools.epoch_order(seed, 0, ctx.traffic["pool"]))[
            :updates * max(cfg.iter_size, 1)]
        gens = lambda: torch.Generator().manual_seed(pools.seed32(seed, 4))  # noqa: E731
    items = pools.train_items(seed, ctx.traffic, cfg.buckets,
                              lambda p: ops.estimate_normals_host(p, k), select=set(order))
    pairs = [items[i] for i in order]

    def follow(c, ps, g, u):
        out = pipeline.follow_training(fresh(), c, ps, g, u, device)
        if dp:  # a data-parallel step reports the mean loss of its pairs
            out["losses"] = [sum(out["losses"]) / len(out["losses"])]
        return out

    _tf32(False)
    ref = follow(cfg, pairs, gens(), updates)
    if fault in ("half_batch", "no_exchange"):
        # half: an update averages half of its pairs; no exchange: rank 0's pair alone
        low_cfg = copy.copy(cfg)
        low_cfg.iter_size = cfg.iter_size // 2 if fault == "half_batch" else 1
        g = gens()
        low = follow(low_cfg, pairs[:low_cfg.iter_size], g[:low_cfg.iter_size] if dp else g, 1)
        if not dp:
            low["losses"] = low["losses"] + ref["losses"][len(low["losses"]):]
        return judge.train_numbers(low, ref)
    _tf32(True)
    low = follow(cfg, pairs, gens(), updates)
    _tf32(False)
    return judge.train_numbers(low, ref)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", default="", choices=("", "half_batch", "no_exchange"))
    args = p.parse_args(argv)
    bench = json.loads((Path(__file__).resolve().parents[1] / "BENCHMARK.json").read_text())
    for seed in args.seeds:
        numbers = readings(bench, args.workload, seed, args.fault)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.fault or "tf32", "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
