"""Serving: one caller in a closed loop on `Matcher(prep="device",
descriptors=True).match`, cycling a seeded pool of raw XYZ pairs.

Traffic keys: pool (pairs), points ([lo, hi] a cloud), overlap, warmup
(requests before the window), check (requests the reference checks),
trace_steps (requests in the profiled stretch).
"""

from __future__ import annotations

from portbench import pools, synthetic


class Driver:
    train = False

    def __init__(self, ctx):
        self.ctx = ctx
        self.traffic = ctx.traffic

    def setup(self) -> None:
        from roitr_torch.serving import Matcher

        ctx, t = self.ctx, self.traffic
        self.pool = pools.request_pool(ctx.seed, t)
        self.order = synthetic.rng_for(ctx.seed, pools.ORDER).permutation(len(self.pool))
        self.matcher = Matcher(ctx.port_cfg, ctx.state_dict, device=ctx.device,
                               descriptors=True, prep="device")
        self.k = 0
        self.kept, self.ran = {}, []
        for _ in range(t["warmup"]):
            self.step()
        self.kept = {}

    def bucket(self) -> int:
        return pools.pick_bucket(max(len(self.pool[0][0]), len(self.pool[0][1])),
                                 self.ctx.ref_cfg.buckets)

    def boundary(self) -> bool:
        return True

    def step(self, timings=None) -> int:
        i = int(self.order[self.k % len(self.pool)])
        self.k += 1
        src, tgt = self.pool[i]
        self.kept[i] = self.matcher.match(src, tgt)
        self.ran.append((len(src), len(tgt)))
        return 1

    def payload(self) -> dict:
        sample = pools.check_sample(self.ctx.seed, list(self.kept), self.pool,
                                    self.traffic["check"])
        return {"sample": sample, "outputs": [self.kept[i] for i in sample]}

    def close(self) -> None:
        self.matcher = self.kept = None


def reference_numbers(ctx, payload, model, device) -> dict:
    """The reference's answers for the sampled requests, against the
    program's."""
    from portbench import judge
    from portbench.reference import pipeline

    pool = pools.request_pool(ctx.seed, ctx.traffic)
    ref = [pipeline.match(model, ctx.ref_cfg, *pool[i], device) for i in payload["sample"]]
    out = judge.match_numbers(payload["outputs"], ref)
    out["requests_checked"] = float(len(ref))
    return out

