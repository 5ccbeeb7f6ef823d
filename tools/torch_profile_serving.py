"""Where a Matcher.match request of the PyTorch port spends its time.

    python3 tools/torch_profile_serving.py            # on a CUDA card
    python3 tools/torch_profile_serving.py --device cpu --points 900 --bucket 1024

Runs Config(benchmark="3DMatch") at full width with seeded random weights
on three synthetic pairs (20k-30k points, the 32768 bucket by default),
after one warm-up request, and prints:

  * per request: host normal estimation, device normal estimation
    (ops/normals.py on the padded clouds), Matcher.match with the normals
    given (the forward and its trim), and the whole request without normals
    under prep="host" and prep="device", the two in turns (their order
    alternates from request to request); all on the host clock around
    torch.cuda.synchronize();
  * per stage of the forward (inclusive wall ms, summed over the three
    requests, with a synchronize at each stage boundary, so the stages add
    the cost of those waits and nothing else);
  * one request under torch.profiler: device time by kernel name (top 15),
    the device's busy share of the request's wall time, and the share of
    the port's own CUDA kernels.

On the card, each line carries the card's name and power limit. With
--device cpu it times the CPU run, whose numbers say nothing of the card.
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from roitr_torch.config import Config  # noqa: E402
from roitr_torch.data.preprocess import estimate_normals_np, normal_redirect_np  # noqa: E402
from roitr_torch.data.synthetic import make_pair_arrays  # noqa: E402
from roitr_torch.data.preprocess import pad_cloud, pick_bucket  # noqa: E402
from roitr_torch.models.roitr import RoITr  # noqa: E402
from roitr_torch.ops.normals import estimate_normals  # noqa: E402
from roitr_torch.serving import Matcher  # noqa: E402

STAGE_MS: "collections.Counter[str]" = collections.Counter()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _timed(name, fn, device):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        _sync(device)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync(device)
        STAGE_MS[name] += (time.perf_counter() - t0) * 1e3
        return out

    return run


def instrument(device):
    """Wrap the forward's stages (module globals and methods) in timers."""
    import roitr_torch.models.backbone as bb
    import roitr_torch.models.roitr as rt
    import roitr_torch.ops.neighbors as nb
    from roitr_torch.models.attention import GlobalRPESelfAttention, LocalPPFTransformer
    from roitr_torch.models.embeddings import GeometricStructureEmbedding
    from roitr_torch.models.transformer import GeometricTransformer

    for mod, name, stage in (
        (bb, "_device_fps_pyramids", "backbone: FPS pyramids (kernel 1)"),
        (bb, "masked_knn", "backbone: kNN (self and cross)"),
        (nb, "masked_knn", "backbone: kNN of the 3-NN upsampling"),
        (rt, "point_to_node_partition", "point-to-node partition"),
        (rt, "coarse_matching", "coarse matching"),
        (rt, "log_sinkhorn_ot", "Sinkhorn (kernel 4, with its inputs)"),
        (rt, "fine_matching", "fine matching"),
    ):
        setattr(mod, name, _timed(stage, getattr(mod, name), device))
    for cls, stage in (
        (bb.RIPointTransformer, "backbone (all)"),
        (LocalPPFTransformer, "backbone: local PPF attention"),
        (GeometricTransformer, "global transformer (all)"),
        (GeometricStructureEmbedding, "global: geometric embedding (kernel 2, with indices)"),
        (GlobalRPESelfAttention, "global: RPE self-attention (kernel 3, with projections)"),
        (RoITr, "forward (all)"),
    ):
        cls.forward = _timed(stage, cls.forward, device)


def card_line(device) -> str:
    if device.type != "cuda":
        return "device cpu (no card numbers)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return f"card {smi.stdout.strip().splitlines()[0]}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--points", type=int, default=30000, help="largest cloud of a pair")
    ap.add_argument("--bucket", type=int, default=32768)
    ap.add_argument("--json", help="also write the numbers to this JSON file")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("FAIL: no CUDA card", file=sys.stderr)
        return 1
    card = card_line(device)
    print(card, flush=True)

    cfg = Config(benchmark="3DMatch")
    state_dict = RoITr(cfg, device="cpu", seed=0).state_dict()
    matcher = Matcher(cfg, state_dict, device=device)
    device_matcher = Matcher(cfg, state_dict, device=device, prep="device")
    rng = np.random.RandomState(0)
    top = args.points
    sizes = [(top, top * 26 // 30), (top * 25 // 30, top * 28 // 30),
             (top * 27 // 30, top * 248 // 300)]
    view = np.zeros(3, np.float32)
    reqs = []
    for n, m in sizes:
        arr = make_pair_arrays(rng, args.bucket, n, m)
        reqs.append((arr["src_points"][:n], arr["tgt_points"][:m]))

    def normals(src, tgt):
        return (normal_redirect_np(src, estimate_normals_np(src, cfg.normal_knn), view),
                normal_redirect_np(tgt, estimate_normals_np(tgt, cfg.normal_knn), view))

    def device_normals(src, tgt):
        """As Matcher(prep="device") does it: pad to the bucket, copy to the
        device, estimate both clouds' normals there."""
        bucket = pick_bucket(max(len(src), len(tgt)), cfg.buckets)
        for pcd in (src, tgt):
            pts = pad_cloud(pcd, np.zeros_like(pcd), bucket)[0]
            estimate_normals(torch.from_numpy(pts).to(device),
                             torch.tensor(len(pcd), device=device), k=cfg.normal_knn)

    def wall_ms(fn, *args):
        _sync(device)
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        return (time.perf_counter() - t0) * 1e3

    matcher.match(*reqs[0], *normals(*reqs[0]))  # warm-up
    device_matcher.match(*reqs[0])
    _sync(device)

    rows = []
    for i, (src, tgt) in enumerate(reqs):
        t0 = time.perf_counter()
        sn, tn = normals(src, tgt)
        host_ms = (time.perf_counter() - t0) * 1e3
        dev_ms = wall_ms(device_normals, src, tgt)
        match_ms = wall_ms(matcher.match, src, tgt, sn, tn)
        order = (("host", matcher), ("device", device_matcher))
        walls = {name: wall_ms(m.match, src, tgt) for name, m in order[::1 - 2 * (i % 2)]}
        rows.append(dict(points=[len(src), len(tgt)], normals_ms=host_ms,
                         device_normals_ms=dev_ms, match_ms=match_ms,
                         request_host_prep_ms=walls["host"],
                         request_device_prep_ms=walls["device"], first=next(iter(walls))))
        print(f"[request {i}] {len(src)} + {len(tgt)} points: host normals {host_ms:.1f} ms, "
              f"device normals {dev_ms:.1f} ms, match with normals {match_ms:.1f} ms; request "
              f"wall prep=host {walls['host']:.1f} ms, prep=device {walls['device']:.1f} ms "
              f"({next(iter(walls))} first); {card}", flush=True)

    instrument(device)
    for src, tgt in reqs:
        matcher.match(src, tgt, *normals(src, tgt))
    stages = {name: ms / len(reqs) for name, ms in STAGE_MS.items()}
    print(f"[stages] inclusive wall ms a request, mean of {len(reqs)} requests; {card}")
    for name, ms in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"[stages] {ms:9.2f} ms/request  {name}")

    prof_rows = None
    if device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        src, tgt = reqs[1]
        sn, tn = normals(src, tgt)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            matcher.match(src, tgt, sn, tn)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages() if getattr(e, "device_type", None) is not None
                   and str(e.device_type).endswith("CUDA")]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        ours = sum(e.self_device_time_total for e in kernels
                   if any(s in e.key for s in ("fps_kernel", "geo_embedding_kernel",
                                               "rpe_attention_kernel", "sinkhorn_lines_fwd",
                                               "sinkhorn_kernel"))) / 1e3
        print(f"[profile] one request (stages timed, so host waits included): wall "
              f"{wall_ms:.1f} ms, device busy {busy:.1f} ms ({busy / wall_ms:.1%}), of which the "
              f"port's four kernels {ours:.1f} ms; {card}")
        kernels.sort(key=lambda e: -e.self_device_time_total)
        prof_rows = []
        for e in kernels[:15]:
            ms = e.self_device_time_total / 1e3
            prof_rows.append(dict(name=e.key[:90], ms=ms, calls=e.count))
            print(f"[profile] {ms:9.3f} ms {e.count:6d} calls  {e.key[:90]}")
        if busy == 0:
            print("[profile] the profiler saw no device time: device numbers not measured")
    if args.json:
        Path(args.json).write_text(json.dumps(dict(
            card=card, requests=rows, stages_ms_per_request=stages, profile_top=prof_rows),
            indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
