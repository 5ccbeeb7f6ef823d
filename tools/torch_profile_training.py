"""Where a training step of the PyTorch port spends its time.

    python3 tools/torch_profile_training.py            # on a CUDA card
    python3 tools/torch_profile_training.py --device cpu --bucket 1024 --points 900
    python3 tools/torch_profile_training.py --bucket 1024 --points 1000 --packed 8

Runs the 3DMatch training configuration (configs/train/tdmatch.yaml) at
full width with seeded random weights on synthetic pairs (20k-30k points,
the 32768 bucket by default): one warm-up step, then three steps split into
forward (losses and metrics included), backward and optimizer, each border
on the host clock after torch.cuda.synchronize(); then one step under
torch.profiler: device time by kernel name (top 20), the device's busy
share of the step's wall time, the share of the port's seven CUDA kernels
and each one's device time and calls, and the peak device memory of a step.
With --packed B each step is a packed batch of B pairs (data/packing.py,
host pyramids, as packed training needs); --host-pyramid gives single
pairs host pyramids too, so that the two modes compare at the same prep.

On the card, each line carries the card's name and power limit. With
--device cpu it times the CPU run, whose numbers say nothing of the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from roitr_torch.config import load_config  # noqa: E402
from roitr_torch.data.loader import dict_to_pair  # noqa: E402
from roitr_torch.data.packing import pack_pairs  # noqa: E402
from roitr_torch.data.pyramid import build_cloud_pyramid  # noqa: E402
from roitr_torch.data.synthetic import SyntheticPairs  # noqa: E402
from roitr_torch.models.roitr import RoITr  # noqa: E402
from roitr_torch.parallel.train_step import make_optimizer, train_step  # noqa: E402

from torch_profile_serving import card_line  # noqa: E402

# each port kernel's device functions, by the names' substrings: the RPE
# backward is its row kernel and the products before and after it; each
# Sinkhorn row its line kernel (the main path's) and its general kernel
OUR_KERNELS = {
    "fps_kernel": ("fps_kernel",), "geo_embedding_kernel": ("geo_embedding_kernel",),
    "geo_embedding_bwd": ("geo_embedding_bwd",), "rpe_attention_kernel": ("rpe_attention_kernel",),
    "rpe_attention_bwd": ("rpe_attention_bwd", "rpe_products", "rpe_sum_splits"),
    "sinkhorn_kernel": ("sinkhorn_lines_fwd", "sinkhorn_kernel"),
    "sinkhorn_bwd_kernel": ("sinkhorn_lines_bwd", "sinkhorn_bwd_kernel"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--points", type=int, default=30000, help="largest cloud of a pair")
    ap.add_argument("--bucket", type=int, default=32768)
    ap.add_argument("--packed", type=int, default=0, help="pairs packed into a step")
    ap.add_argument("--host-pyramid", action="store_true", help="host pyramids for single pairs")
    ap.add_argument("--json", help="also write the numbers to this JSON file")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("FAIL: no CUDA card", file=sys.stderr)
        return 1
    card = card_line(device)
    print(card, flush=True)

    cfg = load_config(str(Path(__file__).resolve().parents[1] / "configs/train/tdmatch.yaml"))
    per_step = max(args.packed, 1)
    data = SyntheticPairs(5 * per_step, args.bucket, counts=(args.points * 2 // 3, args.points),
                          seed=0)
    items = [data[i] for i in range(len(data))]
    if args.packed or args.host_pyramid:
        kw = dict(strides=tuple(cfg.enc_strides), nsample=tuple(cfg.enc_nsample))
        for d in items:
            d["src_pyramid"] = build_cloud_pyramid(d["src_raw_points"], int(d["src_count"]), **kw)
            d["tgt_pyramid"] = build_cloud_pyramid(d["tgt_points"], int(d["tgt_count"]), **kw)
    pairs = [dict_to_pair(d, device) for d in items]
    if args.packed:
        pairs = [pack_pairs(pairs[i:i + per_step]) for i in range(0, len(pairs), per_step)]
    model = RoITr(cfg, device=device, seed=0)
    opt = make_optimizer(cfg, model, steps_per_epoch=len(pairs))
    gen = torch.Generator().manual_seed(0)
    train_step(model, opt, pairs[0], gen)  # warm-up

    rows = []
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for i, pair in enumerate(pairs[1:4]):
        t = {}
        m = train_step(model, opt, pair, gen, timings=t)
        points = [int(pair.src_count.sum()), int(pair.tgt_count.sum())]
        rows.append(dict(points=points, pairs=per_step, **t, loss=m["loss"]))
        print(f"[step {i}] {per_step} pair(s), {points[0]} + {points[1]} points: forward "
              f"{t['forward_ms']:.1f} ms, backward {t['backward_ms']:.1f} ms, optimizer "
              f"{t['optimizer_ms']:.1f} ms, total {sum(t.values()):.1f} ms, "
              f"{per_step * 1e3 / sum(t.values()):.2f} pairs/s; loss {m['loss']:.4f}; {card}",
              flush=True)
    peak = torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda" else None
    if peak is not None:
        print(f"[memory] max_memory_allocated over the three steps {peak:.2f} GiB; {card}")

    prof_rows = None
    if device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(model, opt, pairs[4], gen)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages() if getattr(e, "device_type", None) is not None
                   and str(e.device_type).endswith("CUDA")]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        ours = sum(e.self_device_time_total for e in kernels
                   if any(s in e.key for subs in OUR_KERNELS.values() for s in subs)) / 1e3
        print(f"[profile] one train step: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
              f"({busy / wall_ms:.1%}), of which the port's seven kernels {ours:.1f} ms; {card}")
        for name, subs in OUR_KERNELS.items():
            mine = [e for e in kernels if any(s in e.key for s in subs)]
            print(f"[profile] port kernel {name}: "
                  f"{sum(e.self_device_time_total for e in mine) / 1e3:.3f} ms in "
                  f"{sum(e.count for e in mine)} calls")
        kernels.sort(key=lambda e: -e.self_device_time_total)
        prof_rows = []
        for e in kernels[:20]:
            ms = e.self_device_time_total / 1e3
            prof_rows.append(dict(name=e.key[:90], ms=ms, calls=e.count))
            print(f"[profile] {ms:9.3f} ms {e.count:6d} calls  {e.key[:90]}")
        if busy == 0:
            print("[profile] the profiler saw no device time: device numbers not measured")
    if args.json:
        Path(args.json).write_text(json.dumps(dict(card=card, steps=rows, peak_gib=peak,
                                                   profile_top=prof_rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
