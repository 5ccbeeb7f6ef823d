"""Where a training step of the PyTorch port spends its time.

    python3 tools/torch_profile_training.py            # on a CUDA card
    python3 tools/torch_profile_training.py --device cpu --bucket 1024 --points 900
    python3 tools/torch_profile_training.py --bucket 1024 --points 1000 --packed 8

Runs the 3DMatch training configuration (configs/train/tdmatch.yaml) at
full width with seeded random weights on synthetic pairs (20k-30k points,
the 32768 bucket by default): one warm-up step, then three steps split into
forward (losses and metrics included), backward and optimizer, the laps of
`train_step`'s `timings` (each border on the host clock after
torch.cuda.synchronize()), and the peak device memory of those steps; then
one step inside utils/profiling.py `trace()`: the program's spans
(`span_summary()`), the device idle under each span of the exported trace
(`device_idle_by_span`) and, on the card, device time by operation name
(top 20) from the same trace.
With --packed B each step is a packed batch of B pairs (data/packing.py,
host pyramids, as packed training needs); --host-pyramid gives single
pairs host pyramids too, so that the two modes compare at the same prep.

On the card, each line carries the card's name and power limit. With
--device cpu it times the CPU run, whose numbers say nothing of the card.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import tempfile
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
from roitr_torch.utils.profiling import (  # noqa: E402
    DEVICE_CATS,
    device_idle_by_span,
    reset_spans,
    span_summary,
    span_table,
    trace,
    trace_events,
)

from torch_profile_serving import card_line  # noqa: E402

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

    reset_spans()
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp):
            train_step(model, opt, pairs[4], gen)
            if device.type == "cuda":
                torch.cuda.synchronize()
        events = trace_events(tmp)
    spans = span_summary()
    idle = device_idle_by_span(events) if device.type == "cuda" else None
    print(f"[spans] one train step, traced; {card}")
    for line in span_table(spans, idle):
        print(f"[spans] {line}")
    ops = collections.Counter()
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            ops[e["name"][:90]] += float(e.get("dur", 0)) / 1e3
    for name, ms in ops.most_common(20):
        print(f"[profile] {ms:9.3f} ms  {name}")
    if args.json:
        Path(args.json).write_text(json.dumps(dict(
            card=card, steps=rows, peak_gib=peak, spans=spans, idle_ms_by_span=idle,
            profile_top=ops.most_common(20)), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
