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
  * one request under prep="device" inside utils/profiling.py `trace()`:
    the program's spans (`span_summary()`: calls, host ms, self host ms,
    device ms), the device idle under each span of the exported trace
    (`device_idle_by_span`) and, on the card, device time by operation
    name (top 15) from the same trace.

On the card, each line carries the card's name and power limit. With
--device cpu it times the CPU run, whose numbers say nothing of the card.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import tempfile
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
from roitr_torch.utils.profiling import (  # noqa: E402
    DEVICE_CATS,
    device_idle_by_span,
    reset_spans,
    span_summary,
    span_table,
    trace,
    trace_events,
)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


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

    src, tgt = reqs[1]
    reset_spans()
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp):
            device_matcher.match(src, tgt)
            _sync(device)
        events = trace_events(tmp)
    spans = span_summary()
    idle = device_idle_by_span(events) if device.type == "cuda" else None
    print(f"[spans] one request, prep=device, traced; {card}")
    for line in span_table(spans, idle):
        print(f"[spans] {line}")
    ops = collections.Counter()
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            ops[e["name"][:90]] += float(e.get("dur", 0)) / 1e3
    for name, ms in ops.most_common(15):
        print(f"[profile] {ms:9.3f} ms  {name}")
    if args.json:
        Path(args.json).write_text(json.dumps(dict(
            card=card, requests=rows, spans=spans, idle_ms_by_span=idle,
            profile_top=ops.most_common(15)), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
