"""How far packed serving results sit from one-pair results, on a CUDA card.

    python3 tools/torch_packed_near_ties.py [--seeds 0 1 ... 15] [--out FILE]

For each seed: 8 synthetic pairs of 600-1000 points in the 1024 bucket
(numpy RandomState(seed), as tests/test_torch_cuda.py's
`test_match_batch_packed_on_card`, whose data is seed 9), a model made
from seed 1 at full 3DMatch width, every correspondence kept (confidence
threshold 0). Under prep="host" (host pyramids) and prep="device", each
pair's `Matcher.match_batch(mode="packed")` result against `Matcher.match`
of the same pair:

  fine   kept (src, tgt) pairs in one result only / in either
  flips  coarse (tgt node, src node) correspondences in one forward only
         (the packed forward against the single-pair forward)
  ot     the largest OT score difference on the patches both forwards share
  cos    node descriptors' least cosine similarity

With random weights the OT plan is near uniform, so fine top-k picks sit
at near-ties (~1e-7) that the packed forward's larger products (B * N
rows) round either way; these are the readings behind that test's bounds.
Prints one line a seed and prep, the card's name and power limit, and a
JSON summary as the last line (also written to --out).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from roitr_torch.config import Config  # noqa: E402
from roitr_torch.data.packing import pack_pairs  # noqa: E402
from roitr_torch.data.synthetic import make_pair_arrays  # noqa: E402
from roitr_torch.models.roitr import RoITr  # noqa: E402
from roitr_torch.ops.pyramid import device_prep_packed, device_prep_pair  # noqa: E402
from roitr_torch.serving import Matcher  # noqa: E402
from roitr_torch.utils.packing import to_device  # noqa: E402


def _rows(res):
    keys = np.concatenate([res["src_corr_pts"], res["tgt_corr_pts"]], axis=1)
    return set(map(tuple, keys.tolist()))


def _corr(out):
    """{(tgt node, src node): slot} of a forward's kept coarse correspondences."""
    return {(int(t), int(s)): j for j, (t, s, k) in enumerate(zip(
        out["tgt_node_corr_indices"], out["src_node_corr_indices"], out["node_corr_masks"])) if k}


def readings(matcher, cfg, clouds, prep, dev):
    """Per pair (fine apart, fine union, coarse flips, OT max err, node cos)."""
    got = matcher.match_batch(clouds, batch_size=len(clouds), mode="packed")
    est = (prep == "device",) * 2
    pairs = [matcher._prepare(src, tgt, None, None)[0] for src, tgt in clouds]
    cos = torch.nn.functional.cosine_similarity
    rows = []
    with torch.no_grad():
        batch = to_device(pack_pairs(pairs, require_pyramids=prep == "host"), dev)
        packed = matcher.model(device_prep_packed(batch, cfg, est,
                                                  pyramid=batch.src_pyramid is None))
        for i, ((src, tgt), pair) in enumerate(zip(clouds, pairs)):
            one = matcher.model(device_prep_pair(to_device(pair, dev), cfg, est))
            mine = {k: v[i] for k, v in packed.items()}
            a, b = _corr(mine), _corr(one)
            ot = 0.0
            for key in a.keys() & b.keys():
                x, y = mine["matching_scores"][a[key]], one["matching_scores"][b[key]]
                ot = max(ot, float(torch.where(y > -1e5, (x - y).abs(),
                                               torch.zeros_like(y)).max()))
            c = min(float(cos(mine[f"{s}_node_feats"][:int(one[f"{s}_node_count"])],
                              one[f"{s}_node_feats"][:int(one[f"{s}_node_count"])]).min())
                    for s in ("src", "tgt"))
            g, w = _rows(got[i]), _rows(matcher.match(src, tgt))
            rows.append((len(g ^ w), len(g | w), len(a.keys() ^ b.keys()), ot, c))
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(16)))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    summary = {"card": card, "seeds": args.seeds, "preps": {}}
    for prep in ("host", "device"):
        cfg = Config(benchmark="3DMatch", buckets=(1024,), points_limit=1024,
                     host_pyramid=prep == "host", fine_matching_confidence_threshold=0.0)
        matcher = Matcher(cfg, RoITr(cfg, device="cpu", seed=1).state_dict(), prep=prep)
        per_pair = []
        for seed in args.seeds:
            rng = np.random.RandomState(seed)
            clouds = []
            for _ in range(8):
                n, m = rng.randint(600, 1001, size=2)
                arr = make_pair_arrays(rng, 1024, n, m)
                clouds.append((arr["src_points"][:n], arr["tgt_points"][:m]))
            rows = readings(matcher, cfg, clouds, prep, dev)
            per_pair += [dict(seed=seed, pair=i, fine=d, union=u, flips=f, ot=o, cos=c)
                         for i, (d, u, f, o, c) in enumerate(rows)]
            print(f"prep={prep} seed {seed}: fine apart/union "
                  f"{' '.join(f'{d}/{u}' for d, u, *_ in rows)}; coarse flips "
                  f"{[f for _, _, f, _, _ in rows]}; OT max err "
                  f"{max(o for *_, o, _ in rows):.3g}; node cos min "
                  f"{min(c for *_, c in rows):.7f}; {card}", flush=True)
        shares = [p["fine"] / max(p["union"], 1) for p in per_pair if not p["flips"]]
        summary["preps"][prep] = {
            "pairs": len(per_pair),
            "pairs_with_flips": sum(1 for p in per_pair if p["flips"]),
            "fine_share_no_flip": {"max": max(shares, default=0.0),
                                   "p50": float(np.median(shares)) if shares else 0.0,
                                   "p95": float(np.percentile(shares, 95)) if shares else 0.0},
            "ot_max": max(p["ot"] for p in per_pair),
            "cos_min": min(p["cos"] for p in per_pair),
            "per_pair": per_pair,
        }
    print(card)
    line = json.dumps(summary)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(json.dumps({k: ({p: {kk: vv for kk, vv in v.items() if kk != "per_pair"}
                           for p, v in summary["preps"].items()} if k == "preps" else v)
                      for k, v in summary.items()}))


if __name__ == "__main__":
    main()
