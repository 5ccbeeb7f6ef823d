"""Variants of the geometric-embedding forward kernel, timed side by side.

    python3 tools/torch_geo_embedding_variants.py                 # on a CUDA card
    python3 tools/torch_geo_embedding_variants.py --baseline old_geo_embedding.cu

Builds roitr_torch/csrc/geo_embedding.cu as it is and edited copies of it
(each one nvcc, all at once, into build/geo_variants/), holds every variant
that computes the same function against the plain version, and times all of
them in turns (each variant twice in each of two passes, forwards then
backwards) at R 262144, H 256, k 3 with bf16 output, with and without the
argmax map, by CUDA events over 10 launches of the C entry point. Variants:

  current        the source as it is
  baseline       another source file of the same C interface (--baseline)
  no_stagger     every warp generates the next basis before its products
  w32            16 warps of 32 x 32 output columns instead of 8 of 32 x 64
  fastsin        explicit reduction to [-pi, pi], then __sincosf
  diag_no_products      the mma instructions removed (wrong output)
  diag_no_basis         no basis generated after the first slice (wrong)
  diag_one_product      hi.hi only (fp32 accuracy lost)

It also times the Python entry `fused_geo_embedding` on the same inputs,
which adds the weight split's launch, the even / odd weight copies and the
frequencies. Prints ptxas's registers and spills of each variant and, on
each line, the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from roitr_torch.kernels.build import NVCC_FLAGS, nvcc  # noqa: E402
from roitr_torch.kernels.geo_embedding_kernel import (  # noqa: E402
    _kernel_args,
    fused_geo_embedding,
    geo_embedding_plain,
)

R, K, H = 262144, 3, 256

STAGGER = [
    ("      if (gen_first) gen_a(it + 1, st ^ 1);", "      gen_a(it + 1, st ^ 1);"),
    ("    if (!gen_first && it + 1 < steps) gen_a(it + 1, st ^ 1);\n", ""),
]
FASTSIN = """{
        const float v = x * div[j0 + i];
        const float n = rintf(v * 0.15915494309189535f);
        float r = fmaf(-n, 6.28318548202514648f, v);
        r = fmaf(-n, -1.7484555314695172e-07f, r);
        __sincosf(r, &sv[i], &cv[i]);
      }"""
EDITS = {
    "no_stagger": STAGGER,
    "w32": [("constexpr int kWN = 64; ", "constexpr int kWN = 32; ")],
    "fastsin": [("sincosf(x * div[j0 + i], &sv[i], &cv[i]);", FASTSIN)],
    "diag_no_products": [(
        '      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "\n'
        '      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"',
        '      ""')],
    "diag_no_basis": [("      if (gen_first) gen_a(it + 1, st ^ 1);", ""),
                      ("    if (!gen_first && it + 1 < steps) gen_a(it + 1, st ^ 1);\n", "")],
    "diag_one_product": [
        ("            if (p == 0) mma_bf16(c, al[mt], bh[np][2 * q], bh[np][2 * q + 1]);\n"
         "            else if (p == 1) mma_bf16(c, ah[mt], bl[np][2 * q], bl[np][2 * q + 1]);\n"
         "            else mma_bf16",
         "            if (p == 2) mma_bf16")],
}


def card_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return f"card {smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else 'unknown'}"


def build(sources):
    """{name: source text} -> {name: CDLL}; prints registers and spills."""
    out_dir = ROOT / "build" / "geo_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", str(out_dir / f"lib{name}.so"),
                                        str(cu)], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"[build] {name}: nvcc exit {proc.returncode}\n{log[-2000:]}", flush=True)
            continue
        found = re.findall(r"geo_embedding_kernelILb(\d)E[^\n]*\n[^\n]*?(\d+) bytes stack frame, "
                           r"(\d+) bytes spill stores[^\n]*\n[^\n]*Used (\d+) registers", log)
        print(f"[build] {name}: " + "; ".join(
            f"{'map' if m == '1' else 'no map'} {regs} registers, {spill} bytes spilled, "
            f"{stack} bytes stack" for m, stack, spill, regs in found), flush=True)
        libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="another geo_embedding.cu to time beside the current one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    src = (ROOT / "roitr_torch" / "csrc" / "geo_embedding.cu").read_text()
    sources = {"current": src}
    if args.baseline:
        sources["baseline"] = Path(args.baseline).read_text()
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name}: the source no longer has {old[:60]!r}")
            text = text.replace(old, new)
        sources[name] = text
    libs = build(sources)

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    d = (torch.rand(R, generator=g) * 20).to(dev)  # the smoke's indices reach 21 and 12
    a = (torch.rand(R, K, generator=g) * 12).to(dev)
    a[::4, 1] = a[::4, 0]  # a quarter of the rows with a repeated neighbour
    w = [((torch.rand(*s, generator=g) * 2 - 1) / 16).to(dev) for s in ((H, H), (H,), (H, H), (H,))]
    kargs = _kernel_args(d, a, H, *w)
    ref, ref_map = geo_embedding_plain(d, a, *w, with_argmax=True)
    top = float(ref.abs().max())
    wsplit = torch.empty(1 << 21, dtype=torch.bfloat16, device=dev)
    out32 = torch.empty(R, H, device=dev)
    out16 = torch.empty(R, H, device=dev, dtype=torch.bfloat16)
    amap = torch.empty(R, H, device=dev, dtype=torch.int8)

    def launch(lib, out, with_map):
        fn = lib.roitr_geo_embedding
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        err = fn(*(ctypes.c_void_p(t.data_ptr()) for t in kargs), ctypes.c_void_p(out.data_ptr()),
                 ctypes.c_void_p(amap.data_ptr() if with_map else None),
                 ctypes.c_void_p(wsplit.data_ptr()), R, K, H, int(out.dtype == torch.bfloat16),
                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")

    def ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    for name, lib in libs.items():
        launch(lib, out32, True)
        torch.cuda.synchronize()
        print(f"[check] {name}: fp32 max abs err {float((out32 - ref).abs().max()):.3g} (1e-4 * "
              f"max|ref| = {1e-4 * top:.3g}); map entries off the plain argmax "
              f"{int((amap != ref_map).sum())} of {amap.numel()}; {card}", flush=True)

    times = {name: ([], []) for name in libs}
    order = list(libs)
    for _ in range(2):
        for name in order + order[::-1]:
            times[name][0].append(ms(lambda: launch(libs[name], out16, False)))
            times[name][1].append(ms(lambda: launch(libs[name], out16, True)))
    for name, (plain, mapped) in times.items():
        print(f"[time] {name}: {min(plain):.3f} ms without the map (runs "
              f"{', '.join(f'{t:.3f}' for t in plain)}), {min(mapped):.3f} ms with it; {card}",
              flush=True)
    entry = [ms(lambda: fused_geo_embedding(d, a, *w, out_dtype=torch.bfloat16)) for _ in range(4)]
    print(f"[time] fused_geo_embedding (the built library, through the wrapper): "
          f"{min(entry):.3f} ms (runs {', '.join(f'{t:.3f}' for t in entry)}); {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
