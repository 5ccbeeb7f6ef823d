"""Variants of the geometric-embedding kernels, forward and backward, timed side by side.

    python3 tools/torch_geo_embedding_variants.py                 # on a CUDA card
    python3 tools/torch_geo_embedding_variants.py --baseline old_geo_embedding.cu

Builds roitr_torch/csrc/geo_embedding.cu as it is and edited copies of it
(each one nvcc, all at once, into build/geo_variants/), holds every variant
against the plain versions, and times all of them in turns (each variant
twice in each of two passes, forwards then backwards) at R 262144, H 256,
k 3, by CUDA events over 10 launches of the C entry points: the forward
with bf16 output, without and with the argmax map, and the backward with a
bf16 and with an fp32 cotangent. An edit applies to both kernels wherever
its text occurs. Variants:

  current        the source as it is
  baseline       another source file of the same C interface (--baseline)
  no_stagger     every warp generates the next basis before its products
  libm_sincos    sincosf of the unreduced argument in place of the
                 reduction to [-pi, pi] and __sincosf
  diag_no_products      the mma instructions removed (wrong output)
  diag_no_basis         no basis generated after the first step (wrong)
  diag_one_product      hi.hi only (fp32 accuracy lost)

It also times the Python entries `fused_geo_embedding` and
`geo_embedding_bwd` on the same inputs (the forward adds the weight split's
launch, the even / odd weight copies and the frequencies). Prints ptxas's
registers and spills of each variant's kernels and, on each line, the
card's name and power limit.
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
    _BWD_TARGET_BLOCKS,
    _kernel_args,
    fused_geo_embedding,
    geo_embedding_bwd,
    geo_embedding_bwd_plain,
    geo_embedding_plain,
)

R, K, H = 262144, 3, 256

STAGGER = [
    ("      if (gen_first) gen_a(it + 1, st ^ 1);", "      gen_a(it + 1, st ^ 1);"),
    ("    if (!gen_first && it + 1 < steps) gen_a(it + 1, st ^ 1);\n", ""),
    ("    if (gen_first && it + 1 < steps) gen_basis(", "    if (it + 1 < steps) gen_basis("),
    ("    if (!gen_first && it + 1 < steps) gen_basis(it + 1, st ^ 1);\n", ""),
]
EDITS = {
    "no_stagger": STAGGER,
    "libm_sincos": [("  __sincosf(r, &s, &c);", "  sincosf(v, &s, &c);")],
    "diag_no_products": [(
        '      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "\n'
        '      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"',
        '      ""')],
    "diag_no_basis": [("      if (gen_first) gen_a(it + 1, st ^ 1);", ""),
                      ("    if (!gen_first && it + 1 < steps) gen_a(it + 1, st ^ 1);\n", ""),
                      ("    if (gen_first && it + 1 < steps) gen_basis(it + 1, st ^ 1);\n", ""),
                      ("    if (!gen_first && it + 1 < steps) gen_basis(it + 1, st ^ 1);\n", "")],
    "diag_one_product": [  # the same lines in the forward's and the backward's products
        ("            if (p == 0) mma_bf16(c, al[mt], bh[np][2 * q], bh[np][2 * q + 1]);\n"
         "            else if (p == 1) mma_bf16(c, ah[mt], bl[np][2 * q], bl[np][2 * q + 1]);\n"
         "            else mma_bf16",
         "            if (p == 2) mma_bf16")],
}


def card_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return f"card {smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else 'unknown'}"


def kernel_label(mangled: str) -> str:
    if "bwd_kernel" in mangled:
        return f"backward {'bf16' if 'bfloat16' in mangled else 'fp32'} g"
    return f"forward {'map' if 'ILb1E' in mangled else 'no map'}"


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
        found = [f for f in re.findall(r"Function properties for (\w+)\n\s*(\d+) bytes stack frame, "
                                       r"(\d+) bytes spill stores[^\n]*\n[^\n]*Used (\d+) "
                                       r"registers", log)
                 if re.search(r"geo_embedding_(bwd_)?kernel", f[0])]
        print(f"[build] {name}: " + "; ".join(
            f"{kernel_label(m)} {regs} registers, {spill} bytes spilled, {stack} bytes stack"
            for m, stack, spill, regs in found), flush=True)
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
    cot16 = torch.randn(R, H, generator=g).to(dev, torch.bfloat16)
    cot32 = torch.randn(R, H, generator=g).to(dev)
    dref = {c.dtype: geo_embedding_bwd_plain(d, a, ref_map, c, H) for c in (cot16, cot32)}
    chunks = -(-_BWD_TARGET_BLOCKS // (H // 2 // 32))
    part = torch.empty(16 * chunks, 4, H // 2, H, device=dev)
    part_db = torch.empty(16 * chunks, H, device=dev)
    dw = torch.empty(4, H // 2, H, device=dev)
    db = torch.empty(H, device=dev)
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)  # noqa: E731
    vp = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731

    def launch(lib, out, with_map):
        fn = lib.roitr_geo_embedding
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        err = fn(*(vp(t) for t in kargs), vp(out),
                 ctypes.c_void_p(amap.data_ptr() if with_map else None),
                 vp(wsplit), R, K, H, int(out.dtype == torch.bfloat16), stream())
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")

    def launch_bwd(lib, cot, n_chunks=chunks):
        fn = lib.roitr_geo_embedding_bwd
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        err = fn(vp(d), vp(a), vp(ref_map), vp(cot), vp(kargs[2]), vp(part), vp(part_db), vp(dw),
                 vp(db), R, K, H, n_chunks, int(cot.dtype == torch.bfloat16), stream())
        if err:
            raise RuntimeError(f"backward launch failed: cudaError {err}")

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

    def bwd_out():
        return (torch.stack([dw[0], dw[1]], 1).reshape(H, H), db.clone(),
                torch.stack([dw[2], dw[3]], 1).reshape(H, H))

    for name, lib in libs.items():
        launch(lib, out32, True)
        torch.cuda.synchronize()
        print(f"[check] {name}: forward fp32 max abs err {float((out32 - ref).abs().max()):.3g} "
              f"(1e-4 * max|ref| = {1e-4 * top:.3g}); map entries off the plain argmax "
              f"{int((amap != ref_map).sum())} of {amap.numel()}; {card}", flush=True)
        for cot in (cot16, cot32):
            launch_bwd(lib, cot)
            torch.cuda.synchronize()
            got = bwd_out()
            err = max(float((x - y).abs().max()) for x, y in zip(got, dref[cot.dtype]))
            dtop = max(float(y.abs().max()) for y in dref[cot.dtype])
            print(f"[check] {name}: backward {str(cot.dtype)[6:]} g max abs err {err:.3g} "
                  f"(1e-4 * max|ref| = {1e-4 * dtop:.3g}); {card}", flush=True)

    # the backward's error against a float64 reference as its chunks of rows
    # shorten: the tensor cores' fp32 accumulation loses more over longer ones
    ref64 = geo_embedding_bwd_plain(d.double(), a.double(), ref_map, cot16.double(), H)
    top64 = max(float(y.abs().max()) for y in ref64)
    rel = lambda got: max(float((x.double() - y).abs().max()) for x, y in zip(got, ref64)) / top64  # noqa: E731
    for n in (chunks, 4 * chunks, 16 * chunks):
        launch_bwd(libs["current"], cot16, n)
        torch.cuda.synchronize()
        print(f"[check] current: backward bf16 g in {n} chunks of {-(-R // n)} rows, max abs err "
              f"over max|ref| against float64 {rel(bwd_out()):.3g} (the fp32 plain version "
              f"{rel(dref[torch.bfloat16]):.3g}); {card}", flush=True)
    del ref64

    cases = {"fwd": lambda lib: launch(lib, out16, False), "fwd map": lambda lib: launch(
        lib, out16, True), "bwd bf16 g": lambda lib: launch_bwd(lib, cot16),
             "bwd fp32 g": lambda lib: launch_bwd(lib, cot32)}
    times = {name: {c: [] for c in cases} for name in libs}
    order = list(libs)
    for _ in range(2):
        for name in order + order[::-1]:
            for c, fn in cases.items():
                times[name][c].append(ms(lambda: fn(libs[name])))
    for name, per in times.items():
        print(f"[time] {name}: " + "; ".join(
            f"{c} {min(t):.3f} ms (runs {', '.join(f'{x:.3f}' for x in t)})"
            for c, t in per.items()) + f"; {card}", flush=True)
    entry = [ms(lambda: fused_geo_embedding(d, a, *w, out_dtype=torch.bfloat16)) for _ in range(4)]
    print(f"[time] fused_geo_embedding (the built library, through the wrapper): "
          f"{min(entry):.3f} ms (runs {', '.join(f'{t:.3f}' for t in entry)}); {card}", flush=True)
    entry = [ms(lambda: geo_embedding_bwd(d, a, ref_map, cot16, H)) for _ in range(4)]
    print(f"[time] geo_embedding_bwd, bf16 g (the built library, through the wrapper): "
          f"{min(entry):.3f} ms (runs {', '.join(f'{t:.3f}' for t in entry)}); {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
