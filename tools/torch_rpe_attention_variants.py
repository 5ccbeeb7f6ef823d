"""Variants of the RPE attention kernels, backward and forward, timed side by side.

    python3 tools/torch_rpe_attention_variants.py                 # on a CUDA card
    python3 tools/torch_rpe_attention_variants.py --baseline old_rpe_attention.cu

Builds roitr_torch/csrc/rpe_attention.cu as it is and edited copies of it
(each one nvcc, all at once, into build/rpe_variants/), holds every variant
that keeps the result against the plain versions, and times all of them in
turns (each variant twice in each of two passes, in order and reversed) at
N 512, D 256, H 4, bf16 embedding, 480 valid keys, by CUDA events over 10
launches of the C entry points: the backward, and the forward without and
with the log-sum-exps. `--baseline` takes an older source with the
two-kernel backward (`rpe_attention_bwd_rows` + `_keys`, no log-sum-exp
output), e.g. `git show <commit>:roitr_torch/csrc/rpe_attention.cu` into
a git-ignored directory such as `chip_tree/`. Variants:

  current                the source as it is
  unroll1, unroll4       each group of threads takes one / four keys at once (and
                         so the butterfly of every sum, as generic_reduction)
  generic_reduction      the butterfly of every sum on every lane, in place of the
                         recursive halving of the main path
  stages4                a ring of four stages (three tiles in flight)
  stage18k               ring stages of 18 KB (36 KB as it is)
  minblocks2             the row kernel held to 128 registers (two blocks an SM)
  split8                 the key reduction's rows in 8 ranges (4 as it is)
  diag_rows_only         the row kernel alone (no products before or after)
  diag_no_key_reduction  without the products that give dq, dk and dv
  diag_no_demb_store     demb computed but not stored (wrong output)
  diag_no_row_chain      without the prologue's ghid . hidden chains (wrong)
  diag_loads_only        the ring streams the embedding; no key is computed
  diag_no_exp            both probabilities without their exp2f (wrong)
  diag_no_scratch        ds and attn of the main path's reduction not written to the
                         scratch (wrong dq, dk, dv)
  baseline               the older source (--baseline)
  baseline_rows_only     its row kernel alone (the key reduction removed)

The row kernel's time is diag_rows_only's; the products before it take
diag_no_key_reduction - diag_rows_only, the key reduction current -
diag_no_key_reduction. Prints ptxas's registers, spills and shared memory of
each variant's kernels and, on each line, the card's name and power limit;
with `--sass`, the instruction mix of the current row kernel (bf16, H <= 4)
from `cuobjdump -sass`.
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
from roitr_torch.kernels.rpe_attention_kernel import (  # noqa: E402
    rpe_attention_bwd_plain,
    rpe_attention_plain,
)

N, D, H, VALID = 512, 256, 4, 480

PRE = ("  cudaError_t err = launch_products<64, 64>(pre, 2, stream);\n"
       "  if (err != cudaSuccess) return (int)err;\n")
POST = ("  err = launch_products<64, 32>(post, 3, stream);\n  if (err != cudaSuccess) return (int)err;\n"
        "  rpe_sum_splits<<<")
EDITS = {
    "unroll1": [("constexpr int kUnroll = 2;", "constexpr int kUnroll = 1;")],
    "unroll4": [("constexpr int kUnroll = 2;", "constexpr int kUnroll = 4;")],
    "stages4": [("constexpr int kStages = 3;", "constexpr int kStages = 4;")],
    "stage18k": [("constexpr int kStageBytes = 36864;", "constexpr int kStageBytes = 18432;")],
    "diag_no_row_chain": [("#pragma unroll 16\n    for (int cc = 0; cc < c; ++cc) {",
                           "#pragma unroll 16\n    for (int cc = 0; cc < 0; ++cc) {")],
    "generic_reduction": [("constexpr bool kWarpKeys = MAXH == 4 && kUnroll == 2;",
                           "constexpr bool kWarpKeys = false;")],
    "minblocks2": [("__global__ void __launch_bounds__(kBwdThreads)\nrpe_attention_bwd_rows(",
                    "__global__ void __launch_bounds__(kBwdThreads, 2)\nrpe_attention_bwd_rows(")],
    "diag_loads_only": [("    for (int kb = grp; kb < kt; kb += kpi * kUnroll) {",
                         "    for (int kb = grp; kb < 0; kb += kpi * kUnroll) {")],
    "diag_no_exp": [("pa = on ? exp2f(fmaf(x, scale2, -lse2a)) : 0.f;",
                     "pa = on ? fmaf(x, scale2, -lse2a) : 0.f;"),
                    ("pp = on_p ? exp2f(fmaf(x, scale2, -lse2p)) : 0.f;",
                     "pp = on_p ? fmaf(x, scale2, -lse2p) : 0.f;")],
    "diag_no_scratch": [("          ds_out[o] = ds;\n          attn_out[o] = pa;\n", "")],
    "diag_rows_only": [(PRE, "  cudaError_t err;\n"),
                       (POST, "  return 0;\n  rpe_sum_splits<<<")],
    "diag_no_key_reduction": [(POST, "  return 0;\n  rpe_sum_splits<<<")],
    "split8": [("constexpr int kSplitK = 4;", "constexpr int kSplitK = 8;")],
    "diag_no_demb_store": [
        ("        if (valid[u] && active)\n          store_cols(",
         "        if (valid[u] && active && de[0] == -1.2345e-38f)\n          store_cols(")],
}
BASELINE_EDITS = {
    "baseline_rows_only": [(
        "  rpe_attention_bwd_keys<<<(n + kKeys - 1) / kKeys, kThreads, 0, stream>>>(\n"
        "      q2, ghid, ds_scratch, attn_scratch, dk, dv, n, d, heads);\n", "")],
}
DIAGNOSTIC = ("diag_rows_only", "diag_no_key_reduction", "diag_no_demb_store",
              "diag_no_row_chain", "diag_loads_only", "diag_no_exp",
              "diag_no_scratch", "baseline_rows_only")


def card_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return f"card {smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else 'unknown'}"


def kernel_label(mangled: str) -> str:
    dtype = "bf16" if "bfloat16" in mangled else "fp32"
    heads = next((h for h in ("16", "8", "4") if f"Li{h}E" in mangled), "")
    for name in ("rpe_attention_bwd_rows", "rpe_attention_bwd_keys", "rpe_products",
                 "rpe_attention_kernel"):
        if name in mangled:
            return f"{name}<{dtype}, H <= {heads}>" if heads else name
    return mangled


def edited(text: str, edits, name: str) -> str:
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"variant {name}: the source no longer has {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build(sources):
    """{name: source text} -> {name: CDLL}; prints registers, spills and
    static shared memory of the H <= 4 kernels."""
    out_dir = ROOT / "build" / "rpe_variants"
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
        found = re.findall(r"Function properties for (\w+)\n\s*(\d+) bytes stack frame, "
                           r"(\d+) bytes spill stores[^\n]*\n[^\n]*Used (\d+) registers"
                           r"(?:[^\n]*?(\d+) bytes smem)?", log)
        found = [f for f in found if "Li4E" in f[0] or "rpe_products" in f[0]
                 or "bwd_keys" in f[0]]
        print(f"[build] {name}: " + "; ".join(
            f"{kernel_label(m)} {regs} registers, {spill} bytes spilled, {stack} bytes stack, "
            f"{smem or 0} bytes static smem" for m, stack, spill, regs, smem in found), flush=True)
        libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
    return libs


def print_sass_mix(lib: Path, card: str) -> None:
    """Opcode counts of the bf16, H <= 4 row kernel's SASS (static, the
    whole function: the key loop is unrolled kUnroll times)."""
    cuobjdump = Path(nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300).stdout
    counts, inside = {}, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = "rpe_attention_bwd_rows" in line and "bfloat16Li4E" in line
        elif inside:
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", line)
            if m:
                op = m.group(1).split(".")[0]
                counts[op] = counts.get(op, 0) + 1
    top = sorted(counts.items(), key=lambda kv: -kv[1])
    print(f"[sass] rpe_attention_bwd_rows<bf16, H <= 4>: {sum(counts.values())} instructions; "
          + ", ".join(f"{op} {n}" for op, n in top[:25]) + f"; {card}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="an older rpe_attention.cu to time beside the current one")
    ap.add_argument("--sass", action="store_true", help="print the row kernel's instruction mix")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    src = (ROOT / "roitr_torch" / "csrc" / "rpe_attention.cu").read_text()
    sources = {"current": src}
    sources.update({name: edited(src, e, name) for name, e in EDITS.items()})
    if args.baseline:
        base = Path(args.baseline).read_text()
        sources["baseline"] = base
        sources.update({name: edited(base, e, name) for name, e in BASELINE_EDITS.items()})
    libs = build(sources)
    if "current" not in libs:
        return 1
    if args.sass:
        print_sass_mix(ROOT / "build" / "rpe_variants" / "libcurrent.so", card)

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    q2, k2, v2, ghid = (torch.randn(N, D, generator=g).to(dev) for _ in range(4))
    qwp = (torch.randn(N, H, D, generator=g) * 0.1).to(dev)
    gae = torch.randn(N, H, D, generator=g).to(dev)
    embed = (torch.randn(N, N, D, generator=g) * 0.5).to(dev, torch.bfloat16)
    mask = (torch.arange(N) < VALID).float().to(dev)
    f32 = dict(dtype=torch.float32, device=dev)
    hid, ae = torch.empty((N, D), **f32), torch.empty((N, H, D), **f32)
    lse_a, lse_p = torch.empty((N, H), **f32), torch.empty((N, H), **f32)
    dq, dk, dv = (torch.empty((N, D), **f32) for _ in range(3))
    dqwp = torch.empty((N, H, D), **f32)
    demb = torch.empty_like(embed)
    scratch = torch.empty((4 * N * H * N + 3 * 8 * N * D,), **f32)  # room for kSplitK 8
    vp = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)  # noqa: E731
    new_api = {name: hasattr(lib, "roitr_rpe_attention_bwd_takes") for name, lib in libs.items()}
    # the current source's forward and backward take a pair count before N;
    # --baseline sources (and their edits) predate it
    batch_api = {name: not name.startswith("baseline") for name in libs}

    def forward(lib, name, with_lse=True):
        fn = lib.roitr_rpe_attention
        if batch_api[name]:
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            lse = (vp(lse_a), vp(lse_p)) if with_lse else (None, None)
            err = fn(vp(q2), vp(k2), vp(v2), vp(qwp), vp(embed), vp(mask), vp(hid), vp(ae), *lse,
                     1, N, D, H, 1, stream())
        elif new_api[name]:
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            lse = (vp(lse_a), vp(lse_p)) if with_lse else (None, None)
            err = fn(vp(q2), vp(k2), vp(v2), vp(qwp), vp(embed), vp(mask), vp(hid), vp(ae), *lse,
                     N, D, H, 1, stream())
        else:
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            err = fn(vp(q2), vp(k2), vp(v2), vp(qwp), vp(embed), vp(mask), vp(hid), vp(ae),
                     N, D, H, 1, stream())
        if err:
            raise RuntimeError(f"{name}: forward launch failed: cudaError {err}")

    def backward(lib, name):
        fn = lib.roitr_rpe_attention_bwd
        if batch_api[name]:
            fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            err = fn(vp(q2), vp(k2), vp(v2), vp(qwp), vp(embed), vp(mask), vp(ghid), vp(gae),
                     vp(hid), vp(ae), vp(lse_a), vp(lse_p), vp(dq), vp(dk), vp(dv), vp(dqwp),
                     vp(demb), vp(scratch), 1, N, D, H, 1, stream())
        elif new_api[name]:
            fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            err = fn(vp(q2), vp(k2), vp(v2), vp(qwp), vp(embed), vp(mask), vp(ghid), vp(gae),
                     vp(hid), vp(ae), vp(lse_a), vp(lse_p), vp(dq), vp(dk), vp(dv), vp(dqwp),
                     vp(demb), vp(scratch), N, D, H, 1, stream())
        else:
            half = scratch.numel() // 2
            fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            err = fn(vp(q2), vp(k2), vp(v2), vp(qwp), vp(embed), vp(mask), vp(ghid), vp(gae),
                     vp(dq), vp(dk), vp(dv), vp(dqwp), vp(demb), vp(scratch),
                     ctypes.c_void_p(scratch.data_ptr() + 4 * half), N, D, H, 1, stream())
        if err:
            raise RuntimeError(f"{name}: backward launch failed: cudaError {err}")

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

    ref = rpe_attention_bwd_plain(q2, k2, v2, qwp, embed, mask, ghid, gae)
    ref_h, ref_ae, ref_la, ref_lp = rpe_attention_plain(q2, k2, v2, qwp, embed, mask, True)
    for name, lib in libs.items():
        forward(lib, name)
        backward(lib, name)
        torch.cuda.synchronize()
        errs = []
        for label, a, b in zip(("dq", "dk", "dv", "dqwp", "demb"), (dq, dk, dv, dqwp, demb), ref):
            top = float(b.float().abs().max())
            tol = top / 128 if label == "demb" else 1e-4 * top
            errs.append(f"{label} {float((a.float() - b.float()).abs().max()):.3g} (tol {tol:.3g})")
        fwd = float(max((hid - ref_h).abs().max(), (ae - ref_ae).abs().max()))
        if new_api[name]:
            fin = torch.isfinite(ref_la) & torch.isfinite(ref_lp)
            fwd_lse = max(float((lse_a - ref_la)[fin].abs().max()),
                          float((lse_p - ref_lp)[fin].abs().max()))
            fwd_txt = f"forward {fwd:.3g}, log-sum-exps {fwd_lse:.3g}"
        else:
            fwd_txt = f"forward {fwd:.3g}"
        print(f"[check] {name}{' (diagnostic)' if name in DIAGNOSTIC else ''}: max abs err "
              f"{'; '.join(errs)}; {fwd_txt}; {card}", flush=True)

    cases = {"bwd": lambda lib, name: backward(lib, name),
             "fwd": lambda lib, name: forward(lib, name, with_lse=False),
             "fwd lse": lambda lib, name: forward(lib, name, with_lse=True)}
    order = list(libs)
    times = {name: {c: [] for c in cases} for name in order}
    for name in order:  # the baseline forward has no log-sum-exp output
        if not new_api[name]:
            del times[name]["fwd lse"]
    for _ in range(2):
        for name in order + order[::-1]:
            for c in times[name]:
                times[name][c].append(ms(lambda: cases[c](libs[name], name)))
    for name, per in times.items():
        print(f"[time] {name}: " + "; ".join(
            f"{c} {min(t):.3f} ms (runs {', '.join(f'{x:.3f}' for x in t)})"
            for c, t in per.items()) + f"; {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
