"""Variants of the Sinkhorn kernels, forward and backward, timed side by side.

    python3 tools/torch_sinkhorn_variants.py                      # on a CUDA card
    python3 tools/torch_sinkhorn_variants.py --baseline old_sinkhorn.cu

Builds roitr_torch/csrc/sinkhorn.cu as it is and edited copies of it (each
one nvcc, all at once, into build/sinkhorn_variants/), holds every variant
against the plain versions, and times all of them in turns (each variant in
each of two passes, in order and reversed) by CUDA events over 20 launches
of the C entry points at the main path's shapes: the forward at
(256, 65, 65) x 100 (serving) and at (128, 65, 65) x 100 without and with
the trajectory (training), the backward at (128, 65, 65) x 100 from the
trajectory (training) and making it first (`sinkhorn_bwd` without one).
`--baseline` takes an older source with the C interface from before the
trajectory (its backward recomputes it), e.g. `git show
<commit>:roitr_torch/csrc/sinkhorn.cu` into a git-ignored directory such as
`chip_tree/`. Variants:

  current             the source as it is
  fwd_group1          one lane a line in the forward (two as it is)
  group4              four lanes a line, forward and backward (two as they are)
  diag_no_exp         ex2 and lg2 replaced by two ALU operations that keep the
                      forward's sums in range (wrong output)
  diag_no_traj_write  the forward's trajectory computed but not stored (the
                      backward is given the current kernel's)
  rebase_always       the forward's lines shifted by their max at every step
                      (a max pass and a second read of the patch)
  diag_no_line64      the warp of line 64 skips its reductions (wrong)
  diag_no_barrier     the line kernels' loop barriers made warp barriers (wrong)
  diag_loads_only     no iteration: the loads, the set-up and the stores
  baseline            the older source (--baseline)

Every backward is given the current kernel's trajectory. Prints ptxas's
registers, spills and shared memory of each variant's kernels, the line
kernels' resident blocks an SM, and on each line the card's name and power
limit; with `--sass`, the instruction mix of the current line kernels from
`cuobjdump -sass`.
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
from roitr_torch.kernels.sinkhorn_kernel import (  # noqa: E402
    sinkhorn_bwd_plain,
    sinkhorn_plain,
)
from roitr_torch.ops.sinkhorn import sinkhorn_inputs  # noqa: E402

K, T = 64, 100
TRAJ_U = "      if (kTraj) *tu = kLn2 * (mu2 - lr);\n"
TRAJ_V = "      if (kTraj) *tv = kLn2 * (nu2 - lc);\n"
EDITS = {
    "fwd_group1": [("constexpr int kFwdGroup = 2;", "constexpr int kFwdGroup = 1;")],
    "group4": [("constexpr int kFwdGroup = 2;", "constexpr int kFwdGroup = 4;"),
               ("constexpr int kBwdGroup = 2;", "constexpr int kBwdGroup = 4;")],
    "diag_no_exp": [('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
                     "y = fmaxf(x, -1.f) * 0.f + 1.f;"),
                    ('asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "y = fminf(x, 1.f);")],
    "diag_no_traj_write": [(TRAJ_U, ""), (TRAJ_V, "")],
    "diag_no_line64": [("grouped ? line_lse2<G>(sr, cr, v, s, true, line, q, m1, n1, it == 0)\n"
                        "                             : line_lse2<32>(sr, cr, v, s, true, line, q, m1, n1, it == 0);",
                        "grouped ? line_lse2<G>(sr, cr, v, s, true, line, q, m1, n1, it == 0) : 0.f;"),
                       ("grouped ? line_lse2<G>(sc, cc, u, s, false, line, q, m1, n1, it == 0)\n"
                        "                             : line_lse2<32>(sc, cc, u, s, false, line, q, m1, n1, it == 0);",
                        "grouped ? line_lse2<G>(sc, cc, u, s, false, line, q, m1, n1, it == 0) : 0.f;"),
                       ("grouped ? line_vjp<G>(sr, rsum, w, dv, ucur, q)\n"
                        "                             : line_vjp<32>(sr, rsum, w, dv, ucur, q);",
                        "grouped ? line_vjp<G>(sr, rsum, w, dv, ucur, q) : 0.f;"),
                       ("(grouped ? line_vjp<G>(sc, csum, z, du, vp, q)\n"
                        "                    : line_vjp<32>(sc, csum, z, du, vp, q));",
                        "(grouped ? line_vjp<G>(sc, csum, z, du, vp, q) : 0.f);")],
    "rebase_always": [("const bool rebase = first || ", "const bool rebase = true || ")],
    "diag_no_barrier": [("    }\n    __syncthreads();\n    const float lc",
                         "    }\n    __syncwarp();\n    const float lc"),
                        ("    }\n    __syncthreads();\n  }\n\n  if (out) {",
                         "    }\n    __syncwarp();\n  }\n\n  if (out) {"),
                        ("(t - 2) * m1 + line] : 0.f;\n    __syncthreads();",
                         "(t - 2) * m1 + line] : 0.f;\n    __syncwarp();"),
                        ("      w[line] = vp - nu2;\n    }\n    __syncthreads();",
                         "      w[line] = vp - nu2;\n    }\n    __syncwarp();")],
    "diag_loads_only": [("for (int it = 0; it < num_iter; ++it) {\n    const float lr",
                         "for (int it = 0; it < 0; ++it) {\n    const float lr"),
                        ("for (int t = last; t >= 0; --t) {",
                         "for (int t = last; t >= num_iter; --t) {")],
}
DIAGNOSTIC = ("diag_no_exp", "diag_no_line64", "diag_no_barrier", "diag_loads_only")
KERNELS = ("sinkhorn_lines_fwd", "sinkhorn_lines_bwd", "sinkhorn_bwd_kernel", "sinkhorn_kernel")


def card_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return f"card {smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else 'unknown'}"


def edited(text: str, edits, name: str) -> str:
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"variant {name}: the source no longer has {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build(sources):
    """{name: source text} -> {name: CDLL}; prints each kernel's registers,
    spills and static shared memory."""
    out_dir = ROOT / "build" / "sinkhorn_variants"
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
        parts = []
        for mangled, stack, spill, regs, smem in found:
            label = next((k for k in KERNELS if k in mangled), mangled)
            parts.append(f"{label} {regs} registers, {spill} bytes spilled, {stack} bytes stack, "
                         f"{smem or 0} bytes static smem")
        print(f"[build] {name}: " + "; ".join(parts), flush=True)
        libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
    return libs


def print_sass_mix(lib: Path, card: str) -> None:
    """Opcode counts of each line kernel's SASS (static, the whole
    function)."""
    cuobjdump = Path(nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300).stdout
    counts, inside = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            inside = next((k for k in KERNELS[:2] if k in line), None)
            if inside:
                counts[inside] = {}
        elif inside:
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", line)
            if m:
                op = m.group(1).split(".")[0]
                counts[inside][op] = counts[inside].get(op, 0) + 1
    for name, mix in counts.items():
        top = sorted(mix.items(), key=lambda kv: -kv[1])
        print(f"[sass] {name}: {sum(mix.values())} instructions; "
              + ", ".join(f"{op} {n}" for op, n in top[:25]) + f"; {card}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="an older sinkhorn.cu to time beside the current one")
    ap.add_argument("--sass", action="store_true", help="print the line kernels' instruction mix")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    src = (ROOT / "roitr_torch" / "csrc" / "sinkhorn.cu").read_text()
    sources = {"current": src}
    sources.update({name: edited(src, e, name) for name, e in EDITS.items()})
    if args.baseline:
        sources["baseline"] = Path(args.baseline).read_text()
    libs = build(sources)
    if "current" not in libs:
        return 1
    if args.sass:
        print_sass_mix(ROOT / "build" / "sinkhorn_variants" / "libcurrent.so", card)
    for name, lib in libs.items():
        if name == "baseline":
            continue
        fn = lib.roitr_sinkhorn_lines_blocks_per_sm
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        counts = []
        for which in (0, 1, 2):
            blocks, threads = ctypes.c_int(0), ctypes.c_int(0)
            if fn(which, ctypes.byref(blocks), ctypes.byref(threads)):
                raise SystemExit(f"{name}: occupancy query failed")
            counts.append(f"{blocks.value} of {threads.value} threads")
        print(f"[build] {name}: resident blocks an SM, forward {counts[0]}, with the trajectory "
              f"{counts[1]}, backward {counts[2]}", flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    cases = {}
    for p in (256, 128):
        scores = torch.randn(p, K, K, generator=gen).to(dev)
        rmask = (torch.rand(p, K, generator=gen) > 0.1).to(dev)
        cmask = (torch.rand(p, K, generator=gen) > 0.1).to(dev)
        rmask[-1] = False  # a fully masked patch slot
        padded, mu, nu, _ = sinkhorn_inputs(scores, rmask, cmask, torch.tensor(1.0, device=dev))
        cot = torch.randn(padded.shape, generator=gen).to(dev) * (padded > -1e5)
        cases[p] = (padded, mu, nu, cot)
    vp = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else None)  # noqa: E731
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)  # noqa: E731
    new_api = {name: name != "baseline" for name in libs}
    for name, lib in libs.items():
        if new_api[name]:
            lib.roitr_sinkhorn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
            lib.roitr_sinkhorn_bwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] + [
                ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        else:
            lib.roitr_sinkhorn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
            lib.roitr_sinkhorn_bwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]

    bufs = {}
    for p, (padded, mu, nu, _) in cases.items():
        bufs[p] = dict(out=torch.empty_like(padded), tu=padded.new_empty((p, T, K + 1)),
                       tv=padded.new_empty((p, T, K + 1)), scratch_u=padded.new_empty((p, T, K + 1)),
                       scratch_v=padded.new_empty((p, T, K + 1)), ds=torch.empty_like(padded),
                       dmu=torch.empty_like(mu), dnu=torch.empty_like(nu))

    def forward(name, p, traj, into=None):
        padded, mu, nu, _ = cases[p]
        b = bufs[p]
        lib = libs[name]
        if new_api[name]:
            tu, tv = (into or (b["scratch_u"], b["scratch_v"])) if traj else (None, None)
            err = lib.roitr_sinkhorn(vp(padded), vp(mu), vp(nu), vp(b["out"]), vp(tu), vp(tv),
                                     p, K + 1, K + 1, T, stream())
        else:
            err = lib.roitr_sinkhorn(vp(padded), vp(mu), vp(nu), vp(b["out"]), p, K + 1, K + 1,
                                     T, stream())
        if err:
            raise RuntimeError(f"{name}: forward launch failed: cudaError {err}")

    def backward(name, p, make):
        padded, mu, nu, cot = cases[p]
        b = bufs[p]
        lib = libs[name]
        if new_api[name]:
            tu, tv = (b["scratch_u"], b["scratch_v"]) if make else (b["tu"], b["tv"])
            err = lib.roitr_sinkhorn_bwd(vp(padded), vp(mu), vp(nu), vp(cot), vp(tu), vp(tv),
                                         int(make), vp(b["ds"]), vp(b["dmu"]), vp(b["dnu"]), p,
                                         K + 1, K + 1, T, stream())
        else:
            err = lib.roitr_sinkhorn_bwd(vp(padded), vp(mu), vp(nu), vp(cot), vp(b["ds"]),
                                         vp(b["dmu"]), vp(b["dnu"]), p, K + 1, K + 1, T, stream())
        if err:
            raise RuntimeError(f"{name}: backward launch failed: cudaError {err}")

    def ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    # the current kernel's trajectory, which every backward is given
    for p in cases:
        forward("current", p, True, into=(bufs[p]["tu"], bufs[p]["tv"]))
    refs = {p: (sinkhorn_plain(*cases[p][:3], T), sinkhorn_bwd_plain(*cases[p], T))
            for p in cases}
    for name in libs:
        errs = []
        for p in cases:
            forward(name, p, False)
            backward(name, p, False)
            torch.cuda.synchronize()
            ref_out, ref_bwd = refs[p]
            valid = ref_out > -1e5
            errs.append(f"P {p}: forward {float((bufs[p]['out'] - ref_out)[valid].abs().max()):.3g}, "
                        + ", ".join(f"{k} {float((bufs[p][k] - r).abs().max()) / float(r.abs().max()):.3g}"
                                    for k, r in zip(("ds", "dmu", "dnu"), ref_bwd))
                        + " of max|ref|")
        print(f"[check] {name}{' (diagnostic)' if name in DIAGNOSTIC else ''}: max abs err "
              f"{'; '.join(errs)} (tol forward 1e-4; ds 1e-4, dmu / dnu 1e-3); {card}",
              flush=True)

    timed = {"fwd P256": lambda n: forward(n, 256, False),
             "fwd P128": lambda n: forward(n, 128, False),
             "fwd P128 traj": lambda n: forward(n, 128, True),
             "bwd P128": lambda n: backward(n, 128, False),
             "bwd P128 made": lambda n: backward(n, 128, True)}
    order = list(libs)
    times = {name: {c: [] for c in timed if new_api[name] or "traj" not in c and "made" not in c}
             for name in order}
    for _ in range(2):
        for name in order + order[::-1]:
            for c in times[name]:
                times[name][c].append(ms(lambda: timed[c](name)))
    for name, per in times.items():
        print(f"[time] {name}: " + "; ".join(
            f"{c} {min(t):.4f} ms (runs {', '.join(f'{x:.4f}' for x in t)})"
            for c, t in per.items()) + f"; {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
