"""Drive the PyTorch port (roitr_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. device    name, count, power limit and top SM clock of the card (fails
               without one); the clock and SM count give the special-function
               units' rate of exps and logs, a third term of the bounds
  2. build     nvcc of every kernel in roitr_torch/csrc/, with ptxas's report
               (the tensor-core geometric embedding's forward and backward:
               registers, spills and resident blocks an SM apart; the RPE
               attention's kernels: registers, spills, shared memory; the
               Sinkhorn kernels: registers, spills, shared memory, and the
               line kernels' resident blocks an SM)
  3. kernels   each kernel, forward and backward, against its plain PyTorch
               version on the card at the 32768-point bucket's shapes (FPS
               exact, the others within stated tolerances), timed with CUDA
               events; Sinkhorn's forward also with its trajectory output
               and against a float64 loop, its backward from that
               trajectory (training's) and making its own
  4. forward   one seeded pair at the 4096 bucket through RoITr on the card
               (kernels) and on the CPU (plain versions), same weights
  5. serving   Matcher.match at full 3DMatch width on three synthetic pairs
               of 20k-30k points (bucket 32768); launch counters are zeroed
               just before and read just after, and every forward kernel
               must have run
  6. train parity  one train step's forward, losses and backward at the
               4096 bucket on the card and on the CPU, same weights and
               Gumbel noise: losses and every parameter's gradient compared
  7. training  Trainer at full 3DMatch width (configs/train/tdmatch.yaml)
               for 3 train steps and 1 validation step on synthetic pairs of
               20k-30k points (bucket 32768), in a temporary directory;
               counters zeroed before and read after, and all seven kernels
               must have run
It then prints one JSON line with each kernel's numbers, the card's name
and power limit, and last the result line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 (non-tensor) FLOP/s
# and dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12
# exps and logs (MUFU.EX2, MUFU.LG2) a clock an SM on the special-function
# units; their rate a second, SFU_PER_S, is set from the card's SM count and
# top SM clock by phase_device
SFU_PER_CLOCK_SM = 16
SFU_PER_S = 0.0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of fn over reps launches after one warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, flops: float, peak: float = FP32_FLOP_PER_S, sfu: float = 0.0):
    """(ms, "bytes", "operations" or "sfu"): the largest of the bytes over
    HBM's rate, the operations over `peak` FLOP/s and the exps and logs
    (`sfu`) over the special-function units' rate."""
    times = {"bytes": bytes_moved / HBM_BYTES_PER_S * 1e3, "operations": flops / peak * 1e3,
             "sfu": sfu / SFU_PER_S * 1e3 if sfu else 0.0}
    by = max(times, key=times.get)
    return times[by], by


def phase_device():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: chip_smoke.py needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=60)
    if clock.returncode != 0:
        fail(f"nvidia-smi failed: {clock.stderr.strip()}")
    mhz = float(clock.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    global SFU_PER_S
    SFU_PER_S = SFU_PER_CLOCK_SM * sms * mhz * 1e6
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"nvidia-smi: {smi_line}, max SM clock {mhz:g} MHz, {sms} SMs: "
          f"{SFU_PER_S:.4g} exps a second on the SFUs; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi_line


def phase_build():
    from roitr_torch.kernels import build

    t0 = time.time()
    reports = build.build()
    print(f"[build] {len(reports)} kernels in {time.time() - t0:.1f} s", flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    # the tensor-core geometric embedding, forward (with and without the map)
    # and backward (bf16 and fp32 cotangent): registers, spills, blocks an SM
    import ctypes

    from roitr_torch.kernels.build import function

    def label(mangled):
        if "geo_embedding_bwd_kernel" in mangled:
            return f"geo_embedding_bwd_kernel<{'bf16' if 'bfloat16' in mangled else 'fp32'} g>"
        if "geo_embedding_kernel" in mangled:
            return f"geo_embedding_kernel<{'map' if 'ILb1E' in mangled else 'no map'}>"
        return None

    def rpe_label(mangled):
        heads = next((h for h in ("16", "8", "4") if f"Li{h}E" in mangled), "")
        dtype = "bf16" if "bfloat16" in mangled else "fp32"
        if "rpe_attention_bwd_rows" in mangled:
            return f"rpe_attention_bwd_rows<{dtype} e, H <= {heads}>"
        if "rpe_products" in mangled:
            return f"rpe_products<{'64, 64' if 'ILi64ELi64E' in mangled else '64, 32'}>"
        if "rpe_attention_kernel" in mangled:
            return f"rpe_attention_kernel<{dtype} e, H <= {heads}>"
        return None

    def sinkhorn_label(mangled):
        return next((k for k in ("sinkhorn_lines_fwd", "sinkhorn_lines_bwd", "sinkhorn_bwd_kernel",
                                 "sinkhorn_kernel") if k in mangled), None)

    for source, name_of in (("geo_embedding", label), ("rpe_attention", rpe_label),
                            ("sinkhorn", sinkhorn_label)):
        current = None
        for line in reports[source].splitlines():
            if "Compiling entry function" in line:
                current = name_of(line.split("'")[1])
            elif current and ("Used" in line or "spill" in line):
                print(f"[build] {current}: {line.split(':', 1)[-1].strip()}")
    for symbol, arg, name in (
            ("roitr_geo_embedding_blocks_per_sm", 1, "geo_embedding_kernel<map>"),
            ("roitr_geo_embedding_blocks_per_sm", 0, "geo_embedding_kernel<no map>"),
            ("roitr_geo_embedding_bwd_blocks_per_sm", 1, "geo_embedding_bwd_kernel<bf16 g>"),
            ("roitr_geo_embedding_bwd_blocks_per_sm", 0, "geo_embedding_bwd_kernel<fp32 g>")):
        blocks = ctypes.c_int(0)
        fn = function("geo_embedding", symbol, [ctypes.c_int, ctypes.c_void_p])
        if fn(arg, ctypes.byref(blocks)) != 0:
            fail(f"cudaOccupancyMaxActiveBlocksPerMultiprocessor failed for {name}")
        print(f"[build] {name}: {blocks.value} resident block(s) of 256 threads an SM")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for which, name in ((0, "sinkhorn_lines_fwd"), (1, "sinkhorn_lines_fwd with the trajectory"),
                        (2, "sinkhorn_lines_bwd")):
        blocks, threads = ctypes.c_int(0), ctypes.c_int(0)
        fn = function("sinkhorn", "roitr_sinkhorn_lines_blocks_per_sm",
                      [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
        if fn(which, ctypes.byref(blocks), ctypes.byref(threads)) != 0:
            fail(f"cudaOccupancyMaxActiveBlocksPerMultiprocessor failed for {name}")
        per_sm = {p: min(blocks.value, -(-p // sms)) for p in (256, 128)}
        print(f"[build] {name}: {blocks.value} resident block(s) of {threads.value} threads an "
              f"SM; patches an SM at most: {per_sm[256]} at P 256, {per_sm[128]} at P 128 "
              f"({sms} SMs)")
    smem = function("rpe_attention", "roitr_rpe_attention_bwd_smem_bytes", [ctypes.c_int] * 3,
                    ctypes.c_longlong)
    print(f"[build] rpe_attention_bwd_rows dynamic shared memory a block (any N): "
          f"{smem(256, 4, 1)} bytes at D 256, H 4, bf16; {smem(512, 4, 1)} at D 512", flush=True)


def phase_kernels(rng):
    """Each kernel against its plain version at the 32768 bucket's shapes."""
    from roitr_torch.data.synthetic import make_pair_arrays
    from roitr_torch.kernels.fps_kernel import fps_pairs, fps_plain
    from roitr_torch.kernels.geo_embedding_kernel import (
        fused_geo_embedding,
        geo_embedding_bwd,
        geo_embedding_bwd_plain,
        geo_embedding_bwd_split_plain,
        geo_embedding_plain,
        geo_embedding_split_plain,
    )
    from roitr_torch.kernels.rpe_attention_kernel import (
        fused_rpe_self_attention,
        rpe_attention_bwd,
        rpe_attention_bwd_onepass_plain,
        rpe_attention_bwd_plain,
        rpe_attention_plain,
    )
    from roitr_torch.kernels.sinkhorn_kernel import (
        sinkhorn_base2_plain,
        sinkhorn_bwd,
        sinkhorn_bwd_plain,
        sinkhorn_bwd_split_plain,
        sinkhorn_iterate,
        sinkhorn_plain,
    )
    from roitr_torch.models.embeddings import GeometricStructureEmbedding
    from roitr_torch.ops.sinkhorn import sinkhorn_inputs

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    rows = {}

    # ---- FPS: the three launches of one pair, (2, 32768) -> 8192 -> 2048 -> 512
    arr = make_pair_arrays(rng, 32768, 30000, 27000)
    pts = torch.from_numpy(np.stack([arr["src_points"], arr["tgt_points"]])).to(dev)
    cnt = torch.tensor([30000, 27000], dtype=torch.int32, device=dev)
    levels = []
    idx_err = 0  # largest |kernel index - plain index| over the three levels
    for _ in range(3):
        m = pts.shape[1] // 4
        levels.append((pts, cnt, m))
        idx = fps_pairs(pts, cnt, m)
        plain = fps_plain(pts, cnt, m)
        torch.cuda.synchronize()
        mism = int((idx != plain).sum())
        idx_err = max(idx_err, int((idx - plain).abs().max()))
        print(f"[kernels] fps ({pts.shape[0]}, {pts.shape[1]}) -> {m}: {mism} index mismatches",
              flush=True)
        if mism:
            fail(f"fps kernel differs from its plain version in {mism} indices")
        pts = torch.gather(pts, 1, idx.long()[:, :, None].expand(-1, -1, 3)).contiguous()
        cnt = torch.clamp(cnt // 4, min=1)
    ms = sum(cuda_ms(lambda a=a: fps_pairs(*a), 3) for a in levels)
    plain_ms = sum(cuda_ms(lambda a=a: fps_plain(*a), 1) for a in levels)
    ops = sum(9.0 * float(c.sum()) * (m - 1) for _, c, m in levels)  # 3 sub, 3 mul, 2 add, min
    byt = sum(p.numel() * 4 + p.shape[0] * m * 4 for p, _, m in levels)
    rows["fps"] = dict(max_abs_err=float(idx_err), ms=ms, plain_ms=plain_ms, bytes=byt, flops=ops)

    # ---- geometric embedding of one cloud's 512 nodes: R = 262144, H = 256
    nodes, ncount = pts[0], int(cnt[0])
    emb = GeometricStructureEmbedding(256).to(dev)
    with torch.no_grad():
        for lin in (emb.proj_d, emb.proj_a):
            lin.weight.copy_((torch.rand(256, 256, generator=gen) * 2 - 1) / 16)
            lin.bias.copy_((torch.rand(256, generator=gen) * 2 - 1) / 16)
        d_idx, a_idx = emb.indices(nodes, torch.tensor(ncount, device=dev))
        d_idx = d_idx.reshape(-1).contiguous()
        a_idx = a_idx.reshape(d_idx.shape[0], -1).contiguous()
        w = (emb.proj_d.weight.t(), emb.proj_d.bias, emb.proj_a.weight.t(), emb.proj_a.bias)
        got32 = fused_geo_embedding(d_idx, a_idx, *w, out_dtype=torch.float32)
        ref32 = geo_embedding_plain(d_idx, a_idx, *w, out_dtype=torch.float32)
        got = fused_geo_embedding(d_idx, a_idx, *w, out_dtype=torch.bfloat16)
        ref = geo_embedding_plain(d_idx, a_idx, *w, out_dtype=torch.bfloat16)
        err32 = float((got32 - ref32).abs().max())
        err = float((got.float() - ref.float()).abs().max())
        top = float(ref32.abs().max())
        print(f"[kernels] geo_embedding R={d_idx.shape[0]} H=256 k={a_idx.shape[1]}: "
              f"fp32 max abs err {err32:.3g} (tol 1e-4 * max|ref| = {1e-4 * top:.3g}); "
              f"bf16 max abs err {err:.3g} (tol one bf16 ulp at max|ref| = {top / 128:.3g})",
              flush=True)
        emu = geo_embedding_split_plain(d_idx, a_idx, *w, out_dtype=torch.float32)
        print(f"[kernels] geo_embedding fp32: kernel vs its split-bf16 emulation max abs err "
              f"{float((got32 - emu).abs().max()):.3g}, emulation vs plain "
              f"{float((emu - ref32).abs().max()):.3g}", flush=True)
        del emu
        if not err32 <= 1e-4 * top or not err <= top / 128:
            fail("geo_embedding kernel outside tolerance")
        ms = cuda_ms(lambda: fused_geo_embedding(d_idx, a_idx, *w, out_dtype=torch.bfloat16), 5)
        plain_ms = cuda_ms(lambda: geo_embedding_plain(d_idx, a_idx, *w,
                                                       out_dtype=torch.bfloat16), 3)
    r, k = a_idx.shape
    # the kernel takes each product as three bf16 products on the tensor cores
    byt = r * 4 + r * k * 4 + 4 * (2 * 256 * 256 + 2 * 256) + r * 256 * 2
    flops = 2.0 * r * (1 + k) * 256 * 256
    fp32_ms, _ = bound(byt, flops)
    tc_ms, tc_by = bound(byt, 3 * flops, BF16_TC_FLOP_PER_S)
    print(f"[kernels] geo_embedding bound: {flops:.3g} FLOP, {fp32_ms:.3f} ms on the fp32 CUDA "
          f"cores; three bf16 products {3 * flops:.3g} FLOP, {tc_ms:.3f} ms on the tensor cores "
          f"({tc_by}); bytes {byt / HBM_BYTES_PER_S * 1e3:.3f} ms; kernel {ms:.3f} ms",
          flush=True)
    rows["geo_embedding"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=byt,
                                 flops=3 * flops, peak=BF16_TC_FLOP_PER_S)

    # ---- geometric embedding backward: the kernel's own argmax map and a
    # bf16 cotangent; kernel and plain version are given the same map
    with torch.no_grad():
        _, amap = fused_geo_embedding(d_idx, a_idx, *w, out_dtype=torch.bfloat16,
                                      with_argmax=True)
        _, plain_map = geo_embedding_plain(d_idx, a_idx, *w, out_dtype=torch.bfloat16,
                                           with_argmax=True)
        map_mism = int((amap != plain_map).sum())
        g = torch.randn(r, 256, generator=gen).to(dev, torch.bfloat16)
        dgot = geo_embedding_bwd(d_idx, a_idx, amap, g, 256)
        dref = geo_embedding_bwd_plain(d_idx, a_idx, amap, g, 256)
        err = max(float((a - b).abs().max()) for a, b in zip(dgot, dref))
        top = max(float(b.abs().max()) for b in dref)
        demu = geo_embedding_bwd_split_plain(d_idx, a_idx, amap, g, 256)
        err_emu = max(float((a - b).abs().max()) for a, b in zip(dgot, demu))
        emu_err = max(float((a - b).abs().max()) for a, b in zip(demu, dref))
        del demu
    print(f"[kernels] geo_embedding_bwd R={r} H=256 k={k} bf16 cotangent: max abs err "
          f"{err:.3g} (tol 1e-4 * max|ref| = {1e-4 * top:.3g}); kernel vs its split-bf16 "
          f"emulation {err_emu:.3g}, emulation vs plain {emu_err:.3g}; argmax map: {map_mism} "
          f"of {amap.numel()} entries differ from the plain argmax (near-ties within rounding)",
          flush=True)
    if not err <= 1e-4 * top:
        fail("geo_embedding_bwd kernel outside tolerance")
    if map_mism > 1e-3 * amap.numel():
        fail(f"geo_embedding argmax map differs from the plain argmax in {map_mism} entries "
             f"(tol 1e-3 of {amap.numel()})")
    ms = cuda_ms(lambda: geo_embedding_bwd(d_idx, a_idx, amap, g, 256), 5)
    plain_ms = cuda_ms(lambda: geo_embedding_bwd_plain(d_idx, a_idx, amap, g, 256), 2)
    # each cotangent entry meets one basis row of each projection (the
    # distance's, and the angle's of its winning k): dWd and dWa; the kernel
    # takes each product as two bf16 products (basis hi and lo) on the tensor
    # cores, and multiplies the masked g of every one of the 1 + k phases
    byt = r * 4 + r * k * 4 + r * 256 * (1 + 2) + 4 * (2 * 256 * 256 + 256)
    flops = 2.0 * r * 2 * 256 * 256
    fp32_ms, _ = bound(byt, flops)
    tc_ms, tc_by = bound(byt, 2 * flops, BF16_TC_FLOP_PER_S)
    masked_ms, _ = bound(byt, 2 * flops * (1 + k) / 2, BF16_TC_FLOP_PER_S)
    print(f"[kernels] geo_embedding_bwd bound: {flops:.3g} FLOP, {fp32_ms:.3f} ms on the fp32 "
          f"CUDA cores; two bf16 products {2 * flops:.3g} FLOP, {tc_ms:.3f} ms on the tensor "
          f"cores ({tc_by}); the masked products of all {1 + k} phases {masked_ms:.3f} ms; bytes "
          f"{byt / HBM_BYTES_PER_S * 1e3:.3f} ms; kernel {ms:.3f} ms", flush=True)
    rows["geo_embedding_bwd"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=byt,
                                     flops=2 * flops, peak=BF16_TC_FLOP_PER_S)

    # ---- RPE self-attention: N = 512, D = 256, H = 4, bf16 embedding
    n, d, h = 512, 256, 4
    embed = got.reshape(n, n, d)
    q2, k2, v2 = (torch.randn(n, d, generator=gen).to(dev) for _ in range(3))
    qwp = (torch.randn(n, h, d, generator=gen) * 0.1).to(dev)
    mask = (torch.arange(n) < ncount).float().to(dev)
    hid, ae = fused_rpe_self_attention(q2, k2, v2, qwp, embed, mask)
    hid_ref, ae_ref = rpe_attention_plain(q2, k2, v2, qwp, embed, mask)
    err = max(float((hid - hid_ref).abs().max()), float((ae - ae_ref).abs().max()))
    top = max(float(hid_ref.abs().max()), float(ae_ref.abs().max()))
    print(f"[kernels] rpe_attention N={n} D={d} H={h} bf16 embedding, {ncount} valid keys: "
          f"max abs err {err:.3g} (tol 1e-4 * max|ref| = {1e-4 * top:.3g})", flush=True)
    if not err <= 1e-4 * top:
        fail("rpe_attention kernel outside tolerance")
    # the log-sum-exps that training's forward also writes
    fwd = fused_rpe_self_attention(q2, k2, v2, qwp, embed, mask, with_lse=True)
    fwd_ref = rpe_attention_plain(q2, k2, v2, qwp, embed, mask, with_lse=True)
    lse_err = max(float((a - b).abs().max()) for a, b in zip(fwd[2:], fwd_ref[2:]))
    lse_top = max(float(b.abs().max()) for b in fwd_ref[2:])
    same = all(torch.equal(a, b) for a, b in zip(fwd[:2], (hid, ae)))
    print(f"[kernels] rpe_attention log-sum-exps: max abs err {lse_err:.3g} (tol 1e-4 * "
          f"max|ref| = {1e-4 * lse_top:.3g}); hidden and ae bit-equal without them: {same}",
          flush=True)
    if not (lse_err <= 1e-4 * lse_top and same):
        fail("rpe_attention kernel's log-sum-exps outside tolerance")
    ms = cuda_ms(lambda: fused_rpe_self_attention(q2, k2, v2, qwp, embed, mask), 10)
    lse_ms = cuda_ms(lambda: fused_rpe_self_attention(q2, k2, v2, qwp, embed, mask,
                                                      with_lse=True), 10)
    print(f"[kernels] rpe_attention: {ms:.3f} ms without the log-sum-exps (serving), "
          f"{lse_ms:.3f} ms with them (training)", flush=True)
    plain_ms = cuda_ms(lambda: rpe_attention_plain(q2, k2, v2, qwp, embed, mask), 3)
    rows["rpe_attention"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bytes=n * n * d * 2 + 4 * (3 * n * d + n * h * d + n) + 4 * (n * d + n * h * d),
        flops=2.0 * n * n * (2 * h * d + 2 * d))

    # ---- RPE attention backward, same inputs, random cotangents
    ghid = torch.randn(n, d, generator=gen).to(dev)
    gae = torch.randn(n, h, d, generator=gen).to(dev)
    args = (q2, k2, v2, qwp, embed, mask, ghid, gae)
    got = rpe_attention_bwd(*args, *fwd)
    ref = rpe_attention_bwd_plain(*args)
    emu = rpe_attention_bwd_onepass_plain(*args, *fwd)
    torch.cuda.synchronize()
    print(f"[kernels] rpe_attention_bwd kernel vs its one-pass emulation, max abs err "
          f"{max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, emu)):.3g}; "
          f"emulation vs plain "
          f"{max(float((a.float() - b.float()).abs().max()) for a, b in zip(emu, ref)):.3g}",
          flush=True)
    del emu
    err = 0.0
    for name, a, b in zip(("dq", "dk", "dv", "dqwp", "demb"), got, ref):
        e, top = float((a.float() - b.float()).abs().max()), float(b.float().abs().max())
        tol = top / 128 if name == "demb" else 1e-4 * top
        print(f"[kernels] rpe_attention_bwd {name}: max abs err {e:.3g} (tol {tol:.3g}"
              f"{', one bf16 step at max|ref|' if name == 'demb' else ', 1e-4 * max|ref|'})",
              flush=True)
        if not e <= tol:
            fail(f"rpe_attention_bwd kernel outside tolerance in {name}")
        err = max(err, e)
    ms = cuda_ms(lambda: rpe_attention_bwd(*args, *fwd), 10)
    plain_ms = cuda_ms(lambda: rpe_attention_bwd_plain(*args), 3)
    rows["rpe_attention_bwd"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        # the embedding read once and its gradient written once (bf16), the
        # rest fp32: q2 k2 v2 ghid hidden dq dk dv (N, D), qwp gae ae dqwp
        # (N, H, D), the two log-sum-exps (N, H), mask
        bytes=2 * n * n * d * 2 + 4 * (8 * n * d + 4 * n * h * d + 2 * n * h + n),
        # forward recompute (scores) and the eight products of the backward
        flops=2.0 * n * n * d * (5 * h + 5))

    # ---- Sinkhorn: (256, 65, 65) x 100, the serving shape (the line kernel)
    p, kk, iters = 256, 64, 100
    scores = torch.randn(p, kk, kk, generator=gen).to(dev)
    rmask = (torch.rand(p, kk, generator=gen) > 0.1).to(dev)
    cmask = (torch.rand(p, kk, generator=gen) > 0.1).to(dev)
    padded, log_mu, log_nu, _ = sinkhorn_inputs(scores, rmask, cmask,
                                                torch.tensor(1.0, device=dev))
    out = sinkhorn_iterate(padded, log_mu, log_nu, iters)
    ref = sinkhorn_plain(padded, log_mu, log_nu, iters)
    valid = ref > -1e5
    err = float((out - ref)[valid].abs().max())
    print(f"[kernels] sinkhorn ({p}, {kk + 1}, {kk + 1}) x {iters}: max abs err {err:.3g} on "
          f"valid entries (tol 1e-4)", flush=True)
    if not err <= 1e-4:
        fail("sinkhorn kernel outside tolerance")
    ref64 = sinkhorn_plain(padded.double(), log_mu.double(), log_nu.double(), iters)
    emu = sinkhorn_base2_plain(padded, log_mu, log_nu, iters)
    print(f"[kernels] sinkhorn against a float64 loop, max abs err on valid entries: kernel "
          f"{float((out.double() - ref64)[valid].abs().max()):.3g}, fp32 plain loop "
          f"{float((ref.double() - ref64)[valid].abs().max()):.3g}, its base-2 emulation "
          f"{float((emu.double() - ref64)[valid].abs().max()):.3g}", flush=True)
    ms = cuda_ms(lambda: sinkhorn_iterate(padded, log_mu, log_nu, iters), 20)
    plain_ms = cuda_ms(lambda: sinkhorn_plain(padded, log_mu, log_nu, iters), 2)
    m1 = kk + 1
    # per iteration, entry and half-step: add, max, sub, add on the CUDA
    # cores and one exp on the SFUs; one log a line and half-step
    ops, sfu = 2 * 4.0 * p * m1 * m1 * iters, 2.0 * p * m1 * iters * (m1 + 1)
    byt = 4 * (2 * p * m1 * m1 + 2 * p * m1)
    b_ms, b_by = bound(byt, ops, sfu=sfu)
    print(f"[kernels] sinkhorn bound: {sfu:.4g} exps and logs, {b_ms:.4f} ms ({b_by}); fp32 "
          f"{ops / FP32_FLOP_PER_S * 1e3:.4f} ms, bytes {byt / HBM_BYTES_PER_S * 1e3:.4f} ms; "
          f"kernel {ms:.4f} ms", flush=True)
    rows["sinkhorn"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=byt, flops=ops,
                            sfu=sfu)

    # ---- at the training shape, (128, 65, 65) x 100: the forward with and
    # without the trajectory; the backward from it (training's) and making
    # its own (sinkhorn_bwd without one); a cotangent on valid entries only
    # (the fine loss reads nothing else)
    p = 128
    scores = torch.randn(p, kk, kk, generator=gen).to(dev)
    rmask = (torch.rand(p, kk, generator=gen) > 0.1).to(dev)
    cmask = (torch.rand(p, kk, generator=gen) > 0.1).to(dev)
    padded, log_mu, log_nu, _ = sinkhorn_inputs(scores, rmask, cmask,
                                                torch.tensor(1.0, device=dev))
    g = torch.randn(padded.shape, generator=gen).to(dev) * (padded > -1e5)
    out, traj_u, traj_v = sinkhorn_iterate(padded, log_mu, log_nu, iters, with_traj=True)
    traj = (traj_u, traj_v)
    ref_traj = sinkhorn_plain(padded, log_mu, log_nu, iters, with_traj=True)
    same = torch.equal(out, sinkhorn_iterate(padded, log_mu, log_nu, iters))
    rows_ok, cols_ok = log_mu > -1e5, log_nu > -1e5
    traj_err = max(float((traj_u - ref_traj[1]).abs().amax(dim=1)[rows_ok].max()),
                   float((traj_v - ref_traj[2]).abs().amax(dim=1)[cols_ok].max()))
    fwd_ms = cuda_ms(lambda: sinkhorn_iterate(padded, log_mu, log_nu, iters), 20)
    traj_ms = cuda_ms(lambda: sinkhorn_iterate(padded, log_mu, log_nu, iters, with_traj=True), 20)
    print(f"[kernels] sinkhorn ({p}, {m1}, {m1}) x {iters}: trajectory max abs err {traj_err:.3g} "
          f"on valid rows and columns (tol 1e-4); output bit-equal without it: {same}; "
          f"{fwd_ms:.4f} ms without the trajectory (validation), {traj_ms:.4f} ms with it "
          f"(training)", flush=True)
    if not (traj_err <= 1e-4 and same):
        fail("sinkhorn kernel's trajectory outside tolerance")
    got = sinkhorn_bwd(padded, log_mu, log_nu, g, iters, traj=traj)
    made = sinkhorn_bwd(padded, log_mu, log_nu, g, iters)
    ref = sinkhorn_bwd_plain(padded, log_mu, log_nu, g, iters)
    emu = sinkhorn_bwd_split_plain(padded, log_mu, log_nu, g, iters, traj=traj)
    err = 0.0
    # ds within 1e-4 of its largest value; dmu / dnu, the marginals'
    # cotangents summed over all 100 reverse steps, within 1e-3: there the
    # fp32 plain loop itself is about 1e-4 off the float64 loop printed below
    for name, a, b, frac in zip(("ds", "dmu", "dnu"), got, ref, (1e-4, 1e-3, 1e-3)):
        e, top = float((a - b).abs().max()), float(b.abs().max())
        print(f"[kernels] sinkhorn_bwd ({p}, {m1}, {m1}) x {iters} {name}: max abs err {e:.3g} "
              f"(tol {frac:g} * max|ref| = {frac * top:.3g})", flush=True)
        if not e <= frac * top:
            fail(f"sinkhorn_bwd kernel outside tolerance in {name}")
        err = max(err, e)
    same = all(torch.equal(a, b) for a, b in zip(got, made))
    print(f"[kernels] sinkhorn_bwd making its own trajectory: bit-equal to the one from the "
          f"forward's: {same}; kernel vs its split-sum emulation (same trajectory), max abs "
          f"err {max(float((a - b).abs().max()) for a, b in zip(got, emu)):.3g}", flush=True)
    if not same:
        fail("sinkhorn_bwd differs with and without a given trajectory")
    ref64 = sinkhorn_bwd_plain(padded.double(), log_mu.double(), log_nu.double(), g.double(),
                               iters)
    for name, a, b, c in zip(("ds", "dmu", "dnu"), got, ref, ref64):
        top = float(c.abs().max())
        print(f"[kernels] sinkhorn_bwd {name} against a float64 loop, max abs err / max|ref|: "
              f"kernel {float((a.double() - c).abs().max()) / top:.3g}, fp32 plain loop "
              f"{float((b.double() - c).abs().max()) / top:.3g}", flush=True)
    ms = cuda_ms(lambda: sinkhorn_bwd(padded, log_mu, log_nu, g, iters, traj=traj), 20)
    made_ms = cuda_ms(lambda: sinkhorn_bwd(padded, log_mu, log_nu, g, iters), 20)
    plain_ms = cuda_ms(lambda: sinkhorn_bwd_plain(padded, log_mu, log_nu, g, iters, traj), 2)
    # from the trajectory, per iteration, entry and half-step: two adds and
    # two fmas on the CUDA cores, one exp on the SFUs; the trajectory read
    # once. As the TPU kernel does it, the forward's work first (no
    # trajectory read)
    ops, sfu = 2 * 6.0 * p * m1 * m1 * iters, 2.0 * p * m1 * m1 * iters
    byt = 4 * (3 * p * m1 * m1 + 4 * p * m1)
    traj_bytes = 4 * p * iters * 2 * m1
    b_ms, b_by = bound(byt + traj_bytes, ops, sfu=sfu)
    tpu_ms, tpu_by = bound(byt, ops + 2 * 4.0 * p * m1 * m1 * iters,
                           sfu=2 * sfu + 2.0 * p * m1 * iters * (m1 + 1))
    print(f"[kernels] sinkhorn_bwd bound from the trajectory: {sfu:.4g} exps, "
          f"{traj_bytes / 1e6:.2f} MB of trajectory read, {b_ms:.4f} ms ({b_by}); as the TPU "
          f"kernel does it (recompute, then reverse) {tpu_ms:.4f} ms ({tpu_by}); kernel "
          f"{ms:.4f} ms from the trajectory, {made_ms:.4f} ms making its own", flush=True)
    rows["sinkhorn_bwd"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bytes=byt + traj_bytes, flops=ops, sfu=sfu)
    return rows


def _pair(arr, n, m, device):
    from roitr_torch.data.preprocess import estimate_normals_np, normal_redirect_np
    from roitr_torch.models.roitr import PairInputs

    bucket = arr["src_points"].shape[0]
    view = np.zeros(3, np.float32)
    nrm = {}
    for side, c in (("src", n), ("tgt", m)):
        pts = arr[f"{side}_points"]
        full = np.zeros_like(pts)
        full[:c] = normal_redirect_np(pts[:c], estimate_normals_np(pts[:c], 33), view)
        nrm[side] = full
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    ones = torch.ones((bucket, 1), device=device)
    return PairInputs(
        src_points=t(arr["src_points"]), src_raw_points=t(arr["src_raw_points"]),
        src_normals=t(nrm["src"]), src_feats=ones,
        src_count=torch.tensor(n, device=device), tgt_points=t(arr["tgt_points"]),
        tgt_normals=t(nrm["tgt"]), tgt_feats=ones, tgt_count=torch.tensor(m, device=device),
        rot=t(arr["rot"]), trans=t(arr["trans"]))


def _cos(a, b):
    return torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=-1)


def phase_forward(cfg, rng):
    """One pair at the 4096 bucket: card (kernels) against CPU (plain)."""
    from roitr_torch.data.synthetic import make_pair_arrays
    from roitr_torch.models.roitr import RoITr

    arr = make_pair_arrays(rng, 4096, 3900, 3600)
    gpu = RoITr(cfg, device="cuda", seed=0)
    cpu = RoITr(cfg, device="cpu", seed=0)
    t0 = time.time()
    with torch.no_grad():
        og = gpu(_pair(arr, 3900, 3600, "cuda"))
        torch.cuda.synchronize()
        oc = cpu(_pair(arr, 3900, 3600, "cpu"))
    print(f"[forward] bucket 4096 card + CPU forward in {time.time() - t0:.1f} s", flush=True)
    og = {k: v.cpu() for k, v in og.items()}
    for key in ("src_nodes", "tgt_nodes", "src_node_corr_indices", "tgt_node_corr_indices",
                "src_node_corr_knn_masks", "tgt_node_corr_knn_masks"):
        mism = int((og[key] != oc[key]).sum())
        print(f"[forward] {key}: {mism} index mismatches of {og[key].numel()}")
    snc, tnc = int(oc["src_node_count"]), int(oc["tgt_node_count"])
    node_cos = min(float(_cos(og["src_node_feats"][:snc], oc["src_node_feats"][:snc]).min()),
                   float(_cos(og["tgt_node_feats"][:tnc], oc["tgt_node_feats"][:tnc]).min()))
    pc = torch.cat([_cos(og["src_point_feats"][:3900], oc["src_point_feats"][:3900]),
                    _cos(og["tgt_point_feats"][:3600], oc["tgt_point_feats"][:3600])])
    frac = float((pc >= 0.999).double().mean())
    same = ((og["src_node_corr_indices"] == oc["src_node_corr_indices"])
            & (og["tgt_node_corr_indices"] == oc["tgt_node_corr_indices"]))
    valid = (oc["matching_scores"] > -1e5) & same[:, None, None]
    ms_err = float((og["matching_scores"] - oc["matching_scores"])[valid].abs().max())
    print(f"[forward] node descriptors: min cos {node_cos:.6f} (tol >= 0.999); point "
          f"descriptors: {frac:.4%} with cos >= 0.999 (tol >= 99%), min cos "
          f"{float(pc.min()):.6f}; matching_scores on {int(same.sum())} shared patches: "
          f"max abs err {ms_err:.3g} (tol 1e-2)", flush=True)
    for k, v in og.items():
        if v.is_floating_point() and not torch.isfinite(v).all():
            fail(f"forward output {k} is not finite")
    if not (node_cos >= 0.999 and frac >= 0.99 and ms_err <= 1e-2):
        fail("card forward disagrees with the CPU forward")
    return gpu.state_dict()


def phase_serving(cfg, state_dict, rng):
    """Matcher.match at full 3DMatch width, bucket 32768; returns launches."""
    from roitr_torch.data.synthetic import make_pair_arrays
    from roitr_torch.kernels import FORWARD_KERNELS, launch_counts, reset_launch_counts
    from roitr_torch.serving import Matcher

    matcher = Matcher(cfg, state_dict, device="cuda", descriptors=True)
    sizes = [(30000, 26000), (25000, 28000), (27000, 24800)]
    clouds = []
    for n, m in sizes:
        arr = make_pair_arrays(rng, 32768, n, m)
        clouds.append((arr["src_points"][:n], arr["tgt_points"][:m]))
    matcher.match(*clouds[0])  # warm-up: first-call library set-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    for i, (src, tgt) in enumerate(clouds):
        torch.cuda.synchronize()
        t0 = time.time()
        out = matcher.match(src, tgt)
        torch.cuda.synchronize()
        wall = time.time() - t0
        for k, v in out.items():
            if not np.isfinite(v).all():
                fail(f"serving output {k} is not finite")
        if out["src_point_desc"].shape != (len(src), 256):
            fail(f"src_point_desc shape {out['src_point_desc'].shape}")
        norms = np.linalg.norm(out["src_node_desc"], axis=-1)
        if not np.allclose(norms, 1.0, atol=1e-4):
            fail("node descriptors are not unit length")
        print(f"[serving] request {i}: {len(src)} + {len(tgt)} points, wall {wall * 1e3:.1f} ms "
              f"(includes host normals), {len(out['confidence'])} correspondences "
              f"(random weights: the count carries no meaning)", flush=True)
    launches = dict(launch_counts)
    print(f"[serving] max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches over 3 requests: {launches}", flush=True)
    missing = [k for k in FORWARD_KERNELS if launches[k] == 0]
    if missing:
        fail(f"kernels never launched on the serving path: {missing}")
    backward = [k for k, v in launches.items() if v and k not in FORWARD_KERNELS]
    if backward:
        fail(f"backward kernels launched while serving: {backward}")
    return launches


def _grad_step(model, pair):
    """Forward, losses and backward of one train step (no optimizer):
    (losses, {name: gradient on the CPU})."""
    from roitr_torch.losses import overall_loss

    model.zero_grad(set_to_none=True)
    out = model(pair, train=True, with_gt=True, generator=torch.Generator().manual_seed(0))
    losses = overall_loss(model.cfg, out, pair.rot, pair.trans)
    losses["loss"].backward()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu().double()
             for k, p in model.named_parameters()}
    return {k: float(v.detach()) for k, v in losses.items()}, grads


def phase_train_parity(cfg, rng):
    """One train step's forward, losses and backward at the 4096 bucket on
    the card (kernels, the three backward kernels included) and on the CPU
    (plain versions): same weights, fp32 storage, same Gumbel noise."""
    from roitr_torch.data.synthetic import make_pair_arrays
    from roitr_torch.models.roitr import RoITr

    cfg = cfg.replace(geo_embedding_storage="fp32")
    arr = make_pair_arrays(rng, 4096, 3900, 3600)
    t0 = time.time()
    lg, gg = _grad_step(RoITr(cfg, device="cuda", seed=0), _pair(arr, 3900, 3600, "cuda"))
    torch.cuda.synchronize()
    t_card = time.time() - t0
    t0 = time.time()
    lc, gc = _grad_step(RoITr(cfg, device="cpu", seed=0), _pair(arr, 3900, 3600, "cpu"))
    print(f"[train parity] bucket 4096: card step {t_card:.1f} s, CPU step "
          f"{time.time() - t0:.1f} s; losses card {lg} CPU {lc}", flush=True)
    loss_err = max(abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-6) for k in lc)
    norms = {k: float(v.norm()) for k, v in gc.items()}
    floor = 1e-3 * max(norms.values())
    worst, worst_key = 0.0, ""
    for k in gc:
        rel = float((gg[k] - gc[k]).norm()) / max(norms[k], floor)
        if rel > worst:
            worst, worst_key = rel, k
    flat_g = torch.cat([v.flatten() for v in gg.values()])
    flat_c = torch.cat([v.flatten() for v in gc.values()])
    cos = float(flat_g @ flat_c / (flat_g.norm() * flat_c.norm()))
    finite = all(torch.isfinite(v).all() for v in gg.values())
    print(f"[train parity] losses: largest relative difference {loss_err:.3g} (tol 1e-3); "
          f"gradients of {len(gc)} parameters: cosine over all {cos:.7f} (tol >= 0.9999), "
          f"worst |card - CPU| / max(|CPU|, 1e-3 * largest |CPU|) {worst:.3g} in {worst_key} "
          f"(tol 1e-2); finite on the card: {finite}", flush=True)
    if not (finite and loss_err <= 1e-3 and cos >= 0.9999 and worst <= 1e-2):
        fail("card train step disagrees with the CPU train step")


def phase_training(rng):
    """Trainer at full 3DMatch width from configs/train/tdmatch.yaml: 3 train
    steps and 1 validation step on synthetic pairs of 20k-30k points in the
    32768 bucket. Returns the launch counts of the run and its step times."""
    from roitr_torch.config import load_config
    from roitr_torch.data.synthetic import SyntheticPairs
    from roitr_torch.kernels import launch_counts, reset_launch_counts
    from roitr_torch.train.trainer import Trainer

    cfg = load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "configs", "train", "tdmatch.yaml"),
                      max_epoch=1, training_max_iter=3, val_max_iter=1, verbose_freq=1)
    seed = int(rng.randint(1 << 30))
    t0 = time.time()
    train_set = SyntheticPairs(3, 32768, counts=(20000, 30000), seed=seed)
    val_set = SyntheticPairs(1, 32768, counts=(20000, 30000), seed=seed + 100)
    train_set = [train_set[i] for i in range(len(train_set))]  # host normals up front
    val_set = [val_set[0]]
    print(f"[training] {len(train_set)} + {len(val_set)} synthetic pairs with normals in "
          f"{time.time() - t0:.1f} s (host); counts "
          f"{[(int(d['src_count']), int(d['tgt_count'])) for d in train_set + val_set]}",
          flush=True)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            trainer = Trainer(cfg, train_set, val_set, device="cuda", time_steps=True)
            before = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.time()
            best = trainer.train()
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = dict(launch_counts)
            peak = torch.cuda.max_memory_allocated()
            events = [json.loads(line) for line in
                      open(os.path.join("snapshot", cfg.exp_dir, "events.jsonl"))]
            ckpts = sorted(os.listdir(trainer.ckpt_dir))
        finally:
            os.chdir(cwd)
    steps = [e for e in events if e["phase"] == "train"]
    for i, (t, e) in enumerate(zip(trainer.step_times, steps)):
        print(f"[training] step {i}: forward {t['forward_ms']:.1f} ms, backward "
              f"{t['backward_ms']:.1f} ms, optimizer {t['optimizer_ms']:.1f} ms; running "
              f"loss {e['loss']:.4f}, grads_finite {e['grads_finite']:.0f}", flush=True)
    changed = sum(not torch.equal(v, before[k]) for k, v in trainer.model.state_dict().items())
    print(f"[training] {trainer.step} train steps + {cfg.val_max_iter} validation step in "
          f"{wall:.1f} s; max_memory_allocated {peak / 2**30:.2f} GiB; {changed} of "
          f"{len(before)} tensors changed; val {best}; checkpoints {ckpts}; launches {launches}",
          flush=True)
    if trainer.step != 3 or len(steps) != 3:
        fail(f"expected 3 train steps, ran {trainer.step}")
    if not all(np.isfinite(e["loss"]) and e["grads_finite"] == 1.0 for e in steps):
        fail("a train step's loss or gradients were not finite")
    if not np.isfinite(best["loss"]) or changed == 0:
        fail("validation loss not finite, or the parameters did not change")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"kernels never launched on the training path: {missing}")
    # a train step: six RPE attention layers' backward, one OT forward and
    # backward; the validation step one more OT forward
    steps_val = trainer.step + cfg.val_max_iter
    want = {"rpe_attention_bwd": 6 * trainer.step, "sinkhorn_bwd": trainer.step,
            "sinkhorn": steps_val}
    wrong = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
    if wrong:
        fail(f"training launches (counted, expected): {wrong}")
    return launches, trainer.step_times, peak


SOURCES = {
    "fps": ("roitr_torch/csrc/fps.cu", "roitr_tpu/ops/pallas/fps_kernel.py:47"),
    "geo_embedding": ("roitr_torch/csrc/geo_embedding.cu",
                      "roitr_tpu/ops/pallas/geo_embedding_kernel.py:87"),
    "rpe_attention": ("roitr_torch/csrc/rpe_attention.cu",
                      "roitr_tpu/ops/pallas/rpe_attention_kernel.py:119"),
    "sinkhorn": ("roitr_torch/csrc/sinkhorn.cu", "roitr_tpu/ops/pallas/sinkhorn_kernel.py:65"),
    "sinkhorn_bwd": ("roitr_torch/csrc/sinkhorn.cu",
                     "roitr_tpu/ops/pallas/sinkhorn_kernel.py:135"),
    "rpe_attention_bwd": ("roitr_torch/csrc/rpe_attention.cu",
                          "roitr_tpu/ops/pallas/rpe_attention_kernel.py:146"),
    "geo_embedding_bwd": ("roitr_torch/csrc/geo_embedding.cu",
                          "roitr_tpu/ops/pallas/geo_embedding_kernel.py:190"),
}


def main() -> int:
    t_start = time.time()
    smi_line = phase_device()
    from roitr_torch.config import Config

    phase_build()
    rng = np.random.RandomState(0)
    rows = phase_kernels(rng)
    cfg = Config(benchmark="3DMatch")
    state_dict = phase_forward(cfg, rng)
    phase_serving(cfg, state_dict, rng)
    phase_train_parity(cfg, rng)
    launches, _, _ = phase_training(rng)

    kernels = []
    for name, row in rows.items():
        bound_ms, bound_by = bound(row["bytes"], row["flops"], row.get("peak", FP32_FLOP_PER_S),
                                   row.get("sfu", 0.0))
        source, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": bound_ms,
            # exps and logs on the special-function units are operations
            "bound_by": "bytes" if bound_by == "bytes" else "operations",
            "library_ms": None,
        })
    print(f"[done] {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
