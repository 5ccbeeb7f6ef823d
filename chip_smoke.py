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
               trajectory (training's) and making its own; the RPE
               attention forward and backward also with a pair axis (B 8 at
               N 16, B 2 at N 512; bit-equal to one-pair launches), and
               rows 2, 7, 4 and 5 at a packed train step's shapes
  4. forward   one seeded pair at the 4096 bucket through RoITr on the card
               (kernels) and on the CPU (plain versions), same weights
  5. serving   Matcher.match at full 3DMatch width on three synthetic pairs
               of 20k-30k points (bucket 32768); launch counters are zeroed
               just before and read just after, and every forward kernel
               must have run
  6. packed    Matcher.match_batch at full 3DMatch width, prep="host"
               (host pyramids) and prep="device": 8 pairs of 600-1000 points
               in the 1024 bucket packed into one forward, 2 pairs of
               20k-30k points in the 32768 bucket in map mode; counters
               zeroed before each call and its launches required exactly;
               pairs/s and peak memory; each pair against match of that
               pair, and the packed forward's node correspondences against
               the single-pair forwards'
  7. host pyramid  the native host pyramid of 20k-30k-point clouds split
               into FPS and kNN, beside the card's FPS and kNN for the same
               pairs without a pyramid; match request walls, prep="host",
               with host_pyramid on and off in turns
  8. tester    the Tester (get_trainer) at full 3DMatch width from
               configs/test/tdmatch.yaml (its knn_method approx) on a test
               split in the reference layout: three synthetic pairs of
               20k-30k points as .pth fragments and an info pickle in a
               temporary directory; host prep (host pyramids) with full
               dumps, device prep with full dumps and with c2f dumps, and
               packed batches of two (host and device prep), counters zeroed
               before each run and its launches required exactly; the dumps'
               keys and ragged shapes, c2f against full, packed against
               single-pair dumps, device prep against host prep (node
               descriptors), the compaction on the card with every
               correspondence kept, device normals against host normals;
               s/pair, device normals' ms and peak memory
  9. train parity  one train step's forward, losses and backward at the
               4096 bucket on the card and on the CPU, same weights and
               Gumbel noise: losses and every parameter's gradient compared
  10. training Trainer at full 3DMatch width (configs/train/tdmatch.yaml)
               for 3 train steps and 1 validation step on synthetic pairs of
               20k-30k points (bucket 32768), in a temporary directory;
               counters zeroed before and read after, and all seven kernels
               must have run
  11. packed training  the same Trainer with packed_batch, batch_size 8 and
               host pyramids: 3 packed train steps and 1 packed validation
               step on pairs of 600-1000 points (bucket 1024); counters
               zeroed before and read after, launches required exactly (one a
               layer or side for all 8 pairs, no FPS); step ms split three
               ways, pairs/s, peak memory; then one packed step of 8 pairs
               against 8 single-pair steps of the same pairs, in turns
  12. packed train parity  a packed batch of 4 such pairs at full width:
               the card's gradient against the CPU's, and against the mean
               of the 4 single-pair gradients on the card
  13. 4dmatch  the non-rigid variant at its full width (channel factor 2,
               hidden 512): every kernel at its shapes against its plain
               version (rows 2, 3, 6, 7 at width 512, the Sinkhorn forward
               at the adaptive buffer's 512 patches), each row's ms, bound
               and error on a line of its own; card against CPU at the 4096
               bucket on a flow pair (the with-GT forward's node
               descriptors and adaptive correspondences, one train step's
               losses and gradients); then, on flow pairs of 20k-30k points
               written as the reference's .npz entries in a temporary
               directory, the Trainer (configs/train/fdmatch.yaml: 8 pairs,
               2 updates at iter_size 4, 1 validation step; launches
               exact, widths 512), the Tester (configs/test/fdmatch.yaml,
               host and device prep, full and c2f dumps) with the port's
               NFMR / IR evaluation, and one Matcher.match request
  14. bf16     compute_dtype="bfloat16" at full 3DMatch width: train steps of
               two 20k-30k-point pairs with bf16 and fp32 compute in turns
               (step ms split three ways, peak memory, each step's launches
               required to be a train step's), the bf16 gradient against
               the fp32 one, card against CPU in bf16 at the 4096 bucket
               (node descriptors, losses, gradients), and Matcher.match in
               bf16 and fp32 in turns (wall ms, node descriptor cosine)
  15. remat    remat_local off and on in turns, the same steps (ms, peak
               memory, launches), one step's gradients compared, and one
               step at 4DMatch's width (factor 2) for its peak memory
  16. workers  the Tester under host prep with full dumps on 16 pairs of
               20k-30k points, num_workers 0 and min(8, cores) in turns:
               s/pair, the device's busy share (torch.profiler), launches
               exact, dumps equal byte for byte; then a full-width Trainer
               whose pairs the pool prepares (2 train steps, 1 validation
               step, launches exact)
  17. ddp      data parallelism over processes at full 3DMatch width: with
               two or more cards NCCL, one rank a card (up to 4); with one,
               two gloo ranks on it and a one-rank NCCL group. One train step
               of one 20k-30k-point pair a rank against the one-process step
               of the same pairs (parameters bit-equal across ranks, max
               difference and gradient cosine against the one-process step,
               step ms a rank, the flat gradient's MB and its all-reduce's
               ms); a Trainer (2 steps, 1 validation step, one checkpoint a
               name, launches exact); the Tester on 4 pairs, dumps equal to
               world 1's byte for byte
  18. registration  the port's registration evaluation on 16 synthetic
               dumps with known poses (5000 correspondences, 30-60%
               outliers): registration recall, inlier ratio and feature-match
               recall with RANSAC on the card and in numpy, equal; transforms
               within 5e-3; the card's winning hypothesis the CPU's; the
               card's ms a pair at 50k hypotheses for 5000, 2500, 1000, 500
               and 250 correspondences, numpy's s a pair at 5000, and the
               protocol's time on the card for 1623 pairs, extrapolated
  19. sinkhorn tol  the plain loop's convergence exit (backend "xla", tol
               1e-3) on 256 masked (65, 65) patches, card against CPU (the
               same iteration count, below 100; scores within 1e-5), its ms
               beside the kernel's 100 iterations; a forward at 4096 under
               the default config launches the Sinkhorn kernel, with tol >
               0 too (and warns), under "xla" not; utils/profiling.py
               `trace` of the default forward names the RPE attention kernel
  20. cli      `python -m roitr_torch` at full 3DMatch width on 3 synthetic
               pairs of 20k-30k points: train mode in process from a copy of
               configs/train/tdmatch.yaml cut to 2 train and 2 validation
               steps (launches exact, each step's ms, checkpoints), then test
               mode in a subprocess from a copy of configs/test/tdmatch.yaml
               (knn_method approx) with the trained weights as a reference
               RoITr .pth; its dumps equal an in-process Tester's by sha256
The phases before [workers] prepare pairs in process (num_workers 0).
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


def phase_kernels(rng, hidden: int = 256, serving_patches: int = 256, tag: str = "[kernels]",
                  extras: bool = True):
    """Each kernel against its plain version at the 32768 bucket's shapes:
    the global transformer's width `hidden` (256 at 3DMatch, 512 at 4DMatch)
    for the embedding and the RPE attention, `serving_patches` Sinkhorn
    patches in serving (the 3DMatch top-k's 256, 4DMatch's adaptive buffer
    of 512). `extras`: the pair-axis and packed-shape checks too. Returns
    each row's numbers."""
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
        print(f"{tag} fps ({pts.shape[0]}, {pts.shape[1]}) -> {m}: {mism} index mismatches",
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

    # ---- geometric embedding of one cloud's 512 nodes: R = 262144, H = hidden
    nodes, ncount = pts[0], int(cnt[0])
    emb = GeometricStructureEmbedding(hidden).to(dev)
    with torch.no_grad():
        for lin in (emb.proj_d, emb.proj_a):
            lin.weight.copy_((torch.rand(hidden, hidden, generator=gen) * 2 - 1) / hidden ** 0.5)
            lin.bias.copy_((torch.rand(hidden, generator=gen) * 2 - 1) / hidden ** 0.5)
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
        print(f"{tag} geo_embedding R={d_idx.shape[0]} H={hidden} k={a_idx.shape[1]}: "
              f"fp32 max abs err {err32:.3g} (tol 1e-4 * max|ref| = {1e-4 * top:.3g}); "
              f"bf16 max abs err {err:.3g} (tol one bf16 ulp at max|ref| = {top / 128:.3g})",
              flush=True)
        emu = geo_embedding_split_plain(d_idx, a_idx, *w, out_dtype=torch.float32)
        print(f"{tag} geo_embedding fp32: kernel vs its split-bf16 emulation max abs err "
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
    byt = r * 4 + r * k * 4 + 4 * (2 * hidden * hidden + 2 * hidden) + r * hidden * 2
    flops = 2.0 * r * (1 + k) * hidden * hidden
    fp32_ms, _ = bound(byt, flops)
    tc_ms, tc_by = bound(byt, 3 * flops, BF16_TC_FLOP_PER_S)
    print(f"{tag} geo_embedding bound: {flops:.3g} FLOP, {fp32_ms:.3f} ms on the fp32 CUDA "
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
        g = torch.randn(r, hidden, generator=gen).to(dev, torch.bfloat16)
        dgot = geo_embedding_bwd(d_idx, a_idx, amap, g, hidden)
        dref = geo_embedding_bwd_plain(d_idx, a_idx, amap, g, hidden)
        err = max(float((a - b).abs().max()) for a, b in zip(dgot, dref))
        top = max(float(b.abs().max()) for b in dref)
        demu = geo_embedding_bwd_split_plain(d_idx, a_idx, amap, g, hidden)
        err_emu = max(float((a - b).abs().max()) for a, b in zip(dgot, demu))
        emu_err = max(float((a - b).abs().max()) for a, b in zip(demu, dref))
        del demu
    print(f"{tag} geo_embedding_bwd R={r} H={hidden} k={k} bf16 cotangent: max abs err "
          f"{err:.3g} (tol 1e-4 * max|ref| = {1e-4 * top:.3g}); kernel vs its split-bf16 "
          f"emulation {err_emu:.3g}, emulation vs plain {emu_err:.3g}; argmax map: {map_mism} "
          f"of {amap.numel()} entries differ from the plain argmax (near-ties within rounding)",
          flush=True)
    if not err <= 1e-4 * top:
        fail("geo_embedding_bwd kernel outside tolerance")
    if map_mism > 1e-3 * amap.numel():
        fail(f"geo_embedding argmax map differs from the plain argmax in {map_mism} entries "
             f"(tol 1e-3 of {amap.numel()})")
    ms = cuda_ms(lambda: geo_embedding_bwd(d_idx, a_idx, amap, g, hidden), 5)
    plain_ms = cuda_ms(lambda: geo_embedding_bwd_plain(d_idx, a_idx, amap, g, hidden), 2)
    # each cotangent entry meets one basis row of each projection (the
    # distance's, and the angle's of its winning k): dWd and dWa; the kernel
    # takes each product as two bf16 products (basis hi and lo) on the tensor
    # cores, and multiplies the masked g of every one of the 1 + k phases
    byt = r * 4 + r * k * 4 + r * hidden * (1 + 2) + 4 * (2 * hidden * hidden + hidden)
    flops = 2.0 * r * 2 * hidden * hidden
    fp32_ms, _ = bound(byt, flops)
    tc_ms, tc_by = bound(byt, 2 * flops, BF16_TC_FLOP_PER_S)
    masked_ms, _ = bound(byt, 2 * flops * (1 + k) / 2, BF16_TC_FLOP_PER_S)
    print(f"{tag} geo_embedding_bwd bound: {flops:.3g} FLOP, {fp32_ms:.3f} ms on the fp32 "
          f"CUDA cores; two bf16 products {2 * flops:.3g} FLOP, {tc_ms:.3f} ms on the tensor "
          f"cores ({tc_by}); the masked products of all {1 + k} phases {masked_ms:.3f} ms; bytes "
          f"{byt / HBM_BYTES_PER_S * 1e3:.3f} ms; kernel {ms:.3f} ms", flush=True)
    rows["geo_embedding_bwd"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=byt,
                                     flops=2 * flops, peak=BF16_TC_FLOP_PER_S)

    # ---- RPE self-attention: N = 512, D = hidden, H = 4, bf16 embedding
    n, d, h = 512, hidden, 4
    embed = got.reshape(n, n, d)
    q2, k2, v2 = (torch.randn(n, d, generator=gen).to(dev) for _ in range(3))
    qwp = (torch.randn(n, h, d, generator=gen) * 0.1).to(dev)
    mask = (torch.arange(n) < ncount).float().to(dev)
    hid, ae = fused_rpe_self_attention(q2, k2, v2, qwp, embed, mask)
    hid_ref, ae_ref = rpe_attention_plain(q2, k2, v2, qwp, embed, mask)
    err = max(float((hid - hid_ref).abs().max()), float((ae - ae_ref).abs().max()))
    top = max(float(hid_ref.abs().max()), float(ae_ref.abs().max()))
    print(f"{tag} rpe_attention N={n} D={d} H={h} bf16 embedding, {ncount} valid keys: "
          f"max abs err {err:.3g} (tol 1e-4 * max|ref| = {1e-4 * top:.3g})", flush=True)
    if not err <= 1e-4 * top:
        fail("rpe_attention kernel outside tolerance")
    # the log-sum-exps that training's forward also writes
    fwd = fused_rpe_self_attention(q2, k2, v2, qwp, embed, mask, with_lse=True)
    fwd_ref = rpe_attention_plain(q2, k2, v2, qwp, embed, mask, with_lse=True)
    lse_err = max(float((a - b).abs().max()) for a, b in zip(fwd[2:], fwd_ref[2:]))
    lse_top = max(float(b.abs().max()) for b in fwd_ref[2:])
    same = all(torch.equal(a, b) for a, b in zip(fwd[:2], (hid, ae)))
    print(f"{tag} rpe_attention log-sum-exps: max abs err {lse_err:.3g} (tol 1e-4 * "
          f"max|ref| = {1e-4 * lse_top:.3g}); hidden and ae bit-equal without them: {same}",
          flush=True)
    if not (lse_err <= 1e-4 * lse_top and same):
        fail("rpe_attention kernel's log-sum-exps outside tolerance")
    ms = cuda_ms(lambda: fused_rpe_self_attention(q2, k2, v2, qwp, embed, mask), 10)
    lse_ms = cuda_ms(lambda: fused_rpe_self_attention(q2, k2, v2, qwp, embed, mask,
                                                      with_lse=True), 10)
    print(f"{tag} rpe_attention: {ms:.3f} ms without the log-sum-exps (serving), "
          f"{lse_ms:.3f} ms with them (training)", flush=True)
    plain_ms = cuda_ms(lambda: rpe_attention_plain(q2, k2, v2, qwp, embed, mask), 3)
    rows["rpe_attention"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bytes=n * n * d * 2 + 4 * (3 * n * d + n * h * d + n) + 4 * (n * d + n * h * d),
        flops=2.0 * n * n * (2 * h * d + 2 * d))
    same_one = all(torch.equal(a[0], b) for a, b in zip(
        fused_rpe_self_attention(*(t[None] for t in (q2, k2, v2, qwp, embed, mask))), (hid, ae)))
    print(f"{tag} rpe_attention (1, N, D) inputs bit-equal to the one-pair entry: "
          f"{same_one}", flush=True)
    if not same_one:
        fail("rpe_attention with a pair axis of 1 differs from the one-pair entry")
    if extras:
        rpe_attention_pair_axis(gen)

    # ---- RPE attention backward, same inputs, random cotangents
    ghid = torch.randn(n, d, generator=gen).to(dev)
    gae = torch.randn(n, h, d, generator=gen).to(dev)
    args = (q2, k2, v2, qwp, embed, mask, ghid, gae)
    got = rpe_attention_bwd(*args, *fwd)
    ref = rpe_attention_bwd_plain(*args)
    emu = rpe_attention_bwd_onepass_plain(*args, *fwd)
    torch.cuda.synchronize()
    print(f"{tag} rpe_attention_bwd kernel vs its one-pass emulation, max abs err "
          f"{max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, emu)):.3g}; "
          f"emulation vs plain "
          f"{max(float((a.float() - b.float()).abs().max()) for a, b in zip(emu, ref)):.3g}",
          flush=True)
    del emu
    err = 0.0
    for name, a, b in zip(("dq", "dk", "dv", "dqwp", "demb"), got, ref):
        e, top = float((a.float() - b.float()).abs().max()), float(b.float().abs().max())
        tol = top / 128 if name == "demb" else 1e-4 * top
        print(f"{tag} rpe_attention_bwd {name}: max abs err {e:.3g} (tol {tol:.3g}"
              f"{', one bf16 step at max|ref|' if name == 'demb' else ', 1e-4 * max|ref|'})",
              flush=True)
        if not e <= tol:
            fail(f"rpe_attention_bwd kernel outside tolerance in {name}")
        err = max(err, e)
    ms = cuda_ms(lambda: rpe_attention_bwd(*args, *fwd), 10)
    plain_ms = cuda_ms(lambda: rpe_attention_bwd_plain(*args), 3)
    rows["rpe_attention_bwd"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bytes=rpe_bwd_bytes(1, n, d, h, 2), flops=rpe_bwd_flops(1, n, d, h))
    if extras:
        rpe_attention_bwd_pair_axis(gen)
        packed_shapes(gen)

    # ---- Sinkhorn at the serving shape, (serving_patches, 65, 65) x 100
    # (the line kernel)
    p, kk, iters = serving_patches, 64, 100
    scores = torch.randn(p, kk, kk, generator=gen).to(dev)
    rmask = (torch.rand(p, kk, generator=gen) > 0.1).to(dev)
    cmask = (torch.rand(p, kk, generator=gen) > 0.1).to(dev)
    padded, log_mu, log_nu, _ = sinkhorn_inputs(scores, rmask, cmask,
                                                torch.tensor(1.0, device=dev))
    out = sinkhorn_iterate(padded, log_mu, log_nu, iters)
    ref = sinkhorn_plain(padded, log_mu, log_nu, iters)
    valid = ref > -1e5
    err = float((out - ref)[valid].abs().max())
    print(f"{tag} sinkhorn ({p}, {kk + 1}, {kk + 1}) x {iters}: max abs err {err:.3g} on "
          f"valid entries (tol 1e-4)", flush=True)
    if not err <= 1e-4:
        fail("sinkhorn kernel outside tolerance")
    ref64 = sinkhorn_plain(padded.double(), log_mu.double(), log_nu.double(), iters)
    emu = sinkhorn_base2_plain(padded, log_mu, log_nu, iters)
    print(f"{tag} sinkhorn against a float64 loop, max abs err on valid entries: kernel "
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
    print(f"{tag} sinkhorn bound: {sfu:.4g} exps and logs, {b_ms:.4f} ms ({b_by}); fp32 "
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
    print(f"{tag} sinkhorn ({p}, {m1}, {m1}) x {iters}: trajectory max abs err {traj_err:.3g} "
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
        print(f"{tag} sinkhorn_bwd ({p}, {m1}, {m1}) x {iters} {name}: max abs err {e:.3g} "
              f"(tol {frac:g} * max|ref| = {frac * top:.3g})", flush=True)
        if not e <= frac * top:
            fail(f"sinkhorn_bwd kernel outside tolerance in {name}")
        err = max(err, e)
    same = all(torch.equal(a, b) for a, b in zip(got, made))
    print(f"{tag} sinkhorn_bwd making its own trajectory: bit-equal to the one from the "
          f"forward's: {same}; kernel vs its split-sum emulation (same trajectory), max abs "
          f"err {max(float((a - b).abs().max()) for a, b in zip(got, emu)):.3g}", flush=True)
    if not same:
        fail("sinkhorn_bwd differs with and without a given trajectory")
    ref64 = sinkhorn_bwd_plain(padded.double(), log_mu.double(), log_nu.double(), g.double(),
                               iters)
    for name, a, b, c in zip(("ds", "dmu", "dnu"), got, ref, ref64):
        top = float(c.abs().max())
        print(f"{tag} sinkhorn_bwd {name} against a float64 loop, max abs err / max|ref|: "
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
    print(f"{tag} sinkhorn_bwd bound from the trajectory: {sfu:.4g} exps, "
          f"{traj_bytes / 1e6:.2f} MB of trajectory read, {b_ms:.4f} ms ({b_by}); as the TPU "
          f"kernel does it (recompute, then reverse) {tpu_ms:.4f} ms ({tpu_by}); kernel "
          f"{ms:.4f} ms from the trajectory, {made_ms:.4f} ms making its own", flush=True)
    rows["sinkhorn_bwd"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bytes=byt + traj_bytes, flops=ops, sfu=sfu)
    return rows


def rpe_attention_pair_axis(gen):
    """Row 3 with a pair axis, the packed path's launch: B = 8 pairs of the
    1024 bucket's coarse level (N 16, mixed valid counts) and B = 2 at
    N 512; D 256, H 4, bf16 embedding. Against rpe_attention_plain with the
    pair axis (1e-4 of the largest value) and against B one-pair launches
    (bit-equal); one batched launch and B one-pair launches timed."""
    from roitr_torch.kernels.rpe_attention_kernel import (
        fused_rpe_self_attention,
        rpe_attention_plain,
    )

    dev = torch.device("cuda")
    d, h = 256, 4
    for b, n, valid in ((8, 16, (16, 15, 12, 9, 16, 4, 1, 13)), (2, 512, (512, 430))):
        q2, k2, v2 = (torch.randn(b, n, d, generator=gen).to(dev) for _ in range(3))
        qwp = (torch.randn(b, n, h, d, generator=gen) * 0.1).to(dev)
        embed = torch.randn(b, n, n, d, generator=gen).to(dev, torch.bfloat16)
        mask = (torch.arange(n)[None, :] < torch.tensor(valid)[:, None]).float().to(dev)
        args = (q2, k2, v2, qwp, embed, mask)
        got = fused_rpe_self_attention(*args)
        ref = rpe_attention_plain(*args)
        err = max(float((a - r).abs().max()) for a, r in zip(got, ref))
        top = max(float(r.abs().max()) for r in ref)
        per_pair = [fused_rpe_self_attention(*(t[i] for t in args)) for i in range(b)]
        same = all(torch.equal(got[j][i], per_pair[i][j]) for i in range(b) for j in (0, 1))
        ms = cuda_ms(lambda: fused_rpe_self_attention(*args), 20)
        pair_ms = cuda_ms(lambda: [fused_rpe_self_attention(*(t[i] for t in args))
                                   for i in range(b)], 20)
        plain_ms = cuda_ms(lambda: rpe_attention_plain(*args), 3)
        byt = b * (n * n * d * 2 + 4 * (3 * n * d + n * h * d + n) + 4 * (n * d + n * h * d))
        b_ms, b_by = bound(byt, b * 2.0 * n * n * (2 * h * d + 2 * d))
        print(f"[kernels] rpe_attention pair axis B={b} N={n} D={d} H={h} bf16, valid {valid}: "
              f"max abs err {err:.3g} (tol 1e-4 * max|ref| = {1e-4 * top:.3g}); bit-equal to "
              f"{b} one-pair launches: {same}; one batched launch {ms:.4f} ms, {b} one-pair "
              f"launches {pair_ms:.4f} ms, plain {plain_ms:.3f} ms; bound {b_ms:.4f} ms "
              f"({b_by})", flush=True)
        if not (err <= 1e-4 * top and same):
            fail(f"rpe_attention with a pair axis of {b} outside tolerance or not equal to "
                 "one-pair launches")


def rpe_bwd_bytes(b, n, d, h, esize):
    """Bytes row 6 must move for b pairs: the embedding read once and its
    gradient written once (esize bytes an element), the rest fp32: q2 k2
    v2 ghid hidden dq dk dv (N, D), qwp gae ae dqwp (N, H, D), the two
    log-sum-exps (N, H), mask."""
    return b * (2 * n * n * d * esize + 4 * (8 * n * d + 4 * n * h * d + 2 * n * h + n))


def rpe_bwd_flops(b, n, d, h):
    """The forward recompute (scores) and the eight products of the
    backward, b pairs."""
    return b * 2.0 * n * n * d * (5 * h + 5)


def rpe_attention_bwd_pair_axis(gen):
    """Row 6 with a pair axis, packed training's launch: B = 8 pairs of the
    1024 bucket's coarse level (N 16, mixed valid counts) and B = 2 at
    N 512; D 256, H 4, bf16 and fp32 embeddings, given the forward's saved
    outputs as training gives them. Against rpe_attention_bwd_plain with the
    pair axis (fp32 within 1e-4 of the largest value, a bf16 embedding
    gradient within one bf16 step), bit-equal to B one-pair launches, and
    B = 1 bit-equal to the one-pair entry; one batched launch and B
    one-pair launches timed."""
    from roitr_torch.kernels.rpe_attention_kernel import (
        fused_rpe_self_attention,
        rpe_attention_bwd,
        rpe_attention_bwd_plain,
    )

    dev = torch.device("cuda")
    d, h = 256, 4
    names = ("dq", "dk", "dv", "dqwp", "demb")
    for b, n, valid in ((8, 16, (16, 15, 12, 9, 16, 4, 1, 13)), (2, 512, (512, 430))):
        for dtype in (torch.bfloat16, torch.float32):
            q2, k2, v2, ghid = (torch.randn(b, n, d, generator=gen).to(dev) for _ in range(4))
            qwp = (torch.randn(b, n, h, d, generator=gen) * 0.1).to(dev)
            gae = torch.randn(b, n, h, d, generator=gen).to(dev)
            embed = torch.randn(b, n, n, d, generator=gen).to(dev, dtype)
            mask = (torch.arange(n)[None, :] < torch.tensor(valid)[:, None]).float().to(dev)
            args = (q2, k2, v2, qwp, embed, mask, ghid, gae)
            fwd = fused_rpe_self_attention(*args[:6], with_lse=True)
            got = rpe_attention_bwd(*args, *fwd)
            ref = rpe_attention_bwd_plain(*args)
            errs = []
            for name, a, r in zip(names, got, ref):
                e, top = float((a.float() - r.float()).abs().max()), float(r.float().abs().max())
                tol = top / 128 if a.dtype == torch.bfloat16 else 1e-4 * top
                errs.append(f"{name} {e:.3g} (tol {tol:.3g})")
                if not e <= tol:
                    fail(f"rpe_attention_bwd with a pair axis of {b} outside tolerance in {name}")
            pair_args = [tuple(t[i] for t in args) + tuple(f[i] for f in fwd) for i in range(b)]
            per_pair = [rpe_attention_bwd(*a) for a in pair_args]
            same = all(torch.equal(got[j][i], per_pair[i][j]) for i in range(b) for j in range(5))
            one = rpe_attention_bwd(*(t[:1] for t in args), *(f[:1] for f in fwd))
            same_one = all(torch.equal(x[0], y) for x, y in zip(one, per_pair[0]))
            ms = cuda_ms(lambda: rpe_attention_bwd(*args, *fwd), 20)
            pair_ms = cuda_ms(lambda: [rpe_attention_bwd(*a) for a in pair_args], 20)
            plain_ms = cuda_ms(lambda: rpe_attention_bwd_plain(*args), 3)
            esize = 2 if dtype == torch.bfloat16 else 4
            b_ms, b_by = bound(rpe_bwd_bytes(b, n, d, h, esize), rpe_bwd_flops(b, n, d, h))
            print(f"[kernels] rpe_attention_bwd pair axis B={b} N={n} D={d} H={h} "
                  f"{'bf16' if esize == 2 else 'fp32'} embedding, valid {valid}: max abs err "
                  f"{'; '.join(errs)}; bit-equal to {b} one-pair launches: {same}; B=1 bit-equal "
                  f"to the one-pair entry: {same_one}; one batched launch {ms:.4f} ms, {b} "
                  f"one-pair launches {pair_ms:.4f} ms, plain {plain_ms:.3f} ms; bound "
                  f"{b_ms:.4f} ms ({b_by})", flush=True)
            if not (same and same_one):
                fail(f"rpe_attention_bwd with a pair axis of {b} not equal to one-pair launches")
            del args, fwd, got, ref, per_pair, pair_args, embed


def packed_shapes(gen):
    """Rows 2, 7, 4 and 5 at a packed training step's shapes (B 8 at the
    1024 bucket): the geometric embedding and its backward over B * 16^2 =
    2048 flat rows (H 256, k 3, bf16 out and cotangent), row 7 also against
    a float64 reduction (ROADMAP Queue 3 "Watch": its chunk count follows
    R); the Sinkhorn forward with its trajectory and the backward from it
    over B * 128 = 1024 patches of (65, 65) x 100. Each against its plain
    version with the tolerances of the single-pair shapes."""
    from roitr_torch.kernels.geo_embedding_kernel import (
        fused_geo_embedding,
        geo_embedding_bwd,
        geo_embedding_bwd_plain,
        geo_embedding_plain,
    )
    from roitr_torch.kernels.sinkhorn_kernel import sinkhorn_bwd, sinkhorn_bwd_plain, \
        sinkhorn_iterate, sinkhorn_plain
    from roitr_torch.ops.sinkhorn import sinkhorn_inputs

    dev = torch.device("cuda")
    r, k, hid = 8 * 16 * 16, 3, 256
    d_idx = (torch.rand(r, generator=gen) * 20).to(dev)
    a_idx = (torch.rand(r, k, generator=gen) * 12).to(dev)
    w = [((torch.rand(*s, generator=gen) * 2 - 1) / 16).to(dev)
         for s in ((hid, hid), (hid,), (hid, hid), (hid,))]
    with torch.no_grad():
        out, amap = fused_geo_embedding(d_idx, a_idx, *w, out_dtype=torch.bfloat16,
                                        with_argmax=True)
        ref = geo_embedding_plain(d_idx, a_idx, *w, out_dtype=torch.bfloat16)
        err = float((out.float() - ref.float()).abs().max())
        top = float(ref.float().abs().max())
        g = torch.randn(r, hid, generator=gen).to(dev, torch.bfloat16)
        dgot = geo_embedding_bwd(d_idx, a_idx, amap, g, hid)
        dref = geo_embedding_bwd_plain(d_idx, a_idx, amap, g, hid)
        d64 = geo_embedding_bwd_plain(d_idx.double(), a_idx.double(), amap, g.double(), hid)
        berr = max(float((x - y).abs().max()) for x, y in zip(dgot, dref))
        btop = max(float(y.abs().max()) for y in dref)
        rel64 = (max(float((x.double() - y).abs().max()) for x, y in zip(dgot, d64))
                 / max(float(y.abs().max()) for y in d64))
        ms = cuda_ms(lambda: fused_geo_embedding(d_idx, a_idx, *w, out_dtype=torch.bfloat16,
                                                 with_argmax=True), 20)
        bms = cuda_ms(lambda: geo_embedding_bwd(d_idx, a_idx, amap, g, hid), 20)
    print(f"[kernels] packed shapes: geo_embedding R={r} H={hid} k={k} (B 8 x 16^2) bf16 max abs "
          f"err {err:.3g} (tol {top / 128:.3g}), {ms:.4f} ms; geo_embedding_bwd max abs err "
          f"{berr:.3g} (tol {1e-4 * btop:.3g}), against float64 {rel64:.3g} of max|ref| (66 chunks "
          f"at R 262144: 2.15e-05), {bms:.4f} ms", flush=True)
    if not (err <= top / 128 and berr <= 1e-4 * btop):
        fail("geometric embedding kernels outside tolerance at the packed rows")

    p, kk, iters = 8 * 128, 64, 100
    scores = torch.randn(p, kk, kk, generator=gen).to(dev)
    rmask = (torch.rand(p, kk, generator=gen) > 0.1).to(dev)
    cmask = (torch.rand(p, kk, generator=gen) > 0.1).to(dev)
    padded, log_mu, log_nu, _ = sinkhorn_inputs(scores, rmask, cmask,
                                                torch.tensor(1.0, device=dev))
    out, tu, tv = sinkhorn_iterate(padded, log_mu, log_nu, iters, with_traj=True)
    ref = sinkhorn_plain(padded, log_mu, log_nu, iters)
    valid = ref > -1e5
    err = float((out - ref)[valid].abs().max())
    cot = torch.randn(padded.shape, generator=gen).to(dev) * valid
    got = sinkhorn_bwd(padded, log_mu, log_nu, cot, iters, traj=(tu, tv))
    bref = sinkhorn_bwd_plain(padded, log_mu, log_nu, cot, iters)
    berrs = [float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(got, bref)]
    ms = cuda_ms(lambda: sinkhorn_iterate(padded, log_mu, log_nu, iters, with_traj=True), 20)
    bms = cuda_ms(lambda: sinkhorn_bwd(padded, log_mu, log_nu, cot, iters, traj=(tu, tv)), 20)
    print(f"[kernels] packed shapes: sinkhorn ({p}, {kk + 1}, {kk + 1}) x {iters} with the "
          f"trajectory: max abs err {err:.3g} on valid entries (tol 1e-4), {ms:.4f} ms; "
          f"sinkhorn_bwd from it: ds, dmu, dnu max abs err / max|ref| "
          f"{', '.join(f'{e:.3g}' for e in berrs)} (tol 1e-4, 1e-3, 1e-3), {bms:.4f} ms",
          flush=True)
    if not (err <= 1e-4 and berrs[0] <= 1e-4 and max(berrs[1:]) <= 1e-3):
        fail("sinkhorn kernels outside tolerance at the packed patches")


def _pair(arr, n, m, device):
    from roitr_torch.data.preprocess import estimate_normals_np, normal_redirect_np
    from roitr_torch.models.roitr import PairInputs

    bucket = arr["src_points"].shape[0]
    view = np.zeros(3, np.float32)
    nrm = {}
    # normals of the raw source, as the datasets estimate them (a rigid
    # pair's raw source is its source)
    for side, c, key in (("src", n, "src_raw_points"), ("tgt", m, "tgt_points")):
        pts = arr[key]
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


def _corr_rows(res):
    """{(src xyz, tgt xyz): confidence} of a result's kept correspondences."""
    keys = np.concatenate([res["src_corr_pts"], res["tgt_corr_pts"]], axis=1)
    return {tuple(k): c for k, c in zip(keys.tolist(), res["confidence"].tolist())}


def _corr_diff(got, want):
    """(pairs in one result only, pairs in either, largest confidence
    difference on the shared pairs) of two results."""
    g, w = _corr_rows(got), _corr_rows(want)
    shared = set(g) & set(w)
    err = max((abs(g[k] - w[k]) for k in shared), default=0.0)
    return len(set(g) ^ set(w)), len(set(g) | set(w)), err


# launches of the four forward kernels a forward: FPS three levels (both
# clouds, or both sides of a packed batch, in one launch a level), the
# geometric embedding one a side, RPE attention one a self layer and side,
# Sinkhorn one
FORWARD_LAUNCHES = {"fps": 3, "geo_embedding": 2, "rpe_attention": 6, "sinkhorn": 1}


def phase_packed(cfg, state_dict, rng):
    """Matcher.match_batch at full 3DMatch width: 8 pairs of 600-1000 points
    in the 1024 bucket packed, and 2 pairs of 20k-30k points in the 32768
    bucket in map mode, each under prep="host" (host pyramids) and
    prep="device". Counters zeroed just before each call and read just
    after; pairs/s, peak memory; each pair against `match` of that pair on
    the same card (map mode: equal; packed: near-ties apart, see
    `_coarse_flips`)."""
    from roitr_torch.data.synthetic import make_pair_arrays
    from roitr_torch.kernels import FORWARD_KERNELS, launch_counts, reset_launch_counts
    from roitr_torch.serving import Matcher

    def clouds_of(count, bucket, lo, hi):
        out = []
        for _ in range(count):
            n, m = (int(c) for c in rng.randint(lo, hi + 1, size=2))
            arr = make_pair_arrays(rng, bucket, n, m)
            out.append((arr["src_points"][:n], arr["tgt_points"][:m]))
        return out

    small, big = clouds_of(8, 1024, 600, 1000), clouds_of(2, 32768, 20000, 30000)
    # a 1024 bucket below the config's smallest (4096); every correspondence
    # kept, so that the comparison with match has rows: random weights keep
    # none at the config's threshold
    overrides = dict(buckets=(1024,) + tuple(cfg.buckets),
                     fine_matching_confidence_threshold=0.0)
    print(f"[packed] Config(benchmark='3DMatch') with {overrides}; host_pyramid on under "
          "prep='host'", flush=True)
    for prep in ("host", "device"):
        mcfg = cfg.replace(host_pyramid=prep == "host", **overrides)
        matcher = Matcher(mcfg, state_dict, device="cuda", prep=prep)
        for clouds, mode in ((small, "packed"), (big, "map")):
            matcher.match_batch(clouds, batch_size=8, mode=mode)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.time()
            got = matcher.match_batch(clouds, batch_size=8, mode=mode)
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = {k: launch_counts[k] for k in FORWARD_KERNELS}
            forwards = 1 if mode == "packed" else len(clouds)
            want = {k: v * forwards for k, v in FORWARD_LAUNCHES.items()}
            if prep == "host":
                want["fps"] = 0  # host pyramids: no search on the card
            bucket = 1024 if mode == "packed" else 32768
            print(f"[packed] prep={prep} mode={mode} bucket {bucket}: {len(clouds)} pairs in "
                  f"{wall * 1e3:.1f} ms, {len(clouds) / wall:.2f} pairs/s (host prep "
                  f"included); max_memory_allocated "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches {launches} "
                  f"(expected {want})", flush=True)
            if launches != want:
                fail(f"match_batch prep={prep} mode={mode}: launches {launches}, expected {want}")
            # near-ties of random weights: the packed forward's products
            # (B * N rows) round apart from the single-pair forward's, and a
            # coarse correspondence at a near-tie may go another way; each
            # such one changes at most point_per_patch * fine_matching_topk
            # rows of a result. Map mode runs the single-pair forward itself.
            flips = _coarse_flips(matcher, mcfg, clouds, prep) if mode == "packed" else None
            diffs = []
            for i, (src, tgt) in enumerate(clouds):
                res = got[i]
                if not all(np.isfinite(v).all() for v in res.values()):
                    fail(f"match_batch prep={prep} mode={mode} pair {i}: not finite")
                d, u, e = _corr_diff(res, matcher.match(src, tgt))
                allowed = 0 if flips is None else (
                    0.02 * u + flips[i] * mcfg.point_per_patch * mcfg.fine_matching_topk)
                diffs.append((d, u, e))
                if d > allowed or e > 1e-4:
                    fail(f"match_batch prep={prep} mode={mode} pair {i}: {d} of {u} (src, tgt) "
                         f"pairs differ from match's (allowed {allowed:g}), confidence {e:.3g}")
            print(f"[packed] prep={prep} mode={mode}: against match of each pair, (src, tgt) "
                  f"pairs in one result only / in either: "
                  f"{', '.join(f'{d}/{u}' for d, u, _ in diffs)}; largest confidence "
                  f"difference on shared pairs {max(e for _, _, e in diffs):.3g} (tol 1e-4)"
                  + (f"; coarse correspondences at near-ties a pair {flips}" if flips else ""),
                  flush=True)


def _coarse_flips(matcher, cfg, clouds, prep):
    """Per pair, the coarse (tgt node, src node) correspondences that the
    packed forward and the single-pair forward do not share; fails unless
    the node descriptors agree (cos >= 0.9999) and at most 5% differ."""
    from roitr_torch.data.packing import pack_pairs
    from roitr_torch.ops.pyramid import device_prep_packed, device_prep_pair
    from roitr_torch.utils.packing import to_device

    dev = torch.device("cuda")
    est = (prep == "device",) * 2
    pairs = [matcher._prepare(src, tgt, None, None)[0] for src, tgt in clouds]
    corr = lambda o: {(int(t), int(s)) for t, s, k in zip(o["tgt_node_corr_indices"],
                                                          o["src_node_corr_indices"],
                                                          o["node_corr_masks"]) if k}
    flips, cos_min, total = [], 1.0, 0
    with torch.no_grad():
        batch = to_device(pack_pairs(pairs, require_pyramids=prep == "host"), dev)
        out = matcher.model(device_prep_packed(batch, cfg, est,
                                               pyramid=batch.src_pyramid is None))
        for i, pair in enumerate(pairs):
            one = matcher.model(device_prep_pair(to_device(pair, dev), cfg, est))
            packed_corr, one_corr = corr({k: v[i] for k, v in out.items()}), corr(one)
            flips.append(len(packed_corr ^ one_corr))
            total += len(one_corr)
            for side in ("src", "tgt"):
                nc = int(one[f"{side}_node_count"])
                cos_min = min(cos_min, float(_cos(out[f"{side}_node_feats"][i][:nc],
                                                  one[f"{side}_node_feats"][:nc]).min()))
    print(f"[packed] prep={prep} packed forward against single-pair forwards: coarse "
          f"correspondences in one only {sum(flips)} of {total}; node descriptors min cos "
          f"{cos_min:.7f} (tol >= 0.9999)", flush=True)
    if not cos_min >= 0.9999 or sum(flips) > 0.05 * total:
        fail(f"packed forward disagrees with the single-pair forward (prep={prep})")
    return flips


def phase_host_pyramid(cfg, state_dict, rng):
    """The native host pyramid (data/pyramid.py) of 20k-30k-point clouds,
    split into FPS and kNN, beside the searches the backbone runs on the
    card without a pyramid (FPS of both clouds, and every level's cross,
    self and 3-NN kNN); the forward alone with and without the pyramid;
    then Matcher.match request walls with prep="host", host_pyramid on and
    off, in turns."""
    from roitr_torch import native
    from roitr_torch.data.pyramid import build_cloud_pyramid
    from roitr_torch.data.synthetic import make_pair_arrays
    from roitr_torch.models.backbone import _device_fps_pyramids
    from roitr_torch.ops.fps import num_valid_samples
    from roitr_torch.ops.neighbors import masked_knn
    from roitr_torch.serving import Matcher
    from roitr_torch.utils.packing import to_device

    sizes = [(30000, 26000), (24000, 28500)]
    arrays = [make_pair_arrays(rng, 32768, n, m) for n, m in sizes]
    native.get_lib()  # the build is not timed
    host_total, host_fps, first_diff = [], [], []
    dev_fps, dev_knn = [], []
    for arr, (n, m) in zip(arrays, sizes):
        chains = {}
        for side, c in (("src", n), ("tgt", m)):
            pts = arr[f"{side}_points"]
            t0 = time.perf_counter()
            build_cloud_pyramid(pts, c)
            host_total.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            cur, chain = pts[:c], []
            for _ in range(3):
                idx = native.fps(cur, max(len(cur) // 4, 1))
                chain.append(idx)
                cur = cur[idx]
            host_fps.append((time.perf_counter() - t0) * 1e3)
            chains[side] = chain[0]
        # the backbone's searches for this pair on the card, no pyramid
        p = {s: torch.from_numpy(arr[f"{s}_points"]).cuda() for s in ("src", "tgt")}
        c = {"src": torch.tensor(n, device="cuda"), "tgt": torch.tensor(m, device="cuda")}
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fps = _device_fps_pyramids(p["src"], c["src"], p["tgt"], c["tgt"], cfg.enc_strides)
            torch.cuda.synchronize()
            dev_fps.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            for side, side_fps in (("src", fps[0]), ("tgt", fps[1])):
                cur, cnt = p[side], c[side]
                for stride, k, idx in zip(cfg.enc_strides, cfg.enc_nsample, side_fps):
                    new, new_cnt = cur, cnt
                    if idx is not None:
                        new, new_cnt = cur[idx], num_valid_samples(cnt, stride)
                        masked_knn(cur, new, new_cnt, 3)  # the decoder's 3-NN
                    masked_knn(new, cur, cnt, k, exclude_self=True)
                    masked_knn(new, new, new_cnt, k, exclude_self=True)
                    cur, cnt = new, new_cnt
            torch.cuda.synchronize()
            dev_knn.append((time.perf_counter() - t0) * 1e3)
        for j, side in enumerate(("src", "tgt")):
            host = chains[side]
            differ = np.nonzero(fps[j][1][:len(host)].cpu().numpy() != host)[0]
            first_diff.append(f"{differ[0]} of {len(host)}" if len(differ) else "none")
    fmt = lambda v: ", ".join(f"{x:.1f}" for x in v)
    knn_host = [t - f for t, f in zip(host_total, host_fps)]
    print(f"[host pyramid] native build_cloud_pyramid a cloud (one core): {fmt(host_total)} ms, "
          f"of which FPS {fmt(host_fps)} ms and kNN {fmt(knn_host)} ms; the backbone's "
          f"searches on the card without a pyramid, a pair (two clouds): FPS {fmt(dev_fps)} ms, "
          f"kNN {fmt(dev_knn)} ms", flush=True)
    print(f"[host pyramid] native FPS against the FPS kernel, first sampled level, first pick "
          f"that differs a cloud: {first_diff} (the host rounds squared distances with FMA "
          f"under -ffast-math, the kernel without, so a near-tie pick may diverge)", flush=True)

    src, tgt = (arrays[0][f"{s}_points"][:c] for s, c in (("src", sizes[0][0]),
                                                           ("tgt", sizes[0][1])))
    matchers = {on: Matcher(cfg.replace(host_pyramid=on), state_dict, device="cuda")
                for on in (True, False)}
    # the forward alone, normals given, with the host pyramid and without
    pair, _ = matchers[True]._prepare(src, tgt, np.zeros_like(src), np.zeros_like(tgt))
    inputs = {True: to_device(pair, "cuda"),
              False: to_device(pair._replace(src_pyramid=None, tgt_pyramid=None), "cuda")}
    fwd = {True: [], False: []}
    with torch.no_grad():
        for on in (True, False):
            matchers[on].model(inputs[on])  # warm-up
        for _ in range(3):
            for on in (True, False):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                matchers[on].model(inputs[on])
                torch.cuda.synchronize()
                fwd[on].append((time.perf_counter() - t0) * 1e3)
    print(f"[host pyramid] forward alone (inputs on the card), in turns: with the host "
          f"pyramid {fmt(fwd[True])} ms, without {fmt(fwd[False])} ms", flush=True)
    for m in matchers.values():
        m.match(src, tgt)  # warm-up
    walls = {True: [], False: []}
    for _ in range(3):
        for on in (True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            matchers[on].match(src, tgt)
            torch.cuda.synchronize()
            walls[on].append((time.perf_counter() - t0) * 1e3)
    print(f"[host pyramid] match request wall, prep='host', {len(src)} + {len(tgt)} points, in "
          f"turns: host_pyramid on {fmt(walls[True])} ms, off {fmt(walls[False])} ms", flush=True)


# the keys of a dump of the JAX package's Tester (roitr_tpu/eval/tester.py
# trim_outputs), in both dump modes
DUMP_FILE_KEYS = {"src_raw_pcd", "src_pcd", "tgt_pcd", "src_nodes", "tgt_nodes", "src_node_desc",
                  "tgt_node_desc", "src_point_desc", "tgt_point_desc", "src_corr_pts",
                  "tgt_corr_pts", "confidence", "gt_tgt_node_occ", "gt_src_node_occ", "rot",
                  "trans"}


def _write_tdmatch_split(rng, sizes, base):
    """Synthetic pairs of the given (source, target) counts in the
    reference's 3DMatch layout under `base`: `.pth` fragments under
    base/indoor/test/scene<i> and the info pickle base/test_split.pkl.
    Returns (data root, info path)."""
    import pickle

    from roitr_torch.data.synthetic import make_pair_arrays

    infos = {"rot": [], "trans": [], "src": [], "tgt": [], "overlap": []}
    for i, (n, m) in enumerate(sizes):
        arr = make_pair_arrays(rng, 32768, n, m)
        scene = f"test/scene{i}"
        os.makedirs(os.path.join(base, "indoor", scene))
        for j, cloud in ((2 * i, arr["src_points"][:n]), (2 * i + 1, arr["tgt_points"][:m])):
            torch.save(torch.from_numpy(cloud.copy()),
                       os.path.join(base, "indoor", scene, f"cloud_bin_{j}.pth"))
        infos["src"].append(f"{scene}/cloud_bin_{2 * i}.pth")
        infos["tgt"].append(f"{scene}/cloud_bin_{2 * i + 1}.pth")
        infos["rot"].append(arr["rot"])
        infos["trans"].append(arr["trans"])
        infos["overlap"].append(0.7)
    info = os.path.join(base, "test_split.pkl")
    with open(info, "wb") as f:
        pickle.dump(infos, f)
    return os.path.join(base, "indoor"), info


def phase_tester(rng):
    """The Tester at full 3DMatch width from configs/test/tdmatch.yaml on a
    test split in the reference layout (three synthetic pairs of 20k-30k
    points, `.pth` fragments and an info pickle, in a temporary directory):
    host prep (host pyramids) with full dumps, device prep with full dumps,
    device prep with c2f dumps, and packed batches of two under host and
    device prep; counters zeroed before each run and read after it. The
    pairs are prepared in the Tester's process (num_workers 0; the pool is
    [workers]'s)."""
    from roitr_torch.config import load_config
    from roitr_torch.data import get_dataset
    from roitr_torch.data.loader import dict_to_pair
    from roitr_torch.data.pyramid import build_cloud_pyramid
    from roitr_torch.eval import get_trainer
    from roitr_torch.eval.tester import compact_corr
    from roitr_torch.kernels import FORWARD_KERNELS, launch_counts, reset_launch_counts
    from roitr_torch.models.roitr import RoITr
    from roitr_torch.ops.normals import estimate_normals
    from roitr_torch.ops.pyramid import device_prep_pair

    sizes = [(29000, 25500), (24000, 27500), (26500, 21000)]
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            root, info = _write_tdmatch_split(rng, sizes, tmp)
            yaml_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                                     "test", "tdmatch.yaml")
            overrides = dict(root=root, test_info=info, pretrain=os.path.join(tmp, "weights.pth"),
                             num_workers=0)
            print(f"[tester] {yaml_path} with overrides {overrides}", flush=True)
            cfg = load_config(yaml_path, **overrides)
            torch.save({"model": RoITr(cfg, device="cpu", seed=0).state_dict()}, cfg.pretrain)

            runs = {}
            packed = dict(packed_batch=True, batch_size=2)
            for name, kw in (("host_full", {}), ("device_full", dict(device_prep=True)),
                             ("device_c2f", dict(device_prep=True, dump_mode="c2f")),
                             ("host_packed", packed),
                             ("device_packed", dict(packed, device_prep=True))):
                run_cfg = cfg.replace(exp_dir=name, **kw)
                tester = get_trainer(run_cfg)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launch_counts()
                t0 = time.time()
                tester.test()
                torch.cuda.synchronize()
                wall = time.time() - t0
                launches = dict(launch_counts)
                dumps = [torch.load(os.path.join(tester.snapshot_dir, f"{i}.pth"),
                                    weights_only=False) for i in range(len(sizes))]
                print(f"[tester] {name}: {wall / len(sizes):.3f} s/pair over {len(sizes)} pairs "
                      f"(host prep, forward and dumps); max_memory_allocated "
                      f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}; "
                      f"correspondences {[int(d['confidence'].shape[0]) for d in dumps]} "
                      f"(random weights: the count carries no meaning)", flush=True)
                # three pairs: three forwards, or two packed ones (a pack of
                # two and a tail of one); host prep attaches host
                # pyramids (cfg.host_pyramid), so no FPS runs on the card
                forwards = 2 if run_cfg.packed_batch else len(sizes)
                want = {k: v * forwards for k, v in FORWARD_LAUNCHES.items()}
                if not run_cfg.device_prep:
                    want["fps"] = 0
                if {k: launches[k] for k in FORWARD_KERNELS} != want:
                    fail(f"Tester ({name}) launches {launches}, expected {want}")
                backward = [k for k, v in launches.items() if v and k not in FORWARD_KERNELS]
                if backward:
                    fail(f"backward kernels launched by the Tester ({name}): {backward}")
                for i, ((n, m), d) in enumerate(zip(sizes, dumps)):
                    if set(d) != DUMP_FILE_KEYS:
                        fail(f"{name} dump {i}: keys {sorted(set(d) ^ DUMP_FILE_KEYS)} differ "
                             "from the JAX Tester's")
                    nodes = (d["src_nodes"].shape[0], d["tgt_nodes"].shape[0])
                    shapes = {"src_raw_pcd": (n, 3), "src_pcd": (n, 3), "tgt_pcd": (m, 3),
                              "gt_src_node_occ": (nodes[0],), "gt_tgt_node_occ": (nodes[1],),
                              "tgt_corr_pts": tuple(d["src_corr_pts"].shape),
                              "confidence": (d["src_corr_pts"].shape[0],)}
                    if "full" in name:
                        shapes.update(src_point_desc=(n, 256), tgt_point_desc=(m, 256),
                                      src_node_desc=(nodes[0], 256),
                                      tgt_node_desc=(nodes[1], 256))
                    wrong = {k: tuple(d[k].shape) for k, v in shapes.items()
                             if tuple(d[k].shape) != v}
                    if wrong or not 0 < nodes[0] <= n // 64:
                        fail(f"{name} dump {i}: ragged shapes {wrong}, expected {shapes}; "
                             f"nodes {nodes}")
                    if not all(torch.isfinite(v).all() for v in d.values()):
                        fail(f"{name} dump {i} is not finite")
                runs[name] = dumps

            for i, (full, c2f) in enumerate(zip(runs["device_full"], runs["device_c2f"])):
                if full["confidence"].shape[0] <= cfg.dump_corr_cap and not all(
                        torch.equal(full[k], c2f[k]) for k in ("src_corr_pts", "tgt_corr_pts",
                                                               "confidence")):
                    fail(f"pair {i}: the c2f dump's correspondences differ from the full dump's")
            # packed dumps against the single-pair dumps, file by file
            geometry = ("src_raw_pcd", "src_pcd", "tgt_pcd", "src_nodes", "tgt_nodes", "rot",
                        "trans")
            corr = ("src_corr_pts", "tgt_corr_pts", "confidence")
            for single_name, packed_name in (("host_full", "host_packed"),
                                             ("device_full", "device_packed")):
                worst = 0.0
                for i, (one, pk) in enumerate(zip(runs[single_name], runs[packed_name])):
                    if set(one) != set(pk) or any(one[k].shape != pk[k].shape or
                                                  one[k].dtype != pk[k].dtype for k in one):
                        fail(f"{packed_name} dump {i}: keys, shapes or dtypes differ from "
                             f"{single_name}'s")
                    if not all(torch.equal(one[k], pk[k]) for k in geometry):
                        fail(f"{packed_name} dump {i}: geometry differs from {single_name}'s")
                    for k, v in one.items():
                        if k in geometry or k in corr or not v.is_floating_point():
                            continue
                        top = max(float(v.abs().max()), 1e-6) if v.numel() else 1.0
                        worst = max(worst, float((pk[k] - v).abs().max()) / top
                                    if v.numel() else 0.0)
                    d, u, e = _corr_diff(*({"src_corr_pts": x["src_corr_pts"].numpy(),
                                            "tgt_corr_pts": x["tgt_corr_pts"].numpy(),
                                            "confidence": x["confidence"].numpy()}
                                           for x in (pk, one)))
                    if d > 0.05 * u or e > 1e-4:
                        fail(f"{packed_name} dump {i}: correspondences differ ({d} of {u})")
                print(f"[tester] {packed_name} dumps against {single_name}'s: keys, shapes, "
                      f"dtypes and geometry equal; descriptors and occlusion scores within "
                      f"{worst:.3g} of the largest value (tol 1e-4)", flush=True)
                if not worst <= 1e-4:
                    fail(f"{packed_name} dumps differ from {single_name}'s")

            # device prep against host prep. Host prep attaches host pyramids,
            # whose native FPS rounds distances with FMA, unlike the FPS kernel
            # of device prep: where a near-tie pick diverges the nodes differ,
            # and so do descriptors. Such a cloud's host nodes are held to the
            # native FPS of the same points instead; at most half the clouds
            # may diverge, and at least one is compared
            cos_min, diverged, compared = 1.0, [], 0
            for i, (host, dev) in enumerate(zip(runs["host_full"], runs["device_full"])):
                for k in ("src_pcd", "tgt_pcd", "rot", "trans"):
                    if not torch.equal(host[k], dev[k]):
                        fail(f"pair {i}: {k} differs between host and device prep")
                for side, raw, pcd in (("src", "src_raw_pcd", "src_pcd"),
                                       ("tgt", "tgt_pcd", "tgt_pcd")):
                    if torch.equal(host[f"{side}_nodes"], dev[f"{side}_nodes"]):
                        k = f"{side}_node_desc"
                        cos_min = min(cos_min, float(_cos(host[k], dev[k]).min()))
                        compared += 1
                        continue
                    diverged.append(f"{i} {side}")
                    pyr = build_cloud_pyramid(host[raw].numpy(), host[raw].shape[0],
                                              strides=tuple(cfg.enc_strides),
                                              nsample=tuple(cfg.enc_nsample))
                    picks = torch.from_numpy(pyr.fps_idx2[pyr.fps_idx3][pyr.fps_idx4]).long()
                    if not torch.equal(host[f"{side}_nodes"], host[pcd][picks]):
                        fail(f"pair {i} {side}: host prep's nodes are not the native FPS "
                             "picks of the same points")
            clouds = 2 * len(sizes)
            print(f"[tester] c2f correspondences equal the full dumps' (cap "
                  f"{cfg.dump_corr_cap}); device prep against host prep: {len(diverged)} of "
                  f"{clouds} clouds' nodes differ (FPS near-tie, host FMA) "
                  f"{diverged or ''}, their host nodes equal native FPS of the same points; "
                  f"node descriptors of the other {compared} min cos {cos_min:.6f} "
                  f"(tol > 0.99)", flush=True)
            if not compared or 2 * len(diverged) > clouds:
                fail(f"{len(diverged)} of {clouds} clouds' nodes differ between device and "
                     "host prep (at most half may)")
            if not cos_min > 0.99:
                fail("node descriptors of device prep disagree with host prep")
            # random weights keep no correspondence at the config's threshold, so
            # the compaction is also held, on the card, to an output that keeps
            # every one (threshold 0), under the cap and over it
            keep_all = cfg.replace(fine_matching_confidence_threshold=0.0, device_prep=True)
            model = RoITr(keep_all, device="cuda", seed=0).eval()
            with torch.no_grad():
                out = model(device_prep_pair(dict_to_pair(get_dataset(keep_all, "test")[0],
                                                          "cuda"), keep_all), with_gt=True)
            mask = out["corr_masks"]
            total = int(mask.sum())
            for cap in (cfg.dump_corr_cap, total // 2):
                c = compact_corr(out, cap)
                n = int(c["corr_count"])
                if n != min(total, cap) or not all(
                        torch.equal(c[k][:n], out[k][mask][:n])
                        for k in ("src_corr_points", "tgt_corr_points", "corr_scores")):
                    fail(f"compact_corr on the card at cap {cap}: {n} rows, not the masked "
                         f"selection of {total}")
            print(f"[tester] compact_corr on the card, every correspondence kept: {total} rows "
                  f"equal the masked selection under the cap and its first {total // 2} at cap "
                  f"{total // 2}", flush=True)

            # device normals on the card against the host's (scipy) normals
            host_ds = get_dataset(cfg, "test")
            frac_min, normal_ms = 1.0, []
            for i in range(len(sizes)):
                item = host_ds[i]
                sides = []
                torch.cuda.synchronize()
                t0 = time.time()
                for pts_key, count_key in (("src_raw_points", "src_count"),
                                           ("tgt_points", "tgt_count")):
                    pts = torch.from_numpy(item[pts_key]).cuda()
                    sides.append(estimate_normals(pts, torch.tensor(int(item[count_key]),
                                                                    device="cuda"),
                                                  k=cfg.normal_knn))
                torch.cuda.synchronize()
                normal_ms.append((time.time() - t0) * 1e3)
                for dev_n, side in zip(sides, ("src", "tgt")):
                    c = int(item[f"{side}_count"])
                    dots = (dev_n[:c].cpu() * torch.from_numpy(item[f"{side}_normals"][:c])).sum(-1)
                    frac_min = min(frac_min, float((dots > 0.999).double().mean()))
            print(f"[tester] device normals of a pair (both clouds, H2D of the points included): "
                  f"{', '.join(f'{t:.1f}' for t in normal_ms)} ms; dot > 0.999 with the host "
                  f"normals on at least {frac_min:.4%} of valid points (tol >= 98%)", flush=True)
            if not frac_min >= 0.98:
                fail("device normals disagree with the host normals")
        finally:
            os.chdir(cwd)


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
    _compare_grads("[train parity]", "card vs CPU", [lg], gg, [lc], gc)


def _compare_grads(phase, tag, lg, gg, lc, gc):
    """Losses (lists of per-pair dicts) within 1e-3 relative; gradients'
    cosine over all >= 0.9999 and each parameter's |a - b| within 1e-2 of
    max(|b|, 1e-3 of the largest |b|); fails otherwise."""
    loss_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6) for a, b in zip(lg, lc) for k in b)
    norms = {k: float(v.norm()) for k, v in gc.items()}
    floor = 1e-3 * max(norms.values())
    worst, worst_key = 0.0, ""
    for k in gc:
        rel = float((gg[k] - gc[k]).norm()) / max(norms[k], floor)
        if rel > worst:
            worst, worst_key = rel, k
    fg = torch.cat([v.flatten() for v in gg.values()])
    fc = torch.cat([v.flatten() for v in gc.values()])
    cos = float(fg @ fc / (fg.norm() * fc.norm()))
    finite = all(torch.isfinite(v).all() for v in gg.values())
    print(f"{phase} {tag}: losses largest relative difference {loss_err:.3g} (tol 1e-3); "
          f"gradients of {len(gc)} parameters: cosine over all {cos:.7f} (tol >= 0.9999), "
          f"worst |a - b| / max(|b|, 1e-3 * largest |b|) {worst:.3g} in {worst_key} (tol 1e-2); "
          f"finite {finite}", flush=True)
    if not (finite and loss_err <= 1e-3 and cos >= 0.9999 and worst <= 1e-2):
        fail(f"{phase} {tag}: gradients or losses disagree")


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
                      max_epoch=1, training_max_iter=3, val_max_iter=1, verbose_freq=1,
                      num_workers=0)
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


class _WithPyramids:
    """Items of a dataset with both clouds' host pyramids attached, as
    data/tdmatch.py yields them under cfg.host_pyramid (JAX's
    tests/test_trainer.py PyramidDataset); built once, up front."""

    def __init__(self, dataset, cfg):
        from roitr_torch.data.pyramid import build_cloud_pyramid

        kw = dict(strides=tuple(cfg.enc_strides), nsample=tuple(cfg.enc_nsample))
        self.items = []
        for i in range(len(dataset)):
            d = dict(dataset[i])
            d["src_pyramid"] = build_cloud_pyramid(d["src_raw_points"], int(d["src_count"]), **kw)
            d["tgt_pyramid"] = build_cloud_pyramid(d["tgt_points"], int(d["tgt_count"]), **kw)
            self.items.append(d)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


# launches a packed train step of B pairs and a packed validation step:
# each kernel once a layer or a side for all B pairs, no FPS (host pyramids)
PACKED_TRAIN_STEP = {"fps": 0, "geo_embedding": 2, "rpe_attention": 6, "sinkhorn": 1,
                     "sinkhorn_bwd": 1, "rpe_attention_bwd": 6, "geo_embedding_bwd": 2}
PACKED_VAL_STEP = {"fps": 0, "geo_embedding": 2, "rpe_attention": 6, "sinkhorn": 1,
                   "sinkhorn_bwd": 0, "rpe_attention_bwd": 0, "geo_embedding_bwd": 0}


def _train_cfg(**overrides):
    """configs/train/tdmatch.yaml through load_config; the pairs prepared in
    process (num_workers 0) unless the overrides say otherwise."""
    from roitr_torch.config import load_config

    return load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                                    "train", "tdmatch.yaml"), **{"num_workers": 0, **overrides})


def _step_ms(fn):
    torch.cuda.synchronize()
    t0 = time.time()
    fn()
    torch.cuda.synchronize()
    return (time.time() - t0) * 1e3


def phase_packed_training(rng, single_launches):
    """Trainer at full 3DMatch width from configs/train/tdmatch.yaml with
    packed_batch, batch_size 8 and host pyramids: 24 synthetic pairs of
    600-1000 points in the 1024 bucket (3 packed train steps) and 8 for
    validation (1 packed step), in a temporary directory. Counters zeroed
    before and read after; launches required exactly (PACKED_TRAIN_STEP,
    PACKED_VAL_STEP; the per-step counts also against the single-pair
    [training] phase's). Then one packed step of 8 pairs against 8
    single-pair steps of the same pairs, in turns, with the step's ms,
    pairs/s and peak memory. Returns the launch counts of the Trainer run."""
    from roitr_torch.data.loader import dict_to_pair
    from roitr_torch.data.packing import pack_pairs
    from roitr_torch.data.synthetic import SyntheticPairs
    from roitr_torch.kernels import launch_counts, reset_launch_counts
    from roitr_torch.parallel.train_step import train_step
    from roitr_torch.train.trainer import Trainer

    overrides = dict(packed_batch=True, batch_size=8, host_pyramid=True, max_epoch=1,
                     training_max_iter=24, val_max_iter=8, verbose_freq=1)
    cfg = _train_cfg(**overrides)
    print(f"[packed training] configs/train/tdmatch.yaml with overrides {overrides}", flush=True)
    # a train step of the single-pair [training] run (3 train + 1 validation
    # steps) launches what a packed step does, but FPS (no host pyramid there)
    single = {k: (single_launches[k] - PACKED_VAL_STEP[k]) / 3 for k in PACKED_TRAIN_STEP
              if k != "fps"}
    if single != {k: v for k, v in PACKED_TRAIN_STEP.items() if k != "fps"}:
        fail(f"a single-pair train step launched {single}, a packed one should launch "
             f"{PACKED_TRAIN_STEP}")
    seed = int(rng.randint(1 << 30))
    t0 = time.time()
    train_set = _WithPyramids(SyntheticPairs(24, 1024, counts=(600, 1000), seed=seed), cfg)
    val_set = _WithPyramids(SyntheticPairs(8, 1024, counts=(600, 1000), seed=seed + 100), cfg)
    print(f"[packed training] 24 + 8 synthetic pairs with normals and host pyramids in "
          f"{time.time() - t0:.1f} s (host)", flush=True)
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
        finally:
            os.chdir(cwd)
    steps = [e for e in events if e["phase"] == "train"]
    for i, (t, e) in enumerate(zip(trainer.step_times, steps)):
        total = t["forward_ms"] + t["backward_ms"] + t["optimizer_ms"]
        print(f"[packed training] step {i} (8 pairs): forward {t['forward_ms']:.1f} ms, backward "
              f"{t['backward_ms']:.1f} ms, optimizer {t['optimizer_ms']:.1f} ms, "
              f"{8e3 / total:.2f} pairs/s; running loss {e['loss']:.4f}, grads_finite "
              f"{e['grads_finite']:.0f}", flush=True)
    changed = sum(not torch.equal(v, before[k]) for k, v in trainer.model.state_dict().items())
    want = {k: 3 * PACKED_TRAIN_STEP[k] + PACKED_VAL_STEP[k] for k in PACKED_TRAIN_STEP}
    print(f"[packed training] {trainer.step} packed train steps + 1 packed validation step in "
          f"{wall:.1f} s; max_memory_allocated {peak / 2**30:.3f} GiB; {changed} of "
          f"{len(before)} tensors changed; val {best}; launches {launches} (expected {want})",
          flush=True)
    if trainer.step != 3 or len(steps) != 3:
        fail(f"expected 3 packed train steps, ran {trainer.step}")
    if not all(np.isfinite(e["loss"]) and e["grads_finite"] == 1.0 for e in steps):
        fail("a packed train step's loss or gradients were not finite")
    if not np.isfinite(best["loss"]) or changed == 0:
        fail("packed validation loss not finite, or the parameters did not change")
    if launches != want:
        fail(f"packed training launches {launches}, expected {want}")

    # one packed step of 8 pairs against 8 single-pair steps of the same
    # pairs, in turns (packed, single, single, packed), the same model
    pairs = [dict_to_pair(train_set[i], "cuda") for i in range(8)]
    packed = pack_pairs(pairs)
    model, opt = trainer.model, trainer.optimizer
    gen = torch.Generator().manual_seed(seed)
    runs = {"packed": [], "single": []}
    peaks = {}
    for kind in ("packed", "single", "single", "packed"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if kind == "packed":
            runs[kind].append(_step_ms(lambda: train_step(model, opt, packed, gen)))
        else:
            runs[kind].append(_step_ms(lambda: [train_step(model, opt, p, gen) for p in pairs]))
        peaks[kind] = torch.cuda.max_memory_allocated()
    print(f"[packed training] in turns, 8 pairs of 600-1000 points (1024 bucket): one packed "
          f"step {', '.join(f'{t:.1f}' for t in runs['packed'])} ms "
          f"({', '.join(f'{8e3 / t:.2f}' for t in runs['packed'])} pairs/s), peak "
          f"{peaks['packed'] / 2**30:.3f} GiB; 8 single-pair steps "
          f"{', '.join(f'{t:.1f}' for t in runs['single'])} ms "
          f"({', '.join(f'{8e3 / t:.2f}' for t in runs['single'])} pairs/s), peak "
          f"{peaks['single'] / 2**30:.3f} GiB", flush=True)
    return launches


def _packed_grads(model, pairs, seed):
    """Packed forward of `pairs`, mean of the per-pair losses, backward:
    (per-pair losses, {name: gradient on the CPU in float64})."""
    from roitr_torch.data.packing import pack_pairs
    from roitr_torch.losses import overall_loss

    model.zero_grad(set_to_none=True)
    packed = pack_pairs(pairs)
    out = model(packed, train=True, with_gt=True, generator=torch.Generator().manual_seed(seed))
    losses = [overall_loss(model.cfg, {k: v[i] for k, v in out.items()}, packed.rot[i],
                           packed.trans[i]) for i in range(len(pairs))]
    torch.stack([ls["loss"] for ls in losses]).mean().backward()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu().double()
             for k, p in model.named_parameters()}
    return [{k: float(v.detach()) for k, v in ls.items()} for ls in losses], grads


def phase_packed_train_parity(rng):
    """One packed batch of 4 pairs of 600-1000 points (1024 bucket, host
    pyramids) at full width, fp32 embedding storage: the card's packed
    gradient against the CPU's (same weights, same Gumbel draws), and
    against the mean of the 4 single-pair gradients on the card with the GT
    sampler saturated (num_gt_coarse_corr = max_gt_corr_candidates, as
    JAX's test_packed_train_step_grads), so that no draw decides a patch."""
    from roitr_torch.data.loader import dict_to_pair
    from roitr_torch.data.synthetic import SyntheticPairs
    from roitr_torch.losses import overall_loss
    from roitr_torch.models.roitr import RoITr

    cfg = _train_cfg(geo_embedding_storage="fp32", num_gt_coarse_corr=256,
                     max_gt_corr_candidates=256)
    seed = int(rng.randint(1 << 30))
    items = _WithPyramids(SyntheticPairs(4, 1024, counts=(600, 1000), seed=seed), cfg).items
    t0 = time.time()
    card_model = RoITr(cfg, device="cuda", seed=1)
    lg, gg = _packed_grads(card_model, [dict_to_pair(d, "cuda") for d in items], seed)
    torch.cuda.synchronize()
    t_card = time.time() - t0
    t0 = time.time()
    lc, gc = _packed_grads(RoITr(cfg, device="cpu", seed=1), [dict_to_pair(d) for d in items],
                           seed)
    print(f"[packed train parity] 4 pairs, 1024 bucket, full width, fp32 storage, "
          f"num_gt_coarse_corr = max_gt_corr_candidates = 256: card step {t_card:.1f} s, CPU "
          f"step {time.time() - t0:.1f} s", flush=True)
    _compare_grads("[packed train parity]", "card packed vs CPU packed", lg, gg, lc, gc)
    card_model.zero_grad(set_to_none=True)
    gen = torch.Generator().manual_seed(seed + 1)
    ls = []
    for d in items:
        pair = dict_to_pair(d, "cuda")
        out = card_model(pair, train=True, with_gt=True, generator=gen)
        losses = overall_loss(cfg, out, pair.rot, pair.trans)
        (losses["loss"] / len(items)).backward()
        ls.append({k: float(v.detach()) for k, v in losses.items()})
    gs = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu().double()
          for k, p in card_model.named_parameters()}
    _compare_grads("[packed train parity]", "card packed vs mean of 4 card single-pair "
                   "steps", lg, gg, ls, gs)


# launches of one full-width train step (device FPS, no host pyramids) and
# of one validation step
TRAIN_STEP = {"fps": 3, "geo_embedding": 2, "rpe_attention": 6, "sinkhorn": 1,
              "sinkhorn_bwd": 1, "rpe_attention_bwd": 6, "geo_embedding_bwd": 2}
VAL_STEP = {"fps": 3, "geo_embedding": 2, "rpe_attention": 6, "sinkhorn": 1,
            "sinkhorn_bwd": 0, "rpe_attention_bwd": 0, "geo_embedding_bwd": 0}


def _fd_cfg(kind: str, **overrides):
    """configs/<kind>/fdmatch.yaml through load_config, the pairs prepared
    in process (num_workers 0)."""
    from roitr_torch.config import load_config

    return load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                                    kind, "fdmatch.yaml"),
                       **{"num_workers": 0, **overrides})


def _write_flow_entries(rng, base, sizes):
    """Synthetic flow pairs of the given (source, target) counts as the
    reference's .npz entries under <base>/split/4DMatch/scene0, each with a
    metric_index of every 10th source point; returns the split path
    relative to base."""
    from roitr_torch.data.synthetic import make_flow_pair_arrays

    scene = os.path.join(base, "split", "4DMatch", "scene0")
    os.makedirs(scene)
    for i, (n, m) in enumerate(sizes):
        arr = make_flow_pair_arrays(rng, 32768, n, m)
        np.savez(os.path.join(scene, f"pair{i:02d}.npz"), s_pc=arr["src_raw_points"][:n],
                 t_pc=arr["tgt_points"][:m], s2t_flow=arr["flow"][:n], rot=arr["rot"],
                 trans=arr["trans"], metric_index=np.arange(0, n, 10)[None])
    return os.path.join("split", "4DMatch")


class _Widths:
    """Records the width of each launch of the geometric embedding and the
    RPE attention that the model layers make (their wrappers, wrapped)."""

    def __init__(self):
        import roitr_torch.models.attention as attention
        import roitr_torch.models.embeddings as embeddings

        self.seen = {"geo_embedding": set(), "rpe_attention": set()}
        self.mods = ((embeddings, "geo_embedding", lambda a: a[2].shape[1]),
                     (attention, "rpe_attention", lambda a: a[0].shape[-1]))
        self.saved = []

    def __enter__(self):
        for mod, name, width in self.mods:
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))

            def wrapped(*a, _fn=fn, _name=name, _width=width, **kw):
                self.seen[_name].add(int(_width(a)))
                return _fn(*a, **kw)

            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def phase_fdmatch(rng):
    """The 4DMatch (non-rigid) variant at its full width, channel factor 2:
    the kernels at its shapes against their plain versions; card against
    CPU at the 4096 bucket (the with-GT forward, one train step); then on
    flow pairs of 20k-30k points written as the reference's .npz entries,
    the Trainer (configs/train/fdmatch.yaml: 8 pairs, two updates at
    iter_size 4, one validation step), the Tester (configs/test/fdmatch.yaml,
    4DLoMatch, host pyramids; host and device prep, full and c2f dumps)
    with the port's NFMR / IR evaluation, and one Matcher.match request.
    Returns the Trainer's launches."""
    from roitr_torch.data.synthetic import make_flow_pair_arrays
    from roitr_torch.kernels import FORWARD_KERNELS, launch_counts, reset_launch_counts
    from roitr_torch.models.roitr import RoITr
    from roitr_torch.serving import Matcher

    t_phase = time.time()
    # ---- 1. every kernel at the 4DMatch shapes: rows 2, 3, 6, 7 at width
    # 512, row 4 at the adaptive buffer's 512 patches
    rows = phase_kernels(rng, hidden=512, serving_patches=512, tag="[4dmatch] kernels",
                         extras=False)
    for name, row in rows.items():
        b_ms, b_by = bound(row["bytes"], row["flops"], row.get("peak", FP32_FLOP_PER_S),
                           row.get("sfu", 0.0))
        print(f"[4dmatch] kernel {name}: {row['ms']:.4f} ms, plain {row['plain_ms']:.3f} ms, "
              f"bound {b_ms:.4f} ms ({'bytes' if b_by == 'bytes' else 'operations'}), max abs "
              f"err {row['max_abs_err']:.3g}", flush=True)
    print(f"[4dmatch] kernels in {time.time() - t_phase:.1f} s", flush=True)

    # ---- 2. card against CPU at the 4096 bucket, factor 2, one flow pair
    t0 = time.time()
    cfg = _fd_cfg("train")
    arr = make_flow_pair_arrays(rng, 4096, 3900, 3600)
    gpu, cpu = RoITr(cfg, device="cuda", seed=0), RoITr(cfg, device="cpu", seed=0)
    with torch.no_grad():
        og = {k: v.cpu() for k, v in gpu(_pair(arr, 3900, 3600, "cuda"), with_gt=True).items()}
        oc = cpu(_pair(arr, 3900, 3600, "cpu"), with_gt=True)
    snc, tnc = int(oc["src_node_count"]), int(oc["tgt_node_count"])
    node_cos = min(float(_cos(og["src_node_feats"][:snc], oc["src_node_feats"][:snc]).min()),
                   float(_cos(og["tgt_node_feats"][:tnc], oc["tgt_node_feats"][:tnc]).min()))
    corr = lambda o: {(int(t), int(s)) for t, s, v in zip(  # noqa: E731
        o["tgt_node_corr_indices"], o["src_node_corr_indices"], o["node_corr_masks"]) if v}
    cg, cc = corr(og), corr(oc)
    apart = len(cg ^ cc) / max(len(cg | cc), 1)
    print(f"[4dmatch] bucket 4096 with-GT forward, card + CPU in {time.time() - t0:.1f} s: node "
          f"descriptors min cos {node_cos:.6f} (tol >= 0.999); adaptive node correspondences "
          f"card {len(cg)}, CPU {len(cc)} of a {og['node_corr_masks'].shape[0]}-slot buffer, "
          f"{len(cg ^ cc)} apart = {apart:.2%} of their union (tol 5%: near-ties at the "
          f"{cfg.coarse_similarity_threshold} threshold); GT node correspondences "
          f"{int(oc['gt_node_corr_masks'].sum())}", flush=True)
    for k, v in og.items():
        if v.is_floating_point() and not torch.isfinite(v).all():
            fail(f"[4dmatch] forward output {k} is not finite")
    if not (node_cos >= 0.999 and apart <= 0.05 and len(cc) > 0):
        fail("[4dmatch] card forward disagrees with the CPU forward")
    t0 = time.time()
    pcfg = cfg.replace(geo_embedding_storage="fp32")
    lg, gg = _grad_step(RoITr(pcfg, device="cuda", seed=0), _pair(arr, 3900, 3600, "cuda"))
    lc, gc = _grad_step(RoITr(pcfg, device="cpu", seed=0), _pair(arr, 3900, 3600, "cpu"))
    print(f"[4dmatch] bucket 4096 train step, card + CPU in {time.time() - t0:.1f} s; losses "
          f"card {lg} CPU {lc}", flush=True)
    _compare_grads("[4dmatch]", "train step, card vs CPU", [lg], gg, [lc], gc)

    # ---- 3. full width on flow pairs of 20k-30k points
    sizes = [(int(rng.randint(20000, 30001)), int(rng.randint(20000, 30001))) for _ in range(9)]
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            t0 = time.time()
            split = _write_flow_entries(rng, tmp, sizes)
            print(f"[4dmatch] 9 flow pairs as .npz entries in {time.time() - t0:.1f} s (host); "
                  f"counts {sizes}", flush=True)
            launches = _fdmatch_training(tmp, split, _Widths)
            _fdmatch_tester(tmp, split, rng)
            # serving: one request at 4DMatch (the training config's model:
            # a 512-slot adaptive buffer), host normals
            matcher = Matcher(cfg, gpu.state_dict())
            n, m = sizes[0]
            entry = np.load(os.path.join(split, "scene0", "pair00.npz"))
            src, tgt = entry["s_pc"] + entry["s2t_flow"], entry["t_pc"]
            matcher.match(src, tgt)  # first call: allocator and caches
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.time()
            res = matcher.match(src, tgt)
            torch.cuda.synchronize()
            wall = (time.time() - t0) * 1e3
            got = {k: launch_counts[k] for k in FORWARD_KERNELS}
            print(f"[4dmatch] Matcher.match (4DMatch, {n} + {m} points, host normals): "
                  f"{wall:.1f} ms wall; max_memory_allocated "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {got}; "
                  f"{res['confidence'].shape[0]} correspondences", flush=True)
            if got != FORWARD_LAUNCHES:
                fail(f"[4dmatch] Matcher.match launches {got}, expected {FORWARD_LAUNCHES}")
        finally:
            os.chdir(cwd)
    print(f"[4dmatch] phase in {time.time() - t_phase:.1f} s", flush=True)
    return launches


def _fdmatch_training(tmp, split, widths):
    """Trainer from configs/train/fdmatch.yaml on the first 8 entries (two
    updates at iter_size 4) and one validation step on the ninth: launches
    required exactly, the geometric embedding and RPE attention launched at
    width 512."""
    from roitr_torch.kernels import launch_counts, reset_launch_counts
    from roitr_torch.train.trainer import Trainer

    entries = sorted(os.listdir(os.path.join(split, "scene0")))
    with open("train.txt", "w") as f:
        f.write("\n".join(os.path.join(split, "scene0", e) for e in entries[:8]) + "\n")
    with open("val.txt", "w") as f:
        f.write(os.path.join(split, "scene0", entries[8]) + "\n")
    cfg = _fd_cfg("train", root=tmp, train_info="train.txt", val_info="val.txt", max_epoch=1,
                  training_max_iter=8, val_max_iter=1, verbose_freq=1)
    trainer = Trainer(cfg, device="cuda", time_steps=True)
    before = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.time()
    with widths() as seen:
        metrics = trainer.train_epoch(0)
        val = trainer.eval_epoch(0)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated()
    for i, t in enumerate(trainer.step_times):
        print(f"[4dmatch] train mini-step {i}: forward {t['forward_ms']:.1f} ms, backward "
              f"{t['backward_ms']:.1f} ms, optimizer {t['optimizer_ms']:.1f} ms", flush=True)
    changed = sum(not torch.equal(v, before[k]) for k, v in trainer.model.state_dict().items())
    updates = trainer.optimizer.scheduler.last_epoch
    print(f"[4dmatch] Trainer ({cfg.benchmark}, factor {cfg.channel_factor}, iter_size "
          f"{cfg.iter_size}): {trainer.step} mini-steps, {updates} optimizer updates, 1 "
          f"validation step in {wall:.1f} s; max_memory_allocated {peak / 2**30:.2f} GiB; "
          f"train {metrics}; val {val}; {changed} of {len(before)} tensors changed; launches "
          f"{launches}; widths launched {dict((k, sorted(v)) for k, v in seen.seen.items())}",
          flush=True)
    if trainer.step != 8 or updates != 2 or changed == 0:
        fail("[4dmatch] expected 8 mini-steps and 2 updates that change the parameters")
    if not (np.isfinite(metrics["loss"]) and metrics["grads_finite"] == 1.0
            and np.isfinite(val["loss"])):
        fail("[4dmatch] a train or validation loss or gradient was not finite")
    want = {k: 8 * TRAIN_STEP[k] + VAL_STEP[k] for k in TRAIN_STEP}
    if launches != want:
        fail(f"[4dmatch] Trainer launches {launches}, expected {want} (a kernel of the path "
             "missing, or a layer sent to the plain version)")
    if seen.seen != {"geo_embedding": {512}, "rpe_attention": {512}}:
        fail(f"[4dmatch] kernel widths {seen.seen}, expected 512 only")
    return launches


def _fdmatch_tester(tmp, split, rng):
    """The Tester from configs/test/fdmatch.yaml (4DLoMatch, host pyramids)
    on the first two entries, host prep and device prep, full and c2f dumps,
    every fine correspondence kept (confidence threshold 0: random weights
    keep none at 0.05, and the evaluators and the c2f cap get rows);
    launches required exactly; c2f dumps are the full dumps' first
    dump_corr_cap rows; the port's evaluate_fdmatch reads each run's
    dumps."""
    from roitr_torch.eval import evaluate_fdmatch, get_trainer, list_dumps, load_dump
    from roitr_torch.kernels import FORWARD_KERNELS, launch_counts, reset_launch_counts
    from roitr_torch.models.roitr import RoITr

    entries = sorted(os.listdir(os.path.join(split, "scene0")))[:2]
    with open("test.txt", "w") as f:
        f.write("\n".join(os.path.join(split, "scene0", e) for e in entries) + "\n")
    cfg = _fd_cfg("test", root=tmp, test_info="test.txt", pretrain=os.path.join(tmp, "w.pth"),
                  fine_matching_confidence_threshold=0.0)
    torch.save({"model": RoITr(cfg, device="cpu", seed=0).state_dict()}, cfg.pretrain)
    print(f"[4dmatch] Tester: configs/test/fdmatch.yaml ({cfg.benchmark}, host_pyramid "
          f"{cfg.host_pyramid}) with root, test_info, pretrain and "
          f"fine_matching_confidence_threshold=0.0; dump_corr_cap {cfg.dump_corr_cap}",
          flush=True)
    dumps = {}
    for name, kw in (("host_full", {}), ("host_c2f", dict(dump_mode="c2f")),
                     ("device_full", dict(device_prep=True)),
                     ("device_c2f", dict(device_prep=True, dump_mode="c2f"))):
        run_cfg = cfg.replace(exp_dir=name, **kw)
        tester = get_trainer(run_cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.time()
        tester.test()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {k: launch_counts[k] for k in launch_counts}
        dumps[name] = [load_dump(p) for p in list_dumps(tester.snapshot_dir)]
        res = evaluate_fdmatch(tester.snapshot_dir)
        print(f"[4dmatch] Tester {name}: {wall / len(entries):.3f} s/pair; max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}; "
              f"correspondences {[int(d['confidence'].shape[0]) for d in dumps[name]]}; "
              f"NFMR {res['NFMR']:.4f}, IR {res['IR']:.4f} (random weights: not metrics)",
              flush=True)
        want = {k: v * len(entries) for k, v in FORWARD_LAUNCHES.items()}
        if not run_cfg.device_prep:
            want["fps"] = 0  # host pyramids
        if {k: launches[k] for k in FORWARD_KERNELS} != want or any(
                launches[k] for k in launches if k not in FORWARD_KERNELS):
            fail(f"[4dmatch] Tester ({name}) launches {launches}, expected {want}")
        for d in dumps[name]:
            if "metric_index_list" not in d or d["src_pcd"].shape != d["src_raw_pcd"].shape:
                fail(f"[4dmatch] Tester ({name}): a dump lacks metric_index_list or the raw "
                     "source")
            if not np.abs(d["src_pcd"] - d["src_raw_pcd"]).max() > 1e-3:
                fail(f"[4dmatch] Tester ({name}): src_pcd is not the deformed source")
        if not all(np.isfinite(v) for v in res.values()):
            fail(f"[4dmatch] evaluate_fdmatch of {name}: {res}")
    for prep in ("host", "device"):
        for full, c2f in zip(dumps[f"{prep}_full"], dumps[f"{prep}_c2f"]):
            rows = min(len(full["confidence"]), cfg.dump_corr_cap)
            if len(c2f["confidence"]) != rows:
                fail(f"[4dmatch] Tester {prep}: {len(c2f['confidence'])} c2f rows, expected "
                     f"{rows}")
            for k in ("src_corr_pts", "tgt_corr_pts", "confidence"):
                if not np.array_equal(full[k][:rows], c2f[k]):
                    fail(f"[4dmatch] Tester {prep}: c2f dump's {k} is not the full dump's first "
                         f"{rows} rows")
            for k in ("src_pcd", "src_raw_pcd", "metric_index_list"):
                if not np.array_equal(full[k], c2f[k]):
                    fail(f"[4dmatch] Tester {prep}: c2f dump's {k} differs from the full dump's")


# ---- [bf16], [remat], [workers]: the rest of the one-card Config

# pairs of 20k-30k points at the 32768 bucket for the [bf16] and [remat] steps
FULL_SIZES = [(26000, 23000), (21000, 28500)]


def _count_main(launches, into):
    for k, v in launches.items():
        into[k] = into.get(k, 0) + v


def _timed_steps(models, pairs, order, tag, main):
    """Train steps of `models` (name -> (model, optimizer)) in `order`, each
    over every pair: counters zeroed before and read after each step, which
    must launch TRAIN_STEP exactly; returns {name: [(forward, backward,
    optimizer ms, peak GiB), ...]}."""
    from roitr_torch.kernels import launch_counts, reset_launch_counts
    from roitr_torch.parallel.train_step import train_step

    rows = {name: [] for name in models}
    for name in order:
        model, opt = models[name]
        for pair in pairs:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t = {}
            metrics = train_step(model, opt, pair, torch.Generator().manual_seed(0), t)
            launches = dict(launch_counts)
            peak = torch.cuda.max_memory_allocated() / 2**30
            _count_main(launches, main)
            rows[name].append((t["forward_ms"], t["backward_ms"], t["optimizer_ms"], peak))
            print(f"{tag} {name} step: forward {t['forward_ms']:.1f} ms, backward "
                  f"{t['backward_ms']:.1f} ms, optimizer {t['optimizer_ms']:.1f} ms, "
                  f"{sum(t.values()):.1f} ms; max_memory_allocated {peak:.2f} GiB; loss "
                  f"{metrics['loss']:.4f}, grads_finite {metrics['grads_finite']:.0f}",
                  flush=True)
            if metrics["grads_finite"] != 1.0 or not np.isfinite(metrics["loss"]):
                fail(f"{tag} {name}: a loss or gradient was not finite")
            if launches != TRAIN_STEP:
                fail(f"{tag} {name} step launched {launches}, expected {TRAIN_STEP}")
    for name, r in rows.items():
        later = r[len(pairs):]  # the first step of each mode warms its libraries up
        ms = ", ".join(f"{sum(x[:3]):.1f}" for x in later)
        print(f"{tag} {name}: step ms (after the first) {ms}; peak "
              f"{max(x[3] for x in r):.2f} GiB", flush=True)
    return rows


def _grad_cosines(ga, gb):
    """(global cosine, worst per-parameter cosine, its name) over the
    parameters whose gradient norm is at least 1e-3 of the largest (the
    score biases whose gradient is zero but for rounding are left out)."""
    fa = torch.cat([v.flatten() for v in ga.values()])
    fb = torch.cat([v.flatten() for v in gb.values()])
    top = max(float(v.norm()) for v in gb.values())
    worst, worst_key = 1.0, ""
    for k in gb:
        if float(gb[k].norm()) >= 1e-3 * top:
            c = float(ga[k].flatten() @ gb[k].flatten() / (ga[k].norm() * gb[k].norm()))
            if c < worst:
                worst, worst_key = c, k
    return float(fa @ fb / (fa.norm() * fb.norm())), worst, worst_key


def phase_bf16(rng, main):
    """bf16 compute (compute_dtype="bfloat16") at full 3DMatch width: train
    steps of 20k-30k-point pairs (32768 bucket) with bf16 and fp32 compute
    in turns, launches exact (bf16 leaves the kernels' dtypes alone), step
    ms split three ways and peak memory; the bf16 gradient against the fp32
    one on the card; card against CPU in bf16 at the 4096 bucket; one
    Matcher.match request in bf16 against fp32."""
    from roitr_torch.config import Config
    from roitr_torch.data.synthetic import make_pair_arrays
    from roitr_torch.models.roitr import RoITr
    from roitr_torch.parallel.train_step import make_optimizer
    from roitr_torch.serving import Matcher

    t_phase = time.time()
    cfg32 = _train_cfg()
    cfg16 = cfg32.replace(compute_dtype="bfloat16")
    arrs = [(make_pair_arrays(rng, 32768, n, m), n, m) for n, m in FULL_SIZES]
    pairs = [_pair(a, n, m, "cuda") for a, n, m in arrs]
    models = {}
    for name, c in (("fp32", cfg32), ("bf16", cfg16)):
        model = RoITr(c, device="cuda", seed=0)
        models[name] = (model, make_optimizer(c, model))
    print(f"[bf16] configs/train/tdmatch.yaml, compute_dtype float32 and bfloat16; pairs "
          f"{FULL_SIZES} in the 32768 bucket", flush=True)
    _timed_steps(models, pairs, ("fp32", "bf16", "bf16", "fp32"), "[bf16]", main)

    # the bf16 gradient against the fp32 one, same weights, pair and draws
    l32, g32 = _grad_step(RoITr(cfg32, device="cuda", seed=0), pairs[0])
    l16, g16 = _grad_step(RoITr(cfg16, device="cuda", seed=0), pairs[0])
    cos, worst, worst_key = _grad_cosines(g16, g32)
    print(f"[bf16] one step's gradient, bf16 against fp32 compute on the card: cosine over "
          f"all {cos:.6f} (tol >= 0.98, JAX's descriptor bound), worst parameter {worst:.4f} "
          f"({worst_key}); loss bf16 {l16['loss']:.5f} fp32 {l32['loss']:.5f}", flush=True)
    if not (cos >= 0.98 and all(torch.isfinite(v).all() for v in g16.values())):
        fail("[bf16] the bf16 gradient strays from the fp32 one")

    # card against CPU, both in bf16, at the 4096 bucket
    t0 = time.time()
    pcfg = Config(benchmark="3DMatch", compute_dtype="bfloat16", geo_embedding_storage="fp32")
    arr = make_pair_arrays(rng, 4096, 3900, 3600)
    feats = {}

    def step(device):
        """_grad_step, keeping the forward's node descriptors."""
        model = RoITr(pcfg, device=device, seed=0)
        hook = model.register_forward_hook(lambda _, args, out: feats.__setitem__(device, {
            k: out[k][:int(out[k.replace("feats", "count")])].detach().cpu()
            for k in ("src_node_feats", "tgt_node_feats")}))
        try:
            return _grad_step(model, _pair(arr, 3900, 3600, device))
        finally:
            hook.remove()

    lg, gg = step("cuda")
    lc, gc = step("cpu")
    node_cos = min(float(_cos(feats["cuda"][k], feats["cpu"][k]).min()) for k in feats["cpu"])
    loss_err = max(abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-6) for k in lc)
    cos4, worst4, worst4_key = _grad_cosines(gg, gc)
    print(f"[bf16] bucket 4096, card against CPU in bf16 ({time.time() - t0:.1f} s): node "
          f"descriptors min cos {node_cos:.6f} (tol >= 0.999); losses largest relative "
          f"difference {loss_err:.3g} (tol 1e-2); gradients cosine over all {cos4:.6f} (tol "
          f">= 0.99), worst parameter {worst4:.4f} ({worst4_key})", flush=True)
    if not (node_cos >= 0.999 and loss_err <= 1e-2 and cos4 >= 0.99):
        fail("[bf16] card and CPU disagree in bf16")

    # one Matcher.match request in bf16 against fp32, same weights
    state_dict = models["fp32"][0].state_dict()
    a, n, m = arrs[0]
    src, tgt = a["src_points"][:n], a["tgt_points"][:m]
    res, walls = {}, {}
    for name in ("fp32", "bf16", "bf16", "fp32"):
        mcfg = Config(benchmark="3DMatch", compute_dtype="bfloat16" if name == "bf16"
                      else "float32")
        matcher = Matcher(mcfg, state_dict, device="cuda", descriptors=True)
        torch.cuda.synchronize()
        t0 = time.time()
        res[name] = matcher.match(src, tgt)
        torch.cuda.synchronize()
        walls.setdefault(name, []).append((time.time() - t0) * 1e3)
    desc_cos = min(float(_cos(torch.from_numpy(res["bf16"][k]), torch.from_numpy(res["fp32"][k]))
                         .min()) for k in ("src_node_desc", "tgt_node_desc"))
    print(f"[bf16] Matcher.match, {n} + {m} points (host normals included): wall bf16 "
          f"{', '.join(f'{w:.1f}' for w in walls['bf16'])} ms, fp32 "
          f"{', '.join(f'{w:.1f}' for w in walls['fp32'])} ms; node descriptors bf16 against "
          f"fp32 min cos {desc_cos:.6f} (tol >= 0.98); {time.time() - t_phase:.1f} s in all",
          flush=True)
    if not (desc_cos >= 0.98 and all(np.isfinite(v).all() for v in res["bf16"].values())):
        fail("[bf16] bf16 serving strays from fp32")


def phase_remat(rng, main):
    """remat_local at full 3DMatch width: train steps with it off and on in
    turns (step ms, peak memory, launches exact), one step's gradients with
    and without; then one step at 4DMatch's width (factor 2) with and
    without, for the peak memory."""
    from roitr_torch.data.synthetic import make_flow_pair_arrays, make_pair_arrays
    from roitr_torch.models.roitr import RoITr
    from roitr_torch.parallel.train_step import make_optimizer

    t_phase = time.time()
    cfg = _train_cfg()
    cfg_r = cfg.replace(remat_local=True)
    pairs = [_pair(make_pair_arrays(rng, 32768, n, m), n, m, "cuda") for n, m in FULL_SIZES]
    models = {}
    for name, c in (("off", cfg), ("on", cfg_r)):
        model = RoITr(c, device="cuda", seed=0)
        models[name] = (model, make_optimizer(c, model))
    _timed_steps(models, pairs, ("off", "on", "on", "off"), "[remat]", main)
    lo, go = _grad_step(RoITr(cfg, device="cuda", seed=0), pairs[0])
    lr, gr = _grad_step(RoITr(cfg_r, device="cuda", seed=0), pairs[0])
    # the same ops run again, but the gather backward's atomics may order
    # sums differently from run to run on the card
    _compare_grads("[remat]", "remat_local on vs off, one step at 32768", [lr], gr, [lo], go)

    fd = _fd_cfg("train")
    n, m = 27000, 24000
    pair = _pair(make_flow_pair_arrays(rng, 32768, n, m), n, m, "cuda")
    peaks = {}
    for name, c in (("off", fd), ("on", fd.replace(remat_local=True)),
                    ("off", fd), ("on", fd.replace(remat_local=True))):
        model = RoITr(c, device="cuda", seed=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.time()
        _grad_step(model, pair)
        torch.cuda.synchronize()
        peaks.setdefault(name, []).append(
            (torch.cuda.max_memory_allocated() / 2**30, (time.time() - t0) * 1e3,
             base / 2**30))
        del model
    print(f"[remat] 4DMatch width (factor 2), one step of {n} + {m} points: max_memory_allocated "
          + "; ".join(f"{k} {', '.join(f'{p:.2f} GiB ({ms:.0f} ms)' for p, ms, _ in v)}"
                      for k, v in peaks.items())
          + f" (weights and inputs {peaks['off'][0][2]:.2f} GiB); {time.time() - t_phase:.1f} "
          "s in all", flush=True)
    if not min(p for p, _, _ in peaks["on"]) < min(p for p, _, _ in peaks["off"]):
        fail("[remat] remat_local did not lower the peak memory")


def phase_workers(rng, main):
    """The worker pool: the Tester from configs/test/tdmatch.yaml under host
    prep (host pyramids), full dumps, on 16 synthetic pairs of 20k-30k
    points in the reference layout, with num_workers 0 and min(8, cores) in
    turns: s/pair, the device's busy share (torch.profiler), launches
    exact, every dump equal byte for byte; the time to the first forward
    and the median gap between forwards (the steady state, the pool's start
    left out) beside one pair's host prep in this process and a worker's
    start (`python -S -c "import torch"` in the workers' environment); then
    a Trainer from configs/train/tdmatch.yaml whose pairs the pool prepares
    (the same split, 2 train steps and 1 validation step)."""
    import hashlib
    import statistics

    from torch.profiler import ProfilerActivity, profile

    from roitr_torch.config import load_config
    from roitr_torch.data import get_dataset
    from roitr_torch.data.worker_pool import worker_env
    from roitr_torch.eval import get_trainer
    from roitr_torch.kernels import FORWARD_KERNELS, launch_counts, reset_launch_counts
    from roitr_torch.models.roitr import RoITr
    from roitr_torch.train.trainer import Trainer

    t_phase = time.time()
    cores = os.cpu_count() or 1
    workers = min(8, cores)
    sizes = [(int(a), int(b)) for a, b in rng.randint(20000, 30001, size=(16, 2))]
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            root, info = _write_tdmatch_split(rng, sizes, tmp)
            cfg = load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                                           "test", "tdmatch.yaml"),
                              root=root, test_info=info, pretrain=os.path.join(tmp, "w.pth"))
            torch.save({"model": RoITr(cfg, device="cpu", seed=0).state_dict()}, cfg.pretrain)
            ds = get_dataset(cfg, "test")
            prep = []
            for i in range(2):
                t0 = time.time()
                ds[i]
                prep.append(time.time() - t0)
            t0 = time.time()
            subprocess.run([sys.executable, "-S", "-c", "import torch"], env=worker_env(),
                           check=True)
            start = time.time() - t0
            print(f"[workers] os.cpu_count() {cores}; Tester from configs/test/tdmatch.yaml "
                  f"(host_pyramid {cfg.host_pyramid}, dump_mode {cfg.dump_mode}) on "
                  f"{len(sizes)} pairs, num_workers 0 and {workers} in turns; one pair's host "
                  f"prep in this process {', '.join(f'{t:.3f}' for t in prep)} s; a worker's "
                  f"interpreter with torch imported (alone) {start:.2f} s", flush=True)
            digests, rows = {}, {}
            for turn, nw in enumerate((0, workers, workers, 0)):
                run_cfg = cfg.replace(exp_dir=f"workers{nw}_{turn}", num_workers=nw)
                tester = get_trainer(run_cfg)
                stamps = []
                tester.model.register_forward_pre_hook(lambda *_: stamps.append(time.time()))
                torch.cuda.synchronize()
                reset_launch_counts()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.time()
                    tester.test()
                    torch.cuda.synchronize()
                    wall = time.time() - t0
                launches = dict(launch_counts)
                events = [e for e in prof.key_averages()
                          if str(getattr(e, "device_type", "")).endswith("CUDA")]
                busy = sum(e.self_device_time_total for e in events) / 1e6
                share = f"{busy / wall:.1%}" if busy > 0 else "not measured (no device events)"
                rows.setdefault(nw, []).append(wall / len(sizes))
                files = [os.path.join(tester.snapshot_dir, f"{i}.pth") for i in range(len(sizes))]
                digests[turn] = [hashlib.sha256(open(f, "rb").read()).hexdigest() for f in files]
                for f in files:
                    os.remove(f)
                gap = statistics.median(b - a for a, b in zip(stamps, stamps[1:]))
                print(f"[workers] num_workers {nw}: {wall / len(sizes):.3f} s/pair over "
                      f"{len(sizes)} pairs ({wall:.1f} s, the pool's start included); first "
                      f"forward after {stamps[0] - t0:.2f} s, then a forward every {gap:.3f} s "
                      f"(median); device busy {busy:.2f} s = {share} of the run; launches "
                      f"{launches}", flush=True)
                want = {k: v * len(sizes) for k, v in FORWARD_LAUNCHES.items()}
                want["fps"] = 0  # host pyramids
                if {k: launches[k] for k in FORWARD_KERNELS} != want:
                    fail(f"[workers] Tester launches {launches}, expected {want}")
            if any(d != digests[0] for d in digests.values()):
                apart = [(t, i) for t, d in digests.items() for i, (a, b) in
                         enumerate(zip(d, digests[0])) if a != b]
                fail(f"[workers] dumps differ between runs (run, pair): {apart}")
            print(f"[workers] all {len(digests)} runs' {len(sizes)} dumps equal byte for byte; "
                  f"s/pair num_workers 0: {', '.join(f'{x:.3f}' for x in rows[0])}, "
                  f"{workers}: {', '.join(f'{x:.3f}' for x in rows[workers])}", flush=True)

            # a full-width Trainer whose pairs (normals, host-side) the pool prepares
            tcfg = _train_cfg(root=root, train_info=info, val_info=info, num_workers=workers,
                              max_epoch=1, training_max_iter=2, val_max_iter=1, verbose_freq=1)
            trainer = Trainer(tcfg, device="cuda", time_steps=True)
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.time()
            best = trainer.train()
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = dict(launch_counts)
            _count_main(launches, main)
        finally:
            os.chdir(cwd)
    steps = ", ".join(f"{sum(t.values()):.1f}" for t in trainer.step_times)
    print(f"[workers] Trainer, num_workers {workers}: {trainer.step} train steps ({steps} ms) "
          f"+ 1 validation step in {wall:.1f} s (the pools' start included); val {best}; "
          f"launches {launches}; {time.time() - t_phase:.1f} s in all", flush=True)
    want = {k: 2 * TRAIN_STEP[k] + VAL_STEP[k] for k in TRAIN_STEP}
    if trainer.step != 2 or launches != want or not np.isfinite(best["loss"]):
        fail(f"[workers] Trainer: {trainer.step} steps, launches {launches} (expected {want}), "
             f"val {best}")


def _ddp_ranks():
    """tests/ddp_ranks.py: the rank of the card's step (`card_step`) and its
    helpers, shared with tests/test_torch_cuda.py."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import ddp_ranks

    return ddp_ranks


def _ddp_trainer(job):
    """[ddp]'s Trainer on one rank, in the group's shared directory, with
    its checkpoint writes counted."""
    from roitr_torch.kernels import launch_counts, reset_launch_counts
    from roitr_torch.train import trainer as trainer_module

    saves, save = [], trainer_module.save_checkpoint
    trainer_module.save_checkpoint = lambda path, *a: (saves.append(os.path.basename(path)),
                                                       save(path, *a))
    os.chdir(job["base"])
    try:
        trainer = trainer_module.Trainer(job["train_cfg"], job["train_set"], job["val_set"],
                                         device="cuda", time_steps=True)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.time()
        best = trainer.train()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(launch_counts)
        ckpts = sorted(os.listdir(trainer.ckpt_dir))
    finally:
        trainer_module.save_checkpoint = save
    return dict(steps=trainer.step, step_ms=[dict(t) for t in trainer.step_times], best=best,
                wall=wall, launches=launches, saves=saves, ckpts=ckpts,
                digest=_ddp_ranks().digest(_ddp_ranks().flat_params(trainer.model)))


def _ddp_tester(job):
    from roitr_torch.eval import get_trainer
    from roitr_torch.kernels import launch_counts, reset_launch_counts

    os.chdir(job["base"])
    tester = get_trainer(job["tester_cfg"])
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.time()
    tester.test()
    torch.cuda.synchronize()
    return dict(wall=time.time() - t0, launches=dict(launch_counts),
                pairs=len(range(tester.rank, len(tester.dataset), tester.world)))


def _ddp_rank(rank, world, job):
    """One rank of [ddp] (started by roitr_torch.parallel.distributed.spawn,
    or this process as a one-rank group):
    the parts of `job` it holds (step, trainer, tester), in that order."""
    from roitr_torch.parallel.distributed import init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = init_distributed(job["cfg"], "cuda")
    out = {"device": str(dev)}
    if "pairs" in job:
        out["step"] = _ddp_ranks().card_step(rank, world, job["cfg"], job["pairs"],
                                             job["states"])
    if "train_set" in job:
        out["trainer"] = _ddp_trainer(job)
    if "tester_cfg" in job:
        out["tester"] = _ddp_tester(job)
    return out


def phase_ddp(rng, main):
    """Data parallelism (roitr_torch/parallel/distributed.py) at full 3DMatch
    width. With two or more cards, NCCL and one rank a card (up to 4); with
    one, two gloo ranks on that card and then a one-rank NCCL group (this
    process) through the same Trainer. One train step of one 20k-30k-point pair a rank
    against the one-process step of the same pairs on the card (the same
    Gumbel noise); a Trainer (configs/train/tdmatch.yaml, 2 steps and a
    validation step); the Tester (configs/test/tdmatch.yaml, host prep,
    full dumps) on 4 synthetic pairs, whose dumps must equal world 1's byte
    for byte. The kernels and the native library are built here first; a
    rank that fails or outlives the wall limit fails the phase."""
    import hashlib

    import torch.distributed as dist

    from roitr_torch import native
    from roitr_torch.config import load_config
    from roitr_torch.data.loader import dict_to_pair
    from roitr_torch.data.synthetic import SyntheticPairs
    from roitr_torch.eval import get_trainer
    from roitr_torch.kernels import build, launch_counts, reset_launch_counts
    from roitr_torch.models.roitr import RoITr
    from roitr_torch.parallel.distributed import spawn
    from roitr_torch.parallel.train_step import make_optimizer, train_step

    ddp_ranks = _ddp_ranks()
    t_phase = time.time()
    build.build()
    native.get_lib()
    cards = torch.cuda.device_count()
    if cards >= 2:
        backend, world = "nccl", min(4, cards)
        devices = [f"cuda:{i}" for i in range(world)]
        plan = f"{world} ranks over NCCL, one a card"
    else:
        backend, world, devices = "gloo", 2, ["cuda:0"] * 2
        plan = "2 ranks over gloo, both on card 0; then a one-rank NCCL group (Trainer)"
    print(f"[ddp] {cards} card(s): {plan}", flush=True)
    cfg = _train_cfg(max_epoch=1, training_max_iter=2 * world, val_max_iter=world,
                     verbose_freq=1)
    ds = SyntheticPairs(world, 32768, counts=(20000, 30000), seed=int(rng.randint(1 << 30)))
    items = [ds[i] for i in range(world)]  # host normals up front
    sizes = [(int(d["src_count"]), int(d["tgt_count"])) for d in items]

    # the one-process step of the same pairs, recording each pair's generator state
    model = RoITr(cfg, device="cuda", seed=0)
    opt = make_optimizer(cfg, model, steps_per_epoch=1)
    states = []
    model.register_forward_pre_hook(
        lambda m, args, kw: states.append(kw["generator"].get_state().numpy().copy()),
        with_kwargs=True)
    grads = ddp_ranks.capture_grads(opt)
    timings = {}
    ref_metrics = train_step(model, opt, [dict_to_pair(d, "cuda") for d in items],
                             torch.Generator().manual_seed(0), timings)
    ref_grad = grads[0]
    del model, opt
    torch.cuda.empty_cache()
    print(f"[ddp] one-process step of {world} pairs {sizes} on the card: "
          f"{sum(timings.values()):.1f} ms", flush=True)

    sums = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            root, info = _write_tdmatch_split(rng, [(int(a), int(b)) for a, b in
                                                    rng.randint(20000, 30001, size=(4, 2))], tmp)
            tcfg = load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                                            "test", "tdmatch.yaml"),
                               root=root, test_info=info, pretrain=os.path.join(tmp, "w.pth"),
                               num_workers=0)
            torch.save({"model": RoITr(tcfg, device="cpu", seed=0).state_dict()}, tcfg.pretrain)
            get_trainer(tcfg.replace(exp_dir="ddp_world1")).test()
            job = dict(cfg=cfg, pairs=items, states=states, base=tmp, train_cfg=cfg,
                       train_set=(items * 2)[:2 * world], val_set=items,
                       tester_cfg=tcfg.replace(exp_dir=f"ddp_world{world}"))
            t0 = time.time()
            ranks = spawn(_ddp_rank, world, backend, args=(job,), devices=devices, timeout_s=300)
            group_s = time.time() - t0
            digests = {}
            for name in ("ddp_world1", f"ddp_world{world}"):
                digests[name] = [hashlib.sha256(open(os.path.join(
                    tmp, "snapshot", name, "3DMatch", f"{i}.pth"), "rb").read()).hexdigest()
                    for i in range(4)]
            nccl = None
            if backend == "gloo":  # this process as a one-rank NCCL group
                nccl_base = os.path.join(tmp, "nccl")
                os.makedirs(nccl_base)
                t0 = time.time()
                dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl_store", rank=0,
                                        world_size=1)
                try:
                    nccl = _ddp_rank(0, 1, dict(
                        cfg=cfg, base=nccl_base,
                        train_cfg=cfg.replace(training_max_iter=2, val_max_iter=1),
                        train_set=items[:2], val_set=items[:1]))
                finally:
                    dist.destroy_process_group()
                nccl_s = time.time() - t0
        finally:
            os.chdir(cwd)

    # the step: ranks equal, against the one-process step
    steps = [r["step"] for r in ranks]
    if len({s["flat_digest"] for s in steps}) != 1 or len({s["grad_digest"] for s in steps}) != 1:
        fail("[ddp] the ranks' gradients or parameters after the step differ")
    g, want = steps[0]["grad"].astype(np.float64), ref_grad.astype(np.float64)
    cos = float(g @ want / (np.linalg.norm(g) * np.linalg.norm(want)))
    grad_err = float(np.abs(g - want).max() / np.abs(want).max())
    metric_err = 0.0
    for r, s in enumerate(steps):
        metrics, t, launches = s["metrics"], s["timings"], s["launches"]
        _count_main(launches, sums)
        metric_err = max([metric_err] + [abs(metrics[k] - ref_metrics[k])
                                         / max(abs(ref_metrics[k]), 1e-7)
                                         for k in ("loss", "c_loss", "f_loss")])
        print(f"[ddp] rank {r} ({ranks[r]['device']}) first step: "
              + ", ".join(f"{n[:-3]} {v:.1f} ms" for n, v in t.items())
              + f", {sum(t.values()):.1f} ms; loss {metrics['loss']:.4f} (one process "
              f"{ref_metrics['loss']:.4f}), pairs {metrics['pairs']:.0f}; all-reduce of the flat "
              f"gradient ({s['mb']:.1f} MB) alone "
              + ", ".join(f"{x:.2f}" for x in s["allreduce_ms"]) + " ms", flush=True)
        if launches != TRAIN_STEP or metrics["grads_finite"] != 1.0 or metrics["pairs"] != world:
            fail(f"[ddp] rank {r}: launches {launches} (expected {TRAIN_STEP}), grads_finite "
                 f"{metrics['grads_finite']}, pairs {metrics['pairs']}")
    # the reduced gradient and losses are the one-process step's but for
    # the order of sums (the card's atomic sums round differently from run
    # to run); a wrong pair weighting is off by a factor
    print(f"[ddp] after one step: gradients and parameters bit-equal across the {world} ranks; "
          f"against the one-process step: reduced gradient max |dg| / max |g| {grad_err:.3g} "
          f"(tolerance 1e-3), cosine {cos:.7f} (tolerance 0.999), the losses' largest "
          f"relative difference {metric_err:.3g} (tolerance 1e-5)", flush=True)
    if grad_err > 1e-3 or cos < 0.999 or metric_err > 1e-5:
        fail("[ddp] the data-parallel step does not match the one-process step")

    names = sorted(["model_0.pth"] + [f"model_best_{k}.pth" for k in
                                      ("loss", "c_loss", "f_loss", "o_loss", "PIR", "IR")])
    want_launches = {k: 2 * TRAIN_STEP[k] + VAL_STEP[k] for k in TRAIN_STEP}
    runs = [(f"{backend} world {world}", [r["trainer"] for r in ranks])]
    if nccl is not None:
        runs.append(("nccl world 1", [nccl["trainer"]]))
    for tag, trainers in runs:
        for r, t in enumerate(trainers):
            _count_main(t["launches"], sums)
            steps_ms = "; ".join(", ".join(f"{n[:-3]} {v:.1f}" for n, v in x.items())
                                 + f", {sum(x.values()):.1f} ms" for x in t["step_ms"])
            print(f"[ddp] Trainer {tag} rank {r}: {t['steps']} steps ({steps_ms}), 1 "
                  f"validation step, {t['wall']:.1f} s; val loss {t['best']['loss']:.4f}; "
                  f"checkpoints written {len(t['saves'])}; launches {t['launches']}", flush=True)
            if t["steps"] != 2 or t["launches"] != want_launches:
                fail(f"[ddp] Trainer {tag} rank {r}: {t['steps']} steps, launches "
                     f"{t['launches']} (expected {want_launches})")
            if sorted(t["saves"]) != (names if r == 0 else []) or t["ckpts"] != names:
                fail(f"[ddp] Trainer {tag} rank {r}: wrote {t['saves']}, found {t['ckpts']}")
        if len({t["digest"] for t in trainers}) != 1 or any(t["best"] != trainers[0]["best"]
                                                            for t in trainers):
            fail(f"[ddp] Trainer {tag}: the ranks' parameters or validation metrics differ")
    for r, rank_out in enumerate(ranks):
        t = rank_out["tester"]
        want = {k: v * t["pairs"] for k, v in FORWARD_LAUNCHES.items()}
        want["fps"] = 0  # host pyramids
        print(f"[ddp] Tester rank {r}: {t['pairs']} pairs, {t['wall'] / t['pairs']:.3f} s/pair; "
              f"launches {t['launches']}", flush=True)
        if {k: t["launches"][k] for k in want} != want:
            fail(f"[ddp] Tester rank {r}: launches {t['launches']}, expected {want}")
    if digests["ddp_world1"] != digests[f"ddp_world{world}"]:
        fail(f"[ddp] the Tester's dumps at world {world} differ from world 1's")
    print(f"[ddp] Tester at world {world}: 4 dumps equal world 1's byte for byte (sha256); the "
          f"group ran {group_s:.1f} s" + (f", the NCCL Trainer {nccl_s:.1f} s" if nccl else "")
          + f"; {time.time() - t_phase:.1f} s in all", flush=True)
    _count_main(sums, main)
    return sums


REGISTRATION_SIZES = (5000, 2500, 1000, 500, 250)


def phase_registration(rng):
    """The registration evaluation (roitr_torch/eval/registration.py) on 16
    synthetic dumps with known poses, 5000 correspondences each, 30-60% of
    them outliers, and a TinyMatch ground-truth folder: registration
    recall, inlier ratio and feature-match recall with RANSAC on the card
    (ransac_backend "torch") and on the host ("numpy"), which must be
    equal; the transforms within 5e-3; the card's winning hypothesis that
    of the torch RANSAC on the CPU; the card's ms a pair at 50k hypotheses
    at each of the protocol's five sample sizes, numpy's at 5000, and the
    protocol's time on the card for 1623 pairs, extrapolated."""
    from roitr_torch.eval.ransac import ransac_pose_estimation_correspondences
    from roitr_torch.eval.ransac_torch import (
        best_hypothesis,
        ransac_pose_estimation_correspondences_torch,
    )
    from roitr_torch.eval.registration import (
        benchmark_registration,
        benchmark_registration_rotated,
    )
    from roitr_torch.eval.trajectory import read_trajectory

    t_phase = time.time()
    n_pairs, n_corr = 16, 5000
    with tempfile.TemporaryDirectory() as tmp:
        dump_dir = os.path.join(tmp, "dumps")
        gt_dir = os.path.join(tmp, "gt", "TinyMatch")
        os.makedirs(dump_dir)
        os.makedirs(os.path.join(gt_dir, "scene0"))
        log, inf, corr, shares = [], [], [], []
        for p in range(n_pairs):
            q, _ = np.linalg.qr(rng.randn(3, 3))
            q *= np.sign(np.linalg.det(q))
            t = rng.randn(3)
            src = rng.rand(n_corr, 3) * 3.0
            tgt = src @ q.T + t + rng.randn(n_corr, 3) * 0.005
            share = rng.uniform(0.3, 0.6)
            out = rng.permutation(n_corr)[:int(share * n_corr)]
            tgt[out] = (rng.rand(len(out), 3) * 3.0) @ q.T + t
            np.savez(os.path.join(dump_dir, f"{p}.npz"), src_corr_pts=src.astype(np.float32),
                     tgt_corr_pts=tgt.astype(np.float32),
                     confidence=rng.rand(n_corr).astype(np.float32), rot=q.astype(np.float32),
                     trans=t.reshape(3, 1).astype(np.float32), src_pcd=src.astype(np.float32))
            gt = np.eye(4)
            gt[:3, :3], gt[:3, 3] = q, t
            head = f"{p}\t{p + 2}\t{n_pairs + 2}"
            log += [head] + ["\t".join(f"{v:.12f}" for v in row) for row in gt]
            inf += [head] + ["\t".join(f"{v:.6f}" for v in row) for row in np.eye(6) * 100]
            corr.append((src, tgt))
            shares.append(share)
        for name, lines in (("gt.log", log), ("gt.info", inf)):
            with open(os.path.join(gt_dir, "scene0", name), "w") as f:
                f.write("\n".join(lines) + "\n")
        print(f"[registration] {n_pairs} synthetic dumps, {n_corr} correspondences each, "
              f"outliers {min(shares):.0%}-{max(shares):.0%}", flush=True)

        # the metrics with either backend (5000 hypotheses, 1000 sampled correspondences)
        res, est = {}, {}
        for backend in ("torch", "numpy"):
            kw = dict(ransac_backend=backend, device="cuda", ransac_iterations=5000, seed=0)
            exp = os.path.join(tmp, backend)
            t0 = time.time()
            reg = benchmark_registration(dump_dir, exp, "TinyMatch", 1000, gt_folder=gt_dir, **kw)
            rot = benchmark_registration_rotated(dump_dir, exp, "TinyMatch", 1000, **kw)
            wall = time.time() - t0
            res[backend] = (reg, rot)
            est[backend] = read_trajectory(os.path.join(exp, "TinyMatch", "1000", "scene0",
                                                        "est.log"))[1]
            print(f"[registration] {backend}: Redwood recall {reg['mean_recall']:.4f}, RR "
                  f"(rotated protocol) {rot['registration_recall']:.4f}, IR "
                  f"{reg['inlier_ratio']:.4f}, FMR {reg['feature_match_recall']:.4f}; both "
                  f"protocols {wall:.1f} s", flush=True)
        if res["torch"] != res["numpy"]:
            fail(f"[registration] the metrics differ between backends: {res}")
        diff = float(np.abs(est["torch"] - est["numpy"]).max())
        print(f"[registration] metrics equal; the {n_pairs} transforms torch against numpy: "
              f"max |dT| {diff:.3g} (tolerance 5e-3)", flush=True)
        if diff > 5e-3:
            fail("[registration] transforms torch against numpy beyond 5e-3")

    # the card's winning hypothesis against the CPU's, at 50k hypotheses
    f = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    for p in range(2):
        src, tgt = corr[p][0][:1000], corr[p][1][:1000]
        idx = torch.from_numpy(np.random.RandomState(p).randint(0, 1000, size=(50000, 3)))
        card = best_hypothesis(f(src).cuda(), f(tgt).cuda(), idx.cuda(), 0.05)
        cpu = best_hypothesis(f(src), f(tgt), idx, 0.05)
        print(f"[registration] pair {p}, 1000 correspondences, 50000 hypotheses: winner "
              f"{card[3]} ({card[2]} inliers) on the card, {cpu[3]} ({cpu[2]}) on the CPU",
              flush=True)
        if card[2:] != cpu[2:]:
            fail("[registration] the card's winning hypothesis is not the CPU's")

    # times a pair at 50k hypotheses
    card_ms = {}
    for n in REGISTRATION_SIZES:
        ransac_pose_estimation_correspondences_torch(corr[0][0][:n], corr[0][1][:n], seed=0)
        ms = []
        for p in range(1, 5):
            t0 = time.time()
            ransac_pose_estimation_correspondences_torch(corr[p][0][:n], corr[p][1][:n], seed=0)
            ms.append((time.time() - t0) * 1e3)
        card_ms[n] = ms
        print(f"[registration] card, {n} correspondences, 50000 hypotheses: "
              + ", ".join(f"{x:.1f}" for x in ms) + " ms a pair", flush=True)
    host_s = []
    for p in range(2):
        t0 = time.time()
        ransac_pose_estimation_correspondences(corr[p][0], corr[p][1], seed=0)
        host_s.append(time.time() - t0)
    per_pair = sum(float(np.mean(v)) for v in card_ms.values())
    print(f"[registration] numpy, 5000 correspondences, 50000 hypotheses: "
          + ", ".join(f"{x:.2f}" for x in host_s) + " s a pair; the protocol on the card "
          f"(extrapolated, not run): 1623 pairs x the five sizes = {1623 * per_pair / 1e3:.1f} s "
          f"({per_pair:.1f} ms a pair); {time.time() - t_phase:.1f} s in all", flush=True)


def phase_sinkhorn_tol(rng):
    """sinkhorn_tol on the card. The plain loop's convergence exit (backend
    "xla", tol 1e-3) on 256 masked (65, 65) patches against the CPU's: the
    same iteration count, below num_iter, and the scores within 1e-5; its
    ms beside the kernel's fixed 100 iterations. Then one forward at the
    4096 bucket under the default config (launches row 4), with tol > 0
    under "pallas" (row 4 still, and JAX's warning) and under "xla" (no
    row 4), the first inside utils/profiling.py `trace`, whose Chrome trace
    must name the RPE attention kernel."""
    import glob
    import warnings

    from roitr_torch.config import Config
    from roitr_torch.data.synthetic import make_pair_arrays
    from roitr_torch.kernels import launch_counts, reset_launch_counts
    from roitr_torch.kernels.sinkhorn_kernel import sinkhorn_iterate
    from roitr_torch.models.roitr import RoITr
    from roitr_torch.ops.sinkhorn import log_sinkhorn_ot, sinkhorn_early_exit, sinkhorn_inputs
    from roitr_torch.utils.profiling import annotate, trace

    t_phase = time.time()
    p, k, num_iter, tol = 256, 64, 100, 1e-3
    scores = torch.from_numpy((rng.randn(p, k, k) * 2.0).astype(np.float32))
    rm = torch.from_numpy(rng.rand(p, k) > 0.2)
    cm = torch.from_numpy(rng.rand(p, k) > 0.2)
    rm[-16:] = cm[-16:] = False  # empty slots of a fixed-capacity buffer
    alpha = torch.tensor(1.0)
    runs = {}
    for dev in ("cpu", "cuda"):
        args = [t.to(dev) for t in (scores, rm, cm, alpha)]
        padded, log_mu, log_nu, norm = sinkhorn_inputs(*args)
        out, iters = sinkhorn_early_exit(padded, log_mu, log_nu, num_iter, tol)
        reset_launch_counts()
        via_ot = log_sinkhorn_ot(*args, num_iter=num_iter, tol=tol, backend="xla")
        runs[dev] = (out.cpu(), iters, (via_ot - (out - norm[:, None, None])).abs().max().item(),
                     launch_counts["sinkhorn"])
    # entries of masked rows or columns sit near -1e6 (-3e6 with the
    # potentials), where fp32 steps by 0.25: compared where the CPU's is not
    valid = runs["cpu"][0] > -1e5
    err = (runs["cuda"][0] - runs["cpu"][0])[valid].abs().max().item()
    exit_ms = cuda_ms(lambda: sinkhorn_early_exit(padded, log_mu, log_nu, num_iter, tol), 5)
    kernel_ms = cuda_ms(lambda: sinkhorn_iterate(padded, log_mu, log_nu, num_iter), 20)
    print(f"[sinkhorn tol] (256, 65, 65), tol {tol:g}, backend xla: exit after "
          f"{runs['cuda'][1]} iterations on the card, {runs['cpu'][1]} on the CPU (cap "
          f"{num_iter}); card vs CPU max abs err {err:.3g} on the {int(valid.sum())} entries "
          f"of valid rows and columns (tol 1e-5); log_sinkhorn_ot = the "
          f"loop - norm within {runs['cuda'][2]:.3g}, Sinkhorn kernel launches "
          f"{runs['cuda'][3]}; the exit {exit_ms:.3f} ms (one host read an iteration) against "
          f"the kernel's {num_iter} iterations {kernel_ms:.4f} ms", flush=True)
    if not (runs["cuda"][1] == runs["cpu"][1] < num_iter and err <= 1e-5
            and runs["cuda"][2] == 0.0 and runs["cuda"][3] == 0):
        fail("[sinkhorn tol] the card's convergence exit disagrees with the CPU's")

    arr = make_pair_arrays(rng, 4096, 3900, 3600)
    pair = _pair(arr, 3900, 3600, "cuda")
    model = RoITr(Config(benchmark="3DMatch"), device="cuda", seed=0).eval()
    default = model.cfg
    launches, caught = {}, []
    with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
        for name, cfg in (("default", default),
                          ("pallas tol", default.replace(sinkhorn_tol=tol)),
                          ("xla tol", default.replace(sinkhorn_backend="xla", sinkhorn_tol=tol))):
            model.cfg = cfg
            reset_launch_counts()
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                if name == "default":
                    with trace(os.path.join(tmp, "profiles")) as log_dir:
                        with annotate("roitr_forward"):
                            out = model(pair)
                        torch.cuda.synchronize()
                else:
                    out = model(pair)
            torch.cuda.synchronize()
            caught.append(any("sinkhorn_tol" in str(x.message) for x in w))
            launches[name] = dict(launch_counts)
            if not torch.isfinite(out["matching_scores"]).all():
                fail(f"[sinkhorn tol] {name}: matching scores not finite")
        files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
        names = {e.get("name", "") for f in files for e in json.load(open(f))["traceEvents"]}
    model.cfg = default
    rpe = sorted(n for n in names if "rpe_attention_kernel" in n)
    print(f"[sinkhorn tol] forward at 4096, Sinkhorn kernel launches: default "
          f"{launches['default']['sinkhorn']}, pallas with tol "
          f"{launches['pallas tol']['sinkhorn']} (warned: {caught[1]}), xla with tol "
          f"{launches['xla tol']['sinkhorn']}; trace() of the default forward: {len(files)} "
          f"file(s), region roitr_forward {'roitr_forward' in names}, kernels named "
          f"{rpe[:1]}; {time.time() - t_phase:.1f} s in all", flush=True)
    if [launches[n]["sinkhorn"] for n in launches] != [1, 1, 0] or caught != [False, True, False]:
        fail(f"[sinkhorn tol] launches {launches}, warnings {caught}")
    if len(files) != 1 or "roitr_forward" not in names or not rpe:
        fail("[sinkhorn tol] the trace does not name the annotated region and the RPE kernel")


# the cuts of [cli]'s copies of the repo's configs: the synthetic split's
# paths, the weights, and the run's length
CLI_TRAIN_CUTS = dict(max_epoch=1, training_max_iter=2, val_max_iter=2, num_workers=2)


def _config_copy(src, dst, **overrides):
    """A copy of a repo config (two-level YAML) with `overrides` set in the
    sections that hold them (a new key under data); nothing else changed."""
    import yaml

    with open(src) as f:
        raw = yaml.safe_load(f)
    left = dict(overrides)
    for body in raw.values():
        if isinstance(body, dict):
            for key in [k for k in left if k in body]:
                body[key] = left.pop(key)
    raw["data"].update(left)
    with open(dst, "w") as f:
        yaml.safe_dump(raw, f)
    return dst


def _reference_pth(state_dict, path):
    """A reference RoITr checkpoint of these weights, as the reference's
    trainer saves one: every key of tests/fixtures/ref_state_dict_keys.json
    (seeded values for those the model never reads), a DDP `module.`
    prefix, under "state_dict"."""
    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                           "ref_state_dict_keys.json")
    with open(fixture) as f:
        shapes = json.load(f)
    if not set(state_dict) <= set(shapes):
        fail(f"port keys outside the reference's: {sorted(set(state_dict) - set(shapes))[:5]}")
    gen = torch.Generator().manual_seed(0)
    torch.save({"state_dict": {"module." + key: (state_dict[key] if key in state_dict
                                                 else torch.randn(shape, generator=gen)).cpu()
                               for key, shape in shapes.items()}}, path)


def phase_cli(rng, main):
    """The command line, `python -m roitr_torch`, at full 3DMatch width on a
    synthetic split of 3 pairs of 20k-30k points in the reference layout:
    train mode in this process from a copy of configs/train/tdmatch.yaml
    (CLI_TRAIN_CUTS; 2 train steps, 2 validation steps, launches exact and
    counted into the kernels line, each step timed, checkpoints written),
    then test mode in a subprocess from a copy of configs/test/tdmatch.yaml
    (knn_method approx, host pyramids, num_workers 2) whose `pretrain` is
    the trained weights as a reference RoITr `.pth`; its dumps against an
    in-process Tester's from the same file, by sha256, whose launches are
    the forward's without FPS."""
    import hashlib

    from roitr_torch import main as cli
    from roitr_torch.config import load_config
    from roitr_torch.eval.tester import Tester
    from roitr_torch.kernels import FORWARD_KERNELS, launch_counts, reset_launch_counts
    from roitr_torch.train import trainer as trainer_module
    from roitr_torch.train.checkpoint import load_model_state

    t_phase = time.time()
    here = os.path.dirname(os.path.abspath(__file__))
    sizes = [(int(a), int(b)) for a, b in rng.randint(20000, 30001, size=(3, 2))]
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            root, info = _write_tdmatch_split(rng, sizes, tmp)
            train_yaml = _config_copy(os.path.join(here, "configs", "train", "tdmatch.yaml"),
                                      os.path.join(tmp, "train.yaml"), root=root,
                                      train_info=info, val_info=info, **CLI_TRAIN_CUTS)
            step_ms = []
            real_step = trainer_module.train_step

            def timed_step(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.time()
                res = real_step(*args, **kw)
                torch.cuda.synchronize()
                step_ms.append((time.time() - t0) * 1e3)
                return res

            trainer_module.train_step = timed_step
            try:
                torch.cuda.synchronize()
                reset_launch_counts()
                t0 = time.time()
                trainer = cli.main([train_yaml])
                torch.cuda.synchronize()
                train_wall = time.time() - t0
            finally:
                trainer_module.train_step = real_step
            train_launches = dict(launch_counts)
            _count_main(train_launches, main)
            ckpts = sorted(os.listdir(trainer.ckpt_dir))
            sources = os.path.isfile(os.path.join(trainer.snapshot_dir, "src", "roitr_torch",
                                                  "main.py"))
            print(f"[cli] python -m roitr_torch {train_yaml} (configs/train/tdmatch.yaml with "
                  f"the split's paths and {CLI_TRAIN_CUTS}): {trainer.step} train steps "
                  f"({', '.join(f'{t:.1f}' for t in step_ms)} ms a step, the data included) "
                  f"+ {trainer.cfg.val_max_iter} validation steps in {train_wall:.1f} s (the "
                  f"pools' start included); checkpoints {ckpts}; sources snapshot {sources}; "
                  f"launches {train_launches}", flush=True)
            want = {k: 2 * TRAIN_STEP[k] + 2 * VAL_STEP[k] for k in TRAIN_STEP}
            if trainer.step != 2 or train_launches != want or not sources or not {
                    "model_0.pth", "model_best_loss.pth"} <= set(ckpts):
                fail(f"[cli] train mode: {trainer.step} steps, launches {train_launches} "
                     f"(expected {want}), checkpoints {ckpts}")

            ref = os.path.join(tmp, "model_3dmatch.pth")
            _reference_pth(load_model_state(os.path.join(trainer.ckpt_dir, "model_0.pth")), ref)
            test_yaml = _config_copy(os.path.join(here, "configs", "test", "tdmatch.yaml"),
                                     os.path.join(tmp, "test.yaml"), root=root, test_info=info,
                                     pretrain=ref, num_workers=2)
            env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
            t0 = time.time()
            res = subprocess.run([sys.executable, "-m", "roitr_torch", test_yaml], cwd=tmp,
                                 env=env, capture_output=True, text=True, timeout=600)
            sub_wall = time.time() - t0
            if res.returncode != 0:
                fail(f"[cli] python -m roitr_torch {test_yaml} exited {res.returncode}: "
                     f"{res.stderr[-3000:]}")
            said = [line for line in res.stdout.splitlines() if "s/pair" in line]
            cfg = load_config(test_yaml)
            dump_dir = os.path.join(tmp, "snapshot", cfg.exp_dir, cfg.benchmark)
            print(f"[cli] python -m roitr_torch {test_yaml} (configs/test/tdmatch.yaml with the "
                  f"split's paths, a reference .pth as pretrain, num_workers 2; knn_method "
                  f"{cfg.knn_method}, host_pyramid {cfg.host_pyramid}) in a subprocess: "
                  f"{sub_wall:.1f} s (interpreter, pool and 3 pairs); it said {said}", flush=True)

            tester = Tester(cfg.replace(exp_dir="cli_in_process"),
                            state_dict=load_model_state(ref))
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.time()
            tester.test()
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = dict(launch_counts)
            digest = lambda d: [hashlib.sha256(open(os.path.join(d, f"{i}.pth"), "rb").read())
                                .hexdigest() for i in range(len(sizes))]
            same = digest(dump_dir) == digest(tester.snapshot_dir)
        finally:
            os.chdir(cwd)
    print(f"[cli] in-process Tester from the same .pth: {wall / len(sizes):.3f} s/pair over "
          f"{len(sizes)} pairs (the pool's start included); launches {launches}; dumps equal to "
          f"the subprocess's by sha256: {same}; {time.time() - t_phase:.1f} s in all", flush=True)
    want = {k: v * len(sizes) for k, v in FORWARD_LAUNCHES.items()}
    want["fps"] = 0  # host pyramids
    if {k: launches[k] for k in FORWARD_KERNELS} != want or not same:
        fail(f"[cli] Tester launches {launches} (expected {want}), dumps equal {same}")


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
    phase_packed(cfg, state_dict, rng)
    phase_host_pyramid(cfg, state_dict, rng)
    phase_tester(rng)
    phase_train_parity(cfg, rng)
    launches, _, _ = phase_training(rng)
    packed_launches = phase_packed_training(rng, launches)
    phase_packed_train_parity(rng)
    fd_launches = phase_fdmatch(rng)
    # the train steps of the last phases, counted as the Trainer runs'
    later = {}
    phase_bf16(rng, later)
    phase_remat(rng, later)
    phase_workers(rng, later)
    phase_ddp(rng, later)
    phase_registration(rng)
    phase_sinkhorn_tol(rng)
    phase_cli(rng, later)

    kernels = []
    for name, row in rows.items():
        bound_ms, bound_by = bound(row["bytes"], row["flops"], row.get("peak", FP32_FLOP_PER_S),
                                   row.get("sfu", 0.0))
        source, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            # the training runs: [training], [packed training], the 4DMatch
            # Trainer of [4dmatch], the train steps of [bf16] and [remat],
            # the Trainer of [workers], every rank's steps and Trainers of
            # [ddp], and the train mode of [cli]
            "launches": (launches[name] + packed_launches[name] + fd_launches[name]
                         + later.get(name, 0)),
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
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
