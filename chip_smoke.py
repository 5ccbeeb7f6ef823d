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
               configs/test/tdmatch.yaml (knn_method overridden) on a test
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
    same_one = all(torch.equal(a[0], b) for a, b in zip(
        fused_rpe_self_attention(*(t[None] for t in (q2, k2, v2, qwp, embed, mask))), (hid, ae)))
    print(f"[kernels] rpe_attention (1, N, D) inputs bit-equal to the one-pair entry: "
          f"{same_one}", flush=True)
    if not same_one:
        fail("rpe_attention with a pair axis of 1 differs from the one-pair entry")
    rpe_attention_pair_axis(gen)

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
        bytes=rpe_bwd_bytes(1, n, d, h, 2), flops=rpe_bwd_flops(1, n, d, h))
    rpe_attention_bwd_pair_axis(gen)
    packed_shapes(gen)

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


def phase_tester(rng):
    """The Tester at full 3DMatch width from configs/test/tdmatch.yaml on a
    test split in the reference layout (three synthetic pairs of 20k-30k
    points, `.pth` fragments and an info pickle, in a temporary directory):
    host prep (host pyramids) with full dumps, device prep with full dumps,
    device prep with c2f dumps, and packed batches of two under host and
    device prep; counters zeroed before each run and read after it."""
    import pickle

    from roitr_torch.config import load_config
    from roitr_torch.data import get_dataset
    from roitr_torch.data.loader import dict_to_pair
    from roitr_torch.data.pyramid import build_cloud_pyramid
    from roitr_torch.data.synthetic import make_pair_arrays
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
            infos = {"rot": [], "trans": [], "src": [], "tgt": [], "overlap": []}
            for i, (n, m) in enumerate(sizes):
                arr = make_pair_arrays(rng, 32768, n, m)
                scene = f"test/scene{i}"
                os.makedirs(os.path.join("indoor", scene))
                for j, cloud in ((2 * i, arr["src_points"][:n]), (2 * i + 1, arr["tgt_points"][:m])):
                    torch.save(torch.from_numpy(cloud.copy()),
                               os.path.join("indoor", scene, f"cloud_bin_{j}.pth"))
                infos["src"].append(f"{scene}/cloud_bin_{2 * i}.pth")
                infos["tgt"].append(f"{scene}/cloud_bin_{2 * i + 1}.pth")
                infos["rot"].append(arr["rot"])
                infos["trans"].append(arr["trans"])
                infos["overlap"].append(0.7)
            with open("test_split.pkl", "wb") as f:
                pickle.dump(infos, f)
            yaml_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                                     "test", "tdmatch.yaml")
            overrides = dict(root=os.path.join(tmp, "indoor"),
                             test_info=os.path.join(tmp, "test_split.pkl"),
                             pretrain=os.path.join(tmp, "weights.pth"), knn_method="exact")
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
    from roitr_torch.config import load_config

    return load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                                    "train", "tdmatch.yaml"), **overrides)


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

    kernels = []
    for name, row in rows.items():
        bound_ms, bound_by = bound(row["bytes"], row["flops"], row.get("peak", FP32_FLOP_PER_S),
                                   row.get("sfu", 0.0))
        source, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            # the two training runs: [training] and [packed training]
            "launches": launches[name] + packed_launches[name],
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
