// Fused geometric structure embedding.
//
// Replaces roitr_tpu/ops/pallas/geo_embedding_kernel.py `_kernel` (entries
// `_pallas_forward`, `fused_geo_embedding`). For each flattened node pair r:
//
//   out[r] = [sin(d_r w), cos(d_r w)] @ Wd + bd
//          + max_k [sin(a_rk w), cos(a_rk w)] @ Wa + ba
//
// with the interleaved [sin0, cos0, sin1, cos1, ...] basis of
// models/embeddings.py written as sin @ W[0::2] + cos @ W[1::2] (the
// wrapper passes the even and odd rows of each weight as separate arrays).
//
// What bounds it: operations. At the 32768 bucket R = 512^2 = 262144 rows,
// H = 256, k = 3: (1 + k) x R x H x H multiply-adds, 1.4e11 FLOP a cloud,
// against 134 MB of bf16 output (0.041 ms at 3.35 TB/s). The products run
// on the bf16 tensor cores (mma.sync m16n8k16, fp32 accumulators), each
// fp32 operand x split into hi = bf16(x) and lo = bf16(x - hi) and the
// product taken as lo.hi + hi.lo + hi.hi (lo.lo dropped): three products,
// 4.1e11 FLOP, 0.417 ms at the H100's 989 TFLOP/s dense bf16. Why three:
// against float64 at R 8192, H 256, k 3 (weights U(+-1/16)), the error over
// the largest |ref| and the share of the argmax map that differs are
// 7.7e-07 / 1.4e-06 for fp32, 5.0e-06 / 4.8e-06 for the three split
// products, 3.2e-04 / 5.1e-04 for TF32 and 2.3e-03 / 3.1e-03 for one bf16
// product; the check is 1e-4 and 1e-3, which only the first two pass
// (tests/test_torch_geo_split.py emulates the split on the CPU).
//
// Design. A block owns 64 rows x 256 columns (all of them at H 256, so each
// sin/cos is computed once), 8 warps as 2 x 4, each warp 32 x 64 (2 x 8
// m16n8 tiles). The K dimension runs in slices of 16 frequencies: 16 sin
// then 16 cos columns, two k16 steps. A, the sin/cos basis, is generated
// from the indices into shared memory as hi/lo bf16 (`basis_sincos`: the
// argument reduced to [-pi, pi], then __sincosf) and never reaches device
// memory. B, the weights, is split into hi/lo once per launch by
// `geo_embedding_split_weights` into a slice-major scratch and streamed
// through a two-stage cp.async ring while the next slice's basis is
// generated; half the warps generate before their products and half after,
// so that each SM sub-partition keeps one warp on the tensor pipe while the
// other computes sines. Both operands reach the tensor cores by ldmatrix,
// from rows padded to 80 bytes (eight rows on distinct banks). The k angle
// phases run first, phase 1 straight into the running max and each later
// one into a second array folded in with a strict > (ties keep the first
// k, as torch.argmax does; a padded neighbour repeats the row point, so its
// phase accumulates the same values in the same order and ties exactly);
// the distance phase then accumulates on top of the max. Two arrays of 64
// fp32 a thread. The epilogue adds the biases, stages the tile in shared
// memory in the storage dtype and writes each row once with 16-byte
// stores; under differentiation it also writes the int8 (R, H) map of the
// winning k the same way. One block an SM (239 / 254 registers without /
// with the map, no spills).
//
// On an H100 80GB HBM3 at 700 W this is about 5x off its tensor-core bound at
// the shape above: the sines, the ldmatrix traffic and the products mostly
// queue behind each other in 8 warps an SM (the variants tool,
// tools/torch_geo_embedding_variants.py, times it without each). Later
// work: wgmma with A from registers and B by TMA (asynchronous products,
// no fragment loads through the register file), and a persistent grid
// whose next tile's basis overlaps this tile's products and epilogue.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // the backward's block
constexpr int kBM = 64;          // rows of a block
constexpr int kBN = 256;         // columns of a block
constexpr int kWM = 32;          // rows of a warp
constexpr int kWN = 64;          // columns of a warp
constexpr int kMT = kWM / 16;    // m16 tiles of a warp
constexpr int kNT = kWN / 8;     // n8 tiles of a warp
constexpr int kWarpsN = kBN / kWN;
constexpr int kFwdThreads = 32 * (kBM / kWM) * kWarpsN;
constexpr int kFreq = 16;        // frequencies a K-slice
constexpr int kGenF = kBM * kFreq / kFwdThreads;  // frequencies a thread generates a slice
constexpr int kBK = 2 * kFreq;   // K columns a slice: kFreq sin, then kFreq cos
constexpr int kLd = kBK + 8;     // shared row stride in bf16: 80 bytes
constexpr int kAElems = kBM * kLd;
constexpr int kBElems = kBN * kLd;
constexpr int kStageElems = 2 * kAElems + 2 * kBElems;  // A hi, A lo, B hi, B lo
constexpr int kStages = 2;
constexpr int kOutLdF = kBN + 4;  // epilogue tile strides (16-byte rows)
constexpr int kOutLdH = kBN + 8;
constexpr int kMapLd = kBN + 16;
constexpr size_t kPipeBytes = (size_t)kStages * kStageElems * 2;
constexpr size_t kEpiBytes = (size_t)kBM * kOutLdF * 4 + (size_t)kBM * kMapLd;
constexpr size_t kSmemBytes = kPipeBytes > kEpiBytes ? kPipeBytes : kEpiBytes;

__host__ __device__ inline int slices_of(int hidden) { return (hidden / 2 + kFreq - 1) / kFreq; }
__host__ __device__ inline int ncols_of(int hidden) { return (hidden + kBN - 1) / kBN * kBN; }

// The split weights: wsplit[t][s][h][n][c] bf16, t 0 the distance weight and
// 1 the angle weight, s the K-slice, h 0 hi and 1 lo, n the output column
// (zeros past hidden), c < 16 the even (sin) row 2 (16 s + c) of W and
// c >= 16 the odd (cos) row 2 (16 s + c - 16) + 1 (zeros past hidden / 2).
__global__ void geo_embedding_split_weights(const float* __restrict__ wde,
                                            const float* __restrict__ wdo,
                                            const float* __restrict__ wae,
                                            const float* __restrict__ wao,
                                            __nv_bfloat16* __restrict__ wsplit, int hidden) {
  const int slices = slices_of(hidden);
  const int ncols = ncols_of(hidden);
  const int half = hidden / 2;
  const size_t plane = (size_t)ncols * kBK;
  const size_t total = (size_t)2 * slices * plane;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(e % kBK);
    const int n = (int)(e / kBK % ncols);
    const int ts = (int)(e / plane);  // t * slices + s
    const int s = ts % slices;
    const int j = s * kFreq + c % kFreq;
    float w = 0.f;
    if (n < hidden && j < half) {
      const float* src = ts < slices ? (c < kFreq ? wde : wdo) : (c < kFreq ? wae : wao);
      w = src[(size_t)j * hidden + n];
    }
    const __nv_bfloat16 hi = __float2bfloat16_rn(w);
    __nv_bfloat16* dst = wsplit + (size_t)ts * 2 * plane + e % plane;
    dst[0] = hi;
    dst[plane] = __float2bfloat16_rn(w - __bfloat162float(hi));
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a . b on the tensor cores: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (v0, v1) -> packed bf16 pairs hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// sin and cos of x * w: one entry of the sinusoidal basis, in both
// directions. The argument, up to tens of radians, is first reduced to
// [-pi, pi] with 2 pi in two parts; there the fast intrinsic is as accurate
// as sincosf for the 1e-4 checks (unreduced it is not), at a fraction of
// its instructions and without its slow path.
__device__ __forceinline__ void basis_sincos(float x, float w, float& s, float& c) {
  const float v = x * w;
  const float n = rintf(v * 0.15915494309189535f);  // turns: v / (2 pi)
  float r = fmaf(-n, 6.28318548202514648f, v);       // 2 pi rounded to fp32
  r = fmaf(-n, -1.7484555314695172e-07f, r);         // and its remainder
  __sincosf(r, &s, &c);
}

// acc += A . B over one K-slice of a stage (byte addresses of its A hi, A lo,
// B hi, B lo tiles in shared memory): two k16 steps of three split
// products, each product over all of the warp's tiles before the next, so
// that consecutive mma are independent. Pairs of n8 tiles at or past the
// last column are skipped.
__device__ __forceinline__ void mma_slice(float (&acc)[kMT][kNT][4], uint32_t a_hi,
                                          uint32_t a_lo, uint32_t b_hi, uint32_t b_lo,
                                          int lane, int warp_m, int warp_n, int ncol_left) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int row = warp_m * kWM + mt * 16 + lane % 16;
      const uint32_t off = (uint32_t)(row * kLd + ks * 16 + (lane / 16) * 8) * 2;
      ldsm_x4(a_hi + off, ah[mt]);
      ldsm_x4(a_lo + off, al[mt]);
    }
    uint32_t bh[kNT / 2][4], bl[kNT / 2][4];
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      if (warp_n * kWN + np * 16 >= ncol_left) continue;  // warp-uniform
      const int n = warp_n * kWN + np * 16 + lane % 8 + (lane / 16) * 8;
      const uint32_t off = (uint32_t)(n * kLd + ks * 16 + ((lane / 8) % 2) * 8) * 2;
      ldsm_x4(b_hi + off, bh[np]);
      ldsm_x4(b_lo + off, bl[np]);
    }
#pragma unroll
    for (int p = 0; p < 3; ++p)  // lo.hi, hi.lo, hi.hi
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        if (warp_n * kWN + np * 16 >= ncol_left) continue;
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            float (&c)[4] = acc[mt][2 * np + q];
            if (p == 0) mma_bf16(c, al[mt], bh[np][2 * q], bh[np][2 * q + 1]);
            else if (p == 1) mma_bf16(c, ah[mt], bl[np][2 * q], bl[np][2 * q + 1]);
            else mma_bf16(c, ah[mt], bh[np][2 * q], bh[np][2 * q + 1]);
          }
      }
  }
}

template <bool kArgmax>
__global__ void __launch_bounds__(kFwdThreads, 1)
geo_embedding_kernel(const float* __restrict__ d_idx, const float* __restrict__ a_idx,
                     const float* __restrict__ div, const __nv_bfloat16* __restrict__ wsplit,
                     const float* __restrict__ bd, const float* __restrict__ ba,
                     void* __restrict__ out, int8_t* __restrict__ amax_map, int r_total,
                     int k_total, int hidden, int out_bf16) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* const sm = reinterpret_cast<__nv_bfloat16*>(smem);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp_m = tid / 32 / kWarpsN;
  const int warp_n = tid / 32 % kWarpsN;
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  const int half = hidden / 2;
  const int slices = slices_of(hidden);
  const size_t plane = (size_t)ncols_of(hidden) * kBK;
  const int ncol_left = hidden - col0;
  // steps: the k angle phases, then the distance phase, each `slices` long
  const int steps = (k_total + 1) * slices;

  // B of step `it` into stage `st`: hi and lo, kBN rows of 4 16-byte chunks
  auto load_b = [&](int it, int st) {
    const int q = it / slices;
    const int ts = (q == k_total ? 0 : slices) + it % slices;
    const __nv_bfloat16* src = wsplit + (size_t)ts * 2 * plane + (size_t)col0 * kBK;
    __nv_bfloat16* dst = sm + st * kStageElems + 2 * kAElems;
#pragma unroll
    for (int e = tid; e < 2 * kBN * 4; e += kFwdThreads) {
      const int h = e / (kBN * 4);
      const int n = e / 4 % kBN;
      const int c = e % 4;
      cp_async16(smem_u32(dst + h * kBElems + n * kLd + c * 8),
                 src + h * plane + (size_t)n * kBK + c * 8);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // A of step `it` into stage `st`: this thread's row and kGenF frequencies
  const int gr = tid / (kFreq / kGenF);
  const int gf = tid % (kFreq / kGenF) * kGenF;
  const int grow = row0 + gr;
  auto gen_a = [&](int it, int st) {
    const int q = it / slices;
    const int j0 = it % slices * kFreq + gf;
    float x = 0.f;
    if (grow < r_total) x = q == k_total ? d_idx[grow] : a_idx[(size_t)grow * k_total + q];
    float sv[kGenF], cv[kGenF];
#pragma unroll
    for (int i = 0; i < kGenF; ++i) {
      sv[i] = cv[i] = 0.f;
      if (grow < r_total && j0 + i < half) basis_sincos(x, div[j0 + i], sv[i], cv[i]);
    }
    __nv_bfloat16* a = sm + st * kStageElems + gr * kLd + gf;
#pragma unroll
    for (int i = 0; i < kGenF; i += 2) {
      uint32_t hi, lo;
      split2(sv[i], sv[i + 1], hi, lo);
      *reinterpret_cast<uint32_t*>(a + i) = hi;
      *reinterpret_cast<uint32_t*>(a + kAElems + i) = lo;
      split2(cv[i], cv[i + 1], hi, lo);
      *reinterpret_cast<uint32_t*>(a + kFreq + i) = hi;
      *reinterpret_cast<uint32_t*>(a + kAElems + kFreq + i) = lo;
    }
  };

  float mx[kMT][kNT][4];   // running max over k, then + the distance part
  float acc[kMT][kNT][4];  // angle phases 2..k
  uint32_t arg[kMT][kNT];  // winning k of mx's four entries, one byte each
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      arg[mt][nt] = 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[mt][nt][i] = acc[mt][nt][i] = 0.f;
    }

  load_b(0, 0);
  gen_a(0, 0);
  for (int it = 0; it < steps; ++it) {
    const int st = it & 1;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // step it's A and B are in; every warp is done with it - 1
    // half the warps generate the next basis before their products, half
    // after, so each SM sub-partition has a warp on each pipe
    const bool gen_first = tid < kFwdThreads / 2;
    if (it + 1 < steps) {
      load_b(it + 1, st ^ 1);
      if (gen_first) gen_a(it + 1, st ^ 1);
    }
    const int q = it / slices;
    const uint32_t a_hi = smem_u32(sm + st * kStageElems);
    const uint32_t a_lo = a_hi + kAElems * 2;
    const uint32_t b_hi = a_hi + 4 * kAElems;
    const uint32_t b_lo = b_hi + kBElems * 2;
    if (q == 0 || q == k_total) {
      mma_slice(mx, a_hi, a_lo, b_hi, b_lo, lane, warp_m, warp_n, ncol_left);
    } else {
      mma_slice(acc, a_hi, a_lo, b_hi, b_lo, lane, warp_m, warp_n, ncol_left);
      if (it % slices == slices - 1) {  // fold angle phase q into the max
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (kArgmax && acc[mt][nt][i] > mx[mt][nt][i])
                arg[mt][nt] = (arg[mt][nt] & ~(0xFFu << (8 * i))) | ((uint32_t)q << (8 * i));
              mx[mt][nt][i] = fmaxf(mx[mt][nt][i], acc[mt][nt][i]);
              acc[mt][nt][i] = 0.f;
            }
      }
    }
    if (!gen_first && it + 1 < steps) gen_a(it + 1, st ^ 1);
  }

  // epilogue: the tile (+ biases) in the storage dtype, and the map, through
  // shared memory, then 16-byte row stores
  __syncthreads();  // every warp is done reading the last stage
  float* const tile_f = reinterpret_cast<float*>(smem);
  __nv_bfloat16* const tile_h = reinterpret_cast<__nv_bfloat16*>(smem);
  int8_t* const tile_m = reinterpret_cast<int8_t*>(smem + (size_t)kBM * kOutLdF * 4);
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int cl = warp_n * kWN + nt * 8 + lane % 4 * 2;
    const int c = col0 + cl;
    const float b0 = c < hidden ? bd[c] + ba[c] : 0.f;
    const float b1 = c + 1 < hidden ? bd[c + 1] + ba[c + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = warp_m * kWM + mt * 16 + lane / 4 + 8 * h;
        const float v0 = mx[mt][nt][2 * h] + b0;
        const float v1 = mx[mt][nt][2 * h + 1] + b1;
        if (out_bf16) {
          *reinterpret_cast<__nv_bfloat162*>(tile_h + rl * kOutLdH + cl) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          *reinterpret_cast<float2*>(tile_f + rl * kOutLdF + cl) = make_float2(v0, v1);
        }
        if (kArgmax) {
          tile_m[rl * kMapLd + cl] = (int8_t)((arg[mt][nt] >> (16 * h)) & 0xFFu);
          tile_m[rl * kMapLd + cl + 1] = (int8_t)((arg[mt][nt] >> (16 * h + 8)) & 0xFFu);
        }
      }
  }
  __syncthreads();

  const int rows = min(kBM, r_total - row0);
  const int cols = min(kBN, ncol_left);
  const int esize = out_bf16 ? 2 : 4;
  const bool out_vec = (size_t)hidden * esize % 16 == 0 && (uintptr_t)out % 16 == 0;
  const int per = 16 / esize;  // elements a 16-byte chunk
  for (int e = tid; e < kBM * (kBN / per); e += kFwdThreads) {
    const int rl = e / (kBN / per);
    const int cl = e % (kBN / per) * per;
    if (rl >= rows || cl >= cols) continue;
    const size_t o = (size_t)(row0 + rl) * hidden + col0 + cl;
    const void* src = out_bf16 ? (const void*)(tile_h + rl * kOutLdH + cl)
                               : (const void*)(tile_f + rl * kOutLdF + cl);
    char* dst = static_cast<char*>(out) + o * esize;
    if (out_vec && cl + per <= cols) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int i = 0; i < per && cl + i < cols; ++i)
        for (int b = 0; b < esize; ++b)
          dst[i * esize + b] = static_cast<const char*>(src)[i * esize + b];
    }
  }
  if (kArgmax) {
    const bool map_vec = hidden % 16 == 0 && (uintptr_t)amax_map % 16 == 0;
    for (int e = tid; e < kBM * (kBN / 16); e += kFwdThreads) {
      const int rl = e / (kBN / 16);
      const int cl = e % (kBN / 16) * 16;
      if (rl >= rows || cl >= cols) continue;
      int8_t* dst = amax_map + (size_t)(row0 + rl) * hidden + col0 + cl;
      const int8_t* src = tile_m + rl * kMapLd + cl;
      if (map_vec && cl + 16 <= cols) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int i = 0; i < 16 && cl + i < cols; ++i) dst[i] = src[i];
      }
    }
  }
}

// ---------------------------------------------------------------------
// Backward.
//
// Replaces roitr_tpu/ops/pallas/geo_embedding_kernel.py `_bwd_kernel`
// (entries `_pallas_backward`, `_bwd`). With the forward's argmax map
// routing each cotangent element to the k that won:
//
//   dWd[2j]   = sum_r sin(d_r w_j) g[r]     dWd[2j+1] = sum_r cos(d_r w_j) g[r]
//   dWa[2j]   = sum_r sum_k sin(a_rk w_j) g[r] [amax[r] == k]  (cos likewise)
//   dbd = dba = sum_r g[r]
//
// A GEMM with M the basis column, N the output column and K the rows:
// dWd = E_d^T g and dWa = sum_k E_k^T (g * [amax == k]), the forward's product
// turned on its side. What bounds it: operations. Each cotangent element
// meets one distance basis row and the angle basis row of its winning k, so
// the function needs 2 x R x H x H multiply-adds, 6.9e10 FLOP at R = 262144,
// H = 256, k = 3, against 134 MB of bf16 cotangent and 67 MB of map.
//
// Design. The products run on the bf16 tensor cores (mma.sync m16n8k16,
// fp32 accumulators), each phase a masked dense product: K runs over
// (row, phase) pairs, B of angle phase q is g * [amax == q] and of the
// distance phase g itself, so the kernel multiplies (1 + k) x R x H x H,
// (1 + k) / 2 = 2x the function's work at k = 3, instead of gathering each
// element's winning basis row on the CUDA cores. The basis is split into
// hi + lo bf16 as it is generated; a bf16 cotangent (training's, from the
// bf16 embedding storage) is exact in bf16 and so is its masked copy, so two
// products (lo.g + hi.g) keep fp32 accuracy; an fp32 cotangent is split too
// and takes three (lo.hi, hi.lo, hi.hi).
//
// A block owns 32 frequencies (64 basis columns, 32 sin then 32 cos) x 256
// output columns of both dWd and dWa, so each sin/cos is computed once at
// H 256, and one chunk of rows; 8 warps as 2 x 4, each 32 x 64, two arrays
// of 64 fp32 accumulators a thread (dWd, dWa). Rows run in slices of 32,
// two k16 steps. The slice's g and int8 map rows stream into a two-stage
// cp.async ring one slice ahead (scalar loads when a row is not 16-byte
// aligned, as at H 40 / 42); once a slice, the block rewrites them into
// B planes: g as bf16 hi (and lo), [row][column] padded to 528 bytes and
// read by ldmatrix.trans, and the map widened to int16 in the same layout,
// so that one ldmatrix.trans gives each thread the map entries of its own B
// fragment and a per-halfword compare masks it in registers for each phase.
// The same pass sums g into the bias gradient in fp32 on the CUDA cores.
// A, the basis of one phase, is generated as [basis column][row] (rows
// padded to 80 bytes, plain ldmatrix) into a two-stage ring, one step
// ahead, half the warps before their products and half after, as in the
// forward. The grid runs the j-tiles of a column tile and chunk side by
// side (blockIdx.x fastest), so their repeated reads of g come from L2.
//
// Deterministic split-K: each block writes its chunk's partials, and
// `geo_embedding_bwd_reduce` sums them in chunk order (no atomics; two
// launches are bit-equal). One block an SM (224 / 240 registers with a
// bf16 / fp32 cotangent, no spills). The tensor cores' fp32 accumulation
// loses more over longer chunks: against float64 at the shape above the
// error over max|ref| is 2.2e-05 in 66 chunks of 3972 rows, 6.5e-06 in 264
// and 2.9e-06 in 1056 (the variants tool); the wrapper takes two waves'
// worth, inside the 1e-4 check. On an H100 80GB HBM3 at 700 W the kernel is
// about 13x off its two-product tensor-core bound: the ldmatrix of A, B and
// the map, the mask and the products form one dependent chain a phase that
// 8 warps an SM hide little of (the variants tool times it without each).

constexpr int kBwdFreq = 32;            // frequencies a block
constexpr int kBwdM = 2 * kBwdFreq;     // basis columns a block: sin, then cos
constexpr int kBR = 32;                 // rows a slice: two k16 steps
constexpr int kLdA = kBR + 8;           // A [basis column][row] stride in bf16: 80 bytes
constexpr int kLdB = kBN + 8;           // B [row][column] stride in 16-bit words: 528 bytes
constexpr int kAStage = 2 * kBwdM * kLdA;  // bf16 of an A stage: hi, lo
constexpr int kBPlane = kBR * kLdB;        // 16-bit words of a B plane
constexpr int kGenRows = 4;             // rows of one frequency a thread generates a step
static_assert(kBwdM / kWM * kWarpsN * 32 == kThreads, "8 warps of 32 x 64");
static_assert(kBwdFreq * kBR / kGenRows == kThreads, "one generator task a thread");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void load_pair(const float* p, float& v0, float& v1) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  v0 = v.x;
  v1 = v.y;
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, float& v0, float& v1) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  v0 = v.x;
  v1 = v.y;
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// shared memory of the backward: A ring, B planes (g hi, [g lo,] map), the
// raw g / map ring, and the bias gradient's exchange
template <typename G>
__host__ __device__ constexpr int bwd_raw_g_bytes() { return kBR * kBN * (int)sizeof(G); }
template <typename G>
__host__ __device__ constexpr int bwd_raw_stage_bytes() { return bwd_raw_g_bytes<G>() + kBR * kBN; }
template <typename G>
__host__ __device__ constexpr size_t bwd_smem_bytes() {
  return (size_t)2 * kAStage * 2 + (size_t)(sizeof(G) == 4 ? 3 : 2) * kBPlane * 2 +
         (size_t)2 * bwd_raw_stage_bytes<G>() + kBN * 4;
}

// acc += A . B of one phase over a slice: two k16 steps of
// kProducts split products (lo.hi, [hi.lo,] hi.hi), each over all of the
// warp's tiles before the next. With kMask, B keeps only the entries whose
// map equals `win` (two int16 copies in one word). Pairs of n8 tiles at or
// past the last column are skipped.
template <bool kMask, int kProducts>
__device__ __forceinline__ void bwd_mma_slice(float (&acc)[kMT][kNT][4], uint32_t a_hi,
                                              uint32_t a_lo, uint32_t b_hi, uint32_t b_lo,
                                              uint32_t b_map, uint32_t win, int lane, int warp_m,
                                              int warp_n, int ncol_left) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int row = warp_m * kWM + mt * 16 + lane % 16;
      const uint32_t off = (uint32_t)(row * kLdA + ks * 16 + (lane / 16) * 8) * 2;
      ldsm_x4(a_hi + off, ah[mt]);
      ldsm_x4(a_lo + off, al[mt]);
    }
    uint32_t bh[kNT / 2][4], bl[kNT / 2][4];
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      if (warp_n * kWN + np * 16 >= ncol_left) continue;  // warp-uniform
      const int k = ks * 16 + lane % 8 + ((lane / 8) % 2) * 8;
      const int n = warp_n * kWN + np * 16 + (lane / 16) * 8;
      const uint32_t off = (uint32_t)(k * kLdB + n) * 2;
      ldsm_x4_trans(b_hi + off, bh[np]);
      if (kProducts == 3) ldsm_x4_trans(b_lo + off, bl[np]);
      if (kMask) {
        uint32_t m[4];
        ldsm_x4_trans(b_map + off, m);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t keep = __vcmpeq2(m[i], win);
          bh[np][i] &= keep;
          if (kProducts == 3) bl[np][i] &= keep;
        }
      }
    }
#pragma unroll
    for (int p = 0; p < 3; ++p) {  // lo.hi, hi.lo (fp32 cotangent only), hi.hi
      if (kProducts == 2 && p == 1) continue;
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        if (warp_n * kWN + np * 16 >= ncol_left) continue;
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            float (&c)[4] = acc[mt][2 * np + q];
            if (p == 0) mma_bf16(c, al[mt], bh[np][2 * q], bh[np][2 * q + 1]);
            else if (p == 1) mma_bf16(c, ah[mt], bl[np][2 * q], bl[np][2 * q + 1]);
            else mma_bf16(c, ah[mt], bh[np][2 * q], bh[np][2 * q + 1]);
          }
      }
    }
  }
}

template <typename G>
__global__ void __launch_bounds__(kThreads, 1)
geo_embedding_bwd_kernel(const float* __restrict__ d_idx, const float* __restrict__ a_idx,
                         const int8_t* __restrict__ amax_map, const G* __restrict__ g,
                         const float* __restrict__ div, float* __restrict__ part,
                         float* __restrict__ part_db, int r_total, int k_total, int hidden,
                         int rows_per_chunk) {
  constexpr int kProducts = sizeof(G) == 4 ? 3 : 2;  // an fp32 cotangent is split too
  constexpr int kRawG = bwd_raw_g_bytes<G>();
  constexpr int kRawStage = bwd_raw_stage_bytes<G>();
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* const sa = reinterpret_cast<__nv_bfloat16*>(smem);  // A ring
  __nv_bfloat16* const sg = sa + 2 * kAStage;                        // g hi [, g lo]
  int16_t* const smap = reinterpret_cast<int16_t*>(sg + (kProducts - 1) * kBPlane);
  unsigned char* const raw = reinterpret_cast<unsigned char*>(smap + kBPlane);
  float* const sdb = reinterpret_cast<float*>(raw + 2 * kRawStage);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp_m = tid / 32 / kWarpsN;
  const int warp_n = tid / 32 % kWarpsN;
  const int j0 = blockIdx.x * kBwdFreq;
  const int col0 = blockIdx.y * kBN;
  const int chunk = blockIdx.z;
  const int half = hidden / 2;
  const int ncol_left = hidden - col0;
  const int r_begin = chunk * rows_per_chunk;
  const int r_end = min(r_total, r_begin + rows_per_chunk);
  const int slices = r_end > r_begin ? (r_end - r_begin + kBR - 1) / kBR : 0;
  const int phases = k_total + 1;  // the distance, then the k angles
  const int steps = slices * phases;
  const bool vec = hidden % 16 == 0 && ((uintptr_t)g | (uintptr_t)amax_map) % 16 == 0;

  // slice s's rows of g and the map into raw stage s & 1, 16-byte chunks
  // inside the arrays only
  auto load_raw = [&](int s) {
    unsigned char* dst = raw + (s & 1) * kRawStage;
    const int row0 = r_begin + s * kBR;
    constexpr int kPer = 16 / (int)sizeof(G);  // cotangent elements a chunk
#pragma unroll
    for (int e = tid; e < kBR * (kBN / kPer); e += kThreads) {
      const int rr = e / (kBN / kPer);
      const int c = e % (kBN / kPer) * kPer;
      if (row0 + rr < r_end && c < ncol_left)
        cp_async16(smem_u32(dst + (rr * kBN + c) * (int)sizeof(G)),
                   g + (size_t)(row0 + rr) * hidden + col0 + c);
    }
#pragma unroll
    for (int e = tid; e < kBR * (kBN / 16); e += kThreads) {
      const int rr = e / (kBN / 16);
      const int c = e % (kBN / 16) * 16;
      if (row0 + rr < r_end && c < ncol_left)
        cp_async16(smem_u32(dst + kRawG + rr * kBN + c),
                   amax_map + (size_t)(row0 + rr) * hidden + col0 + c);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // slice s into the B planes: g as bf16 hi (and lo), the map as int16, 0 and
  // -1 outside the arrays; each thread two columns of 16 rows, whose g it
  // also adds to its bias-gradient sums
  const int cb = tid % (kBN / 2) * 2;
  const int rb = tid / (kBN / 2) * (kBR / 2);
  float db0 = 0.f, db1 = 0.f;
  auto convert = [&](int s) {
    const unsigned char* src = raw + (s & 1) * kRawStage;
    const int row0 = r_begin + s * kBR;
#pragma unroll 4
    for (int i = 0; i < kBR / 2; ++i) {
      const int rr = rb + i;
      float v0 = 0.f, v1 = 0.f;
      int m0 = -1, m1 = -1;
      if (cb < ncol_left && row0 + rr < r_end) {
        if (vec) {
          load_pair(reinterpret_cast<const G*>(src) + rr * kBN + cb, v0, v1);
          const char2 m = *reinterpret_cast<const char2*>(src + kRawG + rr * kBN + cb);
          m0 = m.x;
          m1 = m.y;
        } else {
          const size_t o = (size_t)(row0 + rr) * hidden + col0 + cb;
          v0 = to_float(g[o]);
          v1 = to_float(g[o + 1]);
          m0 = amax_map[o];
          m1 = amax_map[o + 1];
        }
      }
      db0 += v0;
      db1 += v1;
      uint32_t hi, lo;
      split2(v0, v1, hi, lo);
      *reinterpret_cast<uint32_t*>(sg + rr * kLdB + cb) = hi;
      if (kProducts == 3) *reinterpret_cast<uint32_t*>(sg + kBPlane + rr * kLdB + cb) = lo;
      *reinterpret_cast<uint32_t*>(smap + rr * kLdB + cb) =
          (uint32_t)(uint16_t)m0 | ((uint32_t)(uint16_t)m1 << 16);
    }
  };

  // A of step `it` (slice it / phases, phase it % phases) into stage `st`:
  // this thread's frequency at kGenRows rows, sin and cos, hi and lo
  const int gf = tid / (kBR / kGenRows);
  const int gr = tid % (kBR / kGenRows) * kGenRows;
  const bool f_ok = j0 + gf < half;
  const float wf = f_ok ? div[j0 + gf] : 0.f;
  auto gen_basis = [&](int it, int st) {
    const int q = it % phases;
    const int row0 = r_begin + it / phases * kBR + gr;
    float sv[kGenRows], cv[kGenRows];
#pragma unroll
    for (int i = 0; i < kGenRows; ++i) {
      sv[i] = cv[i] = 0.f;
      const int row = row0 + i;
      if (f_ok && row < r_end)
        basis_sincos(q == 0 ? d_idx[row] : a_idx[(size_t)row * k_total + q - 1], wf, sv[i],
                     cv[i]);
    }
    __nv_bfloat16* a = sa + st * kAStage + gf * kLdA + gr;
    uint2 hs, ls, hc, lc;
    split2(sv[0], sv[1], hs.x, ls.x);
    split2(sv[2], sv[3], hs.y, ls.y);
    split2(cv[0], cv[1], hc.x, lc.x);
    split2(cv[2], cv[3], hc.y, lc.y);
    *reinterpret_cast<uint2*>(a) = hs;
    *reinterpret_cast<uint2*>(a + kBwdM * kLdA) = ls;
    *reinterpret_cast<uint2*>(a + kBwdFreq * kLdA) = hc;
    *reinterpret_cast<uint2*>(a + (kBwdM + kBwdFreq) * kLdA) = lc;
  };

  float accd[kMT][kNT][4];  // dWd
  float acca[kMT][kNT][4];  // dWa
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) accd[mt][nt][i] = acca[mt][nt][i] = 0.f;

  if (steps > 0) {
    if (vec) load_raw(0);
    gen_basis(0, 0);
  }
  const uint32_t b_hi = smem_u32(sg);
  const uint32_t b_lo = b_hi + kBPlane * 2;
  const uint32_t b_map = smem_u32(smap);
  for (int it = 0; it < steps; ++it) {
    const int st = it & 1;
    const int s = it / phases;
    const int q = it % phases;
    if (q == 0) {
      if (vec) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();  // slice s's rows are in; every warp is done with slice s - 1's B
      convert(s);
      if (vec && s + 1 < slices) load_raw(s + 1);
    }
    __syncthreads();  // step it's A and slice s's B are in; every warp is done with it - 1
    const bool gen_first = tid < kThreads / 2;
    if (gen_first && it + 1 < steps) gen_basis(it + 1, st ^ 1);
    const uint32_t a_hi = smem_u32(sa + st * kAStage);
    const uint32_t a_lo = a_hi + kBwdM * kLdA * 2;
    if (q == 0) {
      bwd_mma_slice<false, kProducts>(accd, a_hi, a_lo, b_hi, b_lo, b_map, 0u, lane, warp_m,
                                      warp_n, ncol_left);
    } else {
      bwd_mma_slice<true, kProducts>(acca, a_hi, a_lo, b_hi, b_lo, b_map,
                                     (uint32_t)(q - 1) * 0x00010001u, lane, warp_m, warp_n,
                                     ncol_left);
    }
    if (!gen_first && it + 1 < steps) gen_basis(it + 1, st ^ 1);
  }

  // partials of this chunk: part[chunk][w][j][col], w = dWd even (sin), odd
  // (cos), dWa even, odd; warp_m 0 holds the sin columns, warp_m 1 the cos
  const size_t plane = (size_t)half * hidden;
  float* const pc = part + (size_t)chunk * 4 * plane;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + mt * 16 + lane / 4 + 8 * h;
      if (j >= half) continue;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int c = col0 + warp_n * kWN + nt * 8 + lane % 4 * 2;
        if (c >= hidden) continue;
        const size_t o = (size_t)j * hidden + c;
        *reinterpret_cast<float2*>(pc + warp_m * plane + o) =
            make_float2(accd[mt][nt][2 * h], accd[mt][nt][2 * h + 1]);
        *reinterpret_cast<float2*>(pc + (2 + warp_m) * plane + o) =
            make_float2(acca[mt][nt][2 * h], acca[mt][nt][2 * h + 1]);
      }
    }
  // the bias gradient of this chunk, by the column tile's first j-tile: the
  // two row halves' sums added in a fixed order
  if (blockIdx.x == 0) {
    if (rb != 0) {
      sdb[cb] = db0;
      sdb[cb + 1] = db1;
    }
    __syncthreads();
    if (rb == 0 && cb < ncol_left) {
      part_db[(size_t)chunk * hidden + col0 + cb] = db0 + sdb[cb];
      part_db[(size_t)chunk * hidden + col0 + cb + 1] = db1 + sdb[cb + 1];
    }
  }
}

// out[e] = sum over chunks, in chunk order, of part[chunk][e]
__global__ void geo_embedding_bwd_reduce(const float* __restrict__ part, int chunks, size_t n,
                                         float* __restrict__ out) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int ch = 0; ch < chunks; ++ch) s += part[(size_t)ch * n + e];
  out[e] = s;
}

// the backward kernel for a bf16 or fp32 cotangent and its dynamic shared
// memory, which it is allowed past the 48 KB default
cudaError_t bwd_kernel_for(int g_bf16, const void** kernel, size_t* bytes) {
  *kernel = g_bf16 ? (const void*)&geo_embedding_bwd_kernel<__nv_bfloat16>
                   : (const void*)&geo_embedding_bwd_kernel<float>;
  *bytes = g_bf16 ? bwd_smem_bytes<__nv_bfloat16>() : bwd_smem_bytes<float>();
  return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
}

}  // namespace

// bf16 elements of the split-weight scratch `wsplit` that roitr_geo_embedding
// takes: 2 weights x slices x (hi, lo) x columns padded to 256 x 32
extern "C" int roitr_geo_embedding_wsplit_elems(int hidden) {
  return 2 * slices_of(hidden) * 2 * ncols_of(hidden) * kBK;
}

// Resident blocks an SM of the current device takes of the forward kernel (with or
// without the map), from its registers and shared memory.
extern "C" int roitr_geo_embedding_blocks_per_sm(int argmax, int* blocks) {
  auto kernel = argmax ? &geo_embedding_kernel<true> : &geo_embedding_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kFwdThreads,
                                                            kSmemBytes);
}

extern "C" int roitr_geo_embedding(const float* d_idx, const float* a_idx, const float* div,
                                   const float* wde, const float* wdo, const float* bd,
                                   const float* wae, const float* wao, const float* ba,
                                   void* out, int8_t* amax_map, void* wsplit, int r_total,
                                   int k_total, int hidden, int out_bf16, void* stream) {
  if (k_total < 1 || k_total > 127 || hidden < 2 || hidden % 2 || r_total < 0)
    return (int)cudaErrorInvalidValue;
  if (r_total == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  __nv_bfloat16* ws = static_cast<__nv_bfloat16*>(wsplit);
  const int elems = roitr_geo_embedding_wsplit_elems(hidden) / 2;  // one thread writes hi and lo
  geo_embedding_split_weights<<<(elems + 255) / 256, 256, 0, st>>>(wde, wdo, wae, wao, ws,
                                                                  hidden);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((r_total + kBM - 1) / kBM, ncols_of(hidden) / kBN);
  auto kernel = amax_map ? &geo_embedding_kernel<true> : &geo_embedding_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kFwdThreads, kSmemBytes, st>>>(d_idx, a_idx, div, ws, bd, ba, out, amax_map,
                                             r_total, k_total, hidden, out_bf16);
  return (int)cudaGetLastError();
}

// Resident blocks an SM of the current device takes of the backward kernel
// (bf16 or fp32 cotangent), from its registers and shared memory.
extern "C" int roitr_geo_embedding_bwd_blocks_per_sm(int g_bf16, int* blocks) {
  const void* kernel;
  size_t bytes;
  cudaError_t err = bwd_kernel_for(g_bf16, &kernel, &bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads, bytes);
}

// part: chunks x (4 x H/2 x H) floats, part_db: chunks x H, dw: 4 x H/2 x H
// (dWd even rows, odd rows, dWa even rows, odd rows), db: H
extern "C" int roitr_geo_embedding_bwd(const float* d_idx, const float* a_idx,
                                       const int8_t* amax_map, const void* g, const float* div,
                                       float* part, float* part_db, float* dw, float* db,
                                       int r_total, int k_total, int hidden, int chunks,
                                       int g_bf16, void* stream) {
  if (k_total < 1 || hidden % 2 || chunks < 1 || r_total < 1) return (int)cudaErrorInvalidValue;
  int rows_per_chunk = (r_total + chunks - 1) / chunks;
  rows_per_chunk = (rows_per_chunk + kBR - 1) / kBR * kBR;
  const dim3 grid((hidden / 2 + kBwdFreq - 1) / kBwdFreq, ncols_of(hidden) / kBN, chunks);
  cudaStream_t st = (cudaStream_t)stream;
  const void* kernel;
  size_t bytes;
  cudaError_t err = bwd_kernel_for(g_bf16, &kernel, &bytes);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&d_idx, (void*)&a_idx, (void*)&amax_map, (void*)&g, (void*)&div,
                  (void*)&part, (void*)&part_db, &r_total, &k_total, &hidden, &rows_per_chunk};
  err = cudaLaunchKernel(kernel, grid, dim3(kThreads), args, bytes, st);
  cudaGetLastError();  // a refused launch leaves no error behind for the next one
  if (err != cudaSuccess) return (int)err;
  const size_t nw = (size_t)4 * (hidden / 2) * hidden;
  geo_embedding_bwd_reduce<<<(unsigned)((nw + 255) / 256), 256, 0, st>>>(part, chunks, nw, dw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  geo_embedding_bwd_reduce<<<(hidden + 255) / 256, 256, 0, st>>>(part_db, chunks,
                                                                 (size_t)hidden, db);
  return (int)cudaGetLastError();
}
