// Fused global RPE self-attention over the coarse nodes of one cloud.
//
// Replaces roitr_tpu/ops/pallas/rpe_attention_kernel.py `_kernel` (entries
// `_pallas_forward`, `fused_rpe_self_attention`). For query row n, head h:
//
//   s[h, m]   = (q_h[n] . k_h[m] + qwp[n, h] . e[n, m]) / sqrt(c)
//   hidden_h  = masked_softmax_m(s[h]) @ v_h
//   ae[n, h]  = masked_softmax_m(s[h], excluding m == n) @ e[n]
//
// with key mask mask[m] > 0; a row with no valid key gives zeros. The
// reference's q . b_p bias is constant along m, so softmax-invariant, and
// is dropped as in the JAX package.
//
// What bounds it: bytes. The (N, N, D) embedding is the only large input:
// 134 MB in bf16 at N = 512, D = 256, against 1.1 GFLOP a launch. Design:
// one block per query row n. Pass 1 streams the block's embedding slab
// e[n] (N x D) once, a warp per key, into H x N scores in shared memory;
// pass 2 turns them into both softmaxes in shared memory; pass 3 streams
// e[n] a second time for the positional aggregation and reads v for the
// hidden state. The second read comes mostly from device memory, not L2:
// the blocks in flight hold far more than its 50 MB of slabs. All sums
// are fp32; the embedding arrives in its storage dtype (bf16 or fp32).
// The per-thread head arrays are sized by a compile-time bound on the head
// count (4, 8 or 16, the smallest that holds H), so the main path's H = 4
// keeps registers low and several blocks share an SM. Reading e[n] once
// instead of twice (an online softmax) is later work. On request (under
// differentiation) it also writes the log-sum-exp of both softmaxes, (N, H)
// each, from which the backward below recomputes every probability without
// a second pass over e[n].
//
// A packed batch of B pairs (the TPU kernel's grid axis added by vmap's
// batching rule) is one launch: the pair is blockIdx.y, and every pointer
// moves by that pair's stride, (N, D) for q/k/v/hidden, (N, H, D) for
// qwp/ae, (N, N, D) for the embedding, (N,) for the mask, (N, H) for the
// log-sum-exps. Each block's arithmetic is that of one pair alone, so a
// pair's result does not depend on B.

#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeads = 16;  // largest head count taken

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// In-place masked softmax of row[0:n] (one warp); keep(m) says which keys
// count. Masked entries become 0; a row with no kept key becomes all 0.
// With lse, lane 0 writes there the log-sum-exp of the kept scores, +inf
// for a row with no kept key (so that exp(s - lse) is 0 for every key).
template <typename Keep>
__device__ void warp_masked_softmax(float* row, int n, Keep keep, int lane,
                                    float* lse = nullptr) {
  float mx = -CUDART_INF_F;
  for (int m = lane; m < n; m += 32)
    if (keep(m)) mx = fmaxf(mx, row[m]);
  mx = warp_max(mx);
  if (mx == -CUDART_INF_F) mx = 0.f;
  float sum = 0.f;
  for (int m = lane; m < n; m += 32) {
    const float e = keep(m) ? expf(row[m] - mx) : 0.f;
    row[m] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  if (lse && lane == 0) *lse = sum == 0.f ? CUDART_INF_F : mx + logf(sum);
  const float inv = sum == 0.f ? 1.f : sum;
  for (int m = lane; m < n; m += 32) row[m] = row[m] / inv;
}

template <typename E, int MAXH>
__global__ void __launch_bounds__(kThreads)
rpe_attention_kernel(const float* __restrict__ q2, const float* __restrict__ k2,
                     const float* __restrict__ v2, const float* __restrict__ qwp,
                     const E* __restrict__ emb, const float* __restrict__ mask,
                     float* __restrict__ hid, float* __restrict__ ae,
                     float* __restrict__ lse_attn, float* __restrict__ lse_pos, int n_total,
                     int d_total, int heads) {
  extern __shared__ float smem[];
  const int c = d_total / heads;
  float* s_q = smem;                          // D
  float* s_qwp = s_q + d_total;               // H x D
  float* s_attn = s_qwp + heads * d_total;    // H x N, value softmax
  float* s_pos = s_attn + heads * n_total;    // H x N, self-excluding softmax

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  {  // this block's pair
    const size_t pair = blockIdx.y;
    const size_t nd = (size_t)n_total * d_total;
    q2 += pair * nd;
    k2 += pair * nd;
    v2 += pair * nd;
    hid += pair * nd;
    qwp += pair * nd * heads;
    ae += pair * nd * heads;
    emb += pair * nd * n_total;
    mask += pair * n_total;
    if (lse_attn) lse_attn += pair * n_total * heads;
    if (lse_pos) lse_pos += pair * n_total * heads;
  }
  const E* e_row = emb + (size_t)n * n_total * d_total;

  for (int i = tid; i < d_total; i += kThreads) s_q[i] = q2[(size_t)n * d_total + i];
  for (int i = tid; i < heads * d_total; i += kThreads)
    s_qwp[i] = qwp[(size_t)n * heads * d_total + i];
  __syncthreads();

  // pass 1: scores, one warp per key m
  const float inv_sqrt_c = 1.f / sqrtf((float)c);
  for (int m = warp; m < n_total; m += kWarps) {
    float sp[MAXH], se[MAXH];
#pragma unroll
    for (int h = 0; h < MAXH; ++h) sp[h] = se[h] = 0.f;
    const E* e_m = e_row + (size_t)m * d_total;
    for (int col = lane; col < d_total; col += 32) {
      const float ev = load(e_m + col);
#pragma unroll
      for (int h = 0; h < MAXH; ++h)
        if (h < heads) sp[h] = fmaf(s_qwp[h * d_total + col], ev, sp[h]);
    }
    const float* k_m = k2 + (size_t)m * d_total;
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      if (h < heads) {
        for (int col = h * c + lane; col < (h + 1) * c; col += 32)
          se[h] = fmaf(s_q[col], __ldg(k_m + col), se[h]);
      }
    }
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      if (h < heads) {
        const float tot = warp_sum(se[h]) + warp_sum(sp[h]);
        if (lane == 0) {
          const float s = tot * inv_sqrt_c;
          s_attn[h * n_total + m] = s;
          s_pos[h * n_total + m] = s;
        }
      }
    }
  }
  __syncthreads();

  // pass 2: the two masked softmaxes, one warp per (head, variant)
  for (int t = warp; t < 2 * heads; t += kWarps) {
    const int h = t % heads;
    if (t < heads) {
      warp_masked_softmax(s_attn + h * n_total, n_total,
                          [&](int m) { return mask[m] > 0.f; }, lane,
                          lse_attn ? lse_attn + (size_t)n * heads + h : nullptr);
    } else {
      warp_masked_softmax(s_pos + h * n_total, n_total,
                          [&](int m) { return mask[m] > 0.f && m != n; }, lane,
                          lse_pos ? lse_pos + (size_t)n * heads + h : nullptr);
    }
  }
  __syncthreads();

  // pass 3: hidden[n, col] = sum_m attn[head(col), m] v[m, col];
  //         ae[n, h, col]  = sum_m pos[h, m] e[n, m, col]
  for (int col = tid; col < d_total; col += kThreads) {
    const int hc = col / c;
    float hsum = 0.f;
    float asum[MAXH];
#pragma unroll
    for (int h = 0; h < MAXH; ++h) asum[h] = 0.f;
    for (int m = 0; m < n_total; ++m) {
      hsum = fmaf(s_attn[hc * n_total + m], __ldg(v2 + (size_t)m * d_total + col), hsum);
      const float ev = load(e_row + (size_t)m * d_total + col);
#pragma unroll
      for (int h = 0; h < MAXH; ++h)
        if (h < heads) asum[h] = fmaf(s_pos[h * n_total + m], ev, asum[h]);
    }
    hid[(size_t)n * d_total + col] = hsum;
#pragma unroll
    for (int h = 0; h < MAXH; ++h)
      if (h < heads) ae[((size_t)n * heads + h) * d_total + col] = asum[h];
  }
}

template <typename E, int MAXH>
int launch(const float* q2, const float* k2, const float* v2, const float* qwp, const void* emb,
           const float* mask, float* hid, float* ae, float* lse_attn, float* lse_pos, int batch,
           int n, int d, int heads, cudaStream_t stream) {
  // shapes whose scores outgrow a block's shared memory are refused here
  const size_t smem = sizeof(float) * ((size_t)d + (size_t)heads * d + 2 * (size_t)heads * n);
  const cudaError_t set = cudaFuncSetAttribute(
      rpe_attention_kernel<E, MAXH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (set != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch is not blamed
    return (int)set;
  }
  rpe_attention_kernel<E, MAXH><<<dim3(n, batch), kThreads, smem, stream>>>(
      q2, k2, v2, qwp, static_cast<const E*>(emb), mask, hid, ae, lse_attn, lse_pos, n, d,
      heads);
  return (int)cudaGetLastError();
}

template <typename E>
int dispatch(const float* q2, const float* k2, const float* v2, const float* qwp,
             const void* emb, const float* mask, float* hid, float* ae, float* lse_attn,
             float* lse_pos, int batch, int n, int d, int heads, cudaStream_t stream) {
  if (heads <= 4)
    return launch<E, 4>(q2, k2, v2, qwp, emb, mask, hid, ae, lse_attn, lse_pos, batch, n, d,
                        heads, stream);
  if (heads <= 8)
    return launch<E, 8>(q2, k2, v2, qwp, emb, mask, hid, ae, lse_attn, lse_pos, batch, n, d,
                        heads, stream);
  return launch<E, kMaxHeads>(q2, k2, v2, qwp, emb, mask, hid, ae, lse_attn, lse_pos, batch, n,
                              d, heads, stream);
}

// ---------------------------------------------------------------------
// Backward.
//
// Replaces roitr_tpu/ops/pallas/rpe_attention_kernel.py `_bwd_kernel`
// (entries `_pallas_backward`, `_bwd`). Given ghid (N, D) and gae (N, H, D),
// with attn / pos the two softmaxes of the forward and c the head width:
//
//   ds[h, n, m] = (attn (ghid_h . v_h[m] - sum_m attn ghid_h . v_h[m])
//                + pos (gae_h . e[n, m] - sum_m pos gae_h . e[n, m])) / sqrt(c)
//   dq[n]       = sum_m ds k[m]             dqwp[n, h] = sum_m ds[h] e[n, m]
//   demb[n, m]  = sum_h pos[h] gae[n, h] + ds[h] qwp[n, h]
//   dk[m]       = sum_n ds[., n, m] q[n]    dv[m] = sum_n attn[., n, m] ghid[n]
//
// What bounds it: bytes. The embedding slab is read once and its gradient
// written once: 2 x 134 MB of bf16 at N = 512, D = 256, 0.080 ms at
// 3.35 TB/s, against 2.7 GFLOP (0.040 ms on the fp32 CUDA cores). On the
// card it ends bound by instruction throughput and latency instead: the
// row kernel takes about 220 registers a thread, one block (8 warps) an
// SM, and its streaming alone runs in less than half its time (PERF.md,
// the variants tool).
//
// Design: one pass over e[n] (FlashAttention-2's backward identity on both
// softmaxes). The forward saved hidden, ae and the log-sum-exp of each
// softmax, so the two row sums of the softmax VJPs are known before any key
// is read: sum_m attn ghid_h . v_h[m] = ghid_h . hidden_h[n] and
// sum_m pos gae_h . e[n, m] = gae_h . ae[n, h]. Every quantity of key m then
// follows from one read of e[n, m]. Four kernels a launch:
//  1. rpe_products: se[n, h, m] = q_h[n] . k_h[m] and dat = ghid_h[n] . v_h[m]
//     for all rows at once ((N, H, N) each, 4 MB at the shape above), so the
//     row kernel does not read k and v once per row (268 MB each from L2).
//  2. rpe_attention_bwd_rows: one block per query row. e[n] streams through
//     a three-stage cp.async ring in shared memory (16-byte copies, 36 KB a
//     stage), with the tile's se, dat and mask. A group of threads takes a
//     key, each thread a few columns (8 at H <= 4), whose qwp and gae stay in
//     registers with the dqwp sums; the group sums its 2H dot products
//     (shuffles, then shared memory across warps when a key spans more than
//     one warp; on the main path, a warp a key and two keys at once, by
//     recursive halving), forms both probabilities from the saved
//     log-sum-exps, ds, its dqwp terms, and writes demb[n, m] in the storage
//     dtype (16-byte stores at H <= 4, bf16). Shared memory does not grow
//     with N. ds and attn go to scratch, (N, N, H).
//  3. rpe_products again: dq = ds @ k, dk = ds^T @ q, dv = attn^T @ ghid per
//     head, tiles of 64 x 32, the rows in kSplitK ranges (768 blocks at the
//     shape above), each summed in order;
//  4. rpe_sum_splits adds the ranges' partial sums in order: deterministic,
//     no atomics.

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kStages = 3;          // ring depth
constexpr int kStageBytes = 36864;  // bytes a ring stage holds (at least one step of keys)
constexpr int kUnroll = 2;          // keys a group takes at once
constexpr int kSplitK = 4;          // ranges of rows the key reduction sums apart
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// C consecutive values of the embedding (C * sizeof(E) bytes, aligned to it)
template <int C>
__device__ __forceinline__ void load_cols(const float* p, float (&v)[C]) {
#pragma unroll
  for (int j = 0; j < C; j += 2) {
    const float2 t = *reinterpret_cast<const float2*>(p + j);
    v[j] = t.x;
    v[j + 1] = t.y;
  }
}
template <int C>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p, float (&v)[C]) {
  uint32_t w[C / 2];
  if constexpr (C == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    w[0] = t.x, w[1] = t.y, w[2] = t.z, w[3] = t.w;
  } else if constexpr (C == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    w[0] = t.x, w[1] = t.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int j = 0; j < C / 2; ++j) {
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}
template <int C>
__device__ __forceinline__ void store_cols(float* p, const float (&v)[C]) {
#pragma unroll
  for (int j = 0; j < C; j += 2) *reinterpret_cast<float2*>(p + j) = make_float2(v[j], v[j + 1]);
}
template <int C>
__device__ __forceinline__ void store_cols(__nv_bfloat16* p, const float (&v)[C]) {
  uint32_t w[C / 2];
#pragma unroll
  for (int j = 0; j < C / 2; ++j) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    w[j] = *reinterpret_cast<const uint32_t*>(&b);
  }
  if constexpr (C == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (C == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  }
}

// Sum v over the g threads of a group (g a power of two, groups aligned):
// shuffles inside a warp, then, for a group of several warps, the warps'
// sums through shared memory in warp order (two buffers, one named barrier
// a call). Every thread of the group gets the same sums.
template <int NV>
__device__ __forceinline__ void group_sum(float (&v)[NV], int g, int grp, float* red,
                                          int& parity) {
  if (g >= 32) {  // the main path's case: five levels, unrolled
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < NV; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
    }
  } else {
    for (int off = g >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < NV; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
    }
  }
  if (g > 32) {
    const int warp = threadIdx.x >> 5;
    float* buf = red + (size_t)parity * kBwdWarps * NV;
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int i = 0; i < NV; ++i) buf[warp * NV + i] = v[i];
    }
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "r"(g) : "memory");
    const int first = grp * (g >> 5);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float s = 0.f;
      for (int w = 0; w < (g >> 5); ++w) s += buf[(first + w) * NV + i];
      v[i] = s;
    }
    parity ^= 1;
  }
}

// Key m's probabilities under both softmaxes and ds, for one head: x is
// the score times sqrt(c); da = ghid_h . v_h[m], dp = gae_h . e[n, m], and
// row_attn / row_pos the softmax VJPs' row sums. Zeros where not kept.
__device__ __forceinline__ void key_head(float se, float sp, float da, float dp, float lse2a,
                                         float lse2p, float row_attn, float row_pos, bool on,
                                         bool on_p, float scale2, float inv_sqrt_c, float& pa,
                                         float& pp, float& ds) {
  const float x = se + sp;
  pa = on ? exp2f(fmaf(x, scale2, -lse2a)) : 0.f;
  pp = on_p ? exp2f(fmaf(x, scale2, -lse2p)) : 0.f;
  ds = on ? (pa * (da - row_attn) + pp * (dp - row_pos)) * inv_sqrt_c : 0.f;
}

// Bytes of one ring stage: kt keys of embedding, then se and dat (kt x
// maxh each, a key's heads side by side) and the mask (kt), fp32.
__host__ __device__ inline int stage_bytes(int kt, int d, int maxh, int esize) {
  return (kt * d * esize + (2 * maxh + 1) * kt * 4 + 15) / 16 * 16;
}

// Start the copies of key tile t of row n into its ring stage: the
// embedding rows in 16-byte pieces, se and dat ((N, H, N) in device memory,
// kt x MAXH in the stage) and the mask. Commits a group even past the last
// tile, so that every thread counts the same.
template <typename E, int MAXH>
__device__ __forceinline__ void copy_tile(int t, int tiles, unsigned char* smem, int sb,
                                          int ebytes, const E* emb, const float* se,
                                          const float* dat, const float* mask, int n,
                                          int n_total, int d_total, int heads, int kt) {
  if (t < tiles) {
    unsigned char* st = smem + (t % kStages) * sb;
    const int m0 = t * kt;
    const int nk = min(kt, n_total - m0);
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(emb + ((size_t)n * n_total + m0) * d_total);
    const int chunks = nk * d_total * (int)sizeof(E) / 16;
    for (int i = threadIdx.x; i < chunks; i += kBwdThreads) cp_async16(st + 16 * i, src + 16 * i);
    float* fs = reinterpret_cast<float*>(st + ebytes);
    for (int i = threadIdx.x; i < heads * nk; i += kBwdThreads) {
      const int h = i / nk, k = i - h * nk;
      const size_t o = ((size_t)n * heads + h) * n_total + m0 + k;
      cp_async4(fs + k * MAXH + h, se + o);
      cp_async4(fs + (kt + k) * MAXH + h, dat + o);
    }
    for (int i = threadIdx.x; i < nk; i += kBwdThreads)
      cp_async4(fs + 2 * MAXH * kt + i, mask + m0 + i);
  }
  cp_async_commit();
}

template <typename E, int MAXH>
__global__ void __launch_bounds__(kBwdThreads)
rpe_attention_bwd_rows(const float* __restrict__ qwp, const E* __restrict__ emb,
                       const float* __restrict__ mask, const float* __restrict__ ghid,
                       const float* __restrict__ gae, const float* __restrict__ hid,
                       const float* __restrict__ ae, const float* __restrict__ lse_attn,
                       const float* __restrict__ lse_pos, const float* __restrict__ se,
                       const float* __restrict__ dat, float* __restrict__ dqwp,
                       E* __restrict__ demb, float* __restrict__ ds_out,
                       float* __restrict__ attn_out, int n_total, int d_total, int heads, int g,
                       int kt) {
  constexpr int C = 32 / MAXH;  // columns a thread: 8 at H <= 4
  constexpr int NV = 2 * MAXH;
  constexpr bool kWarpKeys = MAXH == 4 && kUnroll == 2;  // 16 sums a warp
  extern __shared__ float4 bwd_smem[];  // 16-byte aligned
  unsigned char* smem = reinterpret_cast<unsigned char*>(bwd_smem);
  const int sb = stage_bytes(kt, d_total, MAXH, (int)sizeof(E));
  float* red = reinterpret_cast<float*>(smem + kStages * sb);  // 2 x warps x kUnroll x NV

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int grp = tid / g;
  const int r = tid % g;
  const int kpi = kBwdThreads / g;  // keys a block takes at once, one a group
  const int col0 = r * C;
  const bool active = col0 < d_total;
  const int c = d_total / heads;
  const float inv_sqrt_c = 1.f / sqrtf((float)c);
  int parity = 0;

  // the row's qwp and gae columns stay in registers; dqwp sums beside them
  float wq[MAXH][C], wg[MAXH][C], acc[MAXH][C];
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const bool on = active && h < heads;
      const size_t o = ((size_t)n * heads + h) * d_total + col0 + j;
      wq[h][j] = on ? __ldg(qwp + o) : 0.f;
      wg[h][j] = on ? __ldg(gae + o) : 0.f;
      acc[h][j] = 0.f;
    }
  }
  // The softmax VJPs' row sums, each in the order of the term it is taken
  // from: ghid_h . hidden_h as rpe_products forms dat (one fmaf chain over
  // the head's columns), gae_h . ae_h as the key loop forms gae_h . e (a
  // thread's columns, then the group's sum). A row with one kept key then
  // gets ds = 0 exactly, as the two-pass sums give it.
  __shared__ float s_row_attn[MAXH];
  if (tid < heads) {
    float a = 0.f;
#pragma unroll 16
    for (int cc = 0; cc < c; ++cc) {
      const size_t o = (size_t)n * d_total + tid * c + cc;
      a = fmaf(__ldg(ghid + o), __ldg(hid + o), a);
    }
    s_row_attn[tid] = a;  // read after the first barrier of the key loop
  }
  float rs[MAXH];
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    rs[h] = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (active && h < heads) {
        const float a = __ldg(ae + ((size_t)n * heads + h) * d_total + col0 + j);
        rs[h] = fmaf(wg[h][j], a, rs[h]);
      }
    }
  }
  group_sum(rs, g, grp, red, parity);
  float lse2a[MAXH], lse2p[MAXH];  // log-sum-exps in base 2
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    lse2a[h] = h < heads ? __ldg(lse_attn + (size_t)n * heads + h) * kLog2e : 0.f;
    lse2p[h] = h < heads ? __ldg(lse_pos + (size_t)n * heads + h) * kLog2e : 0.f;
  }
  const float scale2 = inv_sqrt_c * kLog2e;

  const int tiles = (n_total + kt - 1) / kt;
  const int ebytes = kt * d_total * (int)sizeof(E);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s)
    copy_tile<E, MAXH>(s, tiles, smem, sb, ebytes, emb, se, dat, mask, n, n_total, d_total, heads,
                       kt);

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t landed for all; tile t - 1's stage is free again
    copy_tile<E, MAXH>(t + kStages - 1, tiles, smem, sb, ebytes, emb, se, dat, mask, n, n_total,
                       d_total, heads, kt);
    const unsigned char* st = smem + (t % kStages) * sb;
    const E* es = reinterpret_cast<const E*>(st);
    const float* fs = reinterpret_cast<const float*>(st + ebytes);
    const int m0 = t * kt;
    // every group runs the same count of steps (kt is a multiple of kpi x kUnroll)
    for (int kb = grp; kb < kt; kb += kpi * kUnroll) {
      float ev[kUnroll][C];
      float v[kUnroll * NV];
      bool valid[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int kk = kb + u * kpi;
        valid[u] = m0 + kk < n_total;
        if (valid[u] && active) {
          load_cols(es + (size_t)kk * d_total + col0, ev[u]);
        } else {
#pragma unroll
          for (int j = 0; j < C; ++j) ev[u][j] = 0.f;
        }
#pragma unroll
        for (int h = 0; h < MAXH; ++h) {
          float sp = 0.f, dp = 0.f;
#pragma unroll
          for (int j = 0; j < C; ++j) {
            sp = fmaf(wq[h][j], ev[u][j], sp);
            dp = fmaf(wg[h][j], ev[u][j], dp);
          }
          v[u * NV + h] = sp;
          v[u * NV + MAXH + h] = dp;
        }
      }
      // per key and head: the two probabilities and ds
      float dsv[kUnroll][MAXH], ppv[kUnroll][MAXH];
      if (kWarpKeys && g == 32) {
        // the main path (H <= 4, a warp a key, two keys): the 16 sums by
        // recursive halving, each lane left with one (16 shuffles, not 80);
        // lanes (u, kind, h) = (bit 4, bit 3, bits 2-1) take key u's head h,
        // then every lane gets every ds and pos probability (16 more). The
        // sums pair lanes in the butterfly's order, so each equals
        // group_sum's bit for bit (and gae . ae's, which the row sum took).
        const int lane = tid & 31;
        const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
        float w8[8], w4[4], w2[2];
        constexpr unsigned kAll = 0xffffffffu;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          w8[i] = (b4 ? v[i + 8] : v[i]) + __shfl_xor_sync(kAll, b4 ? v[i] : v[i + 8], 16);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w4[i] = (b3 ? w8[i + 4] : w8[i]) + __shfl_xor_sync(kAll, b3 ? w8[i] : w8[i + 4], 8);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          w2[i] = (b2 ? w4[i + 2] : w4[i]) + __shfl_xor_sync(kAll, b2 ? w4[i] : w4[i + 2], 4);
        float w1 = (b1 ? w2[1] : w2[0]) + __shfl_xor_sync(kAll, b1 ? w2[0] : w2[1], 2);
        w1 += __shfl_xor_sync(kAll, w1, 1);
        const float other = __shfl_xor_sync(kAll, w1, 8);
        const int u = lane >> 4, h = (lane >> 1) & 3;
        const int kk = kb + u * kpi;
        const int m = m0 + kk;
        const bool valid_h = m < n_total && h < heads;
        const bool on = valid_h && fs[2 * MAXH * kt + kk] > 0.f;
        float la = lse2a[0], lp = lse2p[0], rp = rs[0];
#pragma unroll
        for (int q = 1; q < MAXH; ++q) {
          la = h == q ? lse2a[q] : la;
          lp = h == q ? lse2p[q] : lp;
          rp = h == q ? rs[q] : rp;
        }
        float pa, pp, ds;
        key_head(fs[kk * MAXH + h], b3 ? other : w1, fs[(kt + kk) * MAXH + h], b3 ? w1 : other,
                 la, lp, s_row_attn[h], rp, on, on && m != n, scale2, inv_sqrt_c, pa, pp, ds);
        if (valid_h && !b3 && !(lane & 1)) {
          const size_t o = ((size_t)n * n_total + m) * heads + h;
          ds_out[o] = ds;
          attn_out[o] = pa;
        }
#pragma unroll
        for (int uu = 0; uu < kUnroll; ++uu) {
#pragma unroll
          for (int hh = 0; hh < MAXH; ++hh) {
            dsv[uu][hh] = __shfl_sync(kAll, ds, uu * 16 + hh * 2);
            ppv[uu][hh] = __shfl_sync(kAll, pp, uu * 16 + hh * 2);
          }
        }
      } else {
        group_sum(v, g, grp, red, parity);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int kk = kb + u * kpi;
          const int m = m0 + kk;
          const bool keep = valid[u] && fs[2 * MAXH * kt + kk] > 0.f;
          float pa[MAXH];
#pragma unroll
          for (int h = 0; h < MAXH; ++h) {  // records past H hold no value: selected away
            const bool on = keep && h < heads;
            key_head(fs[kk * MAXH + h], v[u * NV + h], fs[(kt + kk) * MAXH + h],
                     v[u * NV + MAXH + h], lse2a[h], lse2p[h], s_row_attn[h], rs[h], on,
                     on && m != n, scale2, inv_sqrt_c, pa[h], ppv[u][h], dsv[u][h]);
          }
          // ds and attn to the (N, N, H) scratch: a thread a head, side by side
          for (int hh = r; valid[u] && hh < heads; hh += g) {
            float a = 0.f, b = 0.f;
#pragma unroll
            for (int h = 0; h < MAXH; ++h) {
              a = h == hh ? dsv[u][h] : a;
              b = h == hh ? pa[h] : b;
            }
            const size_t o = ((size_t)n * n_total + m) * heads + hh;
            ds_out[o] = a;
            attn_out[o] = b;
          }
        }
      }
      // dqwp sums and demb[n, m]
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float de[C];
#pragma unroll
        for (int j = 0; j < C; ++j) de[j] = 0.f;
#pragma unroll
        for (int h = 0; h < MAXH; ++h) {
#pragma unroll
          for (int j = 0; j < C; ++j) {
            acc[h][j] = fmaf(dsv[u][h], ev[u][j], acc[h][j]);
            de[j] = fmaf(ppv[u][h], wg[h][j], fmaf(dsv[u][h], wq[h][j], de[j]));
          }
        }
        if (valid[u] && active)
          store_cols(demb + ((size_t)n * n_total + m0 + kb + u * kpi) * d_total + col0, de);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // dqwp: the groups' sums added in group order through shared memory
  float* buf = reinterpret_cast<float*>(smem);  // kpi x H x D
  if (active) {
#pragma unroll
    for (int h = 0; h < MAXH; ++h)
      if (h < heads)
#pragma unroll
        for (int j = 0; j < C; ++j)
          buf[((size_t)grp * heads + h) * d_total + col0 + j] = acc[h][j];
  }
  __syncthreads();
  for (int i = tid; i < heads * d_total; i += kBwdThreads) {
    float s = 0.f;
    for (int q = 0; q < kpi; ++q) s += buf[(size_t)q * heads * d_total + i];
    dqwp[(size_t)n * heads * d_total + i] = s;
  }
}

// One strided fp32 product a launch computes for each of `batch` heads:
// c[b][i][j] = sum_k a[b][i][k] b[b][k][j], strides in elements.
struct Product {
  const float* a;
  const float* b;
  float* c;
  long long a_b, a_i, a_k, b_b, b_k, b_j, c_b, c_i, c_j;
};
struct Products {
  Product p[3];
  float* part[3];  // with splits > 1: each product's partial sums, splits x (its c)
  long long part_stride;
  int m, n, k, batch, splits;
};

// A TI x TJ tile of c a block, k in steps of 16 through shared memory, each
// thread (TI / 16) x (TJ / 16) of it (its rows side by side, read as one
// vector; its columns 16 apart, so that a warp's stores are contiguous),
// summed in order of k: deterministic, no atomics.
// With splits > 1, a block takes one of `splits` consecutive ranges of k and
// writes its partial sums; rpe_sum_splits adds them in range order.
template <int TI, int TJ>
__global__ void __launch_bounds__(256) rpe_products(Products ps) {
  constexpr int KS = 16, RI = TI / 16, RJ = TJ / 16;
  __shared__ __align__(16) float as[KS][TI + 4];
  __shared__ __align__(16) float bs[KS][TJ + 4];
  const int split = blockIdx.z % ps.splits;
  const int pb = blockIdx.z / ps.splits;
  const Product& P = ps.p[pb / ps.batch];
  const int bi = pb % ps.batch;
  const float* a = P.a + bi * P.a_b;
  const float* b = P.b + bi * P.b_b;
  float* c = (ps.splits > 1 ? ps.part[pb / ps.batch] + split * ps.part_stride : P.c) + bi * P.c_b;
  const int kc = (ps.k + ps.splits * KS - 1) / (ps.splits * KS) * KS;  // k a split
  const int k_begin = split * kc, k_end = min(ps.k, k_begin + kc);
  const int i0 = blockIdx.y * TI, j0 = blockIdx.x * TJ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[RI][RJ];
#pragma unroll
  for (int u = 0; u < RI; ++u)
#pragma unroll
    for (int w = 0; w < RJ; ++w) acc[u][w] = 0.f;
  // the next k-step's tiles are loaded into registers while this one's
  // products run; the axis of the smaller stride of each operand is the
  // fastest
  constexpr int LA = TI * KS / 256, LB = TJ * KS / 256;
  const bool a_rows = P.a_i < P.a_k, b_cols = P.b_j < P.b_k;
  float ra[LA], rb[LB];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int q = 0; q < LA; ++q) {
      const int e = threadIdx.x + 256 * q;
      const int i = a_rows ? e % TI : e / KS, kk = a_rows ? e / TI : e % KS;
      ra[q] = i0 + i < ps.m && k0 + kk < k_end
                  ? __ldg(a + (i0 + i) * P.a_i + (k0 + kk) * P.a_k) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < LB; ++q) {
      const int e = threadIdx.x + 256 * q;
      const int j = b_cols ? e % TJ : e / KS, kk = b_cols ? e / TJ : e % KS;
      rb[q] = j0 + j < ps.n && k0 + kk < k_end
                  ? __ldg(b + (k0 + kk) * P.b_k + (j0 + j) * P.b_j) : 0.f;
    }
  };
  fetch(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += KS) {
#pragma unroll
    for (int q = 0; q < LA; ++q) {
      const int e = threadIdx.x + 256 * q;
      as[a_rows ? e / TI : e % KS][a_rows ? e % TI : e / KS] = ra[q];
    }
#pragma unroll
    for (int q = 0; q < LB; ++q) {
      const int e = threadIdx.x + 256 * q;
      bs[b_cols ? e / TJ : e % KS][b_cols ? e % TJ : e / KS] = rb[q];
    }
    __syncthreads();
    if (k0 + KS < k_end) fetch(k0 + KS);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      float ar[RI], br[RJ];
#pragma unroll
      for (int u = 0; u < RI; ++u) ar[u] = as[kk][ty * RI + u];  // one vector load
#pragma unroll
      for (int w = 0; w < RJ; ++w) br[w] = bs[kk][tx + 16 * w];
#pragma unroll
      for (int u = 0; u < RI; ++u)
#pragma unroll
        for (int w = 0; w < RJ; ++w) acc[u][w] = fmaf(ar[u], br[w], acc[u][w]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < RI; ++u) {
    const int i = i0 + ty * RI + u;
#pragma unroll
    for (int w = 0; w < RJ; ++w) {
      const int j = j0 + tx + 16 * w;
      if (i < ps.m && j < ps.n) c[i * P.c_i + j * P.c_j] = acc[u][w];
    }
  }
}

// out[p][e] = sum over s of part[p][s * elems + e], s in order
struct SplitSums {
  const float* part[3];
  float* out[3];
};
__global__ void __launch_bounds__(256)
rpe_sum_splits(SplitSums ss, int splits, long long elems) {
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  if (e >= elems) return;
  const float* part = ss.part[blockIdx.y];
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[k * elems + e];
  ss.out[blockIdx.y][e] = s;
}

template <int TI, int TJ>
cudaError_t launch_products(const Products& ps, int count, cudaStream_t stream) {
  const dim3 grid((ps.n + TJ - 1) / TJ, (ps.m + TI - 1) / TI, count * ps.batch * ps.splits);
  rpe_products<TI, TJ><<<grid, 256, 0, stream>>>(ps);
  return cudaGetLastError();
}

// Threads a group gives one key: D / C rounded up to a power of two.
template <int MAXH>
int group_threads(int d) {
  const int need = (d + 32 / MAXH - 1) / (32 / MAXH);
  int g = 1;
  while (g < need) g <<= 1;
  return g;
}

// The row kernel's layout at width d: threads a key (g), keys a tile (kt)
// and dynamic shared memory (the ring and the group sums' buffers, or the
// dqwp reduction, whichever is larger). Returns false if a key would need
// more threads than a block has.
template <typename E, int MAXH>
bool bwd_layout(int d, int heads, int* g, int* kt, size_t* smem) {
  *g = group_threads<MAXH>(d);
  if (*g > kBwdThreads) return false;
  const int step = kBwdThreads / *g * kUnroll;
  const int esize = (int)sizeof(E);
  *kt = max(step, kStageBytes / (d * esize + (2 * MAXH + 1) * 4) / step * step);
  const size_t ring = (size_t)kStages * stage_bytes(*kt, d, MAXH, esize) +
                      sizeof(float) * 2 * kBwdWarps * kUnroll * 2 * MAXH;
  const size_t epilogue = sizeof(float) * (size_t)(kBwdThreads / *g) * heads * d;
  *smem = ring > epilogue ? ring : epilogue;
  return true;
}

template <typename E, int MAXH>
int launch_bwd(const float* q2, const float* k2, const float* v2, const float* qwp,
               const void* emb, const float* mask, const float* ghid, const float* gae,
               const float* hid, const float* ae, const float* lse_attn, const float* lse_pos,
               float* dq, float* dk, float* dv, float* dqwp, void* demb, float* scratch, int n,
               int d, int heads, cudaStream_t stream) {
  int g, kt;
  size_t smem;
  if (!bwd_layout<E, MAXH>(d, heads, &g, &kt, &smem)) return (int)cudaErrorInvalidValue;
  const size_t nhn = (size_t)n * heads * n;
  float* se = scratch;
  float* dat = se + nhn;
  float* ds = dat + nhn;
  float* attn = ds + nhn;
  const long long D = d, c = d / heads, H = heads, HN = H * n;

  // 1. se = q_h . k_h and dat = ghid_h . v_h, (N, H, N): a warp's stores
  // are contiguous
  Products pre{};
  pre.p[0] = {q2, k2, se, c, D, 1, c, 1, D, n, HN, 1};
  pre.p[1] = {ghid, v2, dat, c, D, 1, c, 1, D, n, HN, 1};
  pre.m = n, pre.n = n, pre.k = (int)c, pre.batch = heads, pre.splits = 1;
  cudaError_t err = launch_products<64, 64>(pre, 2, stream);
  if (err != cudaSuccess) return (int)err;

  // 2. the rows: one pass over e[n]
  err = cudaFuncSetAttribute(rpe_attention_bwd_rows<E, MAXH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch is not blamed
    return (int)err;
  }
  rpe_attention_bwd_rows<E, MAXH><<<n, kBwdThreads, smem, stream>>>(
      qwp, static_cast<const E*>(emb), mask, ghid, gae, hid, ae, lse_attn, lse_pos, se, dat,
      dqwp, static_cast<E*>(demb), ds, attn, n, d, heads, g, kt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // 3. dq = ds @ k, dk = ds^T @ q, dv = attn^T @ ghid, per head, the rows
  // (k) in kSplitK ranges, then their partial sums added in order
  Products post{};
  post.p[0] = {ds, k2, dq, 1, HN, H, c, D, 1, c, D, 1};
  post.p[1] = {ds, q2, dk, 1, H, HN, c, D, 1, c, D, 1};
  post.p[2] = {attn, ghid, dv, 1, H, HN, c, D, 1, c, D, 1};
  post.m = n, post.n = (int)c, post.k = n, post.batch = heads, post.splits = kSplitK;
  const long long nd = (long long)n * d;
  post.part_stride = nd;
  SplitSums sums{};
  for (int p = 0; p < 3; ++p) {
    post.part[p] = attn + nhn + p * kSplitK * nd;
    sums.part[p] = post.part[p];
  }
  sums.out[0] = dq, sums.out[1] = dk, sums.out[2] = dv;
  err = launch_products<64, 32>(post, 3, stream);
  if (err != cudaSuccess) return (int)err;
  rpe_sum_splits<<<dim3((unsigned)((nd + 255) / 256), 3), 256, 0, stream>>>(sums, kSplitK, nd);
  return (int)cudaGetLastError();
}

template <typename E>
int dispatch_bwd(const float* q2, const float* k2, const float* v2, const float* qwp,
                 const void* emb, const float* mask, const float* ghid, const float* gae,
                 const float* hid, const float* ae, const float* lse_attn, const float* lse_pos,
                 float* dq, float* dk, float* dv, float* dqwp, void* demb, float* scratch, int n,
                 int d, int heads, cudaStream_t stream) {
  if (heads <= 4)
    return launch_bwd<E, 4>(q2, k2, v2, qwp, emb, mask, ghid, gae, hid, ae, lse_attn, lse_pos,
                            dq, dk, dv, dqwp, demb, scratch, n, d, heads, stream);
  if (heads <= 8)
    return launch_bwd<E, 8>(q2, k2, v2, qwp, emb, mask, ghid, gae, hid, ae, lse_attn, lse_pos,
                            dq, dk, dv, dqwp, demb, scratch, n, d, heads, stream);
  return launch_bwd<E, kMaxHeads>(q2, k2, v2, qwp, emb, mask, ghid, gae, hid, ae, lse_attn,
                                  lse_pos, dq, dk, dv, dqwp, demb, scratch, n, d, heads, stream);
}

}  // namespace

// Dynamic shared memory of the backward's row kernel a block (0 for a width
// or head count it does not take); it does not depend on N.
extern "C" long long roitr_rpe_attention_bwd_smem_bytes(int d, int heads, int emb_bf16) {
  int g, kt;
  size_t smem = 0;
  if (heads < 1 || heads > kMaxHeads || d < 8) return 0;
  const bool ok =
      heads <= 4 ? (emb_bf16 ? bwd_layout<__nv_bfloat16, 4>(d, heads, &g, &kt, &smem)
                             : bwd_layout<float, 4>(d, heads, &g, &kt, &smem))
      : heads <= 8 ? (emb_bf16 ? bwd_layout<__nv_bfloat16, 8>(d, heads, &g, &kt, &smem)
                               : bwd_layout<float, 8>(d, heads, &g, &kt, &smem))
                   : (emb_bf16 ? bwd_layout<__nv_bfloat16, kMaxHeads>(d, heads, &g, &kt, &smem)
                               : bwd_layout<float, kMaxHeads>(d, heads, &g, &kt, &smem));
  return ok ? (long long)smem : 0;
}

// Floats of the scratch that roitr_rpe_attention_bwd takes: se and dat,
// (N, H, N) each, ds and attn, (N, N, H) each, then the key reduction's
// partial sums of dq, dk and dv, kSplitK x (N, D) each.
extern "C" long long roitr_rpe_attention_bwd_scratch_floats(int n, int d, int heads) {
  return 4LL * n * heads * n + 3LL * kSplitK * n * d;
}

// cudaErrorInvalidValue for a shape the backward does not take (rows of
// 16-byte multiples, at most 16 heads, each of the same width), else 0
extern "C" int roitr_rpe_attention_bwd_takes(int n, int d, int heads) {
  if (heads < 1 || heads > kMaxHeads || d % heads || d % 8 || n < 1)
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

extern "C" int roitr_rpe_attention_bwd(const float* q2, const float* k2, const float* v2,
                                       const float* qwp, const void* emb, const float* mask,
                                       const float* ghid, const float* gae, const float* hid,
                                       const float* ae, const float* lse_attn,
                                       const float* lse_pos, float* dq, float* dk, float* dv,
                                       float* dqwp, void* demb, float* scratch, int n, int d,
                                       int heads, int emb_bf16, void* stream) {
  if (roitr_rpe_attention_bwd_takes(n, d, heads) || reinterpret_cast<uintptr_t>(emb) % 16 ||
      reinterpret_cast<uintptr_t>(demb) % 16)
    return (int)cudaErrorInvalidValue;
  return emb_bf16
             ? dispatch_bwd<__nv_bfloat16>(q2, k2, v2, qwp, emb, mask, ghid, gae, hid, ae,
                                           lse_attn, lse_pos, dq, dk, dv, dqwp, demb, scratch, n,
                                           d, heads, (cudaStream_t)stream)
             : dispatch_bwd<float>(q2, k2, v2, qwp, emb, mask, ghid, gae, hid, ae, lse_attn,
                                   lse_pos, dq, dk, dv, dqwp, demb, scratch, n, d, heads,
                                   (cudaStream_t)stream);
}

// batch pairs of n nodes each, one launch (gridDim.y = batch, at most 65535)
extern "C" int roitr_rpe_attention(const float* q2, const float* k2, const float* v2,
                                   const float* qwp, const void* emb, const float* mask,
                                   float* hid, float* ae, float* lse_attn, float* lse_pos,
                                   int batch, int n, int d, int heads, int emb_bf16,
                                   void* stream) {
  if (heads < 1 || heads > kMaxHeads || d % heads || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  return emb_bf16 ? dispatch<__nv_bfloat16>(q2, k2, v2, qwp, emb, mask, hid, ae, lse_attn,
                                            lse_pos, batch, n, d, heads, (cudaStream_t)stream)
                  : dispatch<float>(q2, k2, v2, qwp, emb, mask, hid, ae, lse_attn, lse_pos,
                                    batch, n, d, heads, (cudaStream_t)stream);
}
