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
// e[n] a second time for the positional aggregation (mostly from L2, which
// the first pass just filled) and reads v for the hidden state. All sums
// are fp32; the embedding arrives in its storage dtype (bf16 or fp32).
// The per-thread head arrays are sized by a compile-time bound on the head
// count (4, 8 or 16, the smallest that holds H), so the main path's H = 4
// keeps registers low and several blocks share an SM. Reading e[n] once
// instead of twice (an online softmax) is later work.

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
template <typename Keep>
__device__ void warp_masked_softmax(float* row, int n, Keep keep, int lane) {
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
  const float inv = sum == 0.f ? 1.f : sum;
  for (int m = lane; m < n; m += 32) row[m] = row[m] / inv;
}

template <typename E, int MAXH>
__global__ void __launch_bounds__(kThreads)
rpe_attention_kernel(const float* __restrict__ q2, const float* __restrict__ k2,
                     const float* __restrict__ v2, const float* __restrict__ qwp,
                     const E* __restrict__ emb, const float* __restrict__ mask,
                     float* __restrict__ hid, float* __restrict__ ae, int n_total,
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
                          [&](int m) { return mask[m] > 0.f; }, lane);
    } else {
      warp_masked_softmax(s_pos + h * n_total, n_total,
                          [&](int m) { return mask[m] > 0.f && m != n; }, lane);
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
           const float* mask, float* hid, float* ae, int n, int d, int heads,
           cudaStream_t stream) {
  // shapes whose scores outgrow a block's shared memory are refused here
  const size_t smem = sizeof(float) * ((size_t)d + (size_t)heads * d + 2 * (size_t)heads * n);
  const cudaError_t set = cudaFuncSetAttribute(
      rpe_attention_kernel<E, MAXH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (set != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch is not blamed
    return (int)set;
  }
  rpe_attention_kernel<E, MAXH><<<n, kThreads, smem, stream>>>(
      q2, k2, v2, qwp, static_cast<const E*>(emb), mask, hid, ae, n, d, heads);
  return (int)cudaGetLastError();
}

template <typename E>
int dispatch(const float* q2, const float* k2, const float* v2, const float* qwp,
             const void* emb, const float* mask, float* hid, float* ae, int n, int d, int heads,
             cudaStream_t stream) {
  if (heads <= 4) return launch<E, 4>(q2, k2, v2, qwp, emb, mask, hid, ae, n, d, heads, stream);
  if (heads <= 8) return launch<E, 8>(q2, k2, v2, qwp, emb, mask, hid, ae, n, d, heads, stream);
  return launch<E, kMaxHeads>(q2, k2, v2, qwp, emb, mask, hid, ae, n, d, heads, stream);
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
// What bounds it: bytes. The embedding slab is read and its cotangent
// written: 3 x 134 MB of bf16 at N = 512, D = 256, against 2.7 GFLOP.
// Design, two kernels. The TPU kernel sums dk/dv over its sequential grid
// in a revisited block; Hopper blocks run in no order, so the first kernel
// (one block per query row, the forward's layout) writes its row of ds and
// attn (H x N each) to a scratch, and the second (one block per 8 keys)
// reduces dk/dv over the rows in a fixed order: deterministic, no atomics.
// Row kernel: pass 1 reads e[n] once for both dot products with it (the
// positional scores and gae . e), pass 2 forms both softmaxes and ds in
// shared memory, pass 3 reads e[n] again (mostly from L2) for dqwp and
// writes demb[n] in the storage dtype.

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename E, int MAXH>
__global__ void __launch_bounds__(kThreads)
rpe_attention_bwd_rows(const float* __restrict__ q2, const float* __restrict__ k2,
                       const float* __restrict__ v2, const float* __restrict__ qwp,
                       const E* __restrict__ emb, const float* __restrict__ mask,
                       const float* __restrict__ ghid, const float* __restrict__ gae,
                       float* __restrict__ dq, float* __restrict__ dqwp, E* __restrict__ demb,
                       float* __restrict__ ds_out, float* __restrict__ attn_out, int n_total,
                       int d_total, int heads) {
  extern __shared__ float smem[];
  const int c = d_total / heads;
  float* s_q = smem;                           // D
  float* s_qwp = s_q + d_total;                // H x D
  float* s_ghid = s_qwp + heads * d_total;     // D
  float* s_gae = s_ghid + d_total;             // H x D
  float* s_attn = s_gae + heads * d_total;     // H x N: scores, then the value softmax
  float* s_pos = s_attn + heads * n_total;     // H x N: scores, then the positional softmax
  float* s_dat = s_pos + heads * n_total;      // H x N: ghid_h . v_h[m], then ds
  float* s_dap = s_dat + heads * n_total;      // H x N: gae_h . e[n, m]

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const E* e_row = emb + (size_t)n * n_total * d_total;

  for (int i = tid; i < d_total; i += kThreads) {
    s_q[i] = q2[(size_t)n * d_total + i];
    s_ghid[i] = ghid[(size_t)n * d_total + i];
  }
  for (int i = tid; i < heads * d_total; i += kThreads) {
    s_qwp[i] = qwp[(size_t)n * heads * d_total + i];
    s_gae[i] = gae[(size_t)n * heads * d_total + i];
  }
  __syncthreads();

  // pass 1: one warp per key m; e[n, m] is read once for sp and dap
  const float inv_sqrt_c = 1.f / sqrtf((float)c);
  for (int m = warp; m < n_total; m += kWarps) {
    float sp[MAXH], dap[MAXH], se[MAXH], dat[MAXH];
#pragma unroll
    for (int h = 0; h < MAXH; ++h) sp[h] = dap[h] = se[h] = dat[h] = 0.f;
    const E* e_m = e_row + (size_t)m * d_total;
    for (int col = lane; col < d_total; col += 32) {
      const float ev = load(e_m + col);
#pragma unroll
      for (int h = 0; h < MAXH; ++h) {
        if (h < heads) {
          sp[h] = fmaf(s_qwp[h * d_total + col], ev, sp[h]);
          dap[h] = fmaf(s_gae[h * d_total + col], ev, dap[h]);
        }
      }
    }
    const float* k_m = k2 + (size_t)m * d_total;
    const float* v_m = v2 + (size_t)m * d_total;
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      if (h < heads) {
        for (int col = h * c + lane; col < (h + 1) * c; col += 32) {
          se[h] = fmaf(s_q[col], __ldg(k_m + col), se[h]);
          dat[h] = fmaf(s_ghid[col], __ldg(v_m + col), dat[h]);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      if (h < heads) {
        const float tot = warp_sum(se[h]) + warp_sum(sp[h]);
        const float a = warp_sum(dat[h]);
        const float b = warp_sum(dap[h]);
        if (lane == 0) {
          s_attn[h * n_total + m] = tot * inv_sqrt_c;
          s_pos[h * n_total + m] = tot * inv_sqrt_c;
          s_dat[h * n_total + m] = a;
          s_dap[h * n_total + m] = b;
        }
      }
    }
  }
  __syncthreads();

  // pass 2a: the two masked softmaxes, one warp per (head, variant)
  for (int t = warp; t < 2 * heads; t += kWarps) {
    const int h = t % heads;
    if (t < heads) {
      warp_masked_softmax(s_attn + h * n_total, n_total,
                          [&](int m) { return mask[m] > 0.f; }, lane);
    } else {
      warp_masked_softmax(s_pos + h * n_total, n_total,
                          [&](int m) { return mask[m] > 0.f && m != n; }, lane);
    }
  }
  __syncthreads();

  // pass 2b: both softmax VJPs into ds (over s_dat), one warp per head;
  // ds and attn also go to the scratch that the key kernel reduces
  for (int h = warp; h < heads; h += kWarps) {
    const float* at = s_attn + h * n_total;
    const float* ps = s_pos + h * n_total;
    float* dd = s_dat + h * n_total;
    const float* dp = s_dap + h * n_total;
    float s1 = 0.f, s2 = 0.f;
    for (int m = lane; m < n_total; m += 32) {
      s1 += at[m] * dd[m];
      s2 += ps[m] * dp[m];
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    const size_t o = ((size_t)n * heads + h) * n_total;
    for (int m = lane; m < n_total; m += 32) {
      const float v = (at[m] * (dd[m] - s1) + ps[m] * (dp[m] - s2)) * inv_sqrt_c;
      dd[m] = v;
      ds_out[o + m] = v;
      attn_out[o + m] = at[m];
    }
  }
  __syncthreads();

  // pass 3: a thread per column; e[n] streamed again, demb[n] written once
  for (int col = tid; col < d_total; col += kThreads) {
    const int hc = col / c;
    float qacc = 0.f;
    float pacc[MAXH], gcol[MAXH], wcol[MAXH];
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      pacc[h] = 0.f;
      gcol[h] = h < heads ? s_gae[h * d_total + col] : 0.f;
      wcol[h] = h < heads ? s_qwp[h * d_total + col] : 0.f;
    }
    E* demb_row = demb + (size_t)n * n_total * d_total;
    for (int m = 0; m < n_total; ++m) {
      const float ev = load(e_row + (size_t)m * d_total + col);
      qacc = fmaf(s_dat[hc * n_total + m], __ldg(k2 + (size_t)m * d_total + col), qacc);
      float from_pos = 0.f, from_ds = 0.f;
#pragma unroll
      for (int h = 0; h < MAXH; ++h) {
        if (h < heads) {
          const float dsv = s_dat[h * n_total + m];
          pacc[h] = fmaf(dsv, ev, pacc[h]);
          from_pos = fmaf(s_pos[h * n_total + m], gcol[h], from_pos);
          from_ds = fmaf(dsv, wcol[h], from_ds);
        }
      }
      store(demb_row + (size_t)m * d_total + col, from_pos + from_ds);
    }
    dq[(size_t)n * d_total + col] = qacc;
#pragma unroll
    for (int h = 0; h < MAXH; ++h)
      if (h < heads) dqwp[((size_t)n * heads + h) * d_total + col] = pacc[h];
  }
}

constexpr int kKeys = 8;  // keys a block of the dk/dv reduction

// dk[m, col] = sum_n ds[head(col), n, m] q[n, col]; dv likewise with attn
// and ghid. A thread per column and kKeys keys; rows n in order.
__global__ void __launch_bounds__(kThreads)
rpe_attention_bwd_keys(const float* __restrict__ q2, const float* __restrict__ ghid,
                       const float* __restrict__ ds, const float* __restrict__ attn,
                       float* __restrict__ dk, float* __restrict__ dv, int n_total, int d_total,
                       int heads) {
  const int c = d_total / heads;
  const int m0 = blockIdx.x * kKeys;
  const int nk = min(kKeys, n_total - m0);
  for (int col = threadIdx.x; col < d_total; col += kThreads) {
    const int h = col / c;
    float ak[kKeys], av[kKeys];
#pragma unroll
    for (int kk = 0; kk < kKeys; ++kk) ak[kk] = av[kk] = 0.f;
    for (int r = 0; r < n_total; ++r) {
      const float qv = __ldg(q2 + (size_t)r * d_total + col);
      const float gv = __ldg(ghid + (size_t)r * d_total + col);
      const size_t o = ((size_t)r * heads + h) * n_total + m0;
#pragma unroll
      for (int kk = 0; kk < kKeys; ++kk) {
        if (kk < nk) {
          ak[kk] = fmaf(__ldg(ds + o + kk), qv, ak[kk]);
          av[kk] = fmaf(__ldg(attn + o + kk), gv, av[kk]);
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < kKeys; ++kk) {
      if (kk < nk) {
        dk[(size_t)(m0 + kk) * d_total + col] = ak[kk];
        dv[(size_t)(m0 + kk) * d_total + col] = av[kk];
      }
    }
  }
}

template <typename E, int MAXH>
int launch_bwd(const float* q2, const float* k2, const float* v2, const float* qwp,
               const void* emb, const float* mask, const float* ghid, const float* gae,
               float* dq, float* dk, float* dv, float* dqwp, void* demb, float* ds_scratch,
               float* attn_scratch, int n, int d, int heads, cudaStream_t stream) {
  // shapes whose rows outgrow a block's shared memory are refused here
  const size_t smem =
      sizeof(float) * (2 * (size_t)d + 2 * (size_t)heads * d + 4 * (size_t)heads * n);
  const cudaError_t set = cudaFuncSetAttribute(
      rpe_attention_bwd_rows<E, MAXH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (set != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch is not blamed
    return (int)set;
  }
  rpe_attention_bwd_rows<E, MAXH><<<n, kThreads, smem, stream>>>(
      q2, k2, v2, qwp, static_cast<const E*>(emb), mask, ghid, gae, dq, dqwp,
      static_cast<E*>(demb), ds_scratch, attn_scratch, n, d, heads);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rpe_attention_bwd_keys<<<(n + kKeys - 1) / kKeys, kThreads, 0, stream>>>(
      q2, ghid, ds_scratch, attn_scratch, dk, dv, n, d, heads);
  return (int)cudaGetLastError();
}

template <typename E>
int dispatch_bwd(const float* q2, const float* k2, const float* v2, const float* qwp,
                 const void* emb, const float* mask, const float* ghid, const float* gae,
                 float* dq, float* dk, float* dv, float* dqwp, void* demb, float* ds_scratch,
                 float* attn_scratch, int n, int d, int heads, cudaStream_t stream) {
  if (heads <= 4)
    return launch_bwd<E, 4>(q2, k2, v2, qwp, emb, mask, ghid, gae, dq, dk, dv, dqwp, demb,
                            ds_scratch, attn_scratch, n, d, heads, stream);
  if (heads <= 8)
    return launch_bwd<E, 8>(q2, k2, v2, qwp, emb, mask, ghid, gae, dq, dk, dv, dqwp, demb,
                            ds_scratch, attn_scratch, n, d, heads, stream);
  return launch_bwd<E, kMaxHeads>(q2, k2, v2, qwp, emb, mask, ghid, gae, dq, dk, dv, dqwp, demb,
                                  ds_scratch, attn_scratch, n, d, heads, stream);
}

}  // namespace

extern "C" int roitr_rpe_attention_bwd(const float* q2, const float* k2, const float* v2,
                                       const float* qwp, const void* emb, const float* mask,
                                       const float* ghid, const float* gae, float* dq, float* dk,
                                       float* dv, float* dqwp, void* demb, float* ds_scratch,
                                       float* attn_scratch, int n, int d, int heads,
                                       int emb_bf16, void* stream) {
  if (heads < 1 || heads > kMaxHeads || d % heads || n < 1) return (int)cudaErrorInvalidValue;
  return emb_bf16
             ? dispatch_bwd<__nv_bfloat16>(q2, k2, v2, qwp, emb, mask, ghid, gae, dq, dk, dv,
                                           dqwp, demb, ds_scratch, attn_scratch, n, d, heads,
                                           (cudaStream_t)stream)
             : dispatch_bwd<float>(q2, k2, v2, qwp, emb, mask, ghid, gae, dq, dk, dv, dqwp,
                                   demb, ds_scratch, attn_scratch, n, d, heads,
                                   (cudaStream_t)stream);
}

extern "C" int roitr_rpe_attention(const float* q2, const float* k2, const float* v2,
                                   const float* qwp, const void* emb, const float* mask,
                                   float* hid, float* ae, int n, int d, int heads,
                                   int emb_bf16, void* stream) {
  if (heads < 1 || heads > kMaxHeads || d % heads) return (int)cudaErrorInvalidValue;
  return emb_bf16 ? dispatch<__nv_bfloat16>(q2, k2, v2, qwp, emb, mask, hid, ae, n, d, heads,
                                            (cudaStream_t)stream)
                  : dispatch<float>(q2, k2, v2, qwp, emb, mask, hid, ae, n, d, heads,
                                    (cudaStream_t)stream);
}
