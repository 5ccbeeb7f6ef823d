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

}  // namespace

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
