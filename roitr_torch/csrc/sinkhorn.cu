// Log-domain Sinkhorn iterations on padded patch scores.
//
// Replaces roitr_tpu/ops/pallas/sinkhorn_kernel.py `_sinkhorn_kernel`
// (entries `_pallas_forward`, `sinkhorn_iterate_pallas`). For each patch p,
// from u = v = 0, `num_iter` times:
//
//   u[i] = mu[i] - logsumexp_j(s[i, j] + v[j])
//   v[j] = nu[j] - logsumexp_i(s[i, j] + u[i])
//
// then out = s + u + v. Invalid entries arrive as -1e6 (finite), and the
// caller subtracts the normaliser (roitr_tpu/ops/sinkhorn.py:94).
//
// What bounds it: latency. At the main path's (256, 65, 65) x 100 the
// inputs are 4.3 MB and the work 0.2 GFLOP of exp/log, but each of the 200
// half-steps depends on the one before. Design: one block per patch, the
// whole loop in one launch; the (M1, N1) score patch (17 KB at 65 x 65)
// and both potentials stay in shared memory for all iterations, so device
// memory is read once and written once. A warp owns a row (u update) or a
// column (v update) and reduces it with shuffles; the patch's row stride
// N1 = 65 is odd, so column walks are free of bank conflicts.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
sinkhorn_kernel(const float* __restrict__ scores, const float* __restrict__ log_mu,
                const float* __restrict__ log_nu, float* __restrict__ out, int m1, int n1,
                int num_iter) {
  extern __shared__ float smem[];
  float* s = smem;             // m1 x n1
  float* u = s + m1 * n1;      // m1
  float* v = u + m1;           // n1
  float* mu = v + n1;          // m1
  float* nu = mu + m1;         // n1

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t base = (size_t)p * m1 * n1;

  for (int e = tid; e < m1 * n1; e += kThreads) s[e] = scores[base + e];
  for (int i = tid; i < m1; i += kThreads) {
    u[i] = 0.f;
    mu[i] = log_mu[(size_t)p * m1 + i];
  }
  for (int j = tid; j < n1; j += kThreads) {
    v[j] = 0.f;
    nu[j] = log_nu[(size_t)p * n1 + j];
  }
  __syncthreads();

  for (int it = 0; it < num_iter; ++it) {
    for (int i = warp; i < m1; i += kWarps) {
      const float* row = s + i * n1;
      float mx = -CUDART_INF_F;
      for (int j = lane; j < n1; j += 32) mx = fmaxf(mx, row[j] + v[j]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < n1; j += 32) sum += expf(row[j] + v[j] - mx);
      sum = warp_sum(sum);
      if (lane == 0) u[i] = mu[i] - (mx + logf(sum));
    }
    __syncthreads();
    for (int j = warp; j < n1; j += kWarps) {
      float mx = -CUDART_INF_F;
      for (int i = lane; i < m1; i += 32) mx = fmaxf(mx, s[i * n1 + j] + u[i]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int i = lane; i < m1; i += 32) sum += expf(s[i * n1 + j] + u[i] - mx);
      sum = warp_sum(sum);
      if (lane == 0) v[j] = nu[j] - (mx + logf(sum));
    }
    __syncthreads();
  }

  for (int e = tid; e < m1 * n1; e += kThreads) {
    const int i = e / n1;
    const int j = e % n1;
    out[base + e] = s[e] + u[i] + v[j];
  }
}

// Reverse mode of the loop above.
//
// Replaces roitr_tpu/ops/pallas/sinkhorn_kernel.py `_sinkhorn_bwd_kernel`
// (entries `_pallas_backward`, `_vjp_bwd`). The forward saves only its
// inputs; this kernel recomputes the u/v trajectory, then walks the
// iterations backwards (a_t, b_t are the row and column softmaxes):
//
//   a_t = exp(s + v_{t-1} - mu + u_t),  b_t = exp(s + u_t - nu + v_t)
//   du = sum_j g, dv = sum_i g, ds = g; per t descending:
//     dnu += dv; ds -= dv b_t; du -= sum_j dv b_t
//     dmu += du; ds -= du a_t; dv = -sum_i du a_t; du = 0
//
// What bounds it: latency, as the forward: 2 x 100 dependent half-steps
// forward and 2 x 100 backward, against 8.7 MB of inputs and outputs at
// (128, 65, 65). Design: one block per patch, everything in shared memory
// for the whole launch: the score patch, the ds accumulator (17 KB each at
// 65 x 65) and the u/v trajectory (52 KB at 100 iterations), 87 KB in
// all, as dynamic shared memory. Masked entries (-1e6) decay to exactly 0
// in the exponents of the valid side, as on the TPU.
__global__ void __launch_bounds__(kThreads)
sinkhorn_bwd_kernel(const float* __restrict__ scores, const float* __restrict__ log_mu,
                    const float* __restrict__ log_nu, const float* __restrict__ g,
                    float* __restrict__ ds_out, float* __restrict__ dmu_out,
                    float* __restrict__ dnu_out, int m1, int n1, int num_iter) {
  extern __shared__ float smem[];
  float* s = smem;                   // m1 x n1
  float* ds = s + m1 * n1;           // m1 x n1
  float* us = ds + m1 * n1;          // num_iter x m1
  float* vs = us + num_iter * m1;    // num_iter x n1
  float* mu = vs + num_iter * n1;    // m1
  float* nu = mu + m1;               // n1
  float* du = nu + n1;               // m1
  float* dv = du + m1;               // n1
  float* dmu = dv + n1;              // m1
  float* dnu = dmu + m1;             // n1

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t base = (size_t)p * m1 * n1;

  for (int e = tid; e < m1 * n1; e += kThreads) {
    s[e] = scores[base + e];
    ds[e] = g[base + e];
  }
  for (int i = tid; i < m1; i += kThreads) {
    mu[i] = log_mu[(size_t)p * m1 + i];
    dmu[i] = 0.f;
  }
  for (int j = tid; j < n1; j += kThreads) {
    nu[j] = log_nu[(size_t)p * n1 + j];
    dnu[j] = 0.f;
  }
  __syncthreads();

  // forward recompute, keeping every u_t and v_t
  for (int it = 0; it < num_iter; ++it) {
    const float* v_prev = vs + (it - 1) * n1;
    float* u_t = us + it * m1;
    for (int i = warp; i < m1; i += kWarps) {
      const float* row = s + i * n1;
      float mx = -CUDART_INF_F;
      for (int j = lane; j < n1; j += 32) mx = fmaxf(mx, row[j] + (it ? v_prev[j] : 0.f));
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < n1; j += 32) sum += expf(row[j] + (it ? v_prev[j] : 0.f) - mx);
      sum = warp_sum(sum);
      if (lane == 0) u_t[i] = mu[i] - (mx + logf(sum));
    }
    __syncthreads();
    float* v_t = vs + it * n1;
    for (int j = warp; j < n1; j += kWarps) {
      float mx = -CUDART_INF_F;
      for (int i = lane; i < m1; i += 32) mx = fmaxf(mx, s[i * n1 + j] + u_t[i]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int i = lane; i < m1; i += 32) sum += expf(s[i * n1 + j] + u_t[i] - mx);
      sum = warp_sum(sum);
      if (lane == 0) v_t[j] = nu[j] - (mx + logf(sum));
    }
    __syncthreads();
  }

  // cotangents of out = s + u_T + v_T
  for (int i = warp; i < m1; i += kWarps) {
    float sum = 0.f;
    for (int j = lane; j < n1; j += 32) sum += ds[i * n1 + j];
    sum = warp_sum(sum);
    if (lane == 0) du[i] = sum;
  }
  for (int j = warp; j < n1; j += kWarps) {
    float sum = 0.f;
    for (int i = lane; i < m1; i += 32) sum += ds[i * n1 + j];
    sum = warp_sum(sum);
    if (lane == 0) dv[j] = sum;
  }
  __syncthreads();

  for (int t = num_iter - 1; t >= 0; --t) {
    const float* u_t = us + t * m1;
    const float* v_t = vs + t * n1;
    const float* v_prev = vs + (t - 1) * n1;
    // v_t = nu - lse_i(s + u_t): b_t, the column softmax
    for (int i = warp; i < m1; i += kWarps) {
      float sum = 0.f;
      for (int j = lane; j < n1; j += 32) {
        const float b = expf(s[i * n1 + j] + u_t[i] - nu[j] + v_t[j]);
        const float dvb = dv[j] * b;
        ds[i * n1 + j] -= dvb;
        sum += dvb;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        du[i] = (t == num_iter - 1 ? du[i] : 0.f) - sum;
        dmu[i] += du[i];
      }
    }
    __syncthreads();
    // u_t = mu - lse_j(s + v_{t-1}): a_t, the row softmax
    for (int j = warp; j < n1; j += kWarps) {
      float sum = 0.f;
      const float vp = t ? v_prev[j] : 0.f;
      for (int i = lane; i < m1; i += 32) {
        const float a = expf(s[i * n1 + j] + vp - mu[i] + u_t[i]);
        const float dua = du[i] * a;
        ds[i * n1 + j] -= dua;
        sum += dua;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        dnu[j] += dv[j];
        dv[j] = -sum;
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < m1 * n1; e += kThreads) ds_out[base + e] = ds[e];
  for (int i = tid; i < m1; i += kThreads) dmu_out[(size_t)p * m1 + i] = dmu[i];
  for (int j = tid; j < n1; j += kThreads) dnu_out[(size_t)p * n1 + j] = dnu[j];
}

}  // namespace

extern "C" int roitr_sinkhorn_bwd(const float* scores, const float* log_mu, const float* log_nu,
                                  const float* g, float* ds, float* dmu, float* dnu, int p,
                                  int m1, int n1, int num_iter, void* stream) {
  // a patch and trajectory larger than a block's shared memory are refused here
  if (num_iter < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (2 * (size_t)m1 * n1 + (size_t)num_iter * (m1 + n1) +
                                       3 * ((size_t)m1 + n1));
  const cudaError_t set = cudaFuncSetAttribute(
      sinkhorn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (set != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch is not blamed
    return (int)set;
  }
  sinkhorn_bwd_kernel<<<p, kThreads, smem, (cudaStream_t)stream>>>(
      scores, log_mu, log_nu, g, ds, dmu, dnu, m1, n1, num_iter);
  return (int)cudaGetLastError();
}

extern "C" int roitr_sinkhorn(const float* scores, const float* log_mu, const float* log_nu,
                              float* out, int p, int m1, int n1, int num_iter, void* stream) {
  // a patch larger than a block's shared memory is refused here
  const size_t smem = sizeof(float) * ((size_t)m1 * n1 + 2 * (size_t)m1 + 2 * (size_t)n1);
  const cudaError_t set = cudaFuncSetAttribute(
      sinkhorn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (set != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch is not blamed
    return (int)set;
  }
  sinkhorn_kernel<<<p, kThreads, smem, (cudaStream_t)stream>>>(scores, log_mu, log_nu, out, m1,
                                                               n1, num_iter);
  return (int)cudaGetLastError();
}
