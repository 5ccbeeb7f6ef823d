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

}  // namespace

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
