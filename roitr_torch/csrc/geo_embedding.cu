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
// H = 256, k = 3: (1 + k) * R * H * H multiply-adds, 1.4e11 FLOP a cloud,
// against 134 MB of bf16 output. Design: a tiled fp32 product whose A
// operand (the sin/cos basis) is generated in shared memory from the
// indices and never reaches device memory. A block owns 64 rows x 128
// columns; for each of the 1 + k phases it streams the basis and the
// weight rows through shared memory in 16-frequency slices, each thread
// holding a 4 x 8 tile of sums in registers, then folds the phase into
// the distance part or the running max over k. The output is written once,
// in the storage dtype. fp32 on the CUDA cores, right before fast: the
// tensor-core (wgmma) form is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kTM = 64;    // rows of a block
constexpr int kTN = 128;   // columns of a block
constexpr int kTJ = 16;    // frequencies a slice
constexpr int kThreads = 256;
constexpr int kRM = 4;     // rows a thread
constexpr int kRN = 8;     // columns a thread

__global__ void __launch_bounds__(kThreads)
geo_embedding_kernel(const float* __restrict__ d_idx, const float* __restrict__ a_idx,
                     const float* __restrict__ div, const float* __restrict__ wde,
                     const float* __restrict__ wdo, const float* __restrict__ bd,
                     const float* __restrict__ wae, const float* __restrict__ wao,
                     const float* __restrict__ ba, void* __restrict__ out, int r_total,
                     int k_total, int hidden, int out_bf16) {
  __shared__ float s_sin[kTJ][kTM];
  __shared__ float s_cos[kTJ][kTM];
  __shared__ float s_we[kTJ][kTN];
  __shared__ float s_wo[kTJ][kTN];

  const int tid = threadIdx.x;
  const int tx = tid % (kTN / kRN);  // 16 column groups
  const int ty = tid / (kTN / kRN);  // 16 row groups
  const int row0 = blockIdx.x * kTM;
  const int col0 = blockIdx.y * kTN;
  const int half = hidden / 2;

  float dsum[kRM][kRN];
  float amax[kRM][kRN];

  for (int phase = 0; phase <= k_total; ++phase) {
    const float* we = phase == 0 ? wde : wae;
    const float* wo = phase == 0 ? wdo : wao;
    float acc[kRM][kRN];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kRN; ++j) acc[i][j] = 0.f;

    for (int j0 = 0; j0 < half; j0 += kTJ) {
      // basis slice: kTJ frequencies x kTM rows
      for (int e = tid; e < kTJ * kTM; e += kThreads) {
        const int jj = e / kTM;
        const int rr = e % kTM;
        const int row = row0 + rr;
        const int j = j0 + jj;
        float s = 0.f, c = 0.f;
        if (row < r_total && j < half) {
          const float x = phase == 0 ? d_idx[row] : a_idx[(size_t)row * k_total + phase - 1];
          sincosf(x * div[j], &s, &c);
        }
        s_sin[jj][rr] = s;
        s_cos[jj][rr] = c;
      }
      // weight slice: kTJ even and odd rows x kTN columns
      for (int e = tid; e < kTJ * kTN; e += kThreads) {
        const int jj = e / kTN;
        const int cc = e % kTN;
        const int j = j0 + jj;
        const int col = col0 + cc;
        const bool ok = j < half && col < hidden;
        s_we[jj][cc] = ok ? we[(size_t)j * hidden + col] : 0.f;
        s_wo[jj][cc] = ok ? wo[(size_t)j * hidden + col] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int jj = 0; jj < kTJ; ++jj) {
        float sv[kRM], cv[kRM], ev[kRN], ov[kRN];
#pragma unroll
        for (int i = 0; i < kRM; ++i) {
          sv[i] = s_sin[jj][ty * kRM + i];
          cv[i] = s_cos[jj][ty * kRM + i];
        }
#pragma unroll
        for (int q = 0; q < kRN; ++q) {
          ev[q] = s_we[jj][tx * kRN + q];
          ov[q] = s_wo[jj][tx * kRN + q];
        }
#pragma unroll
        for (int i = 0; i < kRM; ++i)
#pragma unroll
          for (int q = 0; q < kRN; ++q)
            acc[i][q] = fmaf(cv[i], ov[q], fmaf(sv[i], ev[q], acc[i][q]));
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int q = 0; q < kRN; ++q) {
        if (phase == 0) {
          dsum[i][q] = acc[i][q];
        } else if (phase == 1) {
          amax[i][q] = acc[i][q];
        } else {
          amax[i][q] = fmaxf(amax[i][q], acc[i][q]);
        }
      }
  }

#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int row = row0 + ty * kRM + i;
    if (row >= r_total) continue;
#pragma unroll
    for (int q = 0; q < kRN; ++q) {
      const int col = col0 + tx * kRN + q;
      if (col >= hidden) continue;
      const float v = dsum[i][q] + amax[i][q] + bd[col] + ba[col];
      const size_t o = (size_t)row * hidden + col;
      if (out_bf16) {
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
      } else {
        static_cast<float*>(out)[o] = v;
      }
    }
  }
}

}  // namespace

extern "C" int roitr_geo_embedding(const float* d_idx, const float* a_idx, const float* div,
                                   const float* wde, const float* wdo, const float* bd,
                                   const float* wae, const float* wao, const float* ba,
                                   void* out, int r_total, int k_total, int hidden,
                                   int out_bf16, void* stream) {
  const dim3 grid((r_total + kTM - 1) / kTM, (hidden + kTN - 1) / kTN);
  geo_embedding_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      d_idx, a_idx, div, wde, wdo, bd, wae, wao, ba, out, r_total, k_total, hidden, out_bf16);
  return (int)cudaGetLastError();
}
