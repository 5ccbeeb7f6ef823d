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
// tensor-core (wgmma) form is later work. Under differentiation it also
// writes the int8 (R, H) map of the winning k (`_kernel`'s amax output),
// with the strict > of the TPU kernel: ties keep the first k.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kTM = 64;    // rows of a block
constexpr int kTN = 128;   // columns of a block
constexpr int kTJ = 16;    // frequencies a slice
constexpr int kThreads = 256;
constexpr int kRM = 4;     // rows a thread
constexpr int kRN = 8;     // columns a thread

template <bool kArgmax>
__global__ void __launch_bounds__(kThreads)
geo_embedding_kernel(const float* __restrict__ d_idx, const float* __restrict__ a_idx,
                     const float* __restrict__ div, const float* __restrict__ wde,
                     const float* __restrict__ wdo, const float* __restrict__ bd,
                     const float* __restrict__ wae, const float* __restrict__ wao,
                     const float* __restrict__ ba, void* __restrict__ out,
                     int8_t* __restrict__ amax_map, int r_total, int k_total, int hidden,
                     int out_bf16) {
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
  // the winning k of each (row, column), four int8 lanes a register
  uint32_t arg[kRM][kRN / 4];
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int q = 0; q < kRN / 4; ++q) arg[i][q] = 0u;

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
          if (kArgmax && acc[i][q] > amax[i][q]) {
            const int sh = 8 * (q % 4);
            arg[i][q / 4] = (arg[i][q / 4] & ~(0xFFu << sh)) | ((uint32_t)(phase - 1) << sh);
          }
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
      if (kArgmax) amax_map[o] = (int8_t)((arg[i][q / 4] >> (8 * (q % 4))) & 0xFFu);
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
// What bounds it: operations. Each cotangent element meets one distance
// basis row and the angle basis row of its winning k, so the function needs
// 2 x R x H x H multiply-adds, 6.9e10 FLOP at R = 262144, H = 256, k = 3,
// against 134 MB of bf16 cotangent and 67 MB of map. This kernel does the
// masked dense product in every one of the 1 + k phases, (1 + k) x R x H x H
// multiply-adds, of which (k - 1) x R x H x H multiply a zero; picking each
// element's k-basis in shared memory would remove them (later work).
// Design: a reduction over R. The TPU kernel
// sums over its sequential grid into revisited blocks; here a block owns a
// 64-frequency x 128-column tile of the four even/odd weight gradients and
// one chunk of rows, regenerates the sin/cos basis of its frequencies in
// shared memory slice by slice (the basis never reaches device memory),
// and keeps a 8 x 4 tile of each of its two live sums in registers. The
// per-chunk partials go to a scratch that a second kernel sums in chunk
// order: deterministic, no atomics. fp32 on the CUDA cores.

constexpr int kBJ = 64;   // frequencies a block
constexpr int kBC = 128;  // columns a block
constexpr int kBR = 32;   // rows a slice
constexpr int kRJ = 8;    // frequencies a thread
constexpr int kRC = 4;    // columns a thread (one float4 of the cotangent)

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename G>
__global__ void __launch_bounds__(kThreads)
geo_embedding_bwd_kernel(const float* __restrict__ d_idx, const float* __restrict__ a_idx,
                         const int8_t* __restrict__ amax_map, const G* __restrict__ g,
                         const float* __restrict__ div, float* __restrict__ part,
                         float* __restrict__ part_db, int r_total, int k_total, int hidden,
                         int rows_per_chunk) {
  __shared__ __align__(16) float s_g[kBR][kBC];
  __shared__ __align__(16) int8_t s_am[kBR][kBC];
  __shared__ float s_sin[kBR][kBJ];
  __shared__ float s_cos[kBR][kBJ];

  const int tid = threadIdx.x;
  const int tx = tid % (kBC / kRC);  // 32 column groups
  const int ty = tid / (kBC / kRC);  // 8 frequency groups
  const int j0 = blockIdx.x * kBJ;
  const int c0 = blockIdx.y * kBC;
  const int chunk = blockIdx.z;
  const int half = hidden / 2;
  const int r_begin = chunk * rows_per_chunk;
  const int r_end = min(r_total, r_begin + rows_per_chunk);
  const bool with_db = blockIdx.x == 0 && ty == 0;

  float sd[kRJ][kRC], cd[kRJ][kRC], sa[kRJ][kRC], ca[kRJ][kRC], db[kRC];
#pragma unroll
  for (int i = 0; i < kRJ; ++i)
#pragma unroll
    for (int q = 0; q < kRC; ++q) sd[i][q] = cd[i][q] = sa[i][q] = ca[i][q] = 0.f;
#pragma unroll
  for (int q = 0; q < kRC; ++q) db[q] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += kBR) {
    for (int e = tid; e < kBR * kBC; e += kThreads) {
      const int rr = e / kBC;
      const int cc = e % kBC;
      const int row = r0 + rr;
      const int col = c0 + cc;
      const bool ok = row < r_end && col < hidden;
      s_g[rr][cc] = ok ? to_float(g[(size_t)row * hidden + col]) : 0.f;
      s_am[rr][cc] = ok ? amax_map[(size_t)row * hidden + col] : (int8_t)-1;
    }
    for (int phase = 0; phase <= k_total; ++phase) {
      for (int e = tid; e < kBR * kBJ; e += kThreads) {
        const int rr = e / kBJ;
        const int jj = e % kBJ;
        const int row = r0 + rr;
        const int j = j0 + jj;
        float s = 0.f, c = 0.f;
        if (row < r_end && j < half) {
          const float x = phase == 0 ? d_idx[row] : a_idx[(size_t)row * k_total + phase - 1];
          sincosf(x * div[j], &s, &c);
        }
        s_sin[rr][jj] = s;
        s_cos[rr][jj] = c;
      }
      __syncthreads();
#pragma unroll 4
      for (int rr = 0; rr < kBR; ++rr) {
        float sv[kRJ], cv[kRJ], gv[kRC];
#pragma unroll
        for (int i = 0; i < kRJ; ++i) {
          sv[i] = s_sin[rr][ty * kRJ + i];
          cv[i] = s_cos[rr][ty * kRJ + i];
        }
        // one 16-byte load of the cotangent, one 4-byte load of the map
        const float4 g4 = *reinterpret_cast<const float4*>(&s_g[rr][tx * kRC]);
        const char4 a4 = *reinterpret_cast<const char4*>(&s_am[rr][tx * kRC]);
        const int win = phase - 1;
        gv[0] = (phase == 0 || a4.x == win) ? g4.x : 0.f;
        gv[1] = (phase == 0 || a4.y == win) ? g4.y : 0.f;
        gv[2] = (phase == 0 || a4.z == win) ? g4.z : 0.f;
        gv[3] = (phase == 0 || a4.w == win) ? g4.w : 0.f;
        if (phase == 0) {
          if (with_db) {
#pragma unroll
            for (int q = 0; q < kRC; ++q) db[q] += gv[q];
          }
#pragma unroll
          for (int i = 0; i < kRJ; ++i)
#pragma unroll
            for (int q = 0; q < kRC; ++q) {
              sd[i][q] = fmaf(sv[i], gv[q], sd[i][q]);
              cd[i][q] = fmaf(cv[i], gv[q], cd[i][q]);
            }
        } else {
#pragma unroll
          for (int i = 0; i < kRJ; ++i)
#pragma unroll
            for (int q = 0; q < kRC; ++q) {
              sa[i][q] = fmaf(sv[i], gv[q], sa[i][q]);
              ca[i][q] = fmaf(cv[i], gv[q], ca[i][q]);
            }
        }
      }
      __syncthreads();
    }
  }

  // partials of this chunk: part[chunk][w][j][col], w = dWd even, odd, dWa even, odd
  const size_t plane = (size_t)half * hidden;
  float* pc = part + (size_t)chunk * 4 * plane;
#pragma unroll
  for (int i = 0; i < kRJ; ++i) {
    const int j = j0 + ty * kRJ + i;
    if (j >= half) continue;
#pragma unroll
    for (int q = 0; q < kRC; ++q) {
      const int col = c0 + tx * kRC + q;
      if (col >= hidden) continue;
      const size_t o = (size_t)j * hidden + col;
      pc[o] = sd[i][q];
      pc[plane + o] = cd[i][q];
      pc[2 * plane + o] = sa[i][q];
      pc[3 * plane + o] = ca[i][q];
    }
  }
  if (with_db) {
#pragma unroll
    for (int q = 0; q < kRC; ++q) {
      const int col = c0 + tx * kRC + q;
      if (col < hidden) part_db[(size_t)chunk * hidden + col] = db[q];
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

}  // namespace

extern "C" int roitr_geo_embedding(const float* d_idx, const float* a_idx, const float* div,
                                   const float* wde, const float* wdo, const float* bd,
                                   const float* wae, const float* wao, const float* ba,
                                   void* out, int8_t* amax_map, int r_total, int k_total,
                                   int hidden, int out_bf16, void* stream) {
  if (k_total < 1 || k_total > 127 || hidden % 2) return (int)cudaErrorInvalidValue;
  const dim3 grid((r_total + kTM - 1) / kTM, (hidden + kTN - 1) / kTN);
  if (amax_map) {
    geo_embedding_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        d_idx, a_idx, div, wde, wdo, bd, wae, wao, ba, out, amax_map, r_total, k_total, hidden,
        out_bf16);
  } else {
    geo_embedding_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        d_idx, a_idx, div, wde, wdo, bd, wae, wao, ba, out, amax_map, r_total, k_total, hidden,
        out_bf16);
  }
  return (int)cudaGetLastError();
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
  const dim3 grid((hidden / 2 + kBJ - 1) / kBJ, (hidden + kBC - 1) / kBC, chunks);
  cudaStream_t st = (cudaStream_t)stream;
  if (g_bf16) {
    geo_embedding_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        d_idx, a_idx, amax_map, static_cast<const __nv_bfloat16*>(g), div, part, part_db,
        r_total, k_total, hidden, rows_per_chunk);
  } else {
    geo_embedding_bwd_kernel<float><<<grid, kThreads, 0, st>>>(
        d_idx, a_idx, amax_map, static_cast<const float*>(g), div, part, part_db, r_total,
        k_total, hidden, rows_per_chunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t nw = (size_t)4 * (hidden / 2) * hidden;
  geo_embedding_bwd_reduce<<<(unsigned)((nw + 255) / 256), 256, 0, st>>>(part, chunks, nw, dw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  geo_embedding_bwd_reduce<<<(hidden + 255) / 256, 256, 0, st>>>(part_db, chunks,
                                                                 (size_t)hidden, db);
  return (int)cudaGetLastError();
}
