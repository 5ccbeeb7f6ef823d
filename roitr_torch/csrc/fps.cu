// Farthest point sampling of a batch of prefix-packed clouds.
//
// Replaces roitr_tpu/ops/pallas/fps_kernel.py `_kernel` (entry `fps_pairs`).
// Semantics of roitr_tpu/ops/fps.py: seed index 0; each pick maximizes the
// running min-distance to the picked set, ties to the lowest index; padded
// points hold -inf and are never picked; surplus slots repeat the seed.
//
// What bounds it: latency. Each pick depends on the previous one (8192
// dependent picks at the 32768 bucket's first level), and a pick is one
// pass over the cloud plus an argmax over it, so the chain, not bytes or
// operations, sets the time. Design: the whole chain in one launch, one
// cluster of 8 blocks of 1024 threads per cloud (both clouds of a pair run
// side by side on 16 SMs). Each block owns an eighth of the cloud: its
// running distances stay in shared memory (up to 57856 points a block, a
// global scratch buffer beyond), its coordinates too while they fit (up to
// 14464 points a block, else read from L2). A pick is a warp-shuffle argmax,
// one across the block's 32 warps, then one cluster barrier after which
// every warp reads the 8 block winners from distributed shared memory and
// reduces them the same way, so all blocks agree on the pick without a
// second barrier. The block winners are double-buffered by pick parity: a
// block can only overwrite a slot after the next barrier, which every block
// reaches only after reading it.
//
// Exactness: the distance rounds as (dx*dx + dy*dy) + dz*dz with no fused
// multiply-add (__fmul_rn/__fadd_rn are never contracted), which is how
// the plain version and the JAX reference round it, and the argmax is a
// total order (larger value, then lower index), so the indices match bit
// for bit whatever order the reduction takes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <climits>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;  // blocks a cloud (the portable cluster size)
// dynamic shared memory budget: sm_90's 232448 bytes a block, less room
// for the static reduction buffers
constexpr int kSmemBytes = 231424;

__device__ __forceinline__ void keep_better(float& bv, int& bi, float v, int i) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ pts, const int* __restrict__ counts,
           int* __restrict__ out, float* __restrict__ scratch, int n, int m, int chunk,
           int dist_in_smem, int coords_in_smem) {
  extern __shared__ float smem[];
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ float win_v[2];  // this block's winner of the pick, by pick parity
  __shared__ int win_i[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int lo = rank * chunk;         // this block's points are [lo, hi)
  const int hi = min(lo + chunk, n);
  const float* p = pts + (size_t)b * n * 3;
  float* dist = dist_in_smem ? smem : scratch + (size_t)b * n + lo;
  float* sx = smem + chunk;  // coordinate planes, when they fit
  float* sy = sx + chunk;
  float* sz = sy + chunk;
  const int cnt = counts[b];

  for (int i = lo + tid; i < hi; i += kThreads) {
    const int j = i - lo;
    dist[j] = i < cnt ? 1e10f : -CUDART_INF_F;
    if (coords_in_smem) {
      sx[j] = p[3 * i];
      sy[j] = p[3 * i + 1];
      sz[j] = p[3 * i + 2];
    }
  }
  if (tid == 0 && rank == 0) out[(size_t)b * m] = 0;
  __syncthreads();

  int last = 0;
  for (int s = 1; s < m; ++s) {
    const float lx = __ldg(p + 3 * last);
    const float ly = __ldg(p + 3 * last + 1);
    const float lz = __ldg(p + 3 * last + 2);
    float bv = -CUDART_INF_F;
    int bi = INT_MAX;
    for (int i = lo + tid; i < hi; i += kThreads) {
      const int j = i - lo;
      float x, y, z;
      if (coords_in_smem) {
        x = sx[j]; y = sy[j]; z = sz[j];
      } else {
        x = __ldg(p + 3 * i); y = __ldg(p + 3 * i + 1); z = __ldg(p + 3 * i + 2);
      }
      const float dx = __fsub_rn(x, lx);
      const float dy = __fsub_rn(y, ly);
      const float dz = __fsub_rn(z, lz);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      float cur = dist[j];
      if (i < cnt) {
        cur = fminf(cur, d2);
        dist[j] = cur;
      }
      keep_better(bv, bi, cur, i);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      keep_better(bv, bi, ov, oi);
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = red_v[lane];
      bi = red_i[lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        keep_better(bv, bi, ov, oi);
      }
      if (lane == 0) {
        win_v[s & 1] = bv;
        win_i[s & 1] = bi;
      }
    }
    cluster.sync();
    // every warp reduces the cluster's block winners to the same pick
    float cv = -CUDART_INF_F;
    int ci = INT_MAX;
    if (lane < kCluster) {
      cv = *cluster.map_shared_rank(&win_v[s & 1], lane);
      ci = *cluster.map_shared_rank(&win_i[s & 1], lane);
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, cv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, ci, off);
      keep_better(cv, ci, ov, oi);
    }
    last = __shfl_sync(0xffffffffu, ci, 0);
    if (tid == 0 && rank == 0) out[(size_t)b * m + s] = last;
  }
  // no block may leave while another can still read its shared memory
  cluster.sync();
}

int chunk_of(int n) { return (n + kCluster - 1) / kCluster; }

bool dist_fits(int chunk) { return (size_t)chunk * 4 <= (size_t)kSmemBytes; }

}  // namespace

// Floats of global scratch a cloud of n points needs: 0 while its running
// distances fit in shared memory, else n. Sizes roitr_fps's `scratch`.
extern "C" int roitr_fps_scratch_floats(int n) { return dist_fits(chunk_of(n)) ? 0 : n; }

extern "C" int roitr_fps(const float* pts, const int* counts, int* out, float* scratch,
                         int b, int n, int m, void* stream) {
  const int chunk = chunk_of(n);
  const int dist_in_smem = dist_fits(chunk);
  const int coords_in_smem = (size_t)chunk * 16 <= (size_t)kSmemBytes;
  const size_t smem = dist_in_smem ? (size_t)chunk * (coords_in_smem ? 16 : 4) : 0;
  const cudaError_t set =
      cudaFuncSetAttribute(fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (set != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch is not blamed
    return (int)set;
  }
  fps_kernel<<<b * kCluster, kThreads, smem, (cudaStream_t)stream>>>(
      pts, counts, out, scratch, n, m, chunk, dist_in_smem, coords_in_smem);
  return (int)cudaGetLastError();
}
