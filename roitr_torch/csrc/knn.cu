// Exact k-nearest-neighbour search of prefix-packed clouds in one pass.
//
// Replaces no Pallas kernel: the JAX package searches with lax.top_k (exact)
// and lax.approx_min_k, which XLA computes (roitr_tpu/ops/neighbors.py). The
// port's plain version (kernels/knn_kernel.py `knn_plain`) writes a (T, N)
// fp32 distance tile for each tile of queries, masks the pad keys, turns
// every entry into an int64 sort key (ops/topk.py) and runs a radix select
// over the keys: about 150 bytes of device-memory traffic per (query, key)
// entry, the largest device cost of every request and train step.
//
// What bounds it: fp32 operations, about 8 an entry (the dot product's
// multiply and two FMAs, the -2xy FMA, the add, the clamp, the compare with
// the query's current k-th best); at the card's 67 TFLOP/s that is about a
// millisecond for the 7.7 G entries of a 32768-point request. Device memory
// carries only the inputs and the (Q, k) outputs.
//
// Design: one thread (or a group of G lanes) a query. Each block stages the
// keys through shared memory in tiles of 512: cp.async copies the raw xyz
// rows into one of two buffers while the block works on the previous tile,
// and one pass turns a tile into float4 (x, y, z, |y|^2), so each key's
// norm is computed once a block. Each lane keeps its K best (d^2, index)
// pairs in registers, sorted, and inserts a key only when it beats the
// current K-th, by a fully unrolled compare-and-select over the list (no
// local memory). A lane sees its keys in ascending index order, so a key
// that ties an entry already kept sorts after it and a strict compare
// suffices. When the queries alone would leave the card's SMs short of
// threads (Q x B below 192 a SM), the wrapper splits each query's
// keys over G = 2..32 lanes; their lists merge at the end, lane pairs
// folding in a tree by shuffles, under the full (d^2, index) order. Pad
// keys all sit at 1e10, so only the first K of them can enter a list; they
// are inserted after the merge. The epilogue applies exclude_self (drop the
// first of k + 1), the reference's phantom index-0 slots and the square
// root, and writes int64 indices.
//
// Exactness: the distances equal the plain version's bit for bit. The dot
// form rounds as the plain version's PyTorch operations do on the card:
// |x|^2 as torch.sum(x * x, -1) adds a row of three ((x0^2 + x2^2) + x1^2:
// two lanes split the row, the first taking elements 0 and 2), x.y as the
// fp32 cuBLAS product's FMA chain over k = 0, 1, 2 (TF32 off), then
// (|x|^2 - 2 x.y) + |y|^2 and the clamp at 1e-12. The difference form (the
// 1-NN distance of ops/partition.py) rounds ((dx^2 + dy^2) + dz^2). All
// through __f*_rn intrinsics, which the compiler never contracts. The list
// order is (d^2, index), which is ops/topk.py's, so indices match too.

#include <cuda_runtime.h>
#include <climits>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 512;  // keys a shared-memory tile
constexpr float kPad = 1e10f;  // distance of pad keys and phantom slots
// list sizes the kernel is compiled for; a search of kk neighbours takes the
// smallest that holds kk (kernels/knn_kernel.py CAPACITIES mirrors these):
// 9, 17 and 33 are RoITr's k + 1 searches and its normals, 38 the largest
// radius-neighbour limit of GeoTransformer's grid pyramid (ops/grid.py)
constexpr int kCapacities[] = {1, 3, 9, 17, 33, 38};

enum Form { kDot = 0, kDiff = 1 };

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(z, z)), __fmul_rn(y, y));
}

template <int FORM>
__device__ __forceinline__ float entry(float qx, float qy, float qz, float qn, float4 k) {
  if (FORM == kDot) {
    const float xy = __fmaf_rn(qz, k.z, __fmaf_rn(qy, k.y, __fmul_rn(qx, k.x)));
    // -2 * xy is exact, so one rounding, as qn - 2 * xy
    return fmaxf(__fadd_rn(__fmaf_rn(-2.f, xy, qn), k.w), 1e-12f);
  }
  const float dx = __fsub_rn(qx, k.x), dy = __fsub_rn(qy, k.y), dz = __fsub_rn(qz, k.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__device__ __forceinline__ bool precedes(float d, int j, float e, int i) {
  return d < e || (d == e && j < i);
}

// Insert (d, j) into the ascending list; (d, j) precedes the last entry.
// STRICT: j is above every index in the list, so ties sort after the kept
// entries and d alone decides.
template <int K, bool STRICT>
__device__ __forceinline__ void insert(float (&ld)[K], int (&li)[K], float d, int j) {
  bool below = true;  // (d, j) precedes the old ld[p]
#pragma unroll
  for (int p = K - 1; p > 0; --p) {
    const bool before = STRICT ? d < ld[p - 1] : precedes(d, j, ld[p - 1], li[p - 1]);
    ld[p] = before ? ld[p - 1] : (below ? d : ld[p]);
    li[p] = before ? li[p - 1] : (below ? j : li[p]);
    below = before;
  }
  if (below) {
    ld[0] = d;
    li[0] = j;
  }
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// raw xyz rows of tile t (keys [t * kTile, ...) below `valid`) into dst
__device__ __forceinline__ void load_tile(float* dst, const float* keys, int t, int valid) {
  const int j0 = t * kTile;
  const int floats = 3 * min(kTile, valid - j0);
  for (int f = threadIdx.x; f < floats; f += kThreads) cp_async4(dst + f, keys + 3 * j0 + f);
}

// queries (B, Q, 3), keys (B, N, 3), counts (B,). Each query's list covers
// the keys below its cloud's count, then the pad keys; the outputs
// (B, Q, cols) take entries as masked_knn returns them.
template <int K, int FORM>
__global__ void __launch_bounds__(kThreads, 2)
knn_kernel(const float* __restrict__ queries, const float* __restrict__ keys,
           const int* __restrict__ counts, int q_len, int n, int group_log2,
           int kk, int cols, int exclude_self, int squared, long long* __restrict__ out_idx,
           float* __restrict__ out_dist) {
  __shared__ __align__(16) float raw[2][3 * kTile];
  __shared__ float4 tile[kTile];

  const int b = blockIdx.y;
  const int group = 1 << group_log2;
  const int g = threadIdx.x & (group - 1);
  const int q = (blockIdx.x * kThreads + threadIdx.x) >> group_log2;
  // lanes past the last query run the last one's search (every lane of a
  // warp takes part in the merge's shuffles) and write nothing
  const int qr = min(q, q_len - 1);
  const float* qp = queries + ((size_t)b * q_len + qr) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  const float qn = FORM == kDot ? sq_norm(qx, qy, qz) : 0.f;
  const float* kb = keys + (size_t)b * n * 3;
  const int count = counts[b];
  const int valid = min(max(count, 0), n);

  float ld[K];
  int li[K];
#pragma unroll
  for (int p = 0; p < K; ++p) {
    ld[p] = CUDART_INF_F;
    li[p] = INT_MAX;
  }

  const int tiles = (valid + kTile - 1) / kTile;
  if (tiles > 0) load_tile(raw[0], kb, 0, valid);
  cp_async_commit();
  if (tiles > 1) load_tile(raw[1], kb, 1, valid);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait_one();
    __syncthreads();
    const int j0 = t * kTile;
    const int len = min(kTile, valid - j0);
    const float* r = raw[t & 1];
    for (int j = threadIdx.x; j < len; j += kThreads) {
      const float x = r[3 * j], y = r[3 * j + 1], z = r[3 * j + 2];
      tile[j] = make_float4(x, y, z, FORM == kDot ? sq_norm(x, y, z) : 0.f);
    }
    __syncthreads();
    if (t + 2 < tiles) load_tile(raw[t & 1], kb, t + 2, valid);
    cp_async_commit();
#pragma unroll 4
    for (int j = g; j < len; j += group) {
      const float d = entry<FORM>(qx, qy, qz, qn, tile[j]);
      if (d < ld[K - 1]) insert<K, true>(ld, li, d, j0 + j);
    }
    __syncthreads();
  }

  // fold the group's lists: in round `off`, lane g + off hands its list to
  // lane g (g a multiple of 2 * off), entry by entry in its order, until no
  // receiving lane of the warp takes one
  for (int off = 1; off < group; off <<= 1) {
    const bool recv = (g & (2 * off - 1)) == 0;
#pragma unroll
    for (int p = 0; p < K; ++p) {
      const float pd = __shfl_xor_sync(0xffffffffu, ld[p], off);
      const int pi = __shfl_xor_sync(0xffffffffu, li[p], off);
      const bool take = recv && precedes(pd, pi, ld[K - 1], li[K - 1]);
      if (!__any_sync(0xffffffffu, take)) break;
      if (take) insert<K, false>(ld, li, pd, pi);
    }
  }
  if (g != 0 || q >= q_len) return;

  // pad keys valid, valid + 1, ...: index above every valid key's
#pragma unroll 1
  for (int p = 0; p < K; ++p) {
    const int j = valid + p;
    if (j >= n || !(kPad < ld[K - 1])) break;
    insert<K, true>(ld, li, kPad, j);
  }

  long long* oi = out_idx + ((size_t)b * q_len + q) * cols;
  float* od = out_dist + ((size_t)b * q_len + q) * cols;
  const int shift = exclude_self ? 1 : 0;
#pragma unroll
  for (int p = 0; p < K; ++p) {
    const int c = p - shift;
    if (c < 0 || c >= cols) continue;
    // exclude_self: past the k + 1 searched, or a phantom slot of a short cloud
    const bool phantom = exclude_self && (p >= kk || c >= count - 1);
    const float d = phantom ? kPad : ld[p];
    oi[c] = phantom ? 0 : li[p];
    od[c] = squared ? d : __fsqrt_rn(d);
  }
  for (int c = K - shift; c < cols; ++c) {  // exclude_self with n < k + 1
    oi[c] = 0;
    od[c] = squared ? kPad : __fsqrt_rn(kPad);
  }
}

template <int K>
cudaError_t launch(int form, dim3 grid, cudaStream_t stream, const float* queries,
                   const float* keys, const int* counts, int q_len, int n, int group_log2,
                   int kk, int cols, int exclude_self, int squared, long long* out_idx,
                   float* out_dist) {
  if (form == kDot) {
    knn_kernel<K, kDot><<<grid, kThreads, 0, stream>>>(queries, keys, counts, q_len, n,
                                                       group_log2, kk, cols, exclude_self,
                                                       squared, out_idx, out_dist);
  } else {
    knn_kernel<K, kDiff><<<grid, kThreads, 0, stream>>>(queries, keys, counts, q_len, n,
                                                        group_log2, kk, cols, exclude_self,
                                                        squared, out_idx, out_dist);
  }
  return cudaGetLastError();
}

// The list size a search of kk neighbours runs with; 0 past the largest.
int capacity(int kk) {
  for (int c : kCapacities) {
    if (kk >= 1 && kk <= c) return c;
  }
  return 0;
}

}  // namespace

extern "C" {

// queries (batch, q_len, 3) and keys (batch, n, 3) fp32; counts (batch,)
// int32 on the card; form 0 the x^2 - 2xy + y^2 distance, 1 the coordinate
// differences; kk the neighbours searched (k, or k + 1 under exclude_self),
// cols the columns written (kk, or k); each query's keys split over
// 2^group_log2 lanes. Outputs (batch, q_len, cols):
// int64 indices and sqrt distances (squared: d^2, which only the checks
// against the plain version read). cudaErrorInvalidValue
// (nothing launched) for what the kernel does not take.
int roitr_knn(const float* queries, const float* keys, const int* counts, int batch,
              int q_len, int n, int kk, int cols, int exclude_self, int form, int group_log2,
              int squared, long long* out_idx, float* out_dist, cudaStream_t stream) {
  const int cap = capacity(kk);
  const int want_cols = exclude_self ? cols : kk;
  if (cap == 0 || batch < 1 || batch > 65535 || q_len < 1 || n < 1 || kk > n ||
      cols < 1 || cols != want_cols || (exclude_self && kk > cols + 1) || form < 0 ||
      form > 1 || group_log2 < 0 || group_log2 > 5) {
    return cudaErrorInvalidValue;
  }
  const long long threads = (long long)q_len << group_log2;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)batch);
  switch (cap) {
    case 1:
      return launch<1>(form, grid, stream, queries, keys, counts, q_len, n, group_log2,
                       kk, cols, exclude_self, squared, out_idx, out_dist);
    case 3:
      return launch<3>(form, grid, stream, queries, keys, counts, q_len, n, group_log2,
                       kk, cols, exclude_self, squared, out_idx, out_dist);
    case 9:
      return launch<9>(form, grid, stream, queries, keys, counts, q_len, n, group_log2,
                       kk, cols, exclude_self, squared, out_idx, out_dist);
    case 17:
      return launch<17>(form, grid, stream, queries, keys, counts, q_len, n, group_log2,
                        kk, cols, exclude_self, squared, out_idx, out_dist);
    case 33:
      return launch<33>(form, grid, stream, queries, keys, counts, q_len, n, group_log2,
                        kk, cols, exclude_self, squared, out_idx, out_dist);
    default:
      return launch<38>(form, grid, stream, queries, keys, counts, q_len, n, group_log2,
                        kk, cols, exclude_self, squared, out_idx, out_dist);
  }
}

}  // extern "C"
