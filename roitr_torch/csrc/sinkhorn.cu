// Log-domain Sinkhorn iterations on padded patch scores, and their reverse
// mode.
//
// Replaces roitr_tpu/ops/pallas/sinkhorn_kernel.py `_sinkhorn_kernel`
// (entries `_pallas_forward`, `sinkhorn_iterate_pallas`) and
// `_sinkhorn_bwd_kernel` (entries `_pallas_backward`, `_vjp_bwd`). For each
// patch p, from u = v = 0, `num_iter` times:
//
//   u[i] = mu[i] - logsumexp_j(s[i, j] + v[j])
//   v[j] = nu[j] - logsumexp_i(s[i, j] + u[i])
//
// then out = s + u + v. Invalid entries arrive as -1e6 (finite), and the
// caller subtracts the normaliser (roitr_tpu/ops/sinkhorn.py:94). The
// reverse mode walks the iterations backwards (a_t, b_t are the row and
// column softmaxes of step t):
//
//   a_t = exp(s + v_{t-1} - mu + u_t),  b_t = exp(s + u_t - nu + v_t)
//   du = sum_j g, dv = sum_i g, ds = g; per t descending:
//     dnu += dv; ds -= dv b_t; du -= sum_j dv b_t
//     dmu += du; ds -= du a_t; dv = -sum_i du a_t; du = 0
//
// Two pairs of kernels, chosen by shape in the C entry points below:
//
// * The line kernels (`sinkhorn_lines_fwd`, `sinkhorn_lines_bwd`) take
//   patches whose rows and columns are at most kLines = 65 long (the main
//   path's point_per_patch 64 plus the dustbin). What bounds them: latency,
//   then the special-function unit. At (256, 65, 65) x 100 the forward's
//   216 M exps take 0.053 ms at the H100's 16 MUFU results a clock an SM,
//   but they come in 200 dependent half-steps of one reduction a line, with
//   one or two patches an SM. Design: one block a patch; every line of the
//   patch is reduced at once, lines 0-63 by groups of two lanes and line 64
//   by a warp of its own, each lane holding its entries of its row and of
//   its column in registers, times log2 e, so that an exp is one MUFU.EX2
//   and the potentials are kept in base 2. The forward keeps each line's
//   entries shifted by a constant of the line and so needs no max pass: an
//   entry is an add, an exp and an add, a half-step one shuffle a group and
//   the new potentials through shared memory with one barrier. Under
//   differentiation the forward writes the trajectory u_t, v_t (natural
//   log) to device memory; the backward reads it a step ahead instead of
//   recomputing it, and forms ds = g - sum_t dv_t b_t - sum_t du_t a_t from
//   two sums kept in the row and the column owners' registers, combined
//   once at the end. Four lanes a line (more shuffles), or one (65 exps in
//   a row a warp, registers spilled), measured slower
//   (tools/torch_sinkhorn_variants.py).
// * The general kernels (`sinkhorn_kernel`, `sinkhorn_bwd_kernel`) take
//   longer lines: the patch stays in shared memory, a warp walks a row or a
//   column, and the backward copies the trajectory into shared memory.
//
// Admission is the same for both pairs and is kept exactly as the general
// kernels need it (kernels/sinkhorn_kernel.py `supported_shape`,
// `supported_shape_bwd`): the forward's patch and potentials, and the
// backward's patch, cotangent, trajectory and five vectors, in a block's
// shared memory.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kSmemBytes = 232448;  // shared memory a block of the H100 can take

// ---- line kernels

constexpr int kLines = 65;      // longest row or column they take
constexpr int kFwdGroup = 2;    // lanes that share one of lines 0-63, forward
constexpr int kBwdGroup = 2;    // and backward
constexpr int kPad = 68;        // a potential vector in shared memory
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// threads a block of a line kernel: groups for lines 0-63 and the warp of line 64
__host__ __device__ constexpr int line_threads(int group) { return 64 * group + 32; }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int W>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = 1; off < W; off <<= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

template <int W>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = 1; off < W; off <<= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The entries of its line that lane q of a group of W lanes holds. W < 32:
// one of lines 0-63, entries kPer * q .. kPer * q + kPer - 1 and, for q = 0,
// entry 64. W = 32: line 64, entries q, q + 32 and, for q = 0, 64.
template <int W>
struct Lane {
  static constexpr bool kLast = W == 32;
  static constexpr int kPer = kLast ? 2 : 64 / W;
  static constexpr int N = kPer + 1;
  static_assert(kLast || kPer % 4 == 0, "lanes read the potentials as float4");
  __device__ static int index(int k, int q) {
    return kLast ? (k < 2 ? q + 32 * k : 64) : (k < kPer ? kPer * q + k : 64);
  }
  __device__ static bool holds(int k, int q, int len) {
    return k < N && (k < N - 1 || q == 0) && index(k, q) < len;
  }
  // out[k] = vec[index(k, q)], vec a potential vector in shared memory
  template <int M>
  __device__ static void gather(const float* vec, int q, float (&out)[M]) {
    if (kLast) {
      out[0] = vec[q];
      out[1] = vec[q + 32];
    } else {
      const float4* v4 = reinterpret_cast<const float4*>(vec + kPer * q);
#pragma unroll
      for (int k = 0; k < kPer / 4; ++k) {
        const float4 t = v4[k];
        out[4 * k] = t.x;
        out[4 * k + 1] = t.y;
        out[4 * k + 2] = t.z;
        out[4 * k + 3] = t.w;
      }
    }
    out[kPer] = vec[64];
  }
};

// x[k] = scale * the lane's entry k of row (or column) `line` of the
// (m1, n1) patch `a` in shared memory; `fill` where the lane holds no entry
// there (past the patch's edge), 0 on a whole line past the edge (such a
// line is reduced like the others and never written).
template <int W, int M>
__device__ __forceinline__ void load_line(const float* a, bool row, int line, int q, int m1,
                                          int n1, float scale, float fill, float (&x)[M]) {
  const int len = row ? n1 : m1;
  const bool on = line < (row ? m1 : n1);
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const int e = Lane<W>::index(k, q);
    x[k] = !on ? 0.f
               : Lane<W>::holds(k, q, len) ? scale * (row ? a[line * n1 + e] : a[e * n1 + line])
                                           : fill;
  }
}

// One forward half-step along a line: log2 sum_k 2^(s2[k] + pot[index(k)])
// over the line's lanes, on every one of them. The lane holds its entries
// shifted, sh[k] = s2[k] - c with c a constant of the line, and sums
// 2^(sh[k] + pot[index(k)]): an add and an exp an entry, no max. While that
// sum stays in [2^-64, 2^64) the shift is kept. On the first step, and
// where a line's sum leaves the range, the line is read again from the
// patch and shifted by the max of s2 + pot (its warp takes that path
// together, for the shuffles). Returns c + log2 of the sum.
template <int W, int M>
__device__ __forceinline__ float line_lse2(float (&sh)[M], float& c, const float* pot,
                                           const float* patch, bool row, int line, int q,
                                           int m1, int n1, bool first) {
  constexpr int N = Lane<W>::N;
  float p[M];
  Lane<W>::gather(pot, q, p);
  float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < N; ++k) a[k & 3] += ex2(sh[k] + p[k]);
  float sum = group_sum<W>((a[0] + a[1]) + (a[2] + a[3]));
  const bool rebase = first || !(sum >= 0x1p-64f && sum < 0x1p64f);
  if (__any_sync(kFull, rebase)) {
    float x[M];
    load_line<W>(patch, row, line, q, m1, n1, kLog2e, -CUDART_INF_F, x);
    float m[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) m[r] = x[r < N ? r : 0] + p[r < N ? r : 0];
#pragma unroll
    for (int k = 4; k < N; ++k) m[k & 3] = fmaxf(m[k & 3], x[k] + p[k]);
    const float mx = group_max<W>(fmaxf(fmaxf(m[0], m[1]), fmaxf(m[2], m[3])));
    float b[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float t = x[k] - mx;
      if (rebase) sh[k] = t;
      b[k & 3] += ex2(t + p[k]);
    }
    const float fresh = group_sum<W>((b[0] + b[1]) + (b[2] + b[3]));
    if (rebase) {
      c = mx;
      sum = fresh;
    }
  }
  return c + lg2(sum);
}

// One reverse half-step along a line: e[k] = 2^((s[k] + shift[index(k)]) +
// own), acc[k] += d[index(k)] e[k]; returns the sum of d e over the line.
template <int W, int M>
__device__ __forceinline__ float line_vjp(const float (&s)[M], float (&acc)[M],
                                          const float* shift, const float* d, float own, int q) {
  constexpr int N = Lane<W>::N;
  float sh[M], dd[M];
  Lane<W>::gather(shift, q, sh);
  Lane<W>::gather(d, q, dd);
  float part[2] = {0.f, 0.f};
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float e = ex2((s[k] + sh[k]) + own);
    acc[k] = fmaf(dd[k], e, acc[k]);
    part[k & 1] = fmaf(dd[k], e, part[k & 1]);
  }
  return group_sum<W>(part[0] + part[1]);
}

// Forward, one block a patch: lines 0-63 by groups of G lanes, line 64 by
// the last warp. u, v are base 2 (u2 = u log2 e) in shared memory; out (if
// given) and the trajectory (kTraj) are natural.
template <int G, bool kTraj>
__global__ void __launch_bounds__(line_threads(G), 2)
sinkhorn_lines_fwd(const float* __restrict__ scores, const float* __restrict__ log_mu,
                   const float* __restrict__ log_nu, float* __restrict__ out,
                   float* __restrict__ traj_u, float* __restrict__ traj_v, int m1, int n1,
                   int num_iter) {
  constexpr int kThreadsG = line_threads(G);
  constexpr int M = Lane<G>::N;
  __shared__ float s[kLines * kLines];
  __shared__ __align__(16) float u[kPad];
  __shared__ __align__(16) float v[kPad];

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const bool grouped = tid < 64 * G;
  const int line = grouped ? tid / G : 64;
  const int q = grouped ? tid % G : tid & 31;
  const size_t base = (size_t)p * m1 * n1;

  for (int e = tid; e < m1 * n1; e += kThreadsG) s[e] = scores[base + e];
  for (int i = tid; i < kPad; i += kThreadsG) u[i] = v[i] = 0.f;
  const bool row_on = line < m1, col_on = line < n1;
  const float mu2 = row_on ? kLog2e * log_mu[(size_t)p * m1 + line] : 0.f;
  const float nu2 = col_on ? kLog2e * log_nu[(size_t)p * n1 + line] : 0.f;
  __syncthreads();

  // the lane's entries of its row and of its column, shifted by cr and cc
  // (set on the first step)
  float sr[M], sc[M], cr = 0.f, cc = 0.f;
#pragma unroll
  for (int k = 0; k < M; ++k) sr[k] = sc[k] = 0.f;
  const bool writer = q == 0;
  // this line's u_t and v_t in the trajectory, (p, num_iter, m1 | n1)
  float* tu = kTraj ? traj_u + (size_t)p * num_iter * m1 + line : nullptr;
  float* tv = kTraj ? traj_v + (size_t)p * num_iter * n1 + line : nullptr;

  for (int it = 0; it < num_iter; ++it) {
    const float lr = grouped ? line_lse2<G>(sr, cr, v, s, true, line, q, m1, n1, it == 0)
                             : line_lse2<32>(sr, cr, v, s, true, line, q, m1, n1, it == 0);
    if (writer && row_on) {
      u[line] = mu2 - lr;
      if (kTraj) *tu = kLn2 * (mu2 - lr);
    }
    __syncthreads();
    const float lc = grouped ? line_lse2<G>(sc, cc, u, s, false, line, q, m1, n1, it == 0)
                             : line_lse2<32>(sc, cc, u, s, false, line, q, m1, n1, it == 0);
    if (writer && col_on) {
      v[line] = nu2 - lc;
      if (kTraj) *tv = kLn2 * (nu2 - lc);
    }
    if (kTraj) {
      tu += m1;
      tv += n1;
    }
    __syncthreads();
  }

  if (out) {
    for (int e = tid; e < m1 * n1; e += kThreadsG) {
      const int i = e / n1;
      const int j = e - i * n1;
      out[base + e] = (s[e] + kLn2 * u[i]) + kLn2 * v[j];
    }
  }
}

// Backward, one block a patch, from the forward's trajectory. A row owner
// keeps sum_t dv_t b_t over its entries, a column owner sum_t du_t a_t.
template <int G>
__global__ void __launch_bounds__(line_threads(G), 1)
sinkhorn_lines_bwd(const float* __restrict__ scores, const float* __restrict__ log_mu,
                   const float* __restrict__ log_nu, const float* __restrict__ g,
                   const float* __restrict__ traj_u, const float* __restrict__ traj_v,
                   float* __restrict__ ds_out, float* __restrict__ dmu_out,
                   float* __restrict__ dnu_out, int m1, int n1, int num_iter) {
  constexpr int kThreadsG = line_threads(G);
  constexpr int M = Lane<G>::N;
  __shared__ float s[kLines * kLines];   // the patch; at the end, g - the row sums
  __shared__ float gs[kLines * kLines];  // the cotangent
  __shared__ __align__(16) float w[kPad];   // per column j: v2_t[j] - nu2[j], b_t's shift
  __shared__ __align__(16) float dv[kPad];
  __shared__ __align__(16) float z[kPad];   // per row i: u2_t[i] - mu2[i], a_t's shift
  __shared__ __align__(16) float du[kPad];

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const bool grouped = tid < 64 * G;
  const int line = grouped ? tid / G : 64;
  const int q = grouped ? tid % G : tid & 31;
  const size_t base = (size_t)p * m1 * n1;

  for (int e = tid; e < m1 * n1; e += kThreadsG) {
    s[e] = scores[base + e];
    gs[e] = g[base + e];
  }
  for (int i = tid; i < kPad; i += kThreadsG) w[i] = dv[i] = z[i] = du[i] = 0.f;
  const bool row_on = line < m1, col_on = line < n1;
  const float mu2 = row_on ? kLog2e * log_mu[(size_t)p * m1 + line] : 0.f;
  const float nu2 = col_on ? kLog2e * log_nu[(size_t)p * n1 + line] : 0.f;
  const float* tu = traj_u + (size_t)p * num_iter * m1;  // (num_iter, m1) of this patch
  const float* tv = traj_v + (size_t)p * num_iter * n1;
  const int last = num_iter - 1;
  float ucur = row_on ? kLog2e * tu[(size_t)last * m1 + line] : 0.f;  // u2_t of the row
  float upf = row_on && last >= 1 ? tu[(size_t)(last - 1) * m1 + line] : 0.f;  // u_{t-1}
  float vpf = col_on && last >= 1 ? tv[(size_t)(last - 1) * n1 + line] : 0.f;  // v_{t-1}
  const float vlast = col_on ? kLog2e * tv[(size_t)last * n1 + line] : 0.f;
  __syncthreads();

  float sr[M], sc[M], rsum[M], csum[M];
  float gsum_row = 0.f, dvc = 0.f;  // the row's sum of g; the column's dv
  {
    float gr[M], gc[M];
    if (grouped) {
      load_line<G>(s, true, line, q, m1, n1, kLog2e, -CUDART_INF_F, sr);
      load_line<G>(s, false, line, q, m1, n1, kLog2e, -CUDART_INF_F, sc);
      load_line<G>(gs, true, line, q, m1, n1, 1.f, 0.f, gr);
      load_line<G>(gs, false, line, q, m1, n1, 1.f, 0.f, gc);
    } else {
      load_line<32>(s, true, line, q, m1, n1, kLog2e, -CUDART_INF_F, sr);
      load_line<32>(s, false, line, q, m1, n1, kLog2e, -CUDART_INF_F, sc);
      load_line<32>(gs, true, line, q, m1, n1, 1.f, 0.f, gr);
      load_line<32>(gs, false, line, q, m1, n1, 1.f, 0.f, gc);
    }
#pragma unroll
    for (int k = 0; k < M; ++k) {
      gsum_row += gr[k];
      dvc += gc[k];
      rsum[k] = csum[k] = 0.f;
    }
    gsum_row = grouped ? group_sum<G>(gsum_row) : group_sum<32>(gsum_row);
    dvc = grouped ? group_sum<G>(dvc) : group_sum<32>(dvc);
  }
  const bool writer = q == 0;
  if (writer && col_on) {
    w[line] = vlast - nu2;
    dv[line] = dvc;
  }
  __syncthreads();

  float dmu = 0.f, dnu = 0.f;
  for (int t = last; t >= 0; --t) {
    // b_t = 2^(s2 + (v2_t - nu2) + u2_t); du = [sum_j g at the last step] - sum_j dv b_t
    const float rs = grouped ? line_vjp<G>(sr, rsum, w, dv, ucur, q)
                             : line_vjp<32>(sr, rsum, w, dv, ucur, q);
    const float dui = (t == last ? gsum_row : 0.f) - rs;
    dmu += dui;
    dnu += dvc;
    if (writer && row_on) {
      du[line] = dui;
      z[line] = ucur - mu2;
    }
    ucur = kLog2e * upf;
    upf = row_on && t >= 2 ? tu[(size_t)(t - 2) * m1 + line] : 0.f;
    __syncthreads();
    // a_t = 2^(s2 + (u2_t - mu2) + v2_{t-1}); dv = -sum_i du a_t
    const float vp = t >= 1 ? kLog2e * vpf : 0.f;
    vpf = col_on && t >= 2 ? tv[(size_t)(t - 2) * n1 + line] : 0.f;
    dvc = -(grouped ? line_vjp<G>(sc, csum, z, du, vp, q)
                    : line_vjp<32>(sc, csum, z, du, vp, q));
    if (writer && col_on) {
      dv[line] = dvc;
      w[line] = vp - nu2;
    }
    __syncthreads();
  }

  // ds = (g - the row owners' sums) - the column owners' sums
  if (row_on) {
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const bool has = grouped ? Lane<G>::holds(k, q, n1) : Lane<32>::holds(k, q, n1);
      const int j = grouped ? Lane<G>::index(k, q) : Lane<32>::index(k, q);
      if (has) s[line * n1 + j] = gs[line * n1 + j] - rsum[k];
    }
  }
  __syncthreads();
  if (col_on) {
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const bool has = grouped ? Lane<G>::holds(k, q, m1) : Lane<32>::holds(k, q, m1);
      const int i = grouped ? Lane<G>::index(k, q) : Lane<32>::index(k, q);
      if (has) s[i * n1 + line] -= csum[k];
    }
  }
  __syncthreads();
  for (int e = tid; e < m1 * n1; e += kThreadsG) ds_out[base + e] = s[e];
  if (writer && row_on) dmu_out[(size_t)p * m1 + line] = dmu;
  if (writer && col_on) dnu_out[(size_t)p * n1 + line] = dnu;
}

// ---- general kernels: lines longer than kLines

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// One block a patch; the (m1, n1) patch and both potentials stay in shared
// memory for all iterations, a warp owns a row (u update) or a column (v
// update) and reduces it with shuffles; the odd row stride keeps column
// walks free of bank conflicts.
__global__ void __launch_bounds__(kThreads)
sinkhorn_kernel(const float* __restrict__ scores, const float* __restrict__ log_mu,
                const float* __restrict__ log_nu, float* __restrict__ out,
                float* __restrict__ traj_u, float* __restrict__ traj_v, int m1, int n1,
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
      if (lane == 0) {
        u[i] = mu[i] - (mx + logf(sum));
        if (traj_u) traj_u[((size_t)p * num_iter + it) * m1 + i] = u[i];
      }
    }
    __syncthreads();
    for (int j = warp; j < n1; j += kWarps) {
      float mx = -CUDART_INF_F;
      for (int i = lane; i < m1; i += 32) mx = fmaxf(mx, s[i * n1 + j] + u[i]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int i = lane; i < m1; i += 32) sum += expf(s[i * n1 + j] + u[i] - mx);
      sum = warp_sum(sum);
      if (lane == 0) {
        v[j] = nu[j] - (mx + logf(sum));
        if (traj_v) traj_v[((size_t)p * num_iter + it) * n1 + j] = v[j];
      }
    }
    __syncthreads();
  }

  if (out) {
    for (int e = tid; e < m1 * n1; e += kThreads) {
      const int i = e / n1;
      const int j = e % n1;
      out[base + e] = s[e] + u[i] + v[j];
    }
  }
}

// One block a patch, everything in shared memory for the whole launch: the
// score patch, the ds accumulator and the u/v trajectory (copied from the
// forward's), as dynamic shared memory. Masked entries (-1e6) decay to
// exactly 0 in the exponents of the valid side, as on the TPU.
__global__ void __launch_bounds__(kThreads)
sinkhorn_bwd_kernel(const float* __restrict__ scores, const float* __restrict__ log_mu,
                    const float* __restrict__ log_nu, const float* __restrict__ g,
                    const float* __restrict__ traj_u, const float* __restrict__ traj_v,
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
  for (int e = tid; e < num_iter * m1; e += kThreads)
    us[e] = traj_u[(size_t)p * num_iter * m1 + e];
  for (int e = tid; e < num_iter * n1; e += kThreads)
    vs[e] = traj_v[(size_t)p * num_iter * n1 + e];
  for (int i = tid; i < m1; i += kThreads) {
    mu[i] = log_mu[(size_t)p * m1 + i];
    dmu[i] = 0.f;
  }
  for (int j = tid; j < n1; j += kThreads) {
    nu[j] = log_nu[(size_t)p * n1 + j];
    dnu[j] = 0.f;
  }
  __syncthreads();

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

bool line_shape(int m1, int n1) { return m1 <= kLines && n1 <= kLines; }

size_t general_fwd_smem(int m1, int n1) {
  return sizeof(float) * ((size_t)m1 * n1 + 2 * (size_t)m1 + 2 * (size_t)n1);
}

size_t general_bwd_smem(int m1, int n1, int num_iter) {
  return sizeof(float) * (2 * (size_t)m1 * n1 + (size_t)num_iter * (m1 + n1) +
                          3 * ((size_t)m1 + n1));
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  const cudaError_t set =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (set != cudaSuccess) cudaGetLastError();  // clear it, so the next launch is not blamed
  return set;
}

}  // namespace

// Forward: out (may be null) = s + u + v after num_iter steps; with traj_u
// and traj_v (null or both given), every step's u (p, num_iter, m1) and v
// (p, num_iter, n1). Lines of at most 65 take the line kernel, longer ones
// the general kernel; a patch whose scores and potentials exceed a block's
// shared memory is refused (cudaErrorInvalidValue) before any launch.
extern "C" int roitr_sinkhorn(const float* scores, const float* log_mu, const float* log_nu,
                              float* out, float* traj_u, float* traj_v, int p, int m1, int n1,
                              int num_iter, void* stream) {
  if (p < 0 || m1 < 1 || n1 < 1 || num_iter < 0 || general_fwd_smem(m1, n1) > kSmemBytes)
    return (int)cudaErrorInvalidValue;
  if (p == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (line_shape(m1, n1)) {
    if (traj_u)
      sinkhorn_lines_fwd<kFwdGroup, true><<<p, line_threads(kFwdGroup), 0, st>>>(
          scores, log_mu, log_nu, out, traj_u, traj_v, m1, n1, num_iter);
    else
      sinkhorn_lines_fwd<kFwdGroup, false><<<p, line_threads(kFwdGroup), 0, st>>>(
          scores, log_mu, log_nu, out, nullptr, nullptr, m1, n1, num_iter);
    return (int)cudaGetLastError();
  }
  const size_t smem = general_fwd_smem(m1, n1);
  const cudaError_t set = set_smem((const void*)sinkhorn_kernel, smem);
  if (set != cudaSuccess) return (int)set;
  sinkhorn_kernel<<<p, kThreads, smem, st>>>(scores, log_mu, log_nu, out, traj_u, traj_v, m1, n1,
                                             num_iter);
  return (int)cudaGetLastError();
}

// Backward from the trajectory traj_u, traj_v; with make_traj, the forward
// kernel first writes it there (the caller's scratch). Refused, before any
// launch, for num_iter < 1 and where the general kernel's patch, cotangent,
// trajectory and vectors exceed a block's shared memory, whichever kernel
// the shape takes.
extern "C" int roitr_sinkhorn_bwd(const float* scores, const float* log_mu, const float* log_nu,
                                  const float* g, float* traj_u, float* traj_v, int make_traj,
                                  float* ds, float* dmu, float* dnu, int p, int m1, int n1,
                                  int num_iter, void* stream) {
  if (p < 0 || m1 < 1 || n1 < 1 || num_iter < 1 || general_bwd_smem(m1, n1, num_iter) > kSmemBytes)
    return (int)cudaErrorInvalidValue;
  if (p == 0) return 0;
  if (make_traj) {
    const int err = roitr_sinkhorn(scores, log_mu, log_nu, nullptr, traj_u, traj_v, p, m1, n1,
                                   num_iter, stream);
    if (err) return err;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  if (line_shape(m1, n1)) {
    sinkhorn_lines_bwd<kBwdGroup><<<p, line_threads(kBwdGroup), 0, st>>>(
        scores, log_mu, log_nu, g, traj_u, traj_v, ds, dmu, dnu, m1, n1, num_iter);
    return (int)cudaGetLastError();
  }
  const size_t smem = general_bwd_smem(m1, n1, num_iter);
  const cudaError_t set = set_smem((const void*)sinkhorn_bwd_kernel, smem);
  if (set != cudaSuccess) return (int)set;
  sinkhorn_bwd_kernel<<<p, kThreads, smem, st>>>(scores, log_mu, log_nu, g, traj_u, traj_v, ds,
                                                 dmu, dnu, m1, n1, num_iter);
  return (int)cudaGetLastError();
}

// Resident blocks an SM, and threads a block, of the line kernels: the
// forward without (which = 0) and with (1) the trajectory, the backward (2).
extern "C" int roitr_sinkhorn_lines_blocks_per_sm(int which, int* blocks, int* threads) {
  const void* kernel = which == 0   ? (const void*)sinkhorn_lines_fwd<kFwdGroup, false>
                       : which == 1 ? (const void*)sinkhorn_lines_fwd<kFwdGroup, true>
                                    : (const void*)sinkhorn_lines_bwd<kBwdGroup>;
  *threads = which == 2 ? line_threads(kBwdGroup) : line_threads(kFwdGroup);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, *threads, 0);
}
