// Native host-side geometry kernels for the roitr_torch data loader.
//
// Fills the role Open3D's C++ core plays in the reference input pipeline
// (dataset/tdmatch.py:120-127: KDTree kNN-33 normal estimation per pair):
// a compact 3-D KD-tree with k-NN queries and PCA normal estimation
// (smallest-eigenvalue eigenvector of the neighborhood covariance via a
// closed-form symmetric 3x3 eigen-solver), plus viewpoint redirection.
//
// Exposed through a C ABI consumed with ctypes (roitr_torch/native/__init__.py).
// Built at first use by roitr_torch/native/__init__.py (g++ -O3 -shared -fPIC)
// into build/roitr_torch/. The port's own copy of roitr_tpu/native/kdtree.cpp.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

struct KDNode {
  int32_t left = -1;
  int32_t right = -1;
  int32_t start = 0;  // leaf: [start, end) into indices
  int32_t end = 0;
  int8_t axis = -1;   // -1 marks a leaf
  float split = 0.f;
  float bmin[3], bmax[3];
};

class KDTree {
 public:
  KDTree(const float* pts, int n) : pts_(pts), n_(n), idx_(n) {
    for (int i = 0; i < n; ++i) idx_[i] = i;
    nodes_.reserve(2 * std::max(n / kLeaf, 1));
    root_ = build(0, n);
  }

  // k nearest neighbors of q; returns count written (<= k), ascending dist.
  int query(const float* q, int k, int32_t* out_idx, float* out_dist) const {
    Heap heap(k);
    search(root_, q, heap);
    int cnt = static_cast<int>(heap.data.size());
    // heap holds the k nearest as a max-heap; extract ascending
    std::sort_heap(heap.data.begin(), heap.data.end(), HeapCmp{});
    for (int i = 0; i < cnt; ++i) {
      out_idx[i] = heap.data[i].second;
      out_dist[i] = std::sqrt(heap.data[i].first);
    }
    return cnt;
  }

 private:
  static constexpr int kLeaf = 16;
  using Entry = std::pair<float, int32_t>;  // (sq dist, index)
  struct HeapCmp {
    bool operator()(const Entry& a, const Entry& b) const { return a.first < b.first; }
  };
  struct Heap {
    explicit Heap(int k) : cap(k) { data.reserve(k); }
    void push(float d, int32_t i) {
      if (static_cast<int>(data.size()) < cap) {
        data.emplace_back(d, i);
        std::push_heap(data.begin(), data.end(), HeapCmp{});
      } else if (d < data.front().first) {
        std::pop_heap(data.begin(), data.end(), HeapCmp{});
        data.back() = {d, i};
        std::push_heap(data.begin(), data.end(), HeapCmp{});
      }
    }
    float worst() const {
      return static_cast<int>(data.size()) < cap ? 1e30f : data.front().first;
    }
    int cap;
    mutable std::vector<Entry> data;
  };

  int32_t build(int start, int end) {
    KDNode node;
    node.start = start;
    node.end = end;
    for (int d = 0; d < 3; ++d) {
      node.bmin[d] = 1e30f;
      node.bmax[d] = -1e30f;
    }
    for (int i = start; i < end; ++i) {
      const float* p = pts_ + 3 * idx_[i];
      for (int d = 0; d < 3; ++d) {
        node.bmin[d] = std::min(node.bmin[d], p[d]);
        node.bmax[d] = std::max(node.bmax[d], p[d]);
      }
    }
    int32_t id = static_cast<int32_t>(nodes_.size());
    nodes_.push_back(node);
    if (end - start <= kLeaf) return id;

    int axis = 0;
    float best = -1.f;
    for (int d = 0; d < 3; ++d) {
      float ext = node.bmax[d] - node.bmin[d];
      if (ext > best) {
        best = ext;
        axis = d;
      }
    }
    int mid = (start + end) / 2;
    std::nth_element(
        idx_.begin() + start, idx_.begin() + mid, idx_.begin() + end,
        [&](int32_t a, int32_t b) { return pts_[3 * a + axis] < pts_[3 * b + axis]; });
    float split = pts_[3 * idx_[mid] + axis];

    int32_t l = build(start, mid);
    int32_t r = build(mid, end);
    nodes_[id].axis = static_cast<int8_t>(axis);
    nodes_[id].split = split;
    nodes_[id].left = l;
    nodes_[id].right = r;
    return id;
  }

  static float box_sq_dist(const KDNode& node, const float* q) {
    float d2 = 0.f;
    for (int d = 0; d < 3; ++d) {
      float v = std::max({node.bmin[d] - q[d], 0.f, q[d] - node.bmax[d]});
      d2 += v * v;
    }
    return d2;
  }

  void search(int32_t id, const float* q, Heap& heap) const {
    const KDNode& node = nodes_[id];
    if (box_sq_dist(node, q) > heap.worst()) return;
    if (node.axis < 0) {
      for (int i = node.start; i < node.end; ++i) {
        const float* p = pts_ + 3 * idx_[i];
        float d2 = 0.f;
        for (int d = 0; d < 3; ++d) {
          float v = p[d] - q[d];
          d2 += v * v;
        }
        heap.push(d2, idx_[i]);
      }
      return;
    }
    int32_t near = q[node.axis] < node.split ? node.left : node.right;
    int32_t far = near == node.left ? node.right : node.left;
    search(near, q, heap);
    search(far, q, heap);
  }

  const float* pts_;
  int n_;
  std::vector<int32_t> idx_;
  std::vector<KDNode> nodes_;
  int32_t root_;
};

// Smallest-eigenvalue eigenvector of a symmetric 3x3 matrix.
// Analytic method (eigenvalues via trigonometric solution of the cubic,
// eigenvector via cross products of (A - lambda I) rows).
void smallest_eigenvector(const double a[3][3], double v[3]) {
  double p1 = a[0][1] * a[0][1] + a[0][2] * a[0][2] + a[1][2] * a[1][2];
  double q = (a[0][0] + a[1][1] + a[2][2]) / 3.0;
  double b00 = a[0][0] - q, b11 = a[1][1] - q, b22 = a[2][2] - q;
  double p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1;
  double p = std::sqrt(std::max(p2 / 6.0, 1e-30));
  // det(B)/2 with B = (A - qI)/p
  double inv_p = 1.0 / p;
  double m[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) m[i][j] = (a[i][j] - (i == j ? q : 0.0)) * inv_p;
  double detm =
      m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[2][1]) -
      m[0][1] * (m[1][0] * m[2][2] - m[1][2] * m[2][0]) +
      m[0][2] * (m[1][0] * m[2][1] - m[1][1] * m[2][0]);
  double r = std::min(std::max(detm / 2.0, -1.0), 1.0);
  double phi = std::acos(r) / 3.0;
  // eigenvalues: q + 2p cos(phi + 2k pi/3); smallest at k=1 (phi + 2pi/3... )
  double eig_min = q + 2.0 * p * std::cos(phi + 2.0 * M_PI / 3.0);

  // rows of (A - eig_min I)
  double r0[3] = {a[0][0] - eig_min, a[0][1], a[0][2]};
  double r1[3] = {a[0][1], a[1][1] - eig_min, a[1][2]};
  double r2[3] = {a[0][2], a[1][2], a[2][2] - eig_min};
  double c01[3] = {r0[1] * r1[2] - r0[2] * r1[1], r0[2] * r1[0] - r0[0] * r1[2],
                   r0[0] * r1[1] - r0[1] * r1[0]};
  double c02[3] = {r0[1] * r2[2] - r0[2] * r2[1], r0[2] * r2[0] - r0[0] * r2[2],
                   r0[0] * r2[1] - r0[1] * r2[0]};
  double c12[3] = {r1[1] * r2[2] - r1[2] * r2[1], r1[2] * r2[0] - r1[0] * r2[2],
                   r1[0] * r2[1] - r1[1] * r2[0]};
  double n01 = c01[0] * c01[0] + c01[1] * c01[1] + c01[2] * c01[2];
  double n02 = c02[0] * c02[0] + c02[1] * c02[1] + c02[2] * c02[2];
  double n12 = c12[0] * c12[0] + c12[1] * c12[1] + c12[2] * c12[2];
  const double* best = c01;
  double nbest = n01;
  if (n02 > nbest) { best = c02; nbest = n02; }
  if (n12 > nbest) { best = c12; nbest = n12; }
  double norm = std::sqrt(std::max(nbest, 1e-30));
  v[0] = best[0] / norm;
  v[1] = best[1] / norm;
  v[2] = best[2] / norm;
}

}  // namespace

extern "C" {

// k nearest neighbors of each query among pts. out_idx/out_dist: (m, k).
// Slots beyond the available neighbor count are filled with -1 / inf.
void roitr_knn(const float* pts, int32_t n, const float* queries, int32_t m,
               int32_t k, int32_t* out_idx, float* out_dist) {
  KDTree tree(pts, n);
  std::vector<int32_t> idx(k);
  std::vector<float> dist(k);
  for (int i = 0; i < m; ++i) {
    int cnt = tree.query(queries + 3 * i, k, idx.data(), dist.data());
    for (int j = 0; j < k; ++j) {
      out_idx[i * k + j] = j < cnt ? idx[j] : -1;
      out_dist[i * k + j] = j < cnt ? dist[j] : 1e30f;
    }
  }
}

// PCA normals over the k-neighborhood (incl. self), oriented toward the
// view point. normals: (n, 3) output.
void roitr_estimate_normals(const float* pts, int32_t n, int32_t k,
                            const float* view_point, float* normals) {
  if (k > n) k = n;
  KDTree tree(pts, n);
  std::vector<int32_t> idx(k);
  std::vector<float> dist(k);
  for (int i = 0; i < n; ++i) {
    tree.query(pts + 3 * i, k, idx.data(), dist.data());
    double mean[3] = {0, 0, 0};
    for (int j = 0; j < k; ++j) {
      const float* p = pts + 3 * idx[j];
      for (int d = 0; d < 3; ++d) mean[d] += p[d];
    }
    for (int d = 0; d < 3; ++d) mean[d] /= k;
    double cov[3][3] = {{0, 0, 0}, {0, 0, 0}, {0, 0, 0}};
    for (int j = 0; j < k; ++j) {
      const float* p = pts + 3 * idx[j];
      double c[3] = {p[0] - mean[0], p[1] - mean[1], p[2] - mean[2]};
      for (int r = 0; r < 3; ++r)
        for (int cdim = r; cdim < 3; ++cdim) cov[r][cdim] += c[r] * c[cdim];
    }
    for (int r = 0; r < 3; ++r)
      for (int cdim = r; cdim < 3; ++cdim) {
        cov[r][cdim] /= k;
        cov[cdim][r] = cov[r][cdim];
      }
    double v[3];
    smallest_eigenvector(cov, v);
    const float* p = pts + 3 * i;
    double dot = (view_point[0] - p[0]) * v[0] + (view_point[1] - p[1]) * v[1] +
                 (view_point[2] - p[2]) * v[2];
    double s = dot < 0 ? -1.0 : 1.0;
    normals[3 * i + 0] = static_cast<float>(s * v[0]);
    normals[3 * i + 1] = static_cast<float>(s * v[1]);
    normals[3 * i + 2] = static_cast<float>(s * v[2]);
  }
}

// Exact farthest point sampling (reference semantics: seed = index 0,
// sampling_cuda_kernel.cu:39): out_idx gets m indices into pts.
void roitr_fps(const float* pts, int32_t n, int32_t m, int32_t* out_idx) {
  if (m <= 0) return;
  // struct-of-arrays copy so the min-update pass auto-vectorizes
  std::vector<float> xs(n), ys(n), zs(n), dist(n, 1e30f);
  for (int i = 0; i < n; ++i) {
    xs[i] = pts[3 * i];
    ys[i] = pts[3 * i + 1];
    zs[i] = pts[3 * i + 2];
  }
  constexpr int kBlock = 512;
  const int nb = (n + kBlock - 1) / kBlock;
  std::vector<float> block_max(nb);

  int32_t last = 0;
  out_idx[0] = 0;
  for (int s = 1; s < m; ++s) {
    const float lx = xs[last], ly = ys[last], lz = zs[last];
    float* __restrict__ d = dist.data();
    const float* __restrict__ x = xs.data();
    const float* __restrict__ y = ys.data();
    const float* __restrict__ z = zs.data();
    // single pass: branch-free min update + per-block max (both vectorize)
    for (int b = 0; b < nb; ++b) {
      int lo = b * kBlock, hi = std::min(n, lo + kBlock);
      float bm = -1.f;
      for (int i = lo; i < hi; ++i) {
        float dx = x[i] - lx, dy = y[i] - ly, dz = z[i] - lz;
        float d2 = dx * dx + dy * dy + dz * dz;
        float nd = d2 < d[i] ? d2 : d[i];
        d[i] = nd;
        bm = nd > bm ? nd : bm;
      }
      block_max[b] = bm;
    }
    int best_b = 0;
    for (int b = 1; b < nb; ++b)
      if (block_max[b] > block_max[best_b]) best_b = b;
    float best = block_max[best_b];
    int32_t best_i = best_b * kBlock;
    for (int i = best_b * kBlock; i < std::min(n, (best_b + 1) * kBlock); ++i)
      if (d[i] == best) {
        best_i = i;
        break;
      }
    out_idx[s] = best_i;
    last = best_i;
  }
}

}  // extern "C"
