// Native binned-SAH BVH builder.
//
// The host-side counterpart of the reference's BVH construction
// (RaytracerCore/Raytracing/Acceleration/BVH.cs:193-236 — agglomerative in
// the reference; contract here is the flattened skip-link layout, not the
// build algorithm).  The pure-numpy builder in ../bvh/builder.py is the
// readable specification; this C++ version exists for the million-triangle
// configurations where Python recursion and per-node numpy reductions are
// the bottleneck.  The port's own copy of the JAX package's
// native/bvh_builder.cpp: host code, no CUDA.
//
// Emits nodes in preorder with escape ("skip") links and fixed-K leaf slots,
// exactly matching bvh/builder.py::BVHArrays.
//
// Built at first use by ../bvh/native.py with the host C++ compiler:
//   c++ -O3 -shared -fPIC -o build/libbvh_<hash>.so bvh_builder.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
inline float half_area(const Vec3 &lo, const Vec3 &hi) {
  float dx = std::max(hi.x - lo.x, 0.f);
  float dy = std::max(hi.y - lo.y, 0.f);
  float dz = std::max(hi.z - lo.z, 0.f);
  return dx * dy + dy * dz + dz * dx;
}

constexpr int kBins = 16;

struct Builder {
  const Vec3 *bmin;
  const Vec3 *bmax;
  std::vector<Vec3> centers;
  int leaf_size;

  std::vector<Vec3> node_bmin, node_bmax;
  std::vector<int32_t> skip, leaf_slot;
  std::vector<int32_t> leaf_prims;  // [n_leaves * leaf_size]

  // Recursive preorder emission over an index range [lo, hi) of `order`.
  std::vector<int32_t> order;

  void emit(int lo, int hi) {
    Vec3 nb_lo = bmin[order[lo]], nb_hi = bmax[order[lo]];
    for (int i = lo + 1; i < hi; ++i) {
      nb_lo = vmin(nb_lo, bmin[order[i]]);
      nb_hi = vmax(nb_hi, bmax[order[i]]);
    }
    const int me = static_cast<int>(node_bmin.size());
    node_bmin.push_back(nb_lo);
    node_bmax.push_back(nb_hi);
    skip.push_back(-1);
    leaf_slot.push_back(-1);

    const int n = hi - lo;
    if (n <= leaf_size) {
      leaf_slot[me] = static_cast<int32_t>(leaf_prims.size() / leaf_size);
      for (int i = 0; i < leaf_size; ++i)
        leaf_prims.push_back(i < n ? order[lo + i] : -1);
      skip[me] = static_cast<int32_t>(node_bmin.size());
      return;
    }

    // Centroid bounds + widest axis.
    Vec3 c_lo = centers[order[lo]], c_hi = c_lo;
    for (int i = lo + 1; i < hi; ++i) {
      c_lo = vmin(c_lo, centers[order[i]]);
      c_hi = vmax(c_hi, centers[order[i]]);
    }
    const float ext[3] = {c_hi.x - c_lo.x, c_hi.y - c_lo.y, c_hi.z - c_lo.z};
    int axis = 0;
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;

    int mid;
    if (ext[axis] <= 0.f) {
      mid = lo + n / 2;  // all centers identical
    } else {
      const float c0 = axis == 0 ? c_lo.x : (axis == 1 ? c_lo.y : c_lo.z);
      const float inv = kBins / ext[axis];
      auto bin_of = [&](int32_t t) {
        const Vec3 &c = centers[t];
        const float v = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
        int b = static_cast<int>((v - c0) * inv);
        return std::min(std::max(b, 0), kBins - 1);
      };

      // Bin stats.
      int counts[kBins] = {0};
      Vec3 blo[kBins], bhi[kBins];
      for (int b = 0; b < kBins; ++b) {
        blo[b] = {std::numeric_limits<float>::max(),
                  std::numeric_limits<float>::max(),
                  std::numeric_limits<float>::max()};
        bhi[b] = {-std::numeric_limits<float>::max(),
                  -std::numeric_limits<float>::max(),
                  -std::numeric_limits<float>::max()};
      }
      for (int i = lo; i < hi; ++i) {
        const int b = bin_of(order[i]);
        ++counts[b];
        blo[b] = vmin(blo[b], bmin[order[i]]);
        bhi[b] = vmax(bhi[b], bmax[order[i]]);
      }

      // Sweep SAH.
      float l_area[kBins], r_area[kBins];
      int l_count[kBins];
      {
        Vec3 lo_acc = blo[0], hi_acc = bhi[0];
        int cnt = 0;
        for (int b = 0; b < kBins; ++b) {
          if (b) {
            lo_acc = vmin(lo_acc, blo[b]);
            hi_acc = vmax(hi_acc, bhi[b]);
          }
          cnt += counts[b];
          l_area[b] = half_area(lo_acc, hi_acc);
          l_count[b] = cnt;
        }
        Vec3 rlo = blo[kBins - 1], rhi = bhi[kBins - 1];
        for (int b = kBins - 1; b >= 0; --b) {
          if (b < kBins - 1) {
            rlo = vmin(rlo, blo[b]);
            rhi = vmax(rhi, bhi[b]);
          }
          r_area[b] = half_area(rlo, rhi);
        }
      }
      float best_cost = std::numeric_limits<float>::max();
      int best_split = -1;
      for (int b = 1; b < kBins; ++b) {
        const int nl = l_count[b - 1];
        const int nr = n - nl;
        if (nl == 0 || nr == 0) continue;
        const float cost = l_area[b - 1] * nl + r_area[b] * nr;
        if (cost < best_cost) {
          best_cost = cost;
          best_split = b;
        }
      }

      if (best_split < 0) {
        // Degenerate: median split on the axis.
        std::nth_element(order.begin() + lo, order.begin() + lo + n / 2,
                         order.begin() + hi, [&](int32_t a, int32_t b2) {
                           const Vec3 &ca = centers[a];
                           const Vec3 &cb = centers[b2];
                           const float va =
                               axis == 0 ? ca.x : (axis == 1 ? ca.y : ca.z);
                           const float vb =
                               axis == 0 ? cb.x : (axis == 1 ? cb.y : cb.z);
                           return va < vb;
                         });
        mid = lo + n / 2;
      } else {
        auto it = std::partition(
            order.begin() + lo, order.begin() + hi,
            [&](int32_t t) { return bin_of(t) < best_split; });
        mid = static_cast<int>(it - order.begin());
        if (mid == lo || mid == hi) mid = lo + n / 2;
      }
    }

    emit(lo, mid);
    emit(mid, hi);
    skip[me] = static_cast<int32_t>(node_bmin.size());
  }
};

}  // namespace

extern "C" {

// Returns 0 on success.  Output buffers must be sized for the worst case:
// nodes ≤ 2*ceil(n/1)… precisely ≤ 2*n_leaves-1 with n_leaves ≤ n; callers
// pass capacity 2*n (+1) nodes and n_leaves*leaf_size prim slots.
int rtc_build_bvh(const float *tri_bmin, const float *tri_bmax, int n_tris,
                  int leaf_size, float *out_bmin, float *out_bmax,
                  int32_t *out_skip, int32_t *out_leaf_slot,
                  int32_t *out_leaf_prims, int32_t *out_n_nodes,
                  int32_t *out_n_leaves) {
  if (n_tris <= 0 || leaf_size <= 0) return 1;
  Builder b;
  b.bmin = reinterpret_cast<const Vec3 *>(tri_bmin);
  b.bmax = reinterpret_cast<const Vec3 *>(tri_bmax);
  b.leaf_size = leaf_size;
  b.centers.resize(n_tris);
  for (int i = 0; i < n_tris; ++i) {
    b.centers[i] = {(b.bmin[i].x + b.bmax[i].x) * 0.5f,
                    (b.bmin[i].y + b.bmax[i].y) * 0.5f,
                    (b.bmin[i].z + b.bmax[i].z) * 0.5f};
  }
  b.order.resize(n_tris);
  for (int i = 0; i < n_tris; ++i) b.order[i] = i;

  b.node_bmin.reserve(2 * n_tris);
  b.emit(0, n_tris);

  const int n_nodes = static_cast<int>(b.node_bmin.size());
  const int n_leaves = static_cast<int>(b.leaf_prims.size()) / leaf_size;
  std::memcpy(out_bmin, b.node_bmin.data(), n_nodes * sizeof(Vec3));
  std::memcpy(out_bmax, b.node_bmax.data(), n_nodes * sizeof(Vec3));
  std::memcpy(out_skip, b.skip.data(), n_nodes * sizeof(int32_t));
  std::memcpy(out_leaf_slot, b.leaf_slot.data(), n_nodes * sizeof(int32_t));
  std::memcpy(out_leaf_prims, b.leaf_prims.data(),
              b.leaf_prims.size() * sizeof(int32_t));
  *out_n_nodes = n_nodes;
  *out_n_leaves = n_leaves;
  return 0;
}
}
