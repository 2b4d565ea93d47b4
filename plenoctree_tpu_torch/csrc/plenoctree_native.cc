// Native host library of plenoctree_tpu_torch: the port's own copy of the
// JAX package's native/cc/plenoctree_native.cc, bound with ctypes by
// plenoctree_tpu_torch/native.py (built at first use with g++ -O3
// -std=c++17 -shared -fPIC, the JAX package's flags, into build/native/).
//
// Everything below the includes is that file as it stands, byte for byte
// (tests/test_torch_native.py checks it): the median cut's comparator, its
// nth_element call and its double-precision sums decide the palette, so an
// edit here would make the port's compress CLI write another file than the
// JAX CLI does on the same host.
//
// Entry points (C ABI):
//   pn_build_octree   — bottom-up construction of the child/parent arrays
//                       from the occupied voxel coordinates at depth d (one
//                       sort over Morton codes instead of depth rounds of
//                       descend + refine).
//   pn_median_cut     — k-d median-cut palette quantization.
//   pn_query_points   — batch point -> leaf descent (tree coordinates).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// Interleave 3x21-bit coordinates into a 63-bit Morton code.
static inline uint64_t expand_bits(uint64_t v) {
  v &= 0x1fffff;
  v = (v | (v << 32)) & 0x1f00000000ffffULL;
  v = (v | (v << 16)) & 0x1f0000ff0000ffULL;
  v = (v | (v << 8)) & 0x100f00f00f00f00fULL;
  v = (v | (v << 4)) & 0x10c30c30c30c30c3ULL;
  v = (v | (v << 2)) & 0x1249249249249249ULL;
  return v;
}

static inline uint64_t morton3(uint32_t x, uint32_t y, uint32_t z) {
  return (expand_bits(x) << 2) | (expand_bits(y) << 1) | expand_bits(z);
}

// Build an N=2 octree from occupied voxel integer coords at resolution
// 2^(depth+1) (i.e. leaf cells at node depth `depth`).
//
// Args:
//   coords   [n, 3] int32 voxel coordinates in [0, 2^(depth+1)).
//   n        number of coords.
//   depth    target max node depth (cells of nodes at this depth are leaves).
//   child    out [capacity, 8] int32 (relative child offsets, 0 = leaf).
//   parent_depth out [capacity, 2] int32 (packed parent ptr, node depth).
//   capacity allocated rows in child/parent_depth.
// Returns the number of internal nodes written, or -1 if capacity was
// insufficient (caller re-allocs and retries), -2 on invalid input.
int64_t pn_build_octree(const int32_t* coords, int64_t n, int32_t depth,
                        int32_t* child, int32_t* parent_depth,
                        int64_t capacity) {
  if (depth < 0 || n < 0) return -2;
  const int levels = depth + 1;  // cell levels: root cells .. leaf cells
  // Morton-encode and sort unique codes of the deepest cells.
  std::vector<uint64_t> codes(n);
  for (int64_t i = 0; i < n; ++i) {
    codes[i] = morton3((uint32_t)coords[i * 3 + 0], (uint32_t)coords[i * 3 + 1],
                       (uint32_t)coords[i * 3 + 2]);
  }
  std::sort(codes.begin(), codes.end());
  codes.erase(std::unique(codes.begin(), codes.end()), codes.end());

  // Per level l (0 = root node), the set of *nodes* is the unique set of
  // code prefixes of length 3*l bits. Nodes at level `depth` hold leaf
  // cells only. We place nodes level by level (BFS order: root first),
  // which matches the allocation order the incremental refine produces.
  if (capacity < 1) return -1;
  // node list per level: prefix codes.
  std::vector<std::vector<uint64_t>> level_nodes(levels);
  {
    std::vector<uint64_t> cur(codes);  // node codes at level `depth`
    for (int l = depth; l >= 1; --l) {
      for (auto& c : cur) c >>= 3;  // parent node code
      cur.erase(std::unique(cur.begin(), cur.end()), cur.end());
      level_nodes[l] = cur;  // nodes at level l (children of level l-1 cells)
    }
  }
  // level 0: the root node (code 0, conceptually empty prefix).
  int64_t total = 1;
  for (int l = 1; l < levels; ++l) total += (int64_t)level_nodes[l].size();
  if (total > capacity) return -1;

  std::memset(child, 0, sizeof(int32_t) * capacity * 8);
  std::memset(parent_depth, 0, sizeof(int32_t) * capacity * 2);
  parent_depth[0] = -1;
  parent_depth[1] = 0;

  // Assign node ids in BFS order; remember id by (level, index-in-level).
  // For linking, we need each node's parent id: parent code = code >> 3,
  // parent cell = code & 7. Node codes at level l are sorted, so parent
  // lookup is a binary search in level l-1's code list.
  std::vector<int64_t> level_offset(levels, 0);
  level_offset[0] = 0;
  int64_t next_id = 1;
  for (int l = 1; l < levels; ++l) {
    level_offset[l] = next_id;
    next_id += (int64_t)level_nodes[l].size();
  }

  for (int l = 1; l < levels; ++l) {
    const auto& nodes = level_nodes[l];
    const auto* parent_level = (l == 1) ? nullptr : &level_nodes[l - 1];
    for (size_t i = 0; i < nodes.size(); ++i) {
      uint64_t code = nodes[i];
      uint64_t pcode = code >> 3;
      int cell = (int)(code & 7);
      int64_t pid;
      if (l == 1) {
        pid = 0;
      } else {
        auto it = std::lower_bound(parent_level->begin(), parent_level->end(),
                                   pcode);
        pid = level_offset[l - 1] + (it - parent_level->begin());
      }
      int64_t id = level_offset[l] + (int64_t)i;
      child[pid * 8 + cell] = (int32_t)(id - pid);
      parent_depth[id * 2 + 0] = (int32_t)(pid * 8 + cell);
      parent_depth[id * 2 + 1] = (int32_t)l;
    }
  }
  return next_id;
}

// Batch point -> leaf descent. Positions in tree coords [0, 1).
// child: [n_nodes, 8] relative offsets. Outputs per point: flat leaf cell
// index (node*8 + cell) and node depth.
void pn_query_points(const int32_t* child, int64_t n_nodes, const float* pos,
                     int64_t n_pts, int32_t max_depth, int64_t* out_cell,
                     int32_t* out_depth) {
  (void)n_nodes;
  for (int64_t i = 0; i < n_pts; ++i) {
    float x = pos[i * 3], y = pos[i * 3 + 1], z = pos[i * 3 + 2];
    x = x < 0 ? 0 : (x >= 1 ? 0.9999999f : x);
    y = y < 0 ? 0 : (y >= 1 ? 0.9999999f : y);
    z = z < 0 ? 0 : (z >= 1 ? 0.9999999f : z);
    int64_t node = 0;
    int32_t d = 0;
    for (int l = 0; l <= max_depth; ++l) {
      int ix = (int)(x * 2), iy = (int)(y * 2), iz = (int)(z * 2);
      ix = ix > 1 ? 1 : ix;
      iy = iy > 1 ? 1 : iy;
      iz = iz > 1 ? 1 : iz;
      int cell = ix * 4 + iy * 2 + iz;
      int32_t rel = child[node * 8 + cell];
      if (rel == 0) {
        out_cell[i] = node * 8 + cell;
        out_depth[i] = d;
        break;
      }
      node += rel;
      d += 1;
      x = x * 2 - ix;
      y = y * 2 - iy;
      z = z * 2 - iz;
      if (l == max_depth) {
        out_cell[i] = node * 8 + cell;
        out_depth[i] = d;
      }
    }
  }
}

// k-d median-cut palette quantization.
//   colors [m, c] float32, weights [m] (or null), levels = split rounds.
//   out_ids [m] uint32 (dense palette ids), out_palette [max_palette, c],
//   returns palette size (<= 1 << levels), or -1 if max_palette too small.
int64_t pn_median_cut(const float* colors, const float* weights, int64_t m,
                      int32_t c, int32_t levels, uint32_t* out_ids,
                      float* out_palette, int64_t max_palette) {
  if (m == 0) return 0;
  std::vector<int64_t> order(m);
  std::iota(order.begin(), order.end(), 0);
  // Boxes as contiguous ranges of `order`: (start, end) pairs.
  std::vector<std::pair<int64_t, int64_t>> boxes{{0, m}};
  for (int32_t lvl = 0; lvl < levels; ++lvl) {
    std::vector<std::pair<int64_t, int64_t>> next;
    next.reserve(boxes.size() * 2);
    for (auto [s, e] : boxes) {
      if (e - s <= 1) {
        next.push_back({s, e});
        continue;
      }
      // Longest axis of this box.
      std::vector<float> lo(c, 1e30f), hi(c, -1e30f);
      for (int64_t i = s; i < e; ++i) {
        const float* col = colors + order[i] * c;
        for (int32_t k = 0; k < c; ++k) {
          lo[k] = std::min(lo[k], col[k]);
          hi[k] = std::max(hi[k], col[k]);
        }
      }
      int32_t axis = 0;
      float best = -1e30f;
      for (int32_t k = 0; k < c; ++k) {
        if (hi[k] - lo[k] > best) {
          best = hi[k] - lo[k];
          axis = k;
        }
      }
      int64_t mid = s + (e - s + 1) / 2;
      std::nth_element(order.begin() + s, order.begin() + mid,
                       order.begin() + e, [&](int64_t a, int64_t b) {
                         return colors[a * c + axis] < colors[b * c + axis];
                       });
      next.push_back({s, mid});
      next.push_back({mid, e});
    }
    boxes = std::move(next);
  }
  if ((int64_t)boxes.size() > max_palette) return -1;
  // Weighted means + id assignment.
  int64_t p = 0;
  for (auto [s, e] : boxes) {
    if (e <= s) continue;
    double wsum = 0.0;
    std::vector<double> csum(c, 0.0);
    for (int64_t i = s; i < e; ++i) {
      int64_t idx = order[i];
      double w = weights ? (double)weights[idx] : 1.0;
      wsum += w;
      for (int32_t k = 0; k < c; ++k) csum[k] += colors[idx * c + k] * w;
      out_ids[idx] = (uint32_t)p;
    }
    if (wsum <= 0) wsum = 1.0;
    for (int32_t k = 0; k < c; ++k)
      out_palette[p * c + k] = (float)(csum[k] / wsum);
    ++p;
  }
  return p;
}

}  // extern "C"
