// Native wide-BVH collapse: the C++ twin of accel/bvh8.py::build_wide_bvh.
// Collapses the binary SAH tree into the 8-ary tables of the walk (K3,
// ops/walk.py). Its output is bit-identical to the NumPy collapse
// (tests/test_torch_native.py; NaN-aware on the boxes): the same expansion
// rule (repeatedly split the largest still-oversized
// interior element, first-max on ties), the same pre-order node/group
// emission, f32 child-box centers promoted to f64 for the octant sort
// keys, stable descending sort, and identical f32 min/max sweeps for the
// sub-cluster boxes.
//
// The sign products of the octant keys are exact and the sub-cluster box
// sums are single adds, so no multiply-add is there to contract; the
// library is built with -ffp-contract=off all the same.
//
// A plain C ABI for ctypes; accel/native.py compiles it together with
// bvh_builder.cpp, flatten.cpp and potpack.cpp into one library.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int WIDTH = 8;

const float kZeroBox[3] = {0.0f, 0.0f, 0.0f};

struct Ctx {
  // inputs
  const float* amin = nullptr;    // (nnodes, 3)
  const float* amax = nullptr;    // (nnodes, 3)
  const int32_t* meta = nullptr;  // (nnodes, 4) [left, right, offset, count]
  const float* tri = nullptr;     // (T, 9) [v0, e1, e2]
  int64_t T = 0;
  int32_t leaf_slots = 0;
  int32_t sub = 0;
  int32_t grows = 0;
  int32_t lanes = 0;  // slab lane width = max(leaf_slots, 128)
  int32_t pack = 0;   // 0 = one subtree per group, 1 = FFD bin-pack
  // derived
  std::vector<int64_t> lo, hi;  // subtree triangle ranges
  // emission state
  bool emit;
  int64_t nn = 0, ng = 0;
  int64_t nn_cap = 0, ng_cap = 0;
  bool overflow = false;
  int32_t* wmeta = nullptr;       // (nn, 8) child slot metas (unpermuted)
  float* wtris = nullptr;         // (ng * grows, 128)
  std::vector<float> nodeboxes;   // nn * 8 slots * 6 bounds (child-major)
  // Per leaf group: (lo, count) triangle ranges. pack=1 groups may hold
  // several small sibling subtrees (Python: emit_group_multi).
  std::vector<std::vector<std::pair<int64_t, int64_t>>> groups;
};

inline bool is_leaf(const Ctx& c, int64_t b) { return c.meta[4 * b + 3] > 0; }
inline int64_t count_of(const Ctx& c, int64_t b) { return c.hi[b] - c.lo[b]; }

void subtree_ranges(Ctx& c, int64_t nnodes) {
  c.lo.assign(nnodes, 0);
  c.hi.assign(nnodes, 0);
  for (int64_t i = 0; i < nnodes; ++i) {
    if (is_leaf(c, i)) {
      c.lo[i] = c.meta[4 * i + 2];
      c.hi[i] = c.meta[4 * i + 2] + c.meta[4 * i + 3];
    }
  }
  for (int64_t i = nnodes - 1; i >= 0; --i) {
    if (!is_leaf(c, i) && c.meta[4 * i] >= 0) {
      const int64_t l = c.meta[4 * i], r = c.meta[4 * i + 1];
      c.lo[i] = std::min(c.lo[l], c.lo[r]);
      c.hi[i] = std::max(c.hi[l], c.hi[r]);
    }
  }
}

int64_t alloc_node(Ctx& c) {
  const int64_t nid = c.nn++;
  if (c.emit) {
    if (nid >= c.nn_cap) {
      c.overflow = true;
    } else {
      for (int k = 0; k < WIDTH; ++k) c.wmeta[nid * WIDTH + k] = 0;
      c.nodeboxes.resize((nid + 1) * WIDTH * 6,
                         std::numeric_limits<float>::quiet_NaN());
    }
  }
  return nid;
}

int64_t emit_group(Ctx& c, int64_t glo, int64_t gcnt) {
  const int64_t gid = c.ng++;
  if (c.emit) {
    if (gid >= c.ng_cap) {
      c.overflow = true;
    } else {
      c.groups[gid] = {{glo, gcnt}};
    }
  }
  return -(gid + 1);
}

// Multi-subtree group (pack=1): members sorted ascending by range start,
// exactly like Python's emit_group_multi.
int64_t emit_group_multi(Ctx& c, const std::vector<int64_t>& members) {
  const int64_t gid = c.ng++;
  if (c.emit) {
    if (gid >= c.ng_cap) {
      c.overflow = true;
    } else {
      std::vector<int64_t> order(members);
      std::stable_sort(order.begin(), order.end(),
                       [&](int64_t a, int64_t b) { return c.lo[a] < c.lo[b]; });
      auto& g = c.groups[gid];
      g.clear();
      for (const int64_t e : order) g.emplace_back(c.lo[e], count_of(c, e));
    }
  }
  return -(gid + 1);
}

// First-fit-decreasing bin-pack of small subtrees into leaf_slots-capacity
// groups. Mirrors Python's _pack_bins exactly: stable descending sort by
// count (input order breaks ties), first bin with room wins.
std::vector<std::vector<int64_t>> pack_bins(const Ctx& c,
                                            const std::vector<int64_t>& smalls) {
  std::vector<size_t> order(smalls.size());
  for (size_t i = 0; i < smalls.size(); ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](size_t a, size_t b) {
    return count_of(c, smalls[a]) > count_of(c, smalls[b]);
  });
  std::vector<std::vector<int64_t>> bins;
  std::vector<int64_t> room;
  for (const size_t i : order) {
    const int64_t e = smalls[i];
    const int64_t cnt = count_of(c, e);
    bool placed = false;
    for (size_t k = 0; k < bins.size(); ++k) {
      if (room[k] >= cnt) {
        bins[k].push_back(e);
        room[k] -= cnt;
        placed = true;
        break;
      }
    }
    if (!placed) {
      bins.push_back({e});
      room.push_back(c.leaf_slots - cnt);
    }
  }
  return bins;
}

int64_t slot_demand(const Ctx& c, const std::vector<int64_t>& es) {
  std::vector<int64_t> smalls;
  int64_t overs = 0;
  for (const int64_t e : es) {
    if (count_of(c, e) <= c.leaf_slots) {
      smalls.push_back(e);
    } else {
      ++overs;
    }
  }
  if (c.pack == 1) return overs + (int64_t)pack_bins(c, smalls).size();
  return overs + (int64_t)smalls.size();
}

struct Slot {
  int64_t m;      // meta value (matches Python ints)
  float box[6];   // owned min/max bounds (union boxes have no array home)
};

Slot make_slot(int64_t m, const float* bmn, const float* bmx) {
  Slot s;
  s.m = m;
  for (int j = 0; j < 3; ++j) s.box[j] = bmn[j];
  for (int j = 0; j < 3; ++j) s.box[3 + j] = bmx[j];
  return s;
}

// Union of member node boxes — f32 min/max like NumPy's _union_box.
Slot make_union_slot(const Ctx& c, int64_t m,
                     const std::vector<int64_t>& members) {
  Slot s;
  s.m = m;
  for (int j = 0; j < 6; ++j) s.box[j] = 0.0f;
  if (!c.emit) return s;
  for (int j = 0; j < 3; ++j) {
    s.box[j] = std::numeric_limits<float>::infinity();
    s.box[3 + j] = -std::numeric_limits<float>::infinity();
  }
  for (const int64_t e : members) {
    for (int j = 0; j < 3; ++j) {
      s.box[j] = std::min(s.box[j], c.amin[3 * e + j]);
      s.box[3 + j] = std::max(s.box[3 + j], c.amax[3 * e + j]);
    }
  }
  return s;
}

void fill_node(Ctx& c, int64_t nid, const std::vector<Slot>& slots) {
  if (!c.emit || nid >= c.nn_cap || c.overflow) return;
  for (size_t k = 0; k < slots.size(); ++k) {
    c.wmeta[nid * WIDTH + k] = (int32_t)slots[k].m;
    float* nb = &c.nodeboxes[(nid * WIDTH + k) * 6];
    for (int j = 0; j < 6; ++j) nb[j] = slots[k].box[j];
  }
}

int64_t build_chunks(Ctx& c,
                     const std::vector<std::pair<int64_t, int64_t>>& chunks,
                     int64_t box_node);

int64_t build(Ctx& c, int64_t b) {
  const int64_t nid = alloc_node(c);
  const float* bmn = c.emit ? &c.amin[3 * b] : kZeroBox;
  const float* bmx = c.emit ? &c.amax[3 * b] : kZeroBox;

  if (is_leaf(c, b) && count_of(c, b) > c.leaf_slots) {
    // Oversized binary leaf: chunk it. Chunks share b's box.
    std::vector<std::pair<int64_t, int64_t>> chunks;
    for (int64_t base = c.lo[b]; base < c.hi[b]; base += c.leaf_slots) {
      chunks.emplace_back(base,
                          std::min<int64_t>(c.leaf_slots, c.hi[b] - base));
    }
    std::vector<Slot> slots;
    const size_t head = std::min<size_t>(chunks.size(), WIDTH - 1);
    for (size_t i = 0; i < head; ++i) {
      slots.push_back(make_slot(
          emit_group(c, chunks[i].first, chunks[i].second), bmn, bmx));
    }
    if (chunks.size() == (size_t)WIDTH) {
      slots.push_back(make_slot(
          emit_group(c, chunks[WIDTH - 1].first, chunks[WIDTH - 1].second),
          bmn, bmx));
    } else if (chunks.size() > (size_t)WIDTH) {
      std::vector<std::pair<int64_t, int64_t>> rest(chunks.begin() + WIDTH - 1,
                                                    chunks.end());
      slots.push_back(make_slot(build_chunks(c, rest, b), bmn, bmx));
    }
    fill_node(c, nid, slots);
    return nid;
  }

  // Collect sub-roots by repeatedly expanding the largest still-oversized
  // interior element (first max on ties, like Python max); an expansion is
  // kept while the packed slot demand fits the node (pack=1 frees slots,
  // so nodes expand deeper than one-subtree-per-slot).
  std::vector<int64_t> elems{b};
  for (;;) {
    int best = -1;
    int64_t best_cnt = -1;
    for (size_t i = 0; i < elems.size(); ++i) {
      const int64_t e = elems[i];
      if (!is_leaf(c, e) && count_of(c, e) > c.leaf_slots &&
          count_of(c, e) > best_cnt) {
        best = (int)i;
        best_cnt = count_of(c, e);
      }
    }
    if (best < 0) break;
    std::vector<int64_t> trial(elems);
    const int64_t e = trial[best];
    trial[best] = c.meta[4 * e];
    trial.insert(trial.begin() + best + 1, c.meta[4 * e + 1]);
    if (slot_demand(c, trial) > WIDTH) break;
    elems.swap(trial);
  }

  std::vector<Slot> slots;
  if (c.pack == 1) {
    std::vector<int64_t> smalls;
    for (const int64_t e : elems) {
      if (count_of(c, e) <= c.leaf_slots) smalls.push_back(e);
    }
    for (const auto& members : pack_bins(c, smalls)) {
      if (members.size() == 1) {
        const int64_t e = members[0];
        const float* emn = c.emit ? &c.amin[3 * e] : kZeroBox;
        const float* emx = c.emit ? &c.amax[3 * e] : kZeroBox;
        slots.push_back(
            make_slot(emit_group(c, c.lo[e], count_of(c, e)), emn, emx));
      } else {
        slots.push_back(
            make_union_slot(c, emit_group_multi(c, members), members));
      }
    }
    for (const int64_t e : elems) {
      if (count_of(c, e) > c.leaf_slots) {
        const float* emn = c.emit ? &c.amin[3 * e] : kZeroBox;
        const float* emx = c.emit ? &c.amax[3 * e] : kZeroBox;
        slots.push_back(make_slot(build(c, e), emn, emx));
      }
    }
  } else {
    for (const int64_t e : elems) {
      const float* emn = c.emit ? &c.amin[3 * e] : kZeroBox;
      const float* emx = c.emit ? &c.amax[3 * e] : kZeroBox;
      if (count_of(c, e) <= c.leaf_slots) {
        slots.push_back(
            make_slot(emit_group(c, c.lo[e], count_of(c, e)), emn, emx));
      } else {
        slots.push_back(make_slot(build(c, e), emn, emx));
      }
    }
  }
  fill_node(c, nid, slots);
  return nid;
}

int64_t build_chunks(Ctx& c,
                     const std::vector<std::pair<int64_t, int64_t>>& chunks,
                     int64_t box_node) {
  const int64_t nid = alloc_node(c);
  const float* bmn = c.emit ? &c.amin[3 * box_node] : kZeroBox;
  const float* bmx = c.emit ? &c.amax[3 * box_node] : kZeroBox;
  std::vector<Slot> slots;
  const size_t head = std::min<size_t>(chunks.size(), WIDTH - 1);
  for (size_t i = 0; i < head; ++i) {
    slots.push_back(make_slot(
        emit_group(c, chunks[i].first, chunks[i].second), bmn, bmx));
  }
  if (chunks.size() == (size_t)WIDTH) {
    slots.push_back(make_slot(
        emit_group(c, chunks[WIDTH - 1].first, chunks[WIDTH - 1].second),
        bmn, bmx));
  } else if (chunks.size() > (size_t)WIDTH) {
    std::vector<std::pair<int64_t, int64_t>> rest(chunks.begin() + WIDTH - 1,
                                                  chunks.end());
    slots.push_back(make_slot(build_chunks(c, rest, box_node), bmn, bmx));
  }
  fill_node(c, nid, slots);
  return nid;
}

void finalize(Ctx& c, int32_t* worder, float* wboxes) {
  // Octant ordering: per (node, ray-direction octant), push order is
  // far-to-near along the octant's sign vector — descending stable sort of
  // center . sign, computed exactly as NumPy does (f32 centers, f64 keys).
  for (int64_t n = 0; n < c.nn; ++n) {
    float cx[WIDTH], cy[WIDTH], cz[WIDTH];
    const float* nb = &c.nodeboxes[n * WIDTH * 6];
    for (int k = 0; k < WIDTH; ++k) {
      cx[k] = (nb[k * 6 + 0] + nb[k * 6 + 3]) * 0.5f;
      cy[k] = (nb[k * 6 + 1] + nb[k * 6 + 4]) * 0.5f;
      cz[k] = (nb[k * 6 + 2] + nb[k * 6 + 5]) * 0.5f;
    }
    for (int oct = 0; oct < WIDTH; ++oct) {
      const double sx = (oct & 1) ? -1.0 : 1.0;
      const double sy = (oct & 2) ? -1.0 : 1.0;
      const double sz = (oct & 4) ? -1.0 : 1.0;
      double key[WIDTH];
      for (int k = 0; k < WIDTH; ++k) {
        const double v =
            (double)cx[k] * sx + (double)cy[k] * sy + (double)cz[k] * sz;
        key[k] = std::isnan(v)
                     ? -std::numeric_limits<double>::infinity()
                     : v;
      }
      int perm[WIDTH] = {0, 1, 2, 3, 4, 5, 6, 7};
      std::stable_sort(perm, perm + WIDTH,
                       [&](int a, int b2) { return key[a] > key[b2]; });
      for (int k = 0; k < WIDTH; ++k) {
        worder[n * (WIDTH * WIDTH) + oct * WIDTH + k] =
            c.wmeta[n * WIDTH + perm[k]];
        float* row = &wboxes[((n * WIDTH + oct) * WIDTH + k) * WIDTH];
        for (int j = 0; j < 6; ++j) row[j] = nb[perm[k] * 6 + j];
        row[6] = 0.0f;
        row[7] = 0.0f;
      }
    }
  }

  // Leaf slabs: rows 0-8 component-major triangles, row 9 global indices
  // (-1 padding), rows 16..16+sub the sub-cluster boxes on lanes 0..5
  // (8-aligned base for the walk kernel's dynamic sublane load).
  const int64_t sub_w = c.leaf_slots / c.sub;
  const int64_t lanes = c.lanes;
  std::vector<int64_t> ids;  // concatenated global tri ids for one group
  for (int64_t g = 0; g < c.ng; ++g) {
    ids.clear();
    for (const auto& r : c.groups[g]) {
      for (int64_t j = 0; j < r.second; ++j) ids.push_back(r.first + j);
    }
    const int64_t gcnt = (int64_t)ids.size();
    float* slab = &c.wtris[g * c.grows * lanes];
    std::memset(slab, 0, sizeof(float) * c.grows * lanes);
    for (int r = 0; r < 9; ++r) {
      for (int64_t j = 0; j < gcnt; ++j) {
        slab[r * lanes + j] = c.tri[ids[j] * 9 + r];
      }
    }
    for (int64_t j = 0; j < lanes; ++j) {
      slab[9 * lanes + j] = j < gcnt ? (float)ids[j] : -1.0f;
    }
    for (int32_t s = 0; s < c.sub; ++s) {
      float* row = &slab[(16 + s) * lanes];
      const int64_t a = s * sub_w;
      const int64_t b2 = std::min<int64_t>((s + 1) * sub_w, gcnt);
      if (a >= gcnt) {
        for (int j = 0; j < 6; ++j) {
          row[j] = std::numeric_limits<float>::quiet_NaN();
        }
        continue;
      }
      float mn[3] = {std::numeric_limits<float>::infinity(),
                     std::numeric_limits<float>::infinity(),
                     std::numeric_limits<float>::infinity()};
      float mx[3] = {-std::numeric_limits<float>::infinity(),
                     -std::numeric_limits<float>::infinity(),
                     -std::numeric_limits<float>::infinity()};
      for (int64_t j = a; j < b2; ++j) {
        const float* tr = &c.tri[ids[j] * 9];
        for (int d = 0; d < 3; ++d) {
          const float p0 = tr[d];
          const float p1 = tr[d] + tr[3 + d];  // v0 + e1, f32 like NumPy
          const float p2 = tr[d] + tr[6 + d];  // v0 + e2
          mn[d] = std::min(mn[d], std::min(p0, std::min(p1, p2)));
          mx[d] = std::max(mx[d], std::max(p0, std::max(p1, p2)));
        }
      }
      for (int d = 0; d < 3; ++d) {
        row[d] = mn[d];
        row[3 + d] = mx[d];
      }
    }
  }
}

}  // namespace

extern "C" {

// Count pass: returns 0 and writes the wide node / leaf group counts the
// collapse of this tree will produce (integer-only recursion, no float
// work). meta: (nnodes, 4) int32. pack: 0 = one subtree per group,
// 1 = FFD bin-pack (accel/bvh8.py pack="ffd"). Returns -1 on invalid input.
int64_t wpt_wide_counts(const int32_t* meta, int64_t nnodes, int64_t T,
                        int32_t leaf_slots, int32_t pack, int64_t* out_nn,
                        int64_t* out_ng) {
  if (nnodes <= 0 || T <= 0 || leaf_slots < 1 || pack < 0 || pack > 1) {
    return -1;
  }
  Ctx c;
  c.meta = meta;
  c.T = T;
  c.leaf_slots = leaf_slots;
  c.pack = pack;
  c.emit = false;
  subtree_ranges(c, nnodes);
  build(c, 0);
  *out_nn = c.nn;
  *out_ng = c.ng;
  return 0;
}

// Emit pass: fills the walk tables. Caller allocates wmeta (nn, 8) i32,
// worder (nn, 64) i32, wboxes (nn*64, 8) f32, wtris (ng*grows, 128) f32
// with the exact counts from wpt_wide_counts (grows = the padded group
// row count for `sub`). Returns the root id (0) or -1 on error/overflow.
int64_t wpt_build_wide(const float* amin, const float* amax,
                       const int32_t* meta, int64_t nnodes, const float* tri,
                       int64_t T, int32_t leaf_slots, int32_t sub,
                       int32_t grows, int32_t lanes, int32_t pack,
                       int32_t* wmeta, int32_t* worder, float* wboxes,
                       float* wtris, int64_t nn_cap, int64_t ng_cap) {
  if (nnodes <= 0 || T <= 0 || leaf_slots < 1 || sub < 1 ||
      leaf_slots % sub != 0 || lanes < leaf_slots || lanes < 128 ||
      pack < 0 || pack > 1) {
    return -1;
  }
  Ctx c;
  c.amin = amin;
  c.amax = amax;
  c.meta = meta;
  c.tri = tri;
  c.T = T;
  c.leaf_slots = leaf_slots;
  c.sub = sub;
  c.grows = grows;
  c.lanes = lanes;
  c.pack = pack;
  c.emit = true;
  c.nn_cap = nn_cap;
  c.ng_cap = ng_cap;
  c.wmeta = wmeta;
  c.wtris = wtris;
  c.groups.resize(ng_cap);
  subtree_ranges(c, nnodes);
  const int64_t root = build(c, 0);
  if (c.overflow || root != 0 || c.nn != nn_cap || c.ng != ng_cap) return -1;
  finalize(c, worder, wboxes);
  return root;
}

}  // extern "C"
