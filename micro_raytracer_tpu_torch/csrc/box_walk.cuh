// The box walk: the closest hit, exit and any-hit of a scene's box segment
// through a spatial index over its row ids (ops/hit3.py box_walk_tables),
// for the textured scenes without triangles whose box segment holds at
// least hit3.BOX_CULL_MIN valid boxes (hit3.box_culled; the Minecraft
// class). The whole trace's textured instances (trace_fwd.cu, kBox: render,
// segment and train) and the primary-hit kernel (hit3.cu, kBox) walk it;
// the spheres and planes stay dense.
//
// Replaces: micro_raytracer_tpu/ops/pallas_hit3.py :: sweep_closest with
// _kind_block's box test (the dense box segment of _hit_kernel and of
// pallas_step._trace_kernel's sweeps), with the same t and row on every
// ray. The JAX package sweeps these rows dense; the TPU's tiles made that
// cheap, here it was 98% of the textured trace's bound.
//
// The index: the valid box rows permuted into a median-split order over
// their centres (leaves of kBoxLeaf boxes, nodes of kBoxFan leaves), the
// row table itself left as it is. Each packed row carries its row id, so
// the walk writes the table's rows and breaks ties by them. A node's and a
// leaf's world AABB is the union of its boxes' (|M^-1| sizes / 2 about
// the position), slacked by 1e-4 + 1e-4 * extent; a ray from o grows every
// box it tests by g0 + kBoxGrow (|o - c|_1), c the boxes' centre (header):
// the box test replaces 1/0 by 1/EPS (hit3.cuh row_hit), so on a ray whose
// object-space direction has a zero component it reports hits up to
// EPS t outside the box, and t is at most |o - c| plus the boxes' radius,
// which g0 holds (2e-4 per unit of both, twice that). The walk's slab
// test takes 1/d as it is (1/0 = inf, the exact slab), and counts a NaN
// as a touch. So every row the dense sweep takes lies in a leaf and a
// node the walk enters at or before its t, and the walk gives the dense
// sweep's (t, row); the plain version (ops/hit3.py _box_walk_mask) walks
// the same tables in the same order and tests the same rows.
//
// What bounds it on the H100: the rows a ray tests (the 18-multiply
// transform and three divisions of the box test) and its slab tests. The
// closest hit visits the nodes nearest first and, inside a node, its
// leaves nearest first, stopping at an entry t beyond the best (t, row);
// the any-hit walks the nodes and leaves it touches in order and stops at
// its first hit. The packed rows (64 B: frame, position, sizes, row id)
// are read with four 16-byte loads, from shared memory where the kernel
// stages them (hit3.BOX_STAGE_MAX rows), else through the read-only
// cache; each lane keeps its nodes' and its node's leaves' entry t in its
// own column of shared memory.
//
// Numerics: float32, -fmad=false, as every source here; the row test is
// hit3.cuh row_hit<kBox>'s operations in its order, so the same bits.
#pragma once

#include "hit3.cuh"
#include "tri_walk.cuh"

namespace mrt {

constexpr int kBoxLeaf = 8;   // boxes per leaf (ops/hit3.py BOX_LEAF)
constexpr int kBoxFan = 8;    // leaves per node (BOX_FAN)
constexpr int kBoxRowCols = 16;
constexpr int kBoxHead = 8;   // centre (3), g0, padding
constexpr float kBoxGrow = 2e-4f;  // ops/hit3.py BOX_GROW
// packed rows the kernels stage in shared memory (ops/hit3.py
// BOX_STAGE_MAX); past it they are read from global memory
constexpr int kBoxStageMax = 512;

__device__ __forceinline__ int box_leaves(int n) {
  return (n + kBoxLeaf - 1) / kBoxLeaf;
}
__device__ __forceinline__ int box_nodes(int n) {
  return (box_leaves(n) + kBoxFan - 1) / kBoxFan;
}
// floats of the header and the node and leaf AABBs (ahead of the rows)
__device__ __forceinline__ int box_bounds_floats(int n) {
  return kBoxHead + (box_nodes(n) + box_leaves(n)) * kBbCols;
}

// What a box walk reads: `bb` the header and the node and leaf AABBs
// (box_walk_tables' first box_bounds_floats(n) floats), `rows` the packed
// rows (16-byte aligned), n of them; `tb` the lane's column (stride ts) of
// entry t: its nodes' (box_nodes(n)), then one node's leaves' (kBoxFan);
// `pb` the sweep columns (kSweepCols a row) of the rows before the box
// segment (the spheres and planes), row r at pb + r * kSweepCols.
struct BoxWalk {
  const float* bb = nullptr;
  const float* rows = nullptr;
  float* tb = nullptr;
  int ts = 0;
  const float* pb = nullptr;
  int n = 0;
};

// hit3.cuh row_hit<kBox> of packed row `a` (frame f, position i, sizes s,
// row id): four 16-byte loads, then row_hit's operations in its order
// (every packed row is valid), so the same t0, t1 and hit bit for bit.
__device__ __forceinline__ bool box_hit4(const float* a, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz, float& t0, float& t1,
                                         int& id) {
  const F4 r0 = ld4(a), r1 = ld4(a + 4), r2 = ld4(a + 8), r3 = ld4(a + 12);
  const float f[9] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w, r2.x};
  const float ix = r2.y, iy = r2.z, iz = r2.w;
  const float rx = ox - ix, ry = oy - iy, rz = oz - iz;
  const float opx = f[0] * rx + f[1] * ry + f[2] * rz + ix;
  const float opy = f[3] * rx + f[4] * ry + f[5] * rz + iy;
  const float opz = f[6] * rx + f[7] * ry + f[8] * rz + iz;
  const float dpx = f[0] * dx + f[1] * dy + f[2] * dz;
  const float dpy = f[3] * dx + f[4] * dy + f[5] * dz;
  const float dpz = f[6] * dx + f[7] * dy + f[8] * dz;
  const float dp[3] = {dpx, dpy, dpz};
  const float op[3] = {opx, opy, opz};
  const float ip[3] = {ix, iy, iz};
  const float sz[3] = {r3.x, r3.y, r3.z};
  float lo = 0.0f, hi = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float mm = 1.0f / (dp[c] == 0.0f ? 1.0f : dp[c]);
    mm = dp[c] == 0.0f ? kInvEps : mm;
    const float nb = (op[c] - ip[c]) * mm;
    const float kk = 0.5f * sz[c] * fabsf(mm);
    const float lo_c = -nb - kk, hi_c = -nb + kk;
    lo = c == 0 ? lo_c : nan_max(lo, lo_c);
    hi = c == 0 ? hi_c : nan_min(hi, hi_c);
  }
  t0 = lo;
  t1 = hi;
  id = static_cast<int>(r3.w);
  const bool ok = !((t0 > t1) || (t1 < 0.0f));
  return ok && isfinite(t0) && isfinite(t1);
}

// The growth of every box a ray from o tests (module comment).
__device__ __forceinline__ float box_grow(const float* head, float ox,
                                          float oy, float oz) {
  return head[3] + kBoxGrow * ((fabsf(ox - head[0]) + fabsf(oy - head[1])) +
                               fabsf(oz - head[2]));
}

// (tmin, tmax) of the ray (o, 1/d) against AABB `bb` grown by g; the
// exact slab (1/0 = inf), NaN where an axis gives 0 * inf.
__device__ __forceinline__ void box_slab(const float* bb, float g, float ox,
                                         float oy, float oz, float ix,
                                         float iy, float iz, float& tmin,
                                         float& tmax) {
  const F4 a = ld4(bb), b = ld4(bb + 4);
  const float lo[3] = {a.x - g, a.y - g, a.z - g};
  const float hi[3] = {a.w + g, b.x + g, b.y + g};
  const float o[3] = {ox, oy, oz};
  const float inv[3] = {ix, iy, iz};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float t1 = (lo[k] - o[k]) * inv[k];
    const float t2 = (hi[k] - o[k]) * inv[k];
    const float near = nan_min(t1, t2), far = nan_max(t1, t2);
    tmin = k == 0 ? near : nan_max(tmin, near);
    tmax = k == 0 ? far : nan_min(tmax, far);
  }
}

// Does the ray meet the box at t >= 0 and enter it at or before `best`?
// A NaN is a touch.
__device__ __forceinline__ bool box_touch(float tmin, float tmax,
                                          float best) {
  return !(tmax < nan_max(tmin, 0.0f)) && !(tmin > best);
}

// An entry t for the nearest-first order: a NaN goes first.
__device__ __forceinline__ float box_key(float tmin) {
  return tmin == tmin ? tmin : -kBig;
}

// The lowest-keyed bit of mask m over keys tb[b * ts] (ties to the lowest
// bit), and its key.
__device__ __forceinline__ int box_nearest(unsigned m, const float* tb,
                                           int ts, float& key) {
  int nb = low_bit(m);
  key = tb[nb * ts];
  for (unsigned q = m & (m - 1u); q; q &= q - 1u) {
    const int b = low_bit(q);
    const float t = tb[b * ts];
    if (t < key) {
      key = t;
      nb = b;
    }
  }
  return nb;
}

// Entry sweep of dense rows [start, start + n) of kind K over the sweep
// columns `pb` (hit3.cuh entry_seg), keeping the winner's t1 (kX).
template <int K, bool kX>
__device__ __forceinline__ void box_dense(const float* pb, int start, int n,
                                          float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float& best, int& row, float& bt1) {
  for (int i = start; i < start + n; ++i) {
    float t0, t1;
    if (row_hit<K>(pb + i * kSweepCols, ox, oy, oz, dx, dy, dz, t0, t1) &&
        t0 < best) {
      best = t0;
      row = i;
      if (kX) bt1 = t1;
    }
  }
}

// The box segment's entry: nodes nearest first, each node's leaves
// nearest first, a node or leaf whose entry t is beyond `best` ending its
// level; a hit takes the best when its (t, row) is the smaller pair, so a
// tie goes to the lowest row in any order (kX: keeps its t1 in bt1).
template <bool kX>
__device__ __forceinline__ void box_entry(const BoxWalk& W, float ox,
                                          float oy, float oz, float dx,
                                          float dy, float dz, float& best,
                                          int& row, float& bt1) {
  const int nl = box_leaves(W.n), nn = box_nodes(W.n);
  const float* nodes = W.bb + kBoxHead;
  const float* leaves = nodes + nn * kBbCols;
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  const float g = box_grow(W.bb, ox, oy, oz);
  float* lt = W.tb + nn * W.ts;  // the visited node's leaves
  unsigned m = 0u;
  for (int b = 0; b < nn; ++b) {
    float tmin, tmax;
    box_slab(nodes + b * kBbCols, g, ox, oy, oz, ix, iy, iz, tmin, tmax);
    if (box_touch(tmin, tmax, best)) {
      m |= 1u << b;
      W.tb[b * W.ts] = box_key(tmin);
    }
  }
  while (m) {
    float nt;
    const int nb = box_nearest(m, W.tb, W.ts, nt);
    if (nt > best) break;
    m &= ~(1u << nb);
    const int l0 = nb * kBoxFan, nk = imin(kBoxFan, nl - l0);
    unsigned lm = 0u;
    for (int j = 0; j < nk; ++j) {
      float tmin, tmax;
      box_slab(leaves + (l0 + j) * kBbCols, g, ox, oy, oz, ix, iy, iz, tmin,
               tmax);
      if (box_touch(tmin, tmax, best)) {
        lm |= 1u << j;
        lt[j * W.ts] = box_key(tmin);
      }
    }
    while (lm) {
      float t;
      const int j = box_nearest(lm, lt, W.ts, t);
      if (t > best) break;
      lm &= ~(1u << j);
      const int r0 = (l0 + j) * kBoxLeaf, r1 = imin(r0 + kBoxLeaf, W.n);
      for (int i = r0; i < r1; ++i) {
        float t0, t1;
        int id;
        if (box_hit4(W.rows + i * kBoxRowCols, ox, oy, oz, dx, dy, dz, t0,
                     t1, id) &&
            (t0 < best || (t0 == best && id < row))) {
          best = t0;
          row = id;
          if (kX) bt1 = t1;
        }
      }
    }
  }
}

// Any-hit over the box segment: the nodes and leaves the ray meets at
// t >= 0, in order; true at the first hit.
__device__ __forceinline__ bool box_any(const BoxWalk& W, float ox,
                                        float oy, float oz, float dx,
                                        float dy, float dz) {
  const int nl = box_leaves(W.n), nn = box_nodes(W.n);
  const float* nodes = W.bb + kBoxHead;
  const float* leaves = nodes + nn * kBbCols;
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  const float g = box_grow(W.bb, ox, oy, oz);
  for (int b = 0; b < nn; ++b) {
    float tmin, tmax;
    box_slab(nodes + b * kBbCols, g, ox, oy, oz, ix, iy, iz, tmin, tmax);
    if (!box_touch(tmin, tmax, kBig)) continue;
    const int l1 = imin((b + 1) * kBoxFan, nl);
    for (int l = b * kBoxFan; l < l1; ++l) {
      box_slab(leaves + l * kBbCols, g, ox, oy, oz, ix, iy, iz, tmin, tmax);
      if (!box_touch(tmin, tmax, kBig)) continue;
      const int r1 = imin((l + 1) * kBoxLeaf, W.n);
      for (int i = l * kBoxLeaf; i < r1; ++i) {
        float t0, t1;
        int id;
        if (box_hit4(W.rows + i * kBoxRowCols, ox, oy, oz, dx, dy, dz, t0,
                     t1, id))
          return true;
      }
    }
  }
  return false;
}

// Closest hit of ray (o, d) over a scene whose box segment is walked: the
// spheres and planes dense (hit3.cuh closest_hit's segments before the
// boxes), then the box walk: hit3.cuh closest_hit's t and row. kNeedExit:
// a scene without triangles has one row per group (models/compiler.py),
// so the winner's group exit is the winner row's own t1, kept from its
// entry test: exit_seg's sweep over every row gives that, bit for bit.
template <bool kNeedExit>
__device__ __forceinline__ Hit box_closest_hit(const Layout& L,
                                               const BoxWalk& W, float ox,
                                               float oy, float oz, float dx,
                                               float dy, float dz) {
  float best = kBig, bt1 = -kBig;
  int row = 0;
  box_dense<kSphere, kNeedExit>(W.pb, L.sph_start, L.sph_n, ox, oy, oz, dx,
                                dy, dz, best, row, bt1);
  box_dense<kPlane, kNeedExit>(W.pb, L.pln_start, L.pln_n, ox, oy, oz, dx,
                               dy, dz, best, row, bt1);
  box_entry<kNeedExit>(W, ox, oy, oz, dx, dy, dz, best, row, bt1);
  if (!kNeedExit) return Hit{best, row, best, row};
  return best < kBig ? Hit{best, row, bt1, row} : Hit{best, row, -kBig, 0};
}

// Occlusion over a scene whose box segment is walked: hit3.cuh any_hit's
// bit.
__device__ __forceinline__ bool box_any_hit(const Layout& L,
                                            const BoxWalk& W, float ox,
                                            float oy, float oz, float dx,
                                            float dy, float dz) {
  return any_seg<kSphere>(W.pb, kSweepCols, L.sph_start, L.sph_n, ox, oy,
                          oz, dx, dy, dz) ||
         any_seg<kPlane>(W.pb, kSweepCols, L.pln_start, L.pln_n, ox, oy, oz,
                         dx, dy, dz) ||
         box_any(W, ox, oy, oz, dx, dy, dz);
}

// The floats box_stage puts in shared memory: the bounds, and the rows
// where n <= kBoxStageMax.
__device__ __forceinline__ int box_staged_floats(int n) {
  return box_bounds_floats(n) + (n <= kBoxStageMax ? n * kBoxRowCols : 0);
}

// Where the packed rows are read: after the staged bounds, or in `bw`.
__device__ __forceinline__ const float* box_rows_at(const float* staged,
                                                    const float* bw, int n) {
  return (n <= kBoxStageMax ? staged : bw) + box_bounds_floats(n);
}

// Stage the box walk tables `bw` of n boxes into shared memory at `dst`
// (box_staged_floats of them), block-wide.
__device__ __forceinline__ void box_stage(float* dst, const float* bw,
                                          int n) {
  const int f = box_staged_floats(n);
  stage(dst, bw, 1, f, f);
}

// Shared floats of a box walk's staged tables (box_stage) and of `threads`
// lanes' entry-t columns (host code: the launches' sizes).
inline int box_smem_floats(int n, int threads) {
  const int nl = (n + kBoxLeaf - 1) / kBoxLeaf;
  const int nn = (nl + kBoxFan - 1) / kBoxFan;
  return kBoxHead + (nn + nl) * kBbCols +
         (n <= kBoxStageMax ? n * kBoxRowCols : 0) +
         (nn + kBoxFan) * threads;
}

}  // namespace mrt
