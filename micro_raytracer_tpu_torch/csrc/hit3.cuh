// Closest-hit and any-hit over the dense sphere / plane / box segments and
// the triangle segment.
//
// Replaces: micro_raytracer_tpu/ops/pallas_hit3.py :: sweep_closest with
// _kind_block (dense segments), its triangle segment tri_body, the
// candidate-block cull cb_body over _tri_superbounds, and the triangle exit
// exit_tri, with pallas_tri.py :: _tri_block / _tri_block_any (the
// pallas_call in _call_hit). The same device functions are the entry sweep
// and the shadow sweeps of the whole-trace kernel (trace_fwd.cu) and the
// body of the primary-hit kernel (hit3.cu).
//
// Semantics (rt.rs:299-412, 740-772, 867-898), as in the Pallas kernel:
//  * object-space sphere quadratic, plane equation and box slab test, with
//    every division and sqrt guarded before the op (a==0, dn==0, dp==0 ->
//    1/EPS) and `ok &= isfinite(t0) && isfinite(t1)`;
//  * entry: the smallest t0 over valid rows; equal t goes to the lowest row,
//    across segments too (rows ascend and the update is a strict `<`);
//  * exit: the largest t1 over valid rows of the winner's group, ties to
//    the lowest row. Instead of stashing a (rows x rays) exit-t table the
//    second pass recomputes t1 for the rows whose group id matches, so the
//    group semantics stay general (a mesh group has many rows) at no cost
//    for single-row groups;
//  * misses: te = BIG, row = 0, tx = -BIG, xrow = 0.
//
// Triangles (kTri instances only; the room-only instances compile without
// them): a row of the (Pt, 16) triangle table holds G (9), h (3), thr, the
// group id and the triangle-local [start, end) of the row's group. The
// entry test is _tri_block's Woop form in its operation order: o' = G o +
// h, d' = G d, |d'_z| >= thr, t = -o'_z / d'_z, u, v in the triangle,
// t >= 0. The any-hit test is _tri_block_any's division-free form. A
// triangle's exit t is its entry t, and a mesh's rows are contiguous in the
// table, so the exit pass sweeps only the winner group's rows.
//
// Sphere blocks (pallas_hit3.sweep_closest's sphere_cull_sweep over
// _sphere_blockbounds): a sphere segment of at least 256 rows
// (hit3.sph_cull_rows; the compiler gives it the median-split order) is cut
// into 64-row blocks behind world AABBs (centre +- r, hit3.sph_blockbounds).
// Entry-only and any-hit sweeps — the shadow sweeps of refractive scenes
// too — walk the blocks in ascending order and skip a block the ray does
// not enter at or before its best t (any-hit: a block it misses); a swept
// block runs the dense row test. A sphere's hit point lies inside its
// block's AABB, so no hit is lost and ties still go to the lowest row: the
// culled sweep gives the dense sweep's t and row. The cull is a runtime
// branch on the layout's block count (0: dense), not a template instance,
// and only in the instances for scenes without triangles and textures
// (kSph): those get no sphere blocks (hit3.sph_table), so the Mesh-class
// and textured instances keep their code and their registers. A lane keeps
// the blocks its ray touches as a bit mask: 32 bits (`unsigned`) in the
// whole-trace and primary-hit kernels, whose dense rows (step.MAX_ROWS)
// hold at most 32 blocks, 64 (`unsigned long long`) in the per-step
// kernel (step_fwd.cu), up to the JAX package's 64 blocks.
//
// Per-ray block cull: the segment is cut into 64-row blocks (the compiler's
// median-split leaf) with world AABBs (hit3.tri_blockbounds). Where the JAX
// package culls — entry-only sweeps and any-hit sweeps, never an exit pass
// — a ray slab-tests each block and skips it when it misses the AABB or
// enters it beyond the ray's best t so far. The JAX kernel cut the same
// blocks per 1024-ray tile (a block is swept for the whole tile if one lane
// needs it); one thread per ray makes the per-ray test natural. Both drop
// only "phantom" |det| >= E hits outside their block's AABB, and the plain
// version (ops/hit3.py) applies this same rule, so the two agree ray by ray.
//
// What bounds it on the H100: arithmetic. Each ray runs ~40 float ops per
// row and per sweep, the row table is a few KB read from shared memory as
// warp-wide broadcasts, and a ray costs 24 bytes in and 16 out. The design
// keeps one ray per thread with the dense rows and the block AABBs in
// shared memory (staged once per block by the caller), loops over rows with
// the kind fixed per segment (no per-row kind branch), and exits the
// any-hit loop at the first hit. The triangle table (64 B a row, ~61 KB for
// a 960-triangle mesh) stays in global memory and is read through the
// read-only cache: a warp's threads test the same row together, so a row
// is one broadcast from L1, and it has no row bound.
//
// Geometry stays in float32; 1/sqrt is written as 1.0f/sqrtf (rsqrtf is
// approximate), and the build uses -fmad=false so every product and sum
// rounds as in the plain PyTorch version.
#pragma once

#include <math.h>

namespace mrt {

constexpr float kBig = 3.0e38f;
constexpr float kEps = 1e-4f;
constexpr float kInvEps = 10000.0f;  // 1/EPS as the JAX package rounds it

// Sweep columns of one primitive row: frame (9), instance position (3),
// geometry (3: plane normal | box sizes), radius, valid, group id.
constexpr int kSweepCols = 18;
enum SweepCol { C_FR = 0, C_IP = 9, C_PA = 12, C_PR = 15, C_VALID = 16,
                C_GID = 17 };

// Kind segments [start, start + n) of the kind-sorted row table, n the
// rows up to the segment's last valid one: the padding rows after it are
// never tested. The triangle segment starts at tri_start and sweeps tri_n
// rows in n_cb cull blocks, the sphere segment's rows lie in n_sb cull
// blocks (0: no culling).
struct Layout {
  int sph_start, sph_n, pln_start, pln_n, box_start, box_n;
  int tri_start = 0, tri_n = 0, n_cb = 0, n_sb = 0;
};

// Triangle table columns (ops/hit3.py TRI_COLS) and the cull blocks.
constexpr int kTriCols = 16;
enum TriCol { T_G = 0, T_H = 9, T_THR = 12, T_GID = 13, T_GS = 14, T_GE = 15 };
constexpr int kCullRows = 64;
constexpr int kBbCols = 8;

// The triangle segment's tables: `tab` (Pt, kTriCols) in global memory,
// `bb` block AABBs [lo | hi | pad] in shared memory: the triangle
// segment's (n_cb, kBbCols) or, in a scene without triangles, the sphere
// segment's (n_sb, kBbCols).
struct Tris {
  const float* __restrict__ tab;
  const float* bb;
};

struct Hit {
  float te;
  int row;
  float tx;
  int xrow;
};

enum Kind { kSphere = 0, kPlane = 1, kBox = 2 };

__device__ __forceinline__ float nan_max(float a, float b) {
  // max that propagates NaN, like jnp.maximum / torch.amax
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// (t0, t1, ok) of ray (o, d) against row `r` (a pointer to its sweep
// columns), for a row of kind K. Operation order follows _kind_block.
template <int K>
__device__ __forceinline__ bool row_hit(const float* r, float ox, float oy,
                                        float oz, float dx, float dy,
                                        float dz, float& t0, float& t1) {
  const float ix = r[C_IP], iy = r[C_IP + 1], iz = r[C_IP + 2];
  const float rx = ox - ix, ry = oy - iy, rz = oz - iz;
  const float opx = r[0] * rx + r[1] * ry + r[2] * rz + ix;
  const float opy = r[3] * rx + r[4] * ry + r[5] * rz + iy;
  const float opz = r[6] * rx + r[7] * ry + r[8] * rz + iz;
  const float dpx = r[0] * dx + r[1] * dy + r[2] * dz;
  const float dpy = r[3] * dx + r[4] * dy + r[5] * dz;
  const float dpz = r[6] * dx + r[7] * dy + r[8] * dz;
  bool ok;
  if (K == kSphere) {
    const float rad = r[C_PR];
    const float ox_ = opx - ix, oy_ = opy - iy, oz_ = opz - iz;
    const float a = dpx * dpx + dpy * dpy + dpz * dpz;
    const float bq = 2.0f * (ox_ * dpx + oy_ * dpy + oz_ * dpz);
    const float c = ox_ * ox_ + oy_ * oy_ + oz_ * oz_ - rad * rad;
    const float disc = bq * bq - 4.0f * a * c;
    const float sq = sqrtf(disc >= 0.0f ? nan_max(disc, 1e-12f) : 1.0f);
    const float a2 = a == 0.0f ? 1.0f : 2.0f * a;
    t0 = (-bq - sq) / a2;
    t1 = (-bq + sq) / a2;
    ok = (disc >= 0.0f) && (t0 >= 0.0f);
  } else if (K == kPlane) {
    const float a0 = r[C_PA], a1 = r[C_PA + 1], a2 = r[C_PA + 2];
    const float nn = a0 * a0 + a1 * a1 + a2 * a2;
    const float inv = 1.0f / sqrtf(nn > 0.0f ? nn : 1.0f);
    const float nx = a0 * inv, ny = a1 * inv, nz = a2 * inv;
    const float dd = -(nx * ix + ny * iy + nz * iz);
    const float dn = dpx * nx + dpy * ny + dpz * nz;
    t0 = -(opx * nx + opy * ny + opz * nz + dd) / (dn == 0.0f ? 1.0f : dn);
    t1 = t0;
    ok = (t0 > 0.0f) && (dn != 0.0f);
  } else {
    const float dp[3] = {dpx, dpy, dpz};
    const float op[3] = {opx, opy, opz};
    const float ip[3] = {ix, iy, iz};
    float lo = 0.0f, hi = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float mm = 1.0f / (dp[c] == 0.0f ? 1.0f : dp[c]);
      mm = dp[c] == 0.0f ? kInvEps : mm;
      const float nb = (op[c] - ip[c]) * mm;
      const float kk = 0.5f * r[C_PA + c] * fabsf(mm);
      const float lo_c = -nb - kk, hi_c = -nb + kk;
      lo = c == 0 ? lo_c : nan_max(lo, lo_c);
      hi = c == 0 ? hi_c : nan_min(hi, hi_c);
    }
    t0 = lo;
    t1 = hi;
    ok = !((t0 > t1) || (t1 < 0.0f));
  }
  return ok && r[C_VALID] > 0.5f && isfinite(t0) && isfinite(t1);
}

// Entry sweep of one kind segment: strict `<` keeps the lowest row on ties.
template <int K>
__device__ __forceinline__ void entry_seg(const float* tab, int stride,
                                          int start, int n, float ox,
                                          float oy, float oz, float dx,
                                          float dy, float dz, float& best,
                                          int& row) {
  for (int i = start; i < start + n; ++i) {
    float t0, t1;
    if (row_hit<K>(tab + i * stride, ox, oy, oz, dx, dy, dz, t0, t1) &&
        t0 < best) {
      best = t0;
      row = i;
    }
  }
}

// Exit sweep of one kind segment over the rows of group `wg`: strict `>`.
template <int K>
__device__ __forceinline__ void exit_seg(const float* tab, int stride,
                                         int start, int n, float wg, float ox,
                                         float oy, float oz, float dx,
                                         float dy, float dz, float& best,
                                         int& row) {
  for (int i = start; i < start + n; ++i) {
    const float* r = tab + i * stride;
    if (r[C_GID] != wg) continue;
    float t0, t1;
    const float v =
        row_hit<K>(r, ox, oy, oz, dx, dy, dz, t0, t1) ? t1 : -kBig;
    if (v > best) {
      best = v;
      row = i;
    }
  }
}

template <int K>
__device__ __forceinline__ bool any_seg(const float* tab, int stride,
                                        int start, int n, float ox, float oy,
                                        float oz, float dx, float dy,
                                        float dz) {
  for (int i = start; i < start + n; ++i) {
    float t0, t1;
    if (row_hit<K>(tab + i * stride, ox, oy, oz, dx, dy, dz, t0, t1))
      return true;
  }
  return false;
}

// o' = G o + h and d' = G d of triangle row `a` (_tri_block's `prod`
// order: three products summed left to right, then h).
struct TriProds {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ TriProds tri_prods(const float* __restrict__ a,
                                              float ox, float oy, float oz,
                                              float dx, float dy, float dz) {
  TriProds p;
  p.ox = __ldg(a + 0) * ox + __ldg(a + 1) * oy + __ldg(a + 2) * oz +
         __ldg(a + T_H + 0);
  p.oy = __ldg(a + 3) * ox + __ldg(a + 4) * oy + __ldg(a + 5) * oz +
         __ldg(a + T_H + 1);
  p.oz = __ldg(a + 6) * ox + __ldg(a + 7) * oy + __ldg(a + 8) * oz +
         __ldg(a + T_H + 2);
  p.dx = __ldg(a + 0) * dx + __ldg(a + 1) * dy + __ldg(a + 2) * dz;
  p.dy = __ldg(a + 3) * dx + __ldg(a + 4) * dy + __ldg(a + 5) * dz;
  p.dz = __ldg(a + 6) * dx + __ldg(a + 7) * dy + __ldg(a + 8) * dz;
  return p;
}

// Woop entry test of triangle row `a` (_tri_block): t only where
// |d'_z| >= thr passed.
__device__ __forceinline__ bool tri_hit(const float* __restrict__ a,
                                        float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        float& t) {
  const TriProds p = tri_prods(a, ox, oy, oz, dx, dy, dz);
  if (!(fabsf(p.dz) >= __ldg(a + T_THR))) return false;
  t = -p.oz / p.dz;
  const float u = p.ox + t * p.dx;
  const float v = p.oy + t * p.dy;
  return u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f && t >= 0.0f;
}

// Division-free occlusion test of triangle row `a` (_tri_block_any): with
// D = d'_z, u in [0, 1] iff 0 <= u D^2 <= D^2, and t >= 0 iff o'_z D <= 0.
__device__ __forceinline__ bool tri_any(const float* __restrict__ a,
                                        float ox, float oy, float oz,
                                        float dx, float dy, float dz) {
  const TriProds p = tri_prods(a, ox, oy, oz, dx, dy, dz);
  const float D = p.dz;
  if (!(fabsf(D) >= __ldg(a + T_THR))) return false;
  const float D2 = D * D;
  const float Pu = (p.ox * D - p.oz * p.dx) * D;
  const float Pv = (p.oy * D - p.oz * p.dy) * D;
  return Pu >= 0.0f && Pu <= D2 && Pv >= 0.0f && Pu + Pv <= D2 &&
         p.oz * D <= 0.0f;
}

// Does the ray (o, 1/d) enter block AABB `bb` at or before `best`?
// (pallas_hit3 _slab and its touch test, per ray; NaN propagates as in
// jnp.minimum / torch.minimum.)
__device__ __forceinline__ bool block_touch(const float* bb, float ox,
                                            float oy, float oz, float ix,
                                            float iy, float iz, float best) {
  const float o[3] = {ox, oy, oz};
  const float inv[3] = {ix, iy, iz};
  float tmin = 0.0f, tmax = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float t1 = (bb[k] - o[k]) * inv[k];
    const float t2 = (bb[3 + k] - o[k]) * inv[k];
    const float near = nan_min(t1, t2), far = nan_max(t1, t2);
    tmin = k == 0 ? near : nan_max(tmin, near);
    tmax = k == 0 ? far : nan_min(tmax, far);
  }
  return tmax >= nan_max(tmin, 0.0f) && tmin <= best;
}

// 1 / d with EPS for a zero component (the slab test's inverse direction)
__device__ __forceinline__ float inv_dir(float d) {
  return 1.0f / (d == 0.0f ? kEps : d);
}

// The lowest set bit of a block mask.
__device__ __forceinline__ int low_bit(unsigned m) { return __ffs(m) - 1; }
__device__ __forceinline__ int low_bit(unsigned long long m) {
  return __ffsll(static_cast<long long>(m)) - 1;
}

// The sphere blocks a ray's slab test touches at all (bit b: block b; at
// most as many blocks as Mask has bits, hit3.sph_cull_rows). A block
// outside it fails every later test against a best t too.
template <class Mask = unsigned>
__device__ __forceinline__ Mask sph_touched(const Layout& L,
                                            const float* sbb, float ox,
                                            float oy, float oz, float ix,
                                            float iy, float iz) {
  Mask mask = 0u;
  for (int b = 0; b < L.n_sb; ++b)
    if (block_touch(sbb + b * kBbCols, ox, oy, oz, ix, iy, iz, kBig))
      mask |= Mask(1) << b;
  return mask;
}

// Entry sweep of the sphere segment: dense, or with the layout's sphere
// blocks (`cull`) block by block in row order, skipping the blocks the ray
// does not enter at or before `best`; strict `<` within, so the lowest row
// keeps a tie. Each lane walks its own touched blocks (a bit mask, lowest
// first), so a warp's lanes sweep their blocks side by side and the warp
// pays for its busiest lane's blocks, not for every block one of its lanes
// touches.
template <class Mask = unsigned>
__device__ __forceinline__ void sph_entry(const float* tab, int stride,
                                          const Layout& L, const float* sbb,
                                          bool cull, float ox, float oy,
                                          float oz, float dx, float dy,
                                          float dz, float& best, int& row) {
  if (!cull) {
    entry_seg<kSphere>(tab, stride, L.sph_start, L.sph_n, ox, oy, oz, dx,
                       dy, dz, best, row);
    return;
  }
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  for (Mask m = sph_touched<Mask>(L, sbb, ox, oy, oz, ix, iy, iz); m;
       m &= m - 1u) {
    const int b = low_bit(m);
    if (!block_touch(sbb + b * kBbCols, ox, oy, oz, ix, iy, iz, best))
      continue;
    const int lo = b * kCullRows;
    entry_seg<kSphere>(tab, stride, L.sph_start + lo,
                       imin(kCullRows, L.sph_n - lo), ox, oy, oz, dx, dy, dz,
                       best, row);
  }
}

// Any-hit over the sphere segment, culled per ray (the lane's touched
// blocks, lowest first) when the layout has sphere blocks; stops at the
// first hit.
template <class Mask = unsigned>
__device__ __forceinline__ bool sph_any(const float* tab, int stride,
                                        const Layout& L, const float* sbb,
                                        float ox, float oy, float oz,
                                        float dx, float dy, float dz) {
  if (L.n_sb == 0)
    return any_seg<kSphere>(tab, stride, L.sph_start, L.sph_n, ox, oy, oz,
                            dx, dy, dz);
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  for (Mask m = sph_touched<Mask>(L, sbb, ox, oy, oz, ix, iy, iz); m;
       m &= m - 1u) {
    const int lo = low_bit(m) * kCullRows;
    if (any_seg<kSphere>(tab, stride, L.sph_start + lo,
                         imin(kCullRows, L.sph_n - lo), ox, oy, oz, dx, dy,
                         dz))
      return true;
  }
  return false;
}

// Entry sweep of the triangle segment, block by block in row order:
// strict `<` after the dense rows' best keeps the lowest row on ties;
// `cull` skips the blocks the ray does not enter before `best`.
__device__ __forceinline__ void tri_entry(const Tris& T, const Layout& L,
                                          bool cull, float ox, float oy,
                                          float oz, float dx, float dy,
                                          float dz, float& best, int& row) {
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  for (int lo = 0, b = 0; lo < L.tri_n; lo += kCullRows, ++b) {
    if (cull &&
        !block_touch(T.bb + b * kBbCols, ox, oy, oz, ix, iy, iz, best))
      continue;
    const int hi = imin(lo + kCullRows, L.tri_n);
    for (int i = lo; i < hi; ++i) {
      float t;
      if (tri_hit(T.tab + i * kTriCols, ox, oy, oz, dx, dy, dz, t) &&
          t < best) {
        best = t;
        row = L.tri_start + i;
      }
    }
  }
}

// Any-hit over the triangle segment, culled per ray when the segment has
// cull blocks; stops at the first hit.
__device__ __forceinline__ bool tri_any_seg(const Tris& T, const Layout& L,
                                            float ox, float oy, float oz,
                                            float dx, float dy, float dz) {
  const bool cull = L.n_cb > 0;
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  for (int lo = 0, b = 0; lo < L.tri_n; lo += kCullRows, ++b) {
    if (cull &&
        !block_touch(T.bb + b * kBbCols, ox, oy, oz, ix, iy, iz, kBig))
      continue;
    const int hi = imin(lo + kCullRows, L.tri_n);
    for (int i = lo; i < hi; ++i)
      if (tri_any(T.tab + i * kTriCols, ox, oy, oz, dx, dy, dz)) return true;
  }
  return false;
}

// Exit pass over the triangle rows of the winner's group (the winner is
// triangle-local row `w`): the largest t, strict `>`, rows ascending.
__device__ __forceinline__ void tri_exit(const Tris& T, const Layout& L,
                                         int w, float ox, float oy, float oz,
                                         float dx, float dy, float dz,
                                         float& best, int& row) {
  const float* wr = T.tab + w * kTriCols;
  const float wg = __ldg(wr + T_GID);
  const int hi = imin(static_cast<int>(__ldg(wr + T_GE)), L.tri_n);
  for (int i = static_cast<int>(__ldg(wr + T_GS)); i < hi; ++i) {
    const float* r = T.tab + i * kTriCols;
    if (__ldg(r + T_GID) != wg) continue;
    float t;
    const float v = tri_hit(r, ox, oy, oz, dx, dy, dz, t) ? t : -kBig;
    if (v > best) {
      best = v;
      row = L.tri_start + i;
    }
  }
}

// Closest hit of ray (o, d) over the table `tab` (the dense rows; rows of
// `stride` floats whose first kSweepCols are the sweep columns) and, with
// kTri, the triangle segment. kNeedExit: entry and group exit, never
// culled; otherwise entry only, culled (the triangle blocks; with kSph the
// sphere blocks, in the instances of scenes without triangles or textures,
// which alone get them: hit3.sph_table). Mask: the type of a lane's
// sphere-block mask (the blocks it may hold).
template <bool kNeedExit, bool kTri = false, bool kSph = !kTri,
          class Mask = unsigned>
__device__ __forceinline__ Hit closest_hit(const float* tab, int stride,
                                           const Layout& L, float ox,
                                           float oy, float oz, float dx,
                                           float dy, float dz,
                                           const Tris& T = Tris{}) {
  float best = kBig;
  int row = 0;
  sph_entry<Mask>(tab, stride, L, T.bb, kSph && !kNeedExit && L.n_sb > 0,
                  ox, oy, oz, dx, dy, dz, best, row);
  entry_seg<kPlane>(tab, stride, L.pln_start, L.pln_n, ox, oy, oz, dx, dy,
                    dz, best, row);
  entry_seg<kBox>(tab, stride, L.box_start, L.box_n, ox, oy, oz, dx, dy, dz,
                  best, row);
  if (kTri)
    tri_entry(T, L, !kNeedExit && L.n_cb > 0, ox, oy, oz, dx, dy, dz, best,
              row);
  Hit h;
  h.te = best;
  h.row = row;
  if (!kNeedExit) {
    h.tx = best;
    h.xrow = row;
    return h;
  }
  float xbest = -kBig;
  int xrow = 0;
  if (kTri && best < kBig && row >= L.tri_start) {
    // a triangle's group holds triangle rows only
    tri_exit(T, L, row - L.tri_start, ox, oy, oz, dx, dy, dz, xbest, xrow);
  } else {
    // miss lanes keep wg = BIG, which matches no row's group id
    const float wg = best < kBig ? tab[row * stride + C_GID] : kBig;
    exit_seg<kSphere>(tab, stride, L.sph_start, L.sph_n, wg, ox, oy, oz, dx,
                      dy, dz, xbest, xrow);
    exit_seg<kPlane>(tab, stride, L.pln_start, L.pln_n, wg, ox, oy, oz, dx,
                     dy, dz, xbest, xrow);
    exit_seg<kBox>(tab, stride, L.box_start, L.box_n, wg, ox, oy, oz, dx, dy,
                   dz, xbest, xrow);
  }
  h.tx = xbest;
  h.xrow = xrow;
  return h;
}

// Occlusion: does the ray hit any valid row? (rt.rs:1036-1038) kSph: the
// sphere blocks cull, as in closest_hit.
template <bool kTri = false, bool kSph = !kTri, class Mask = unsigned>
__device__ __forceinline__ bool any_hit(const float* tab, int stride,
                                        const Layout& L, float ox, float oy,
                                        float oz, float dx, float dy,
                                        float dz, const Tris& T = Tris{}) {
  return (kSph ? sph_any<Mask>(tab, stride, L, T.bb, ox, oy, oz, dx, dy, dz)
               : any_seg<kSphere>(tab, stride, L.sph_start, L.sph_n, ox, oy,
                                  oz, dx, dy, dz)) ||
         any_seg<kPlane>(tab, stride, L.pln_start, L.pln_n, ox, oy, oz, dx,
                         dy, dz) ||
         any_seg<kBox>(tab, stride, L.box_start, L.box_n, ox, oy, oz, dx, dy,
                       dz) ||
         (kTri && tri_any_seg(T, L, ox, oy, oz, dx, dy, dz));
}

// Stage the first `cols` floats of each of `rows` rows (`stride` floats
// apart in global memory) into a dense (rows, cols) shared table,
// block-wide.
__device__ __forceinline__ void stage(float* dst, const float* src, int rows,
                                      int stride, int cols) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x)
    dst[i] = src[(i / cols) * stride + i % cols];
}

}  // namespace mrt
