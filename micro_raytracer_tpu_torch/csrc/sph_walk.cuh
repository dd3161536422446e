// The walks of a culled sphere segment (a sphere segment of 256 or more
// rows in 64-row cull blocks, hit3.cuh, in a scene without triangles or
// textures): 8-row sub-blocks behind boxes that grow with the ray's
// distance, packed 16-float rows read with 16-byte loads, the closest hit
// nearest first from inside the segment's AABB and lowest first from
// outside it, shadows lowest first. The per-step forward (step_fwd.cu, its
// kCull instances) and the whole-trace kernels (trace_fwd.cu and hit3.cu,
// their kWalk instances: walk_closest_hit, walk_any_hit) walk it.
//
// Replaces: micro_raytracer_tpu/ops/pallas_hit3.py :: sphere_cull_sweep
// over _sphere_blockbounds (the TPU kernel culled whole 64-row blocks per
// 1024-ray tile; here a lane walks its own blocks and sub-blocks), with
// _kind_block's sphere test in its operation order.
//
// What bounds it on the H100: the rows a ray tests and their loads. The
// lowest-first walk of whole 64-row blocks (hit3.cuh sph_entry) swept
// every row of each block a ray entered before its best t, and the whole
// trace staged the whole row table in shared memory (104 B a row: 2 blocks
// of 128 threads per SM for the 1,000-sphere grid). Here a visited block
// tests its sub-blocks' boxes first, bounced rays inside the grid visit
// their blocks nearest first so the best t falls early, rows come from
// global memory as four 16-byte loads through the read-only cache, and the
// whole trace stages only the boxes, the planes' and boxes' sweep rows and
// the lights, so its warps per SM are bound by registers.
//
// Numerics: float32, -fmad=false, as every source here.
#pragma once

#include "tri_walk.cuh"

namespace mrt {

// (tmin, tmax) of the ray (o, 1/d) against block AABB `bb`: hit3.cuh
// block_touch's operations in its order, so the same bits.
__device__ __forceinline__ void block_slab(const float* bb, float ox,
                                           float oy, float oz, float ix,
                                           float iy, float iz, float& tmin,
                                           float& tmax) {
  const float o[3] = {ox, oy, oz};
  const float inv[3] = {ix, iy, iz};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float t1 = (bb[k] - o[k]) * inv[k];
    const float t2 = (bb[3 + k] - o[k]) * inv[k];
    const float near = nan_min(t1, t2), far = nan_max(t1, t2);
    tmin = k == 0 ? near : nan_max(tmin, near);
    tmax = k == 0 ? far : nan_min(tmax, far);
  }
}

// The culled sphere segment's walk tables (ops/hit3.py sph_walk_tables):
// its rows packed 16 floats a row (frame, position, radius, valid) in
// global memory, 16-byte aligned (rows are segment-local); the AABBs of
// its kSubRows-row sub-blocks [lo | hi | g | 0], in global memory (the
// per-step kernel) or staged in shared memory (the whole trace's and the
// primary-hit kernel's: kSubGlobal false), 16-byte aligned; and in the
// kernels' shared memory the AABB of all its blocks, `seg` [lo | hi].
struct SphPack {
  const float* rows;
  const float* sub;
  const float* seg = nullptr;
};
constexpr int kSubRows = 8;  // ops/hit3.py SPH_SUB
constexpr int kSubs = kCullRows / kSubRows;

// hit3.cuh row_hit<kSphere> of packed row `a` (frame f, position i,
// radius, valid): four 16-byte loads, then row_hit's operations in its
// order, so the same t0, t1 and hit bit for bit. (row_hit itself is left
// as it is: sharing this code with it compiled the whole-trace kernel's
// instances to other registers.)
__device__ __forceinline__ bool sph_hit4(const float* a, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz, float& t0, float& t1) {
  const F4 r0 = ld4g(a), r1 = ld4g(a + 4), r2 = ld4g(a + 8),
           r3 = ld4g(a + 12);
  const float f[9] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w, r2.x};
  const float ix = r2.y, iy = r2.z, iz = r2.w, rad = r3.x;
  const float rx = ox - ix, ry = oy - iy, rz = oz - iz;
  const float opx = f[0] * rx + f[1] * ry + f[2] * rz + ix;
  const float opy = f[3] * rx + f[4] * ry + f[5] * rz + iy;
  const float opz = f[6] * rx + f[7] * ry + f[8] * rz + iz;
  const float dpx = f[0] * dx + f[1] * dy + f[2] * dz;
  const float dpy = f[3] * dx + f[4] * dy + f[5] * dz;
  const float dpz = f[6] * dx + f[7] * dy + f[8] * dz;
  const float ox_ = opx - ix, oy_ = opy - iy, oz_ = opz - iz;
  const float qa = dpx * dpx + dpy * dpy + dpz * dpz;
  const float bq = 2.0f * (ox_ * dpx + oy_ * dpy + oz_ * dpz);
  const float c = ox_ * ox_ + oy_ * oy_ + oz_ * oz_ - rad * rad;
  const float disc = bq * bq - 4.0f * qa * c;
  const float sq = sqrtf(disc >= 0.0f ? nan_max(disc, 1e-12f) : 1.0f);
  const float a2 = qa == 0.0f ? 1.0f : 2.0f * qa;
  t0 = (-bq - sq) / a2;
  t1 = (-bq + sq) / a2;
  const bool ok = (disc >= 0.0f) && (t0 >= 0.0f);
  return ok && r3.y > 0.5f && isfinite(t0) && isfinite(t1);
}

// Does the ray (o, 1/d) enter sub-block AABB `sb` at or before `best`,
// the box grown by g (1 + |o - c|^2), c its centre and g = sb[6]? A row
// the sphere test (hit3.cuh sphere_hit) reports hit lies inside the box
// so grown, and its t0 is at least the grown box's entry t: the test's
// rounding, on a ray that grazes the sphere from a distance |o - c|,
// moves its closest approach by about 1e-7 |o - c|^2 / r and, where the
// discriminant is near zero, its t0 by about 3.5e-4 |o - c| (the square
// root of the discriminant's rounding), and g (ops/hit3.py
// sph_walk_tables) is 1e-3 + 2e-6 / r, at least twice both. So a skipped
// sub-block holds no row a whole block's sweep would have taken: a far
// ray's sphere hits can lie outside the slacked boxes (about 0.01 at 200
// units), and a sub-block culled at its bare box would drop them.
template <bool kSubGlobal = true>
__device__ __forceinline__ bool sub_touch(const float* sb, float ox,
                                          float oy, float oz, float ix,
                                          float iy, float iz, float best) {
  const F4 a = kSubGlobal ? ld4g(sb) : ld4(sb);
  const F4 b = kSubGlobal ? ld4g(sb + 4) : ld4(sb + 4);
  const float qx = ox - 0.5f * (a.x + a.w), qy = oy - 0.5f * (a.y + b.x),
              qz = oz - 0.5f * (a.z + b.y);
  const float grow = b.z * (1.0f + qx * qx + qy * qy + qz * qz);
  const float lo[3] = {a.x - grow, a.y - grow, a.z - grow};
  const float hi[3] = {a.w + grow, b.x + grow, b.y + grow};
  const float o[3] = {ox, oy, oz};
  const float inv[3] = {ix, iy, iz};
  float tmin = 0.0f, tmax = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float t1 = (lo[k] - o[k]) * inv[k];
    const float t2 = (hi[k] - o[k]) * inv[k];
    const float near = nan_min(t1, t2), far = nan_max(t1, t2);
    tmin = k == 0 ? near : nan_max(tmin, near);
    tmax = k == 0 ? far : nan_min(tmax, far);
  }
  return tmax >= nan_max(tmin, 0.0f) && tmin <= best;
}

// The rows of sphere block b, sub-block by sub-block: a sub-block whose
// grown AABB (sub_touch) the ray does not enter at or before `best`
// (kAny: does not meet; best is BIG) is skipped. Entry (kAny false): a hit
// takes the best when its (t, row) is the smaller pair, so a tie goes to
// the lowest row in any order of blocks; kAny: true at the first hit.
template <bool kAny, bool kSubGlobal = true>
__device__ __forceinline__ bool sph_block_rows(const Layout& L,
                                               const SphPack& P, int b,
                                               float ox, float oy, float oz,
                                               float dx, float dy, float dz,
                                               float ix, float iy, float iz,
                                               float& best, int& row) {
  for (int s = b * kSubs; s < b * kSubs + kSubs; ++s) {
    const int r0 = s * kSubRows;
    if (r0 >= L.sph_n) break;
    if (!sub_touch<kSubGlobal>(P.sub + s * kBbCols, ox, oy, oz, ix, iy, iz,
                               best))
      continue;
    const int r1 = imin(r0 + kSubRows, L.sph_n);
    for (int i = r0; i < r1; ++i) {
      float t0, t1;
      if (!sph_hit4(P.rows + i * 16, ox, oy, oz, dx, dy, dz, t0, t1))
        continue;
      if (kAny) return true;
      const int r = L.sph_start + i;
      if (t0 < best || (t0 == best && r < row)) {
        best = t0;
        row = r;
      }
    }
  }
  return false;
}

// Entry sweep of the sphere segment through its cull blocks `sbb`: the
// blocks the ray's slab test touches at all (hit3.cuh sph_touched), their
// entry t kept in `tb` (the lane's column of shared memory, stride ts),
// each swept sub-block by sub-block (sph_block_rows). A ray whose origin
// lies inside the segment's AABB (P.seg: a bounced ray inside the grid)
// visits them nearest first, in ascending entry t until the next begins
// beyond `best`; any other ray lowest first, skipping a block it does not
// enter at or before `best`: hit3.cuh sph_entry's walk.
//
// Why the nearest-first walk gives the lowest-first walk's t and row: a
// sphere's hit point lies inside its block's AABB (centre +- r with a
// slack of 1e-4 + 1e-4 * extent, hit3.sph_blockbounds), so a hit's t is
// at least its block's entry t; a block skipped here begins beyond the
// best t, so its hits lose to it, and a block skipped there did likewise.
// Both walks thus give the smallest (t, row) over the rows of every
// touched block, the dense sweep's. The sphere test's rounding can put a
// grazing hit outside its block's box (a phantom), where the two orders
// could part, only from origins some tens of units away (sub_touch's
// estimate against the slack); inside the segment's box the origins are
// within its diagonal of every sphere. The host tests
// (test_torch_step_walk.py) and the outputs of tools/torch_compare_trees.py
// hold the two equal ray by ray. Bounced rays inside a grid meet many
// blocks, and the lowest-first walk swept each whose entry came before its
// best so far, all 64 rows of it.
template <class Mask, bool kSubGlobal = true>
__device__ __forceinline__ void sph_entry_nearest(
    const Layout& L, const float* sbb, const SphPack& P, float* tb, int ts,
    float ox, float oy, float oz, float dx, float dy, float dz, float& best,
    int& row) {
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  Mask m = 0u;
  for (int b = 0; b < L.n_sb; ++b) {
    float tmin, tmax;
    block_slab(sbb + b * kBbCols, ox, oy, oz, ix, iy, iz, tmin, tmax);
    if (tmax >= nan_max(tmin, 0.0f) && tmin <= kBig) {
      m |= Mask(1) << b;
      tb[b * ts] = tmin;
    }
  }
  const float* g = P.seg;
  const bool inside = ox >= g[0] && oy >= g[1] && oz >= g[2] &&
                      ox <= g[3] && oy <= g[4] && oz <= g[5];
  while (m) {
    int nb = low_bit(m);
    float nt = tb[nb * ts];
    if (inside) {
      for (Mask q = m & (m - 1u); q; q &= q - 1u) {
        const int b = low_bit(q);
        const float t = tb[b * ts];
        if (t < nt) {
          nt = t;
          nb = b;
        }
      }
      if (!(nt <= best)) break;
    }
    m &= ~(Mask(1) << nb);
    if (nt <= best)
      sph_block_rows<false, kSubGlobal>(L, P, nb, ox, oy, oz, dx, dy, dz, ix,
                                        iy, iz, best, row);
  }
}

// Any-hit over the sphere segment: hit3.cuh sph_any's walk (the touched
// blocks lowest first: a shadow ray leaves its origin's block, which a
// nearest-first walk would take first), each block sub-block by sub-block.
template <class Mask, bool kSubGlobal = true>
__device__ __forceinline__ bool sph_any_sub(const Layout& L,
                                            const float* sbb,
                                            const SphPack& P, float ox,
                                            float oy, float oz, float dx,
                                            float dy, float dz) {
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  float big = kBig;
  int row = 0;
  for (Mask m = sph_touched<Mask>(L, sbb, ox, oy, oz, ix, iy, iz); m;
       m &= m - 1u)
    if (sph_block_rows<true, kSubGlobal>(L, P, low_bit(m), ox, oy, oz, dx,
                                         dy, dz, ix, iy, iz, big, row))
      return true;
  return false;
}

// What the whole trace's and the primary-hit kernel's sweeps of a culled
// sphere segment read (their kWalk instances): the walk tables P (its
// sub-blocks in shared memory), the 64-row blocks' AABBs `sbb` (shared
// memory), the lane's column `tb` (stride ts) of its blocks' entry t, and
// `pb`, the sweep columns (kSweepCols a row) of the plane and box rows in
// shared memory, based so that row r (r >= L.pln_start) is at pb + r *
// kSweepCols.
struct SphWalk {
  SphPack P;
  const float* sbb;
  float* tb;
  int ts;
  const float* pb;
};

// Closest hit of ray (o, d) over a scene whose sphere segment is culled:
// the sphere segment walked through its sub-blocks (sph_entry_nearest),
// then the planes and boxes dense: hit3.cuh closest_hit's kSph sweep, the
// same t and row (its lowest-first walk of 64-row blocks; the two walks'
// equality is argued at sph_entry_nearest). kNeedExit: in a scene without
// triangles every group is one row (models/compiler.py), so the winner's
// group exit is the winner row's own t1, computed once. That is what
// hit3.cuh exit_seg's sweep over every row gives, bit for bit (the same
// row test: sph_hit4 is row_hit<kSphere> on the packed row).
template <bool kNeedExit, class Mask = unsigned>
__device__ __forceinline__ Hit walk_closest_hit(const Layout& L,
                                                const SphWalk& W, float ox,
                                                float oy, float oz, float dx,
                                                float dy, float dz) {
  float best = kBig;
  int row = 0;
  sph_entry_nearest<Mask, false>(L, W.sbb, W.P, W.tb, W.ts, ox, oy, oz, dx,
                                 dy, dz, best, row);
  entry_seg<kPlane>(W.pb, kSweepCols, L.pln_start, L.pln_n, ox, oy, oz, dx,
                    dy, dz, best, row);
  entry_seg<kBox>(W.pb, kSweepCols, L.box_start, L.box_n, ox, oy, oz, dx,
                  dy, dz, best, row);
  if (!kNeedExit) return Hit{best, row, best, row};
  float xbest = -kBig;
  int xrow = 0;
  if (best < kBig) {
    float t0, t1;
    bool ok;
    if (row < L.sph_start + L.sph_n)
      ok = sph_hit4(W.P.rows + (row - L.sph_start) * 16, ox, oy, oz, dx, dy,
                    dz, t0, t1);
    else if (row < L.pln_start + L.pln_n)
      ok = row_hit<kPlane>(W.pb + row * kSweepCols, ox, oy, oz, dx, dy, dz,
                           t0, t1);
    else
      ok = row_hit<kBox>(W.pb + row * kSweepCols, ox, oy, oz, dx, dy, dz, t0,
                         t1);
    const float v = ok ? t1 : -kBig;
    if (v > xbest) {
      xbest = v;
      xrow = row;
    }
  }
  return Hit{best, row, xbest, xrow};
}

// Occlusion over a scene whose sphere segment is culled: the spheres
// through their sub-blocks lowest first (sph_any_sub), then the planes and
// boxes: hit3.cuh any_hit's bit.
template <class Mask = unsigned>
__device__ __forceinline__ bool walk_any_hit(const Layout& L,
                                             const SphWalk& W, float ox,
                                             float oy, float oz, float dx,
                                             float dy, float dz) {
  return sph_any_sub<Mask, false>(L, W.sbb, W.P, ox, oy, oz, dx, dy, dz) ||
         any_seg<kPlane>(W.pb, kSweepCols, L.pln_start, L.pln_n, ox, oy, oz,
                         dx, dy, dz) ||
         any_seg<kBox>(W.pb, kSweepCols, L.box_start, L.box_n, ox, oy, oz, dx,
                       dy, dz);
}

}  // namespace mrt
