// step_fwd: one bounce step of every ray per launch, from a carry in
// device memory to the next — the forward of the per-step path, which
// takes the scenes past the whole-trace kernels' bounds (more than 4
// lights; more than step.MAX_ROWS sphere, plane and box rows, or
// step.BWD_MAX_ROWS in training; ops/step.py route). Two instances share
// one body: the render instance (mrt_step_fwd) and the train instance
// (mrt_step_fwd_train), which also writes the step's residuals in the
// layout of trace_step.cuh (ResRow; one step, K = 1) for the backward
// kernel step_bwd.cu.
//
// Replaces: micro_raytracer_tpu/ops/pallas_step.py :: _step_kernel (l.1110,
// called by _call_step l.1192, pallas_call l.1256) with its body _step_math
// (emit_kill off, as the TPU kernel runs it) in inference and train mode;
// the per-step scan around it is step.trace_steps (models/tracer.py:564-597
// in the JAX package). What it computes is trace_fwd.cu's step: closest
// hit (hit3.cuh; entry and group exit on a refractive scene), one any-hit
// shadow sweep per light from the entry point, reflect / refract from the
// step's uniforms, direct light at the chosen point with the entry point's
// occlusion, the next ray and the fold B += A*b, A *= a; textures (kTex)
// and triangles (kTri) as there. The TPU kernel's one-hot attribute fetch,
// its lane-major and component-form layouts and its whole-tile dead skip
// have no counterpart: a thread reads its winner row and a dead ray skips
// its own work.
//
// Carry (trace_step.cuh CarryRow, (14, R) floats, rays on the fastest
// axis): o, d, pwr, live, A, B. A ray that is dead on entry or misses
// passes its carry through (live 0); pwr decays on every lane, as in the
// JAX step. An emit draw ends the ray (live 0 after the step; A = 0, so
// nothing later contributes). hit (R,) is the step's hit liveness before
// that kill (the JAX step's live2): step 0's is the trace's first_live,
// and the train instance writes the residuals of the rays that hit.
// Composed over K steps this is the whole trace bit for bit (the same
// device functions in the same order; only the carry's round trip through
// device memory is added).
//
// Lights: any number L, in shared memory; each light's shadow sweep runs
// beside its direct-light term in light order, so no per-light state is
// kept (trace_fwd.cu holds kMaxLights occlusion bits in registers). The
// render instance skips the lights of a step whose emit draw fires (its b
// is the albedo; the train instance still writes their occlusion bits).
//
// What bounds it on the H100: arithmetic and divergence, as trace_fwd.cu:
// a live ray runs 1 + L sweeps per step. Bytes: 56 in and 56 out of carry,
// 4*NU of uniforms per ray (train: 4*CR of residuals per ray that hits).
// The dense rows are read from global memory through L1 and L2 (no row
// bound: a 3,376-row table is 351 KB, past the 227 KB of shared memory);
// the lights and the cull blocks' AABBs (the triangle segment's, at most
// hit3.MAX_TRI_BLOCKS, past which the kTriIn instances below take over, or
// the sphere segment's, at most 64) are staged in shared memory. The
// sphere cull holds 64 blocks per lane (StepMask), the JAX package's bound
// (pallas_hit3._CAND_MAX); beyond that a segment sweeps dense.
//
// The design (PERF.md, row 4's ablation: a one-ray-per-thread walk of
// whole 64-row blocks spent the 3,375-sphere grid's time in sphere rows,
// half of them in the shadow walks, the big meshes' in the shadow walks'
// 1,024 slab tests, and 16-40% of a sample in warps' dead lanes):
//  * a culled sphere segment (kCull) is walked through 64-row blocks and
//    their 8-row sub-blocks, whose boxes grow with the ray's distance past
//    the sphere test's rounding (sub_touch), its rows read as 16-byte
//    loads of a packed copy (ops/hit3.py sph_walk_tables); the closest
//    hit visits the blocks nearest first from inside the segment's box,
//    lowest first from outside it (sph_entry_nearest), the shadows lowest
//    first (sph_any_sub);
//  * the kSph and kTriIn instances' warps refill from a ray counter and
//    step only live rays, 32 at a time (refill_rays); the kTri and kTex
//    instances step one ray per thread, and a block whose lanes are all
//    dead only passes its carry through.
//
// kTriIn (a triangle segment of more blocks than hit3.MAX_TRI_BLOCKS, a
// mesh of more than 16,384 triangles): the closest hit takes the triangle
// segment's (te, row, tx, xrow) from tri.cu's launch before the step and
// merges it with the dense rows by closest_hit_tri_pallas's rule
// (micro_raytracer_tpu/ops/intersect.py:488-524): triangles are the last
// segment, so a triangle wins only with te strictly below the dense rows'
// best, and its group's exit is the triangles' exit. The shadow sweeps
// walk the triangle blocks through their superblocks (tri_walk.cuh
// tri_any_walk; the superblocks staged in shared memory, the block AABBs
// read from global memory), where a one-level walk slab-tested every
// block for every shadow ray.
//
// Numerics: float32, -fmad=false, as trace_fwd.cu.
#include "trace_step.cuh"
#include "tri_walk.cuh"

namespace mrt {

// A lane's sphere-block mask in the per-step kernel: up to 64 blocks.
using StepMask = unsigned long long;

// The triangle segment's hit of each ray (kTriIn): te, the triangle-local
// row, and on a refractive scene the group exit tx, xrow (tri.cu).
struct TriIn {
  const float* te;
  const int* row;
  const float* tx;
  const int* xrow;
};

// Closest hit over the dense rows (spheres dense, as every triangle
// instance sweeps them) merged with the triangle segment's hit `in` of ray
// i; kNeedExit: the winner group's exit too.
template <bool kNeedExit>
__device__ __forceinline__ Hit closest_hit_in(const float* tab, int stride,
                                              const Layout& L, float ox,
                                              float oy, float oz, float dx,
                                              float dy, float dz,
                                              const TriIn& in, int i) {
  float best = kBig;
  int row = 0;
  entry_seg<kSphere>(tab, stride, L.sph_start, L.sph_n, ox, oy, oz, dx, dy,
                     dz, best, row);
  entry_seg<kPlane>(tab, stride, L.pln_start, L.pln_n, ox, oy, oz, dx, dy,
                    dz, best, row);
  entry_seg<kBox>(tab, stride, L.box_start, L.box_n, ox, oy, oz, dx, dy, dz,
                  best, row);
  const float tt = in.te[i];
  const bool tri_won = tt < best;
  if (tri_won) {
    best = tt;
    row = L.tri_start + in.row[i];
  }
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
  if (tri_won) {
    xbest = in.tx[i];
    xrow = L.tri_start + in.xrow[i];
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

// The culled sphere segment's tables of the per-step walks
// (ops/hit3.py sph_walk_tables): its rows packed 16 floats a row (frame,
// position, radius, valid) and the AABBs of its kSubRows-row sub-blocks
// [lo | hi | g | 0], both in global memory, 16-byte aligned (rows are
// segment-local); and in the kernels' shared memory the AABB of all its
// blocks, `seg` [lo | hi].
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
__device__ __forceinline__ bool sub_touch(const float* sb, float ox,
                                          float oy, float oz, float ix,
                                          float iy, float iz, float best) {
  const F4 a = ld4g(sb), b = ld4g(sb + 4);
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
template <bool kAny>
__device__ __forceinline__ bool sph_block_rows(const Layout& L,
                                               const SphPack& P, int b,
                                               float ox, float oy, float oz,
                                               float dx, float dy, float dz,
                                               float ix, float iy, float iz,
                                               float& best, int& row) {
  for (int s = b * kSubs; s < b * kSubs + kSubs; ++s) {
    const int r0 = s * kSubRows;
    if (r0 >= L.sph_n) break;
    if (!sub_touch(P.sub + s * kBbCols, ox, oy, oz, ix, iy, iz, best))
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
template <class Mask>
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
      sph_block_rows<false>(L, P, nb, ox, oy, oz, dx, dy, dz, ix, iy, iz,
                            best, row);
  }
}

// Any-hit over the sphere segment: hit3.cuh sph_any's walk (the touched
// blocks lowest first: a shadow ray leaves its origin's block, which a
// nearest-first walk would take first), each block sub-block by sub-block.
template <class Mask>
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
    if (sph_block_rows<true>(L, P, low_bit(m), ox, oy, oz, dx, dy, dz, ix,
                             iy, iz, big, row))
      return true;
  return false;
}

// The closest hit of the per-step kernels: hit3.cuh closest_hit's, or
// with kCull (the instances of a culled sphere segment: sphere blocks
// staged in T.bb, L.n_sb > 0) the sphere blocks walked nearest first
// (sph_entry_nearest) where the sweep is entry only.
template <bool kNeedExit, bool kTri, bool kSph, bool kCull = false>
__device__ __forceinline__ Hit step_closest_hit(const float* tab,
                                                const Layout& L, float ox,
                                                float oy, float oz, float dx,
                                                float dy, float dz,
                                                const Tris& T,
                                                const SphPack& P, float* tb,
                                                int ts) {
  if constexpr (kCull && !kNeedExit) {
    float best = kBig;
    int row = 0;
    sph_entry_nearest<StepMask>(L, T.bb, P, tb, ts, ox, oy, oz, dx, dy, dz,
                                best, row);
    entry_seg<kPlane>(tab, kRowCols, L.pln_start, L.pln_n, ox, oy, oz, dx,
                      dy, dz, best, row);
    entry_seg<kBox>(tab, kRowCols, L.box_start, L.box_n, ox, oy, oz, dx, dy,
                    dz, best, row);
    return Hit{best, row, best, row};
  } else {
    return closest_hit<kNeedExit, kTri, kSph, StepMask>(tab, kRowCols, L, ox,
                                                        oy, oz, dx, dy, dz,
                                                        T);
  }
}

// Occlusion of the per-step kernels: hit3.cuh any_hit's, or with kCull
// the culled sphere segment walked sub-block by sub-block (sph_any_sub).
template <bool kTri, bool kSph, bool kCull = false>
__device__ __forceinline__ bool step_any_hit(const float* tab,
                                             const Layout& L, float ox,
                                             float oy, float oz, float dx,
                                             float dy, float dz,
                                             const Tris& T,
                                             const SphPack& P) {
  if constexpr (kCull)
    return sph_any_sub<StepMask>(L, T.bb, P, ox, oy, oz, dx, dy, dz) ||
           any_seg<kPlane>(tab, kRowCols, L.pln_start, L.pln_n, ox, oy, oz,
                           dx, dy, dz) ||
           any_seg<kBox>(tab, kRowCols, L.box_start, L.box_n, ox, oy, oz, dx,
                         dy, dz);
  else
    return any_hit<kTri, kSph, StepMask>(tab, kRowCols, L, ox, oy, oz, dx,
                                         dy, dz, T);
}

// Occlusion for the kTriIn instances: the dense rows, then the triangle
// segment through the two levels of its cull blocks (tri_walk.cuh
// tri_any_walk, `S` its superblocks), where hit3.cuh any_hit walked its
// blocks one level (tri_any_seg); the same bit.
__device__ __forceinline__ bool any_hit_in(const float* tab, const Layout& L,
                                           const Tris& T, const Supers& S,
                                           float ox, float oy, float oz,
                                           float dx, float dy, float dz) {
  return any_seg<kSphere>(tab, kRowCols, L.sph_start, L.sph_n, ox, oy, oz,
                          dx, dy, dz) ||
         any_seg<kPlane>(tab, kRowCols, L.pln_start, L.pln_n, ox, oy, oz, dx,
                         dy, dz) ||
         any_seg<kBox>(tab, kRowCols, L.box_start, L.box_n, ox, oy, oz, dx,
                       dy, dz) ||
         tri_any_walk(T, L, S, walk_blocks(L), ox, oy, oz, dx, dy, dz);
}

// What the walks of a step read beyond the tables: with a culled sphere
// segment, the lane's column `tb` (stride ts) of its blocks' entry t and
// the packed rows and sub-blocks `sph`; on a kTriIn instance the triangle
// segment's hits `tin` and its cull blocks' superblocks `sup`.
struct StepWalk {
  float* tb = nullptr;
  int ts = 0;
  SphPack sph{};
  TriIn tin{};
  Supers sup{};
};

// One ray's bounce step from the carry `c0` to `c1` (both (14, R)) with
// the step's uniforms `u8` (NU, R); hit_out (R,) the step's hit liveness;
// kTrain: the step's residuals (CR, R) of a ray that hits. `tab` is the
// whole row table in global memory, `s_lt` the lights and T.bb the cull
// blocks in shared memory (kTriIn: T.bb in global memory; kTriIn takes
// kTri), `W` what the walks read besides; kCull: the sphere segment has
// cull blocks and W its walk tables (kCull takes !kTri, !kTex).
template <bool kRefract, bool kTrain, bool kTri = false, bool kTex = false,
          bool kTriIn = false, bool kCull = false>
__device__ __forceinline__ void step_ray(
    const float* tab, const Tris& T, const Layout& lay, const float* s_lt,
    int L, float dk, const Tex& tex, int i, int R,
    const float* __restrict__ c0, const float* __restrict__ u8,
    float* __restrict__ c1, float* __restrict__ hit_out,
    float* __restrict__ resid, const StepWalk& W = StepWalk{}) {
  constexpr bool kSph = !kTri && !kTex;  // the sphere blocks (hit3.cuh)
  const float* c = c0 + i;
  V3 o = v3(c[(kC_O + 0) * R], c[(kC_O + 1) * R], c[(kC_O + 2) * R]);
  V3 d = v3(c[(kC_D + 0) * R], c[(kC_D + 1) * R], c[(kC_D + 2) * R]);
  const float pwr = c[kC_PWR * R];
  V3 A = v3(c[(kC_A + 0) * R], c[(kC_A + 1) * R], c[(kC_A + 2) * R]);
  V3 B = v3(c[(kC_B + 0) * R], c[(kC_B + 1) * R], c[(kC_B + 2) * R]);
  bool hit = false, alive = false;
  Hit h{};
  if (c[kC_LIVE * R] > 0.5f) {
    if constexpr (kTriIn)
      h = closest_hit_in<kRefract>(tab, kRowCols, lay, o.x, o.y, o.z, d.x,
                                   d.y, d.z, W.tin, i);
    else
      h = step_closest_hit<kRefract, kTri, kSph, kCull>(
          tab, lay, o.x, o.y, o.z, d.x, d.y, d.z, T, W.sph, W.tb, W.ts);
    hit = h.te < kBig * 0.5f;
  }
  if (hit) {
    const float* u = u8 + i;
    const int side_rows = kTex ? tex_side_rows(tex.slots) : 0;
    float* r = kTrain ? resid + i : nullptr;
    const float* atE = row_at<kTri>(tab, tab, h.row, lay);
    const V3 p_e = add(o, scale(d, h.te));
    const int kind_e = row_kind<kTri>(h.row, lay);
    const V3 n_e = normal_full(atE, p_e, kind_e).n;
    Texels tE{};  // the entry side's texels (kTex)
    if constexpr (kTex) {
      side_texels(tex, h.row, atE, p_e, kind_e, tE);
      if constexpr (kTrain)
        write_texels(r, res_rows<kTri>(L), R, tex.slots, tE);
    }
    const Side<kTex> sE(atE, tE);
    const float opa_e = sE.col(A_OPA);

    // reflect from the entry hit (rt.rs:559-572)
    const float rough_r = rough_override(sE, u[0]) ? 1.0f : sE.col(A_RGH);
    const V3 nr = sphere_rand(n_e, rough_r, u[R], u[2 * R]);
    const V3 refl = safe_norm(sub(d, scale(nr, 2.0f * dot(d, nr))));

    V3 next_dir = refl, from_p = p_e, norm_c = n_e;
    Side<kTex> sC = sE;  // the chosen side's material
    bool choose = false;
    float u_emit;
    if (kRefract) {
      // refract from the exit hit (rt.rs:574-589, 1054-1058)
      const float* atX = row_at<kTri>(tab, tab, h.xrow, lay);
      const V3 p_x = add(o, scale(d, h.tx));
      const int kind_x = row_kind<kTri>(h.xrow, lay);
      const V3 n_x = normal_full(atX, p_x, kind_x).n;
      Texels tX{};
      if constexpr (kTex) {
        side_texels(tex, h.xrow, atX, p_x, kind_x, tX);
        if constexpr (kTrain)
          write_texels(r, res_rows<kTri>(L) + side_rows, R, tex.slots, tX);
      }
      const Side<kTex> sX(atX, tX);
      const float rough_f =
          rough_override(sX, u[3 * R]) ? 1.0f : sX.col(A_RGH);
      const V3 nf = sphere_rand(n_x, rough_f, u[4 * R], u[5 * R]);
      const float eta = 1.0f + 0.5f * sX.col(A_GLS);
      const float cs = -dot(nf, d);
      const float kk = 1.0f - eta * eta * (1.0f - cs * cs);
      const bool refr_ok = kk >= 0.0f;
      const float k_safe = refr_ok ? fmaxf(kk, 1e-12f) : 1.0f;
      const V3 refr = finite0(safe_norm(
          add(scale(d, eta), scale(nf, cs * eta + sqrtf(k_safe)))));
      choose = (u[6 * R] < fminf(1.0f - opa_e, 0.85f)) && refr_ok;
      if (choose) {
        next_dir = refr;
        from_p = p_x;
        norm_c = n_x;
        sC = sX;
      }
      u_emit = u[7 * R];
    } else {
      u_emit = u[3 * R];
    }
    const V3 alb_c = sC.alb();
    const float rgh_c = sC.col(A_RGH);
    const float met_c = sC.col(A_MET);
    const bool b_emit = u_emit < sC.col(A_EMI);

    // direct light at the chosen point, occlusion from the entry point
    // (rt.rs:973-987 vs 1027-1046): per light, its shadow sweep, then its
    // term, summed in light order as trace_fwd.cu sums them
    V3 l_col = v3(0.0f, 0.0f, 0.0f);
    if (kTrain || !b_emit) {
      for (int li = 0; li < L; ++li) {
        const float* lt = s_lt + li * kLightCols;
        const V3 lv_e = light_vec(lt, p_e);
        const V3 ln_e = scale(lv_e, 1.0f / sqrtf(dot(lv_e, lv_e)));
        const V3 so = add(p_e, scale(ln_e, kEps));
        bool ok;
        if constexpr (kTriIn)
          ok = !any_hit_in(tab, lay, T, W.sup, so.x, so.y, so.z, ln_e.x,
                           ln_e.y, ln_e.z);
        else
          ok = !step_any_hit<kTri, kSph, kCull>(tab, lay, so.x, so.y, so.z,
                                                ln_e.x, ln_e.y, ln_e.z, T,
                                                W.sph);
        if constexpr (kTrain) r[(R_LOK + li) * R] = ok ? 1.0f : 0.0f;
        if (!ok) continue;
        const V3 lv = light_vec(lt, from_p);
        const V3 ln = scale(lv, 1.0f / sqrtf(dot(lv, lv)));
        const float diff = fmaxf(dot(ln, norm_c), 0.0f);
        const V3 lrefl = sub(ln, scale(norm_c, 2.0f * dot(ln, norm_c)));
        const float spec =
            pow32(fmaxf(dot(d, lrefl), 0.0f)) * (1.0f - rgh_c);
        const V3 o_col = scale(alb_c, 1.0f - met_c);
        const float pl = lt[7];
        l_col = add(l_col, v3((o_col.x * diff * lt[8] + spec) * pl,
                              (o_col.y * diff * lt[9] + spec) * pl,
                              (o_col.z * diff * lt[10] + spec) * pl));
      }
    }

    if constexpr (kTrain) {
      r[(R_O + 0) * R] = o.x;
      r[(R_O + 1) * R] = o.y;
      r[(R_O + 2) * R] = o.z;
      r[(R_D + 0) * R] = d.x;
      r[(R_D + 1) * R] = d.y;
      r[(R_D + 2) * R] = d.z;
      r[(R_A + 0) * R] = A.x;
      r[(R_A + 1) * R] = A.y;
      r[(R_A + 2) * R] = A.z;
      r[R_TE * R] = h.te;
      r[R_TX * R] = h.tx;
      r[R_ROW * R] = static_cast<float>(h.row);
      r[R_CHOOSE * R] = choose ? 1.0f : 0.0f;
      if (kTri) r[res_xrow(L) * R] = static_cast<float>(h.xrow);
    }

    // fold update (rt.rs:966-992 composed forward)
    const V3 a_f = b_emit ? v3(0.0f, 0.0f, 0.0f)
                          : v3(pwr * (0.5f + alb_c.x), pwr * (0.5f + alb_c.y),
                               pwr * (0.5f + alb_c.z));
    const V3 b_f = b_emit ? alb_c : scale(l_col, pwr);
    B = add(B, mul(A, b_f));
    A = mul(A, a_f);
    o = add(from_p, scale(next_dir, kEps));  // Ray::cast
    d = next_dir;
    alive = !b_emit;  // emit kill: A == 0, nothing later contributes
  }
  hit_out[i] = hit ? 1.0f : 0.0f;
  float* out = c1 + i;
  const float v[kCarryRows] = {o.x, o.y, o.z, d.x, d.y, d.z, pwr * dk,
                               alive ? 1.0f : 0.0f, A.x, A.y, A.z,
                               B.x, B.y, B.z};
#pragma unroll
  for (int k = 0; k < kCarryRows; ++k) out[k * R] = v[k];
}

}  // namespace mrt

#ifdef __CUDACC__
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

#include "grid.cuh"

namespace {

constexpr int kThreads = 128;

constexpr unsigned kFull = 0xffffffffu;

// Persistent warps that refill (the kSph and kTriIn instances): a warp
// takes 32 rays at a time from the counter next[0] (one atomic), passes
// each dead one's carry through (dead(j)) and queues the live ones in its
// 64 slots of shared memory s_q; whenever 32 are queued its lanes step
// those 32 together (live(j)), so that its warps step full warps of live
// rays, in the frame's order, and the rest (under 32) once the counter
// passes R. Every ray's outputs are its own, whichever lane steps it.
template <class Live, class Dead>
__device__ __forceinline__ void refill_rays(int R, const float* c0,
                                            int* next, int* s_q,
                                            const Live& live,
                                            const Dead& dead) {
  const int lane = threadIdx.x & 31;
  int q = 0;  // queued live rays, the same on every lane
  while (true) {
    int base = 0;
    if (lane == 0) base = atomicAdd(next, 32);
    base = __shfl_sync(kFull, base, 0);
    if (base >= R) break;
    const int j = base + lane;
    const bool on = j < R && c0[mrt::kC_LIVE * R + j] > 0.5f;
    if (j < R && !on) dead(j);
    const unsigned bal = __ballot_sync(kFull, on);
    if (on) s_q[q + __popc(bal & ((1u << lane) - 1u))] = j;
    q += __popc(bal);
    __syncwarp();
    if (q >= 32) {
      const int r = s_q[lane];
      __syncwarp();
      if (lane < q - 32) s_q[lane] = s_q[32 + lane];
      __syncwarp();
      q -= 32;
      live(r);
    }
  }
  __syncwarp();
  if (lane < q) live(s_q[lane]);
}

// The last block of a refilling launch to finish zeroes its counters for
// the next launch (every block's atomics on next[0] have returned).
__device__ __forceinline__ void release_counters(int* next) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(next + 1, 1) == static_cast<int>(gridDim.x) - 1) {
      next[0] = 0;
      next[1] = 0;
    }
  }
}

// kSph (scenes without triangles or textures) and kTriIn instances refill
// their warps (refill_rays): a sample's later steps leave a third to a
// half of the lanes dead, and a warp of the one-ray-per-thread schedule
// paid for its live lanes' walks beside its dead ones (PERF.md, row 4's
// ablation: the same carries with their live rays first took 16-40% off a
// sample). kTri and kTex instances step one ray per thread.
template <bool kRefract, bool kTrain, bool kTri, bool kTex, bool kCull>
__global__ void step_fwd_kernel(const float* __restrict__ tab,
                                mrt::Layout lay,
                                const float* __restrict__ tri,
                                const float* __restrict__ bb,
                                const float* __restrict__ sbb,
                                const float* __restrict__ lights, int L,
                                float dk, mrt::Tex tex,
                                const float* __restrict__ c0,
                                const float* __restrict__ u8, int R,
                                float* __restrict__ c1,
                                float* __restrict__ hit,
                                float* __restrict__ resid,
                                mrt::SphPack sph, int* __restrict__ next) {
  constexpr bool kSph = !kTri && !kTex;
  extern __shared__ float smem[];
  float* s_lt = smem;
  float* s_bb = s_lt + L * mrt::kLightCols;
  if constexpr (kSph) {
    __shared__ int s_q[2 * kThreads];
    __shared__ float s_seg[mrt::kBbCols];
    float* s_tb = s_bb + lay.n_sb * mrt::kBbCols;
    mrt::stage(s_lt, lights, L, mrt::kLightCols, mrt::kLightCols);
    mrt::stage(s_bb, sbb, lay.n_sb, mrt::kBbCols, mrt::kBbCols);
    __syncthreads();
    // the AABB of all the sphere blocks (at most 64: one chunk)
    if (kCull) mrt::chunk_bounds(s_bb, lay.n_sb, s_seg, threadIdx.x, 6);
    __syncthreads();
    const mrt::Tris T{tri, s_bb};
    const mrt::StepWalk W{s_tb + threadIdx.x, kThreads,
                          mrt::SphPack{sph.rows, sph.sub, s_seg}};
    refill_rays(
        R, c0, next, s_q + 2 * (threadIdx.x & ~31u),
        [&](int j) {
          mrt::step_ray<kRefract, kTrain, kTri, kTex, false, kCull>(
              tab, T, lay, s_lt, L, dk, tex, j, R, c0, u8, c1, hit, resid,
              W);
        },
        [&](int j) {
          mrt::step_ray<kRefract, kTrain, kTri, kTex>(
              tab, T, lay, s_lt, L, dk, tex, j, R, c0, u8, c1, hit, resid);
        });
    release_counters(next);
    return;
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // a block whose lanes are all dead only passes its carry through
  if (__syncthreads_or(i < R && c0[mrt::kC_LIVE * R + i] > 0.5f)) {
    mrt::stage(s_lt, lights, L, mrt::kLightCols, mrt::kLightCols);
    if (kTri)
      mrt::stage(s_bb, bb, lay.n_cb, mrt::kBbCols, mrt::kBbCols);
    __syncthreads();
  }
  if (i >= R) return;
  mrt::step_ray<kRefract, kTrain, kTri, kTex>(
      tab, mrt::Tris{tri, s_bb}, lay, s_lt, L, dk, tex, i, R, c0, u8, c1,
      hit, resid);
}

// kTriIn: the lights and the triangle segment's superblocks (and their
// chunks' bounds, tri_walk.cuh) in shared memory; the cull blocks' AABBs
// are read from global memory, the triangle segment's hits from `tin`.
// Its warps refill (step_fwd_kernel).
template <bool kRefract, bool kTrain, bool kTex>
__global__ void step_fwd_in_kernel(const float* __restrict__ tab,
                                   mrt::Layout lay,
                                   const float* __restrict__ tri,
                                   const float* __restrict__ bb,
                                   const float* __restrict__ lights, int L,
                                   float dk, mrt::Tex tex,
                                   const float* __restrict__ c0,
                                   const float* __restrict__ u8, int R,
                                   float* __restrict__ c1,
                                   float* __restrict__ hit,
                                   float* __restrict__ resid,
                                   mrt::TriIn tin,
                                   const float* __restrict__ tsb, int n_tsb,
                                   int* __restrict__ next) {
  extern __shared__ float smem[];
  __shared__ __align__(16) mrt::Staged st;
  __shared__ int s_q[2 * kThreads];
  float* s_lt = smem;
  mrt::stage(s_lt, lights, L, mrt::kLightCols, mrt::kLightCols);
  const mrt::Supers S = mrt::stage_supers(st, tsb, n_tsb);  // synchronizes
  const mrt::Tris T{tri, bb};
  const mrt::StepWalk W{nullptr, 0, {}, tin, S};
  refill_rays(
      R, c0, next, s_q + 2 * (threadIdx.x & ~31u),
      [&](int j) {
        mrt::step_ray<kRefract, kTrain, true, kTex, true>(
            tab, T, lay, s_lt, L, dk, tex, j, R, c0, u8, c1, hit, resid, W);
      },
      [&](int j) {
        mrt::step_ray<kRefract, kTrain, true, kTex, true>(
            tab, T, lay, s_lt, L, dk, tex, j, R, c0, u8, c1, hit, resid);
      });
  release_counters(next);
}

// The arguments every instance takes.
struct Args {
  const float* tab;
  mrt::Layout lay;
  const float* tri;
  const float* bb;
  const float* sbb;
  const float* lights;
  int L;
  float dk;
  mrt::Tex tex;
  const float* c0;
  const float* u8;
  int R;
  float* c1;
  float* hit;
  float* resid;
  mrt::TriIn tin;  // te null: the triangle segment is swept in the kernel
  const float* tsb;  // kTriIn: the superblocks (n_tsb)
  int n_tsb;
  mrt::SphPack sph;  // a culled sphere segment's walk tables
  int* next;  // the refill counters (two int32, zeroed; left zeroed)
};

// dynamic shared bytes of an instance: the lights, the cull blocks, and
// where the sphere blocks are walked nearest first (kCull, entry only)
// each lane's column of their entry t
template <bool kRefract, bool kTri, bool kTex, bool kCull>
size_t smem_bytes(const mrt::Layout& lay, int L) {
  const int n_bb = kTri ? lay.n_cb : kTex ? 0 : lay.n_sb;
  const int n_tb = kCull && !kRefract ? lay.n_sb * kThreads : 0;
  return (static_cast<size_t>(L) * mrt::kLightCols +
          static_cast<size_t>(n_bb) * mrt::kBbCols + n_tb) *
         sizeof(float);
}

// the kTriIn instances': the lights
size_t smem_in_bytes(int L) {
  return static_cast<size_t>(L) * mrt::kLightCols * sizeof(float);
}

// blocks of a launch: one per kThreads rays, or where the warps refill
// as many as the card keeps resident (grid.cuh), at most that
int grid(int R, bool refill, int per_sm, int sms) {
  const int blocks = (R + kThreads - 1) / kThreads;
  return refill ? std::max(1, std::min(blocks, per_sm * sms)) : blocks;
}

// the launch of one instance
struct Launch {
  const Args& a;
  cudaStream_t s;
  template <bool kRefract, bool kTrain, bool kTri, bool kTex, bool kCull>
  int run() const {
    constexpr bool kRefill = !kTri && !kTex;
    const size_t smem = smem_bytes<kRefract, kTri, kTex, kCull>(a.lay, a.L);
    const auto kernel = step_fwd_kernel<kRefract, kTrain, kTri, kTex, kCull>;
    int per_sm = 0, sms = 0;
    const int e = mrt::resident_blocks(kernel, kThreads, smem, &per_sm, &sms);
    if (e) return e;
    if (kRefill && a.next == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    kernel<<<grid(a.R, kRefill, per_sm, sms), kThreads, smem, s>>>(
        a.tab, a.lay, a.tri, a.bb, a.sbb, a.lights, a.L, a.dk, a.tex, a.c0,
        a.u8, a.R, a.c1, a.hit, a.resid, a.sph, a.next);
    return static_cast<int>(cudaGetLastError());
  }
  template <bool kRefract, bool kTrain, bool kTex>
  int run_in() const {
    const size_t smem = smem_in_bytes(a.L);
    const auto kernel = step_fwd_in_kernel<kRefract, kTrain, kTex>;
    int per_sm = 0, sms = 0;
    const int e = mrt::resident_blocks(kernel, kThreads, smem, &per_sm, &sms);
    if (e) return e;
    if (a.next == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    kernel<<<grid(a.R, true, per_sm, sms), kThreads, smem, s>>>(
        a.tab, a.lay, a.tri, a.bb, a.lights, a.L, a.dk, a.tex, a.c0, a.u8,
        a.R, a.c1, a.hit, a.resid, a.tin, a.tsb, a.n_tsb, a.next);
    return static_cast<int>(cudaGetLastError());
  }
};

// the occupancy query of one instance
struct Occupancy {
  mrt::Layout lay;
  int L;
  int* per_sm;
  template <bool kRefract, bool kTrain, bool kTri, bool kTex, bool kCull>
  int run() const {
    return mrt::resident_blocks(
        step_fwd_kernel<kRefract, kTrain, kTri, kTex, kCull>, kThreads,
        smem_bytes<kRefract, kTri, kTex, kCull>(lay, L), per_sm);
  }
  template <bool kRefract, bool kTrain, bool kTex>
  int run_in() const {
    return mrt::resident_blocks(step_fwd_in_kernel<kRefract, kTrain, kTex>,
                                kThreads, smem_in_bytes(L), per_sm);
  }
};

// the instance for the scene: train, refraction, triangles (swept here or,
// in, taken from tri.cu), textures, a culled sphere segment
template <class F>
int dispatch(const F& f, bool train, bool refract, bool tri, bool tex,
             bool in, bool cull) {
  auto pick = [&](auto t, auto r) {
    constexpr bool kT = decltype(t)::value, kR = decltype(r)::value;
    if (in)
      return tex ? f.template run_in<kR, kT, true>()
                 : f.template run_in<kR, kT, false>();
    if (tri)
      return tex ? f.template run<kR, kT, true, true, false>()
                 : f.template run<kR, kT, true, false, false>();
    if (tex) return f.template run<kR, kT, false, true, false>();
    return cull ? f.template run<kR, kT, false, false, true>()
                : f.template run<kR, kT, false, false, false>();
  };
  using Yes = std::true_type;
  using No = std::false_type;
  if (train) return refract ? pick(Yes{}, Yes{}) : pick(Yes{}, No{});
  return refract ? pick(No{}, Yes{}) : pick(No{}, No{});
}

}  // namespace

// The arguments of mrt_trace_fwd for the tables (P: the dense rows, read
// from global memory here; tri / bb / sbb and the texture tables as there,
// sbb with up to 64 blocks), then the carry in c0 (14, R), the step's
// uniforms u8 (NU, R), and out the carry c1 (14, R) and the hit liveness
// hit (R,); the train instance also writes resid (CR, R), the rows of a ray
// that hits. tte (null: the kernel sweeps the triangles, bb staged in
// shared memory) selects the kTriIn instance: the triangle segment's te,
// row (R,) from mrt_tri_entry or, refracting, te, row, tx, xrow (R,) from
// mrt_tri_entry_exit, with bb read from global memory and the cull
// blocks' n_tsb superblocks tsb (ops/tri.py superbounds, 16-byte aligned)
// for the shadow sweeps. With sphere cull blocks (n_sb > 0), srows and
// ssb are the sphere segment's packed rows and sub-block AABBs
// (ops/hit3.py sph_walk_tables, 16-byte aligned). next: two zeroed int32
// counters from which the warps of a scene without triangles or textures,
// or of the kTriIn instances, take their rays (left zeroed; null for the
// others).
extern "C" int mrt_step_fwd(const float* tab, int P, int sph_start,
                            int sph_n, int pln_start, int pln_n,
                            int box_start, int box_n, const float* tri,
                            int tri_start, int tri_n, const float* bb,
                            int n_cb, const float* sbb, int n_sb,
                            const float* lights, int L, float dk,
                            const int* maps, const float* atlas,
                            const int* tmeta, int slots, const float* c0,
                            const float* u8, int R, int refract, float* c1,
                            float* hit, const float* tte, const int* trow,
                            const float* ttx, const int* txrow,
                            const float* tsb, int n_tsb, const float* srows,
                            const float* ssb, int* next, void* stream) {
  (void)P;
  if (n_sb > 0 && (srows == nullptr || ssb == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{tab,
               mrt::Layout{sph_start, sph_n, pln_start, pln_n, box_start,
                           box_n, tri_start, tri_n, n_cb, n_sb},
               tri, bb, sbb, lights, L, dk,
               mrt::Tex{maps, atlas, tmeta, slots}, c0, u8, R, c1, hit,
               nullptr, mrt::TriIn{tte, trow, ttx, txrow}, tsb, n_tsb,
               mrt::SphPack{srows, ssb}, next};
  return dispatch(Launch{a, static_cast<cudaStream_t>(stream)}, false,
                  refract != 0, tri_n > 0, slots != 0, tte != nullptr,
                  n_sb > 0);
}

extern "C" int mrt_step_fwd_train(
    const float* tab, int P, int sph_start, int sph_n, int pln_start,
    int pln_n, int box_start, int box_n, const float* tri, int tri_start,
    int tri_n, const float* bb, int n_cb, const float* sbb, int n_sb,
    const float* lights, int L, float dk, const int* maps,
    const float* atlas, const int* tmeta, int slots, const float* c0,
    const float* u8, int R, int refract, float* c1, float* hit,
    float* resid, const float* tte, const int* trow, const float* ttx,
    const int* txrow, const float* tsb, int n_tsb, const float* srows,
    const float* ssb, int* next, void* stream) {
  (void)P;
  if (n_sb > 0 && (srows == nullptr || ssb == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{tab,
               mrt::Layout{sph_start, sph_n, pln_start, pln_n, box_start,
                           box_n, tri_start, tri_n, n_cb, n_sb},
               tri, bb, sbb, lights, L, dk,
               mrt::Tex{maps, atlas, tmeta, slots}, c0, u8, R, c1, hit,
               resid, mrt::TriIn{tte, trow, ttx, txrow}, tsb, n_tsb,
               mrt::SphPack{srows, ssb}, next};
  return dispatch(Launch{a, static_cast<cudaStream_t>(stream)}, true,
                  refract != 0, tri_n > 0, slots != 0, tte != nullptr,
                  n_sb > 0);
}

// Resident warps per SM of the instance a launch of these tables takes
// (train: the train instance; tri_in: the kTriIn instance), into *warps
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); returns a CUDA error.
extern "C" int mrt_step_fwd_occupancy(int sph_n, int pln_n, int box_n,
                                      int tri_n, int n_cb, int n_sb, int L,
                                      int slots, int refract, int train,
                                      int tri_in, int* warps) {
  int per_sm = 0;
  const mrt::Layout lay{0, sph_n, 0, pln_n, 0, box_n, 0, tri_n, n_cb, n_sb};
  const int e = dispatch(Occupancy{lay, L, &per_sm}, train != 0,
                         refract != 0, tri_n > 0, slots != 0, tri_in != 0,
                         n_sb > 0);
  *warps = per_sm * (kThreads / 32);
  return e;
}
#endif  // __CUDACC__
