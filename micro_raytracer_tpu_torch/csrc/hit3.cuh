// Closest-hit and any-hit over the dense sphere / plane / box segments.
//
// Replaces: micro_raytracer_tpu/ops/pallas_hit3.py :: sweep_closest with
// _kind_block (dense segments; the pallas_call in _call_hit). The same
// device functions are the entry sweep and the shadow sweeps of the
// whole-trace kernel (trace_fwd.cu) and the body of the primary-hit kernel
// (hit3.cu).
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
// What bounds it on the H100: arithmetic. Each ray runs ~40 float ops per
// row and per sweep, the row table is a few KB read from shared memory as
// warp-wide broadcasts, and a ray costs 24 bytes in and 16 out. The design
// keeps one ray per thread with the whole table in shared memory (staged
// once per block by the caller), loops over rows with the kind fixed per
// segment (no per-row kind branch), and exits the any-hit loop at the
// first hit.
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
// never tested.
struct Layout {
  int sph_start, sph_n, pln_start, pln_n, box_start, box_n;
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

// Closest hit of ray (o, d) over the table `tab` (rows of `stride` floats
// whose first kSweepCols are the sweep columns).
template <bool kNeedExit>
__device__ __forceinline__ Hit closest_hit(const float* tab, int stride,
                                           const Layout& L, float ox,
                                           float oy, float oz, float dx,
                                           float dy, float dz) {
  float best = kBig;
  int row = 0;
  entry_seg<kSphere>(tab, stride, L.sph_start, L.sph_n, ox, oy, oz, dx, dy,
                     dz, best, row);
  entry_seg<kPlane>(tab, stride, L.pln_start, L.pln_n, ox, oy, oz, dx, dy,
                    dz, best, row);
  entry_seg<kBox>(tab, stride, L.box_start, L.box_n, ox, oy, oz, dx, dy, dz,
                  best, row);
  Hit h;
  h.te = best;
  h.row = row;
  if (!kNeedExit) {
    h.tx = best;
    h.xrow = row;
    return h;
  }
  // miss lanes keep wg = BIG, which matches no row's group id
  const float wg = best < kBig ? tab[row * stride + C_GID] : kBig;
  float xbest = -kBig;
  int xrow = 0;
  exit_seg<kSphere>(tab, stride, L.sph_start, L.sph_n, wg, ox, oy, oz, dx,
                    dy, dz, xbest, xrow);
  exit_seg<kPlane>(tab, stride, L.pln_start, L.pln_n, wg, ox, oy, oz, dx, dy,
                   dz, xbest, xrow);
  exit_seg<kBox>(tab, stride, L.box_start, L.box_n, wg, ox, oy, oz, dx, dy,
                 dz, xbest, xrow);
  h.tx = xbest;
  h.xrow = xrow;
  return h;
}

// Occlusion: does the ray hit any valid row? (rt.rs:1036-1038)
__device__ __forceinline__ bool any_hit(const float* tab, int stride,
                                        const Layout& L, float ox, float oy,
                                        float oz, float dx, float dy,
                                        float dz) {
  return any_seg<kSphere>(tab, stride, L.sph_start, L.sph_n, ox, oy, oz, dx,
                          dy, dz) ||
         any_seg<kPlane>(tab, stride, L.pln_start, L.pln_n, ox, oy, oz, dx,
                         dy, dz) ||
         any_seg<kBox>(tab, stride, L.box_start, L.box_n, ox, oy, oz, dx, dy,
                       dz);
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
