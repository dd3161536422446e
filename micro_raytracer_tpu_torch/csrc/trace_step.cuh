// Step math shared by the whole-trace forward (trace_fwd.cu) and backward
// (trace_bwd.cu): 3-vectors, the row table's attribute columns, normals,
// the jittered sampling direction, light vectors, and the training
// residual layout.
//
// Row table: (P, 26) floats per row — the 18 sweep columns of hit3.cuh
// (frame 9, instance position 3, plane normal / box sizes / a triangle's
// raw normal 3, radius, valid, group id) then albedo (3), rough, metal,
// glass, opacity, emit. The kernels stage the dense rows (below
// tri_start) in shared memory and read triangle rows from global memory
// (row_at).
// Light table: (L, 11) floats [pos 3 | -normalize(dir) 3 | is_dir | pwr |
// color 3].
//
// Residuals of a training forward, per step k and ray i at
// resid[(k * res_rows<kTri>(L) + r) * R + i] (rays on the fastest axis):
// the step's input ray o, d and throughput A, the entry and exit t of its
// hit, the entry winner row, the refract choice, one occlusion bit per
// light and, with a triangle segment (kTri), the exit winner row. Without
// triangles every group is one row, so the exit row is the entry row and
// is not saved.
// pwr is dk^k and B never shapes a cotangent (it enters additively), so
// neither is saved. Steps at or after a ray's live-step count are neither
// written nor read.
#pragma once

#include "hit3.cuh"

namespace mrt {

constexpr int kRowCols = kSweepCols + 8;
constexpr int kLightCols = 11;
constexpr int kMaxLights = 4;
// attribute columns of the row table (pallas_step._C_*): frame, position
// and plane normal / box sizes are the sweep columns
enum AttrCol {
  A_FR = C_FR,
  A_IP = C_IP,
  A_NA = C_PA,
  A_PR = C_PR,
  A_ALB = kSweepCols + 0,
  A_RGH = kSweepCols + 3,
  A_MET = kSweepCols + 4,
  A_GLS = kSweepCols + 5,
  A_OPA = kSweepCols + 6,
  A_EMI = kSweepCols + 7
};

enum ResRow {
  R_O = 0,
  R_D = 3,
  R_A = 6,
  R_TE = 9,
  R_TX = 10,
  R_ROW = 11,
  R_CHOOSE = 12,
  R_LOK = 13
};
template <bool kTri>
__device__ __forceinline__ int res_rows(int L) {
  return R_LOK + L + (kTri ? 1 : 0);
}
// the exit winner row (kTri only), after the occlusion bits
__device__ __forceinline__ int res_xrow(int L) { return R_LOK + L; }

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 mul(V3 a, V3 b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ V3 scale(V3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }
__device__ __forceinline__ V3 load3(const float* p) { return {p[0], p[1], p[2]}; }

// M @ v with M the row's frame columns (row-major)
__device__ __forceinline__ V3 matvec(const float* f, V3 v) {
  return {f[0] * v.x + f[1] * v.y + f[2] * v.z,
          f[3] * v.x + f[4] * v.y + f[5] * v.z,
          f[6] * v.x + f[7] * v.y + f[8] * v.z};
}

// M^T @ v
__device__ __forceinline__ V3 matTvec(const float* f, V3 v) {
  return {f[0] * v.x + f[3] * v.y + f[6] * v.z,
          f[1] * v.x + f[4] * v.y + f[7] * v.z,
          f[2] * v.x + f[5] * v.y + f[8] * v.z};
}

constexpr float kNormEps = 1e-20f;

// v * rsqrt(max(|v|^2, 1e-20)) (_safe_norm_rows)
__device__ __forceinline__ V3 safe_norm(V3 v) {
  return scale(v, 1.0f / sqrtf(fmaxf(dot(v, v), kNormEps)));
}

__device__ __forceinline__ float finite0(float v) {
  return isfinite(v) ? v : 0.0f;
}

__device__ __forceinline__ V3 finite0(V3 v) {
  return v3(finite0(v.x), finite0(v.y), finite0(v.z));
}

// the constant unit direction the jittered normal mixes in (u1, u2 are
// uniforms, not differentiable)
__device__ __forceinline__ V3 sphere_dir(float u1, float u2) {
  const float ct = fminf(fmaxf(1.0f - 2.0f * u1, -1.0f), 1.0f);
  const float st = sqrtf(fmaxf(1.0f - ct * ct, 0.0f));
  const float phi = u2 * 6.28318530717958647692f;
  float s, c;
  sincosf(phi, &s, &c);
  return v3(st * c, st * s, ct);
}

// normalize(n + rough * uniform_sphere(u1, u2)) (_sphere_rand_rows)
__device__ __forceinline__ V3 sphere_rand(V3 n, float rough, float u1,
                                          float u2) {
  return safe_norm(add(n, scale(sphere_dir(u1, u2), rough)));
}

__device__ __forceinline__ float pow32(float x) {
  const float x2 = x * x, x4 = x2 * x2, x8 = x4 * x4, x16 = x8 * x8;
  return x16 * x16;
}

enum RowKind { kRowSphere = 0, kRowPlane = 1, kRowBox = 2, kRowTri = 3 };

// the kind of row `row` from the segment bounds (absent kinds have n = 0
// and start where the previous segment ends, so the tests stay ordered;
// kTri: rows from tri_start on are triangles)
template <bool kTri = false>
__device__ __forceinline__ int row_kind(int row, const Layout& L) {
  if (kTri && row >= L.tri_start) return kRowTri;
  return row < L.sph_start + L.sph_n
             ? kRowSphere
             : (row < L.pln_start + L.pln_n ? kRowPlane : kRowBox);
}

// Attributes of row `row`: a dense row from the shared copy `s_tab`, a
// triangle row (kTri) from the global table `g_tab`.
template <bool kTri>
__device__ __forceinline__ const float* row_at(const float* s_tab,
                                               const float* g_tab, int row,
                                               const Layout& L) {
  return (kTri && row >= L.tri_start) ? g_tab + row * kRowCols
                                      : s_tab + row * kRowCols;
}

// World-space normal at p of row `row` (attributes `at`), _normal_rows with
// the box z test not chained to the x/y tests (rt.rs:435) and a
// triangle's raw normal as its object-space normal, and the intermediates
// its transpose needs: rel = p - ip, the object-space normal n_obj, mv = M
// n_obj and its normalization nn (n = finite0(nn)).
struct Normal {
  V3 rel, n_obj, mv, nn, n;
};

__device__ __forceinline__ Normal normal_full(const float* at, V3 p, int kind) {
  const V3 ip = load3(at + A_IP);
  const V3 pa = load3(at + A_NA);
  const float* f = at + A_FR;
  Normal r;
  r.rel = sub(p, ip);
  if (kind == kRowSphere) {
    r.n_obj = sub(add(ip, matvec(f, r.rel)), ip);
  } else if (kind == kRowPlane || kind == kRowTri) {
    r.n_obj = pa;
  } else {
    const V3 hp = add(ip, matvec(f, r.rel));
    const V3 sizes = v3(pa.x == 0.0f ? 1.0f : pa.x, pa.y == 0.0f ? 1.0f : pa.y,
                        pa.z == 0.0f ? 1.0f : pa.z);
    const V3 q = mul(sub(hp, ip), v3(2.0f / sizes.x, 2.0f / sizes.y,
                                     2.0f / sizes.z));
    const bool ix1 = fabsf(q.x - 1.0f) < kEps;
    const bool ix_1 = fabsf(q.x + 1.0f) < kEps;
    const bool iy1 = fabsf(q.y - 1.0f) < kEps;
    const bool iy_1 = fabsf(q.y + 1.0f) < kEps;
    const bool iz1 = fabsf(q.z - 1.0f) < kEps;
    const bool iz_1 = fabsf(q.z + 1.0f) < kEps;
    const float bx = ix1 ? 1.0f : (ix_1 ? -1.0f : 0.0f);
    const float by = (ix1 || ix_1) ? 0.0f : (iy1 ? 1.0f : (iy_1 ? -1.0f : 0.0f));
    const bool anyz = iz1 || iz_1;
    r.n_obj = v3(anyz ? 0.0f : bx, anyz ? 0.0f : by,
                 iz1 ? 1.0f : (iz_1 ? -1.0f : 0.0f));
  }
  r.mv = matvec(f, r.n_obj);
  r.nn = safe_norm(r.mv);
  r.n = finite0(r.nn);
  return r;
}

template <bool kTri = false>
__device__ __forceinline__ V3 normal(const float* at, V3 p, int row,
                                     const Layout& L) {
  return normal_full(at, p, row_kind<kTri>(row, L)).n;
}

// vector from p toward light `lt` (un-normalized; -normalize(dir) for
// directional lights)
__device__ __forceinline__ V3 light_vec(const float* lt, V3 p) {
  return lt[6] > 0.5f ? load3(lt + 3) : sub(load3(lt), p);
}

// The dielectric re-roll of the roughness (rt.rs:559-572): a dielectric
// row samples a diffuse lobe when the draw is below 0.8.
__device__ __forceinline__ bool rough_override(const float* at, float u) {
  const bool diel = (at[A_MET] == 0.0f) && (at[A_OPA] != 0.0f);
  return diel && u < 0.8f;
}

}  // namespace mrt
