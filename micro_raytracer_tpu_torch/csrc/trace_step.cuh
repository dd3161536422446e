// Step math shared by the whole-trace forward (trace_fwd.cu) and backward
// (trace_bwd.cu) and the per-step kernels (step_fwd.cu, step_bwd.cu):
// 3-vectors, the row table's attribute columns, normals, the jittered
// sampling direction, light vectors, materials with their texture maps,
// the carry and the training residual layout.
//
// Row table: (P, 26) floats per row — the 18 sweep columns of hit3.cuh
// (frame 9, instance position 3, plane normal / box sizes / a triangle's
// raw normal 3, radius, valid, group id) then albedo (3), rough, metal,
// glass, opacity, emit. The whole-trace kernels stage the dense rows
// (below tri_start) in shared memory and read triangle rows from global
// memory (row_at); the per-step kernels read every row from global
// memory.
// Light table: (L, 11) floats [pos 3 | -normalize(dir) 3 | is_dir | pwr |
// color 3].
// Textures (textured scenes, the kTex instances): a (P, 6) int32 table of
// each row's map ids (-1: no map; slots tex, rmap, mmap, gmap, omap,
// emap), the flat (N, 3) float32 atlas and a (T, 3) int32 table of each
// texture's (offset, width, height), all read from global memory (only the
// winner rows' ids and texels are read, once per side per live step).
//
// Residuals of a training forward, per step k and ray i at
// resid[(k * CR + r) * R + i] with CR = res_rows_all (rays on the fastest
// axis):
// the step's input ray o, d and throughput A, the entry and exit t of its
// hit, the entry winner row, the refract choice, one occlusion bit per
// light, with a triangle segment (kTri) the exit winner row (without
// triangles every group is one row, so the exit row is the entry row and
// is not saved), and with textures (kTex) the texels of the present map
// slots (3 rows for slot 0, 1 for each other slot; 0 where the side's id
// is -1), entry side then, on a refractive scene, exit side.
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
// The carry of a segmented render and of the per-step path
// (pallas_step's c0 rows; step.CARRY_ROWS): o, d, pwr, live, A, B.
enum CarryRow { kC_O = 0, kC_D = 3, kC_PWR = 6, kC_LIVE = 7, kC_A = 8,
                kC_B = 11, kCarryRows = 14 };

template <bool kTri>
__device__ __forceinline__ int res_rows(int L) {
  return R_LOK + L + (kTri ? 1 : 0);
}
// the exit winner row (kTri only), after the occlusion bits
__device__ __forceinline__ int res_xrow(int L) { return R_LOK + L; }

// texel rows of one hit side for the present map slots (bit s: slot s)
__device__ __forceinline__ int tex_side_rows(int slots) {
  int n = (slots & 1) ? 3 : 0;
  for (int s = 1; s < 6; ++s) n += (slots >> s) & 1;
  return n;
}

// residual rows per step; the texel rows start at res_rows<kTri>(L)
template <bool kRefract, bool kTri, bool kTex>
__device__ __forceinline__ int res_rows_all(int L, int slots) {
  return res_rows<kTri>(L) +
         (kTex ? tex_side_rows(slots) * (kRefract ? 2 : 1) : 0);
}

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

// vector from p toward light `lt` (un-normalized; -normalize(dir) for
// directional lights)
__device__ __forceinline__ V3 light_vec(const float* lt, V3 p) {
  return lt[6] > 0.5f ? load3(lt + 3) : sub(load3(lt), p);
}

// ---- materials and textures ----

constexpr int kMapSlots = 6;
constexpr float kPi = 3.14159265358979323846f;

struct Tex {
  const int* maps;     // (P, 6) map ids of each row, -1: none
  const float* atlas;  // (N, 3) texels, texture after texture
  const int* meta;     // (T, 3) offset, width, height of each texture
  int slots;           // bit s: some row maps slot s
};

// A hit side's map ids and texels: the rgb of slot 0 in v[0..2], the red
// channel of slot s >= 1 in v[2 + s]; 0 where the id is -1.
struct Texels {
  int id[kMapSlots];
  float v[8];
};

struct UV {
  float u, v;
};

// The material of one hit side. The untextured instances keep the row
// and read each column where it is used (their code before textures); the
// textured ones apply the texels once (rt.rs:811-863: slot 0 multiplies
// the albedo by the rgb texel, slots 1-5 replace rough, metal, glass,
// opacity and emit by its red channel where the slot is mapped) and keep
// the mapped values, so that the texels need not stay live.
template <bool kTex>
struct Side {
  const float* at;
  __device__ __forceinline__ Side(const float* row, const Texels&)
      : at(row) {}
  __device__ __forceinline__ V3 alb() const { return load3(at + A_ALB); }
  // column c, A_RGH..A_EMI
  __device__ __forceinline__ float col(int c) const { return at[c]; }
  // the unmapped metal, which the dielectric test reads (rt.rs:564)
  __device__ __forceinline__ float raw_met() const { return at[A_MET]; }
};

template <>
struct Side<true> {
  V3 a;
  float v[5];  // A_RGH..A_EMI, mapped
  float met;
  __device__ __forceinline__ Side(const float* at, const Texels& tv)
      : a(load3(at + A_ALB)), met(at[A_MET]) {
    if (tv.id[0] >= 0) a = mul(a, v3(tv.v[0], tv.v[1], tv.v[2]));
#pragma unroll
    for (int s = 1; s < kMapSlots; ++s)
      v[s - 1] = tv.id[s] >= 0 ? tv.v[2 + s] : at[A_RGH + s - 1];
  }
  __device__ __forceinline__ V3 alb() const { return a; }
  __device__ __forceinline__ float col(int c) const { return v[c - A_RGH]; }
  __device__ __forceinline__ float raw_met() const { return met; }
};

// The dielectric re-roll of the roughness (rt.rs:559-572): a dielectric
// side (raw metal 0, mapped opacity not 0) samples a diffuse lobe when the
// draw is below 0.8.
template <bool kTex>
__device__ __forceinline__ bool rough_override(const Side<kTex>& m,
                                               float u) {
  const bool diel = (m.raw_met() == 0.0f) && (m.col(A_OPA) != 0.0f);
  return diel && u < 0.8f;
}

// Texture coordinates at world point p of a row of kind `kind`
// (rt.rs:468-548, intersect.uv_from_attrs): the sphere's spherical map of
// the unguarded normalize(hp - ip) (a degenerate point gives NaN, whose
// texel is the first); the plane's fract(x + 0.5) as x - trunc(x), wrapped
// below 0; the box's 4x3 cross atlas, the first face test that holds in
// rt.rs order (x+, x-, y+, y-, z+, z-) choosing the face; a triangle's 0
// (the reference's todo!()).
__device__ __forceinline__ UV uv_of(const float* at, V3 p, int kind) {
  if (kind == kRowTri) return UV{0.0f, 0.0f};
  const V3 ip = load3(at + A_IP);
  const V3 hp = add(ip, matvec(at + A_FR, sub(p, ip)));
  const V3 rel = sub(hp, ip);
  if (kind == kRowSphere) {
    const float inv = 1.0f / sqrtf(dot(rel, rel));
    const V3 n = scale(rel, inv);
    return UV{0.5f + 0.5f * atan2f(n.x, -n.y) / kPi, 0.5f - 0.5f * n.z};
  }
  if (kind == kRowPlane) {
    const float fx = (hp.x + 0.5f) - truncf(hp.x + 0.5f);
    const float fy = (hp.y + 0.5f) - truncf(hp.y + 0.5f);
    return UV{fx < 0.0f ? 1.0f + fx : fx, fy < 0.0f ? 1.0f + fy : fy};
  }
  const V3 pa = load3(at + A_NA);
  const float qx = rel.x * (2.0f / (pa.x == 0.0f ? 1.0f : pa.x));
  const float qy = rel.y * (2.0f / (pa.y == 0.0f ? 1.0f : pa.y));
  const float qz = rel.z * (2.0f / (pa.z == 0.0f ? 1.0f : pa.z));
  const float side = (0.5f - 0.5f * qz) / 3.0f + 1.0f / 3.0f;
  const float top_u = (0.5f + 0.5f * qx) / 4.0f + 1.0f / 4.0f;
  if (fabsf(qx - 1.0f) < kEps)
    return UV{(0.5f + 0.5f * qy) / 4.0f + 2.0f / 4.0f, side};
  if (fabsf(qx + 1.0f) < kEps) return UV{(0.5f - 0.5f * qy) / 4.0f, side};
  if (fabsf(qy - 1.0f) < kEps)
    return UV{(0.5f - 0.5f * qx) / 4.0f + 3.0f / 4.0f, side};
  if (fabsf(qy + 1.0f) < kEps) return UV{top_u, side};
  if (fabsf(qz - 1.0f) < kEps) return UV{top_u, (0.5f - 0.5f * qy) / 3.0f};
  if (fabsf(qz + 1.0f) < kEps)
    return UV{top_u, (0.5f + 0.5f * qy) / 3.0f + 2.0f / 3.0f};
  return UV{0.0f, 0.0f};
}

// clip(int(f), 0, n - 1) with NaN at 0 (fmaxf returns the number)
__device__ __forceinline__ int texel_index(float f, int n) {
  return static_cast<int>(fminf(fmaxf(f, 0.0f), static_cast<float>(n - 1)));
}

// The nearest texel of texture `id` at uv (rt.rs:618-628,
// intersect.sample_texture): off + x + y*w, from the read-only cache.
__device__ __forceinline__ const float* texel(const Tex& t, int id, UV uv) {
  const int* m = t.meta + 3 * id;
  const int off = __ldg(m), w = __ldg(m + 1), h = __ldg(m + 2);
  const int x = texel_index(uv.u * static_cast<float>(w), w);
  const int y = texel_index(uv.v * static_cast<float>(h), h);
  return t.atlas + 3 * static_cast<size_t>(off + x + y * w);
}

// The map ids of row `row` and the texels of its mapped slots at point p
// (kind `kind`).
__device__ __forceinline__ void side_texels(const Tex& t, int row,
                                            const float* at, V3 p, int kind,
                                            Texels& tv) {
  const UV uv = uv_of(at, p, kind);
#pragma unroll
  for (int s = 0; s < kMapSlots; ++s)
    tv.id[s] = __ldg(t.maps + row * kMapSlots + s);
#pragma unroll
  for (int c = 0; c < 8; ++c) tv.v[c] = 0.0f;
  if (tv.id[0] >= 0) {
    const float* px = texel(t, tv.id[0], uv);
    tv.v[0] = __ldg(px);
    tv.v[1] = __ldg(px + 1);
    tv.v[2] = __ldg(px + 2);
  }
#pragma unroll
  for (int s = 1; s < kMapSlots; ++s)
    if (tv.id[s] >= 0) tv.v[2 + s] = __ldg(texel(t, tv.id[s], uv));
}

// One side's texel residual rows: the present slots in order, from row r0
// of a step's block `r` (stride R).
__device__ __forceinline__ void write_texels(float* r, int r0, int R,
                                             int slots, const Texels& tv) {
  int j = r0;
#pragma unroll
  for (int c = 0; c < 8; ++c)
    if ((slots >> (c < 3 ? 0 : c - 2)) & 1) r[(j++) * R] = tv.v[c];
}

__device__ __forceinline__ void read_texels(const float* r, int r0, int R,
                                            int slots, Texels& tv) {
  int j = r0;
#pragma unroll
  for (int c = 0; c < 8; ++c)
    tv.v[c] = ((slots >> (c < 3 ? 0 : c - 2)) & 1) ? r[(j++) * R] : 0.0f;
}

}  // namespace mrt
