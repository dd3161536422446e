// trace_fwd: the whole forward path trace — all bounce + 1 steps of a ray
// in one launch, for rendering (no residuals).
//
// Replaces: micro_raytracer_tpu/ops/pallas_step.py :: _trace_kernel (called
// by _call_trace, inference mode) with its body _step_math — the rows tail
// (pallas_step.py:1016-1107), emit_kill=True and the first-bounce record.
// The component-form tail of that kernel is a TPU register relayout of the
// same math and has no counterpart here.
//
// Per ray and step: closest hit (hit3.cuh), winner-attribute fetch (a row
// read from shared memory), normals with the box missing-`else` quirk,
// materials, one any-hit shadow sweep per light from the entry point,
// reflect / refract sampling from the step's uniforms, direct light shaded
// at the chosen point with the entry point's occlusion, and the affine fold
// B += A*b, A *= a. Step 0 takes its closest hit from the primary-hit pass
// (hit3.cu, the same sweep) instead of sweeping again. The carry (o, d,
// pwr, A, B) never leaves registers. A ray that misses, or whose emit draw
// ends its path, leaves the step loop: the fold passes dead rays through
// unchanged (a = 1, b = 0), which is the Pallas kernel's whole-tile dead
// skip made per thread.
//
// Inputs: the (P, 26) row table — the 18 sweep columns of hit3.cuh (whose
// fr, ipos, pa and pr are pallas_step's attribute columns _C_FR.._C_PR)
// then albedo (3), rough, metal, glass, opacity, emit — the (L, 11) light
// table [pos | -normalize(dir) | is_dir | pwr | color], primaries o0, d0
// (3, R), their hits te0, row0, tx0, xrow0 (R,), and uniforms u8s
// (K, NU, R) with NU = 8 ([u0..u6, u_emit]) when the scene refracts and 4
// ([u0, u1, u2, u_emit]) otherwise. Outputs: A, B (3, R) and first_live
// (R,), the pre-kill hit liveness of step 0.
//
// What bounds it on the H100: arithmetic and divergence. A ray costs 40
// bytes of primaries and hits, 4*NU bytes of uniforms per step and 28
// bytes out, while each step runs 1 + L sweeps over all rows (~40 float
// ops per row) plus ~300 ops of shading. The design keeps the row table
// (P*104 bytes, at most step.MAX_ROWS = 2048 rows, 208 KB) and the lights
// in shared memory, reads the uniforms coalesced (rays on the fastest
// axis), and lets a warp's threads drop out of the step loop
// independently; it does not regroup live rays, so warps with one long
// path run at the pace of that path.
//
// Numerics: float32 throughout; 1/sqrt as 1.0f/sqrtf, sincosf at full
// precision, -fmad=false (see hit3.cuh).
#include <cuda_runtime.h>

#include "hit3.cuh"

namespace {

constexpr int kRowCols = mrt::kSweepCols + 8;
constexpr int kLightCols = 11;
constexpr int kMaxLights = 4;
// attribute columns of the row table (pallas_step._C_*): frame, position
// and plane normal / box sizes are the sweep columns
enum AttrCol {
  A_FR = mrt::C_FR,
  A_IP = mrt::C_IP,
  A_NA = mrt::C_PA,
  A_ALB = mrt::kSweepCols + 0,
  A_RGH = mrt::kSweepCols + 3,
  A_MET = mrt::kSweepCols + 4,
  A_GLS = mrt::kSweepCols + 5,
  A_OPA = mrt::kSweepCols + 6,
  A_EMI = mrt::kSweepCols + 7
};

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

// M @ v with M the row's frame columns
__device__ __forceinline__ V3 matvec(const float* f, V3 v) {
  return {f[0] * v.x + f[1] * v.y + f[2] * v.z,
          f[3] * v.x + f[4] * v.y + f[5] * v.z,
          f[6] * v.x + f[7] * v.y + f[8] * v.z};
}

// v * rsqrt(max(|v|^2, 1e-20)) (_safe_norm_rows)
__device__ __forceinline__ V3 safe_norm(V3 v) {
  return scale(v, 1.0f / sqrtf(fmaxf(dot(v, v), 1e-20f)));
}

__device__ __forceinline__ float finite0(float v) {
  return isfinite(v) ? v : 0.0f;
}

// normalize(n + rough * uniform_sphere(u1, u2)) (_sphere_rand_rows)
__device__ __forceinline__ V3 sphere_rand(V3 n, float rough, float u1,
                                          float u2) {
  const float ct = fminf(fmaxf(1.0f - 2.0f * u1, -1.0f), 1.0f);
  const float st = sqrtf(fmaxf(1.0f - ct * ct, 0.0f));
  const float phi = u2 * 6.28318530717958647692f;
  float s, c;
  sincosf(phi, &s, &c);
  return safe_norm(add(n, scale(v3(st * c, st * s, ct), rough)));
}

__device__ __forceinline__ float pow32(float x) {
  const float x2 = x * x, x4 = x2 * x2, x8 = x4 * x4, x16 = x8 * x8;
  return x16 * x16;
}

// World-space normal at p of row `row` (attributes `at`): _normal_rows,
// with the kind taken from the row's segment and the box z test not
// chained to the x/y tests (rt.rs:435).
__device__ __forceinline__ V3 normal(const float* at, V3 p, int row,
                                     const mrt::Layout& L) {
  const V3 ip = load3(at + A_IP);
  const V3 pa = load3(at + A_NA);
  const float* f = at + A_FR;
  V3 n_obj;
  if (row < L.sph_start + L.sph_n) {
    n_obj = sub(add(ip, matvec(f, sub(p, ip))), ip);
  } else if (row < L.pln_start + L.pln_n) {
    n_obj = pa;
  } else {
    const V3 hp = add(ip, matvec(f, sub(p, ip)));
    const V3 sizes = v3(pa.x == 0.0f ? 1.0f : pa.x, pa.y == 0.0f ? 1.0f : pa.y,
                        pa.z == 0.0f ? 1.0f : pa.z);
    const V3 q = mul(sub(hp, ip), v3(2.0f / sizes.x, 2.0f / sizes.y,
                                     2.0f / sizes.z));
    const bool ix1 = fabsf(q.x - 1.0f) < mrt::kEps;
    const bool ix_1 = fabsf(q.x + 1.0f) < mrt::kEps;
    const bool iy1 = fabsf(q.y - 1.0f) < mrt::kEps;
    const bool iy_1 = fabsf(q.y + 1.0f) < mrt::kEps;
    const bool iz1 = fabsf(q.z - 1.0f) < mrt::kEps;
    const bool iz_1 = fabsf(q.z + 1.0f) < mrt::kEps;
    const float bx = ix1 ? 1.0f : (ix_1 ? -1.0f : 0.0f);
    const float by = (ix1 || ix_1) ? 0.0f : (iy1 ? 1.0f : (iy_1 ? -1.0f : 0.0f));
    const bool anyz = iz1 || iz_1;
    n_obj = v3(anyz ? 0.0f : bx, anyz ? 0.0f : by,
               iz1 ? 1.0f : (iz_1 ? -1.0f : 0.0f));
  }
  const V3 n = safe_norm(matvec(f, n_obj));
  return v3(finite0(n.x), finite0(n.y), finite0(n.z));
}

// vector from p toward light li (un-normalized; -normalize(dir) for
// directional lights)
__device__ __forceinline__ V3 light_vec(const float* lt, V3 p) {
  return lt[6] > 0.5f ? load3(lt + 3) : sub(load3(lt), p);
}

template <bool kRefract>
__global__ void trace_fwd_kernel(const float* __restrict__ tab, int P,
                                 mrt::Layout lay,
                                 const float* __restrict__ lights, int L,
                                 float dk, const float* __restrict__ o0,
                                 const float* __restrict__ d0,
                                 const float* __restrict__ te0,
                                 const int* __restrict__ row0,
                                 const float* __restrict__ tx0,
                                 const int* __restrict__ xrow0,
                                 const float* __restrict__ u8s, int K, int R,
                                 float* __restrict__ A_out,
                                 float* __restrict__ B_out,
                                 float* __restrict__ fl_out) {
  constexpr int NU = kRefract ? 8 : 4;
  extern __shared__ float smem[];
  float* s_tab = smem;
  float* s_lt = smem + P * kRowCols;
  mrt::stage(s_tab, tab, P, kRowCols, kRowCols);
  mrt::stage(s_lt, lights, L, kLightCols, kLightCols);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;

  V3 o = v3(o0[i], o0[R + i], o0[2 * R + i]);
  V3 d = v3(d0[i], d0[R + i], d0[2 * R + i]);
  float pwr = 1.0f;
  V3 A = v3(1.0f, 1.0f, 1.0f);
  V3 B = v3(0.0f, 0.0f, 0.0f);
  float first_live = 0.0f;

  for (int k = 0; k < K; ++k) {
    const float* u = u8s + static_cast<size_t>(k) * NU * R + i;
    const mrt::Hit h =
        k == 0 ? mrt::Hit{te0[i], row0[i], tx0[i], xrow0[i]}
               : mrt::closest_hit<kRefract>(s_tab, kRowCols, lay, o.x, o.y,
                                            o.z, d.x, d.y, d.z);
    const bool hit = h.te < mrt::kBig * 0.5f;
    if (k == 0) first_live = hit ? 1.0f : 0.0f;
    if (!hit) break;  // dead from here on: a = 1, b = 0 every later step

    const float* atE = s_tab + h.row * kRowCols;
    const V3 p_e = add(o, scale(d, h.te));

    // per-light occlusion from the entry point (rt.rs:1027-1046)
    bool light_ok[kMaxLights];
#pragma unroll
    for (int li = 0; li < kMaxLights; ++li) {
      if (li >= L) break;
      const V3 lv = light_vec(s_lt + li * kLightCols, p_e);
      const V3 ln = scale(lv, 1.0f / sqrtf(dot(lv, lv)));
      const V3 so = add(p_e, scale(ln, mrt::kEps));
      light_ok[li] = !mrt::any_hit(s_tab, kRowCols, lay, so.x, so.y, so.z,
                                   ln.x, ln.y, ln.z);
    }

    const V3 n_e = normal(atE, p_e, h.row, lay);
    const float met_raw_e = atE[A_MET];
    const float opa_e = atE[A_OPA];

    // reflect from the entry hit (rt.rs:559-572)
    const bool diel_e = (met_raw_e == 0.0f) && (opa_e != 0.0f);
    const float rough_r = (diel_e && u[0] < 0.8f) ? 1.0f : atE[A_RGH];
    const V3 nr = sphere_rand(n_e, rough_r, u[R], u[2 * R]);
    const V3 refl = safe_norm(sub(d, scale(nr, 2.0f * dot(d, nr))));

    V3 next_dir = refl, from_p = p_e, norm_c = n_e;
    const float* atC = atE;  // chosen side's attributes
    float u_emit;
    if (kRefract) {
      // refract from the exit hit (rt.rs:574-589, 1054-1058)
      const float* atX = s_tab + h.xrow * kRowCols;
      const V3 p_x = add(o, scale(d, h.tx));
      const V3 n_x = normal(atX, p_x, h.xrow, lay);
      const bool diel_x = (atX[A_MET] == 0.0f) && (atX[A_OPA] != 0.0f);
      const float rough_f = (diel_x && u[3 * R] < 0.8f) ? 1.0f : atX[A_RGH];
      const V3 nf = sphere_rand(n_x, rough_f, u[4 * R], u[5 * R]);
      const float eta = 1.0f + 0.5f * atX[A_GLS];
      const float cs = -dot(nf, d);
      const float kk = 1.0f - eta * eta * (1.0f - cs * cs);
      const bool refr_ok = kk >= 0.0f;
      const float k_safe = refr_ok ? fmaxf(kk, 1e-12f) : 1.0f;
      V3 refr = safe_norm(
          add(scale(d, eta), scale(nf, cs * eta + sqrtf(k_safe))));
      refr = v3(finite0(refr.x), finite0(refr.y), finite0(refr.z));
      const bool choose =
          (u[6 * R] < fminf(1.0f - opa_e, 0.85f)) && refr_ok;
      if (choose) {
        next_dir = refr;
        from_p = p_x;
        norm_c = n_x;
        atC = atX;
      }
      u_emit = u[7 * R];
    } else {
      u_emit = u[3 * R];
    }
    const V3 alb_c = load3(atC + A_ALB);
    const float rgh_c = atC[A_RGH];
    const float met_c = atC[A_MET];
    const float emi_c = atC[A_EMI];

    // direct light at the chosen point, occlusion from the entry point
    // (rt.rs:973-987 vs 1027-1046)
    V3 l_col = v3(0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int li = 0; li < kMaxLights; ++li) {
      if (li >= L) break;
      const float* lt = s_lt + li * kLightCols;
      const V3 lv = light_vec(lt, from_p);
      const V3 ln = scale(lv, 1.0f / sqrtf(dot(lv, lv)));
      const float diff = fmaxf(dot(ln, norm_c), 0.0f);
      const V3 lrefl = sub(ln, scale(norm_c, 2.0f * dot(ln, norm_c)));
      const float spec = pow32(fmaxf(dot(d, lrefl), 0.0f)) * (1.0f - rgh_c);
      const V3 o_col = scale(alb_c, 1.0f - met_c);
      const float pl = lt[7];
      const V3 contrib = v3((o_col.x * diff * lt[8] + spec) * pl,
                            (o_col.y * diff * lt[9] + spec) * pl,
                            (o_col.z * diff * lt[10] + spec) * pl);
      if (light_ok[li]) l_col = add(l_col, contrib);
    }

    // fold update (rt.rs:966-992 composed forward)
    const bool b_emit = u_emit < emi_c;
    const V3 a_f = b_emit ? v3(0.0f, 0.0f, 0.0f)
                          : v3(pwr * (0.5f + alb_c.x), pwr * (0.5f + alb_c.y),
                               pwr * (0.5f + alb_c.z));
    const V3 b_f = b_emit ? alb_c : scale(l_col, pwr);
    B = add(B, mul(A, b_f));
    A = mul(A, a_f);

    o = add(from_p, scale(next_dir, mrt::kEps));  // Ray::cast
    d = next_dir;
    pwr = pwr * dk;
    if (b_emit) break;  // emit kill: A == 0, nothing later contributes
  }
  A_out[i] = A.x;
  A_out[R + i] = A.y;
  A_out[2 * R + i] = A.z;
  B_out[i] = B.x;
  B_out[R + i] = B.y;
  B_out[2 * R + i] = B.z;
  fl_out[i] = first_live;
}

template <bool kRefract>
int launch(const float* tab, int P, const mrt::Layout& lay,
           const float* lights, int L, float dk, const float* o0,
           const float* d0, const float* te0, const int* row0,
           const float* tx0, const int* xrow0, const float* u8s, int K,
           int R, float* A, float* B, float* fl, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(P) * kRowCols + static_cast<size_t>(L) * kLightCols) *
      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        trace_fwd_kernel<kRefract>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int threads = 128;
  const int blocks = (R + threads - 1) / threads;
  trace_fwd_kernel<kRefract><<<blocks, threads, smem, stream>>>(
      tab, P, lay, lights, L, dk, o0, d0, te0, row0, tx0, xrow0, u8s, K, R,
      A, B, fl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mrt_trace_fwd(const float* tab, int P, int sph_start,
                             int sph_n, int pln_start, int pln_n,
                             int box_start, int box_n, const float* lights,
                             int L, float dk, const float* o0,
                             const float* d0, const float* te0,
                             const int* row0, const float* tx0,
                             const int* xrow0, const float* u8s, int K, int R,
                             int refract, float* A, float* B, float* fl,
                             void* stream) {
  const mrt::Layout lay{sph_start, sph_n, pln_start, pln_n, box_start, box_n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return refract ? launch<true>(tab, P, lay, lights, L, dk, o0, d0, te0,
                                row0, tx0, xrow0, u8s, K, R, A, B, fl, s)
                 : launch<false>(tab, P, lay, lights, L, dk, o0, d0, te0,
                                 row0, tx0, xrow0, u8s, K, R, A, B, fl, s);
}
