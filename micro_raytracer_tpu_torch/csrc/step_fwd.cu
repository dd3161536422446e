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
// hit3.MAX_TRI_BLOCKS, or the sphere segment's, at most 64) are staged in
// shared memory. The sphere cull holds 64 blocks per lane (StepMask), the
// JAX package's bound (pallas_hit3._CAND_MAX); beyond that a segment
// sweeps dense. A block whose lanes are all dead only passes its carry
// through.
//
// Numerics: float32, -fmad=false, as trace_fwd.cu.
#include "trace_step.cuh"

namespace mrt {

// A lane's sphere-block mask in the per-step kernel: up to 64 blocks.
using StepMask = unsigned long long;

// One ray's bounce step from the carry `c0` to `c1` (both (14, R)) with
// the step's uniforms `u8` (NU, R); hit_out (R,) the step's hit liveness;
// kTrain: the step's residuals (CR, R) of a ray that hits. `tab` is the
// whole row table in global memory, `s_lt` the lights and T.bb the cull
// blocks in shared memory.
template <bool kRefract, bool kTrain, bool kTri = false, bool kTex = false>
__device__ __forceinline__ void step_ray(
    const float* tab, const Tris& T, const Layout& lay, const float* s_lt,
    int L, float dk, const Tex& tex, int i, int R,
    const float* __restrict__ c0, const float* __restrict__ u8,
    float* __restrict__ c1, float* __restrict__ hit_out,
    float* __restrict__ resid) {
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
    h = closest_hit<kRefract, kTri, kSph, StepMask>(tab, kRowCols, lay, o.x,
                                                    o.y, o.z, d.x, d.y, d.z,
                                                    T);
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
        const bool ok = !any_hit<kTri, kSph, StepMask>(
            tab, kRowCols, lay, so.x, so.y, so.z, ln_e.x, ln_e.y, ln_e.z, T);
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

namespace {

template <bool kRefract, bool kTrain, bool kTri, bool kTex>
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
                                float* __restrict__ resid) {
  extern __shared__ float smem[];
  float* s_lt = smem;
  float* s_bb = s_lt + L * mrt::kLightCols;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // a block whose lanes are all dead only passes its carry through
  if (__syncthreads_or(i < R && c0[mrt::kC_LIVE * R + i] > 0.5f)) {
    mrt::stage(s_lt, lights, L, mrt::kLightCols, mrt::kLightCols);
    if (kTri)
      mrt::stage(s_bb, bb, lay.n_cb, mrt::kBbCols, mrt::kBbCols);
    else if (!kTex)
      mrt::stage(s_bb, sbb, lay.n_sb, mrt::kBbCols, mrt::kBbCols);
    __syncthreads();
  }
  if (i >= R) return;
  mrt::step_ray<kRefract, kTrain, kTri, kTex>(
      tab, mrt::Tris{tri, s_bb}, lay, s_lt, L, dk, tex, i, R, c0, u8, c1,
      hit, resid);
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
};

template <bool kRefract, bool kTrain, bool kTri, bool kTex>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(a.L) * mrt::kLightCols +
       static_cast<size_t>(kTri ? a.lay.n_cb : kTex ? 0 : a.lay.n_sb) *
           mrt::kBbCols) *
      sizeof(float);
  auto kernel = step_fwd_kernel<kRefract, kTrain, kTri, kTex>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int threads = 128;
  const int blocks = (a.R + threads - 1) / threads;
  kernel<<<blocks, threads, smem, stream>>>(
      a.tab, a.lay, a.tri, a.bb, a.sbb, a.lights, a.L, a.dk, a.tex, a.c0,
      a.u8, a.R, a.c1, a.hit, a.resid);
  return static_cast<int>(cudaGetLastError());
}

// the instance for the scene: refraction, triangles, textures
template <bool kTrain>
int dispatch(const Args& a, int refract, cudaStream_t s) {
  const bool tri = a.lay.tri_n > 0, tex = a.tex.slots != 0;
  if (refract) {
    if (tri)
      return tex ? launch<true, kTrain, true, true>(a, s)
                 : launch<true, kTrain, true, false>(a, s);
    return tex ? launch<true, kTrain, false, true>(a, s)
               : launch<true, kTrain, false, false>(a, s);
  }
  if (tri)
    return tex ? launch<false, kTrain, true, true>(a, s)
               : launch<false, kTrain, true, false>(a, s);
  return tex ? launch<false, kTrain, false, true>(a, s)
             : launch<false, kTrain, false, false>(a, s);
}

}  // namespace

// The arguments of mrt_trace_fwd for the tables (P: the dense rows, read
// from global memory here; tri / bb / sbb and the texture tables as there,
// sbb with up to 64 blocks), then the carry in c0 (14, R), the step's
// uniforms u8 (NU, R), and out the carry c1 (14, R) and the hit liveness
// hit (R,); the train instance also writes resid (CR, R), the rows of a ray
// that hits.
extern "C" int mrt_step_fwd(const float* tab, int P, int sph_start,
                            int sph_n, int pln_start, int pln_n,
                            int box_start, int box_n, const float* tri,
                            int tri_start, int tri_n, const float* bb,
                            int n_cb, const float* sbb, int n_sb,
                            const float* lights, int L, float dk,
                            const int* maps, const float* atlas,
                            const int* tmeta, int slots, const float* c0,
                            const float* u8, int R, int refract, float* c1,
                            float* hit, void* stream) {
  (void)P;
  const Args a{tab,
               mrt::Layout{sph_start, sph_n, pln_start, pln_n, box_start,
                           box_n, tri_start, tri_n, n_cb, n_sb},
               tri, bb, sbb, lights, L, dk,
               mrt::Tex{maps, atlas, tmeta, slots}, c0, u8, R, c1, hit,
               nullptr};
  return dispatch<false>(a, refract, static_cast<cudaStream_t>(stream));
}

extern "C" int mrt_step_fwd_train(
    const float* tab, int P, int sph_start, int sph_n, int pln_start,
    int pln_n, int box_start, int box_n, const float* tri, int tri_start,
    int tri_n, const float* bb, int n_cb, const float* sbb, int n_sb,
    const float* lights, int L, float dk, const int* maps,
    const float* atlas, const int* tmeta, int slots, const float* c0,
    const float* u8, int R, int refract, float* c1, float* hit,
    float* resid, void* stream) {
  (void)P;
  const Args a{tab,
               mrt::Layout{sph_start, sph_n, pln_start, pln_n, box_start,
                           box_n, tri_start, tri_n, n_cb, n_sb},
               tri, bb, sbb, lights, L, dk,
               mrt::Tex{maps, atlas, tmeta, slots}, c0, u8, R, c1, hit,
               resid};
  return dispatch<true>(a, refract, static_cast<cudaStream_t>(stream));
}
#endif  // __CUDACC__
