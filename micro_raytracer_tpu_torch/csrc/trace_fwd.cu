// trace_fwd: the whole forward path trace — all bounce + 1 steps of a ray
// in one launch. Two instances share one step body: the render instance
// (mrt_trace_fwd, no residuals) and the train instance
// (mrt_trace_fwd_train), which also writes the residuals the backward
// kernel (trace_bwd.cu) reads and each ray's live-step count.
//
// Replaces: micro_raytracer_tpu/ops/pallas_step.py :: _trace_kernel (called
// by _call_trace) with its body _step_math — the rows tail
// (pallas_step.py:1016-1107), emit_kill=True and the first-bounce record —
// in inference mode and in train mode (residual block res_o, _res_rows
// l.1298), for scenes with and without triangles (n_tri > 0 with the cull
// table tbb: the triangle sweeps of hit3.cuh, the triangle normal of
// _normal_rows, and the exit side's attributes fetched at xrow, l.959-990,
// since a mesh group has many rows). The component-form tail of that
// kernel is a TPU register relayout of the same math and has no
// counterpart here; the residual layout is this port's own
// (trace_step.cuh).
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
// skip made per thread. The train instance writes a step's residuals only
// while the ray lives, and the ray's count of live steps at the end; the
// Pallas kernel wrote a whole tile's rows until the tile died.
//
// Inputs: the (P, 26) row table and (L, 11) light table (trace_step.cuh),
// the triangle table (Pt, 16) and cull-block AABBs (n_cb, 8) (hit3.cuh),
// primaries o0, d0 (3, R), their hits te0, row0, tx0, xrow0 (R,), and
// uniforms u8s (K, NU, R) with NU = 8 ([u0..u6, u_emit]) when the scene
// refracts and 4 ([u0, u1, u2, u_emit]) otherwise. Outputs: A, B (3, R)
// and first_live (R,), the pre-kill hit liveness of step 0; in train mode
// also resid (K, 14 + L, R) and n_live (R,) int32.
//
// What bounds it on the H100: arithmetic and divergence. A ray costs 40
// bytes of primaries and hits, 4*NU bytes of uniforms per step and 28
// bytes out (train mode: 4*(14 + L) bytes of residuals per live step),
// while each step runs 1 + L sweeps over all dense rows (~65 float ops per
// row) and the triangle rows the cull leaves (~30 ops per row), plus ~300
// ops of shading. The design keeps the dense rows (P*104 bytes, at most
// step.MAX_ROWS = 2048 rows, 208 KB), the lights and the cull-block AABBs
// (at most hit3.MAX_TRI_BLOCKS, 8 KB) in shared memory, reads the triangle
// table (64 B a row, no row bound) and the winner's attributes of a
// triangle row from global memory through the read-only cache, reads the
// uniforms and writes the residuals coalesced (rays on the fastest axis),
// and lets a warp's threads drop out of the step loop independently; it
// does not regroup live rays, so warps with one long path run at the pace
// of that path. Staging a 960-triangle mesh's row and triangle tables per
// block (~100 KB) would leave one or two blocks per SM and copy them from
// L2 ~9,100 times per 1080x1080 launch; the triangle rows a warp tests
// together are one L1 broadcast instead. A scene without triangles runs
// the kTri = false instances: the code of the dense-only kernel.
//
// Numerics: float32 throughout; 1/sqrt as 1.0f/sqrtf, sincosf at full
// precision, -fmad=false (see hit3.cuh). The train instance's A, B and
// first_live equal the render instance's bit for bit: the residual stores
// are the only difference.
#include "trace_step.cuh"

namespace mrt {

// One ray's whole trace (the body of both instances). `s_tab` holds the
// dense rows, `g_tab` the whole row table (triangle rows are read there).
template <bool kRefract, bool kTrain, bool kTri = false>
__device__ __forceinline__ void trace_ray(
    const float* s_tab, const float* g_tab, const Tris& T, const Layout& lay,
    const float* s_lt, int L, float dk,
    int i, int R, int K, const float* __restrict__ o0,
    const float* __restrict__ d0, Hit h0, const float* __restrict__ u8s,
    float* __restrict__ A_out, float* __restrict__ B_out,
    float* __restrict__ fl_out, float* __restrict__ resid,
    int* __restrict__ n_live) {
  constexpr int NU = kRefract ? 8 : 4;
  const int CR = res_rows<kTri>(L);
  V3 o = v3(o0[i], o0[R + i], o0[2 * R + i]);
  V3 d = v3(d0[i], d0[R + i], d0[2 * R + i]);
  float pwr = 1.0f;
  V3 A = v3(1.0f, 1.0f, 1.0f);
  V3 B = v3(0.0f, 0.0f, 0.0f);
  float first_live = 0.0f;
  int n = 0;

  for (int k = 0; k < K; ++k) {
    const float* u = u8s + static_cast<size_t>(k) * NU * R + i;
    const Hit h = k == 0 ? h0
                         : closest_hit<kRefract, kTri>(s_tab, kRowCols, lay,
                                                       o.x, o.y, o.z, d.x,
                                                       d.y, d.z, T);
    const bool hit = h.te < kBig * 0.5f;
    if (k == 0) first_live = hit ? 1.0f : 0.0f;
    if (!hit) break;  // dead from here on: a = 1, b = 0 every later step

    const float* atE = row_at<kTri>(s_tab, g_tab, h.row, lay);
    const V3 p_e = add(o, scale(d, h.te));

    // per-light occlusion from the entry point (rt.rs:1027-1046)
    bool light_ok[kMaxLights];
#pragma unroll
    for (int li = 0; li < kMaxLights; ++li) {
      if (li >= L) break;
      const V3 lv = light_vec(s_lt + li * kLightCols, p_e);
      const V3 ln = scale(lv, 1.0f / sqrtf(dot(lv, lv)));
      const V3 so = add(p_e, scale(ln, kEps));
      light_ok[li] = !any_hit<kTri>(s_tab, kRowCols, lay, so.x, so.y, so.z,
                                    ln.x, ln.y, ln.z, T);
    }

    const V3 n_e = normal<kTri>(atE, p_e, h.row, lay);
    const float opa_e = atE[A_OPA];

    // reflect from the entry hit (rt.rs:559-572)
    const float rough_r = rough_override(atE, u[0]) ? 1.0f : atE[A_RGH];
    const V3 nr = sphere_rand(n_e, rough_r, u[R], u[2 * R]);
    const V3 refl = safe_norm(sub(d, scale(nr, 2.0f * dot(d, nr))));

    V3 next_dir = refl, from_p = p_e, norm_c = n_e;
    const float* atC = atE;  // chosen side's attributes
    bool choose = false;
    float u_emit;
    if (kRefract) {
      // refract from the exit hit (rt.rs:574-589, 1054-1058)
      const float* atX = row_at<kTri>(s_tab, g_tab, h.xrow, lay);
      const V3 p_x = add(o, scale(d, h.tx));
      const V3 n_x = normal<kTri>(atX, p_x, h.xrow, lay);
      const float rough_f = rough_override(atX, u[3 * R]) ? 1.0f : atX[A_RGH];
      const V3 nf = sphere_rand(n_x, rough_f, u[4 * R], u[5 * R]);
      const float eta = 1.0f + 0.5f * atX[A_GLS];
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

    if constexpr (kTrain) {
      float* r = resid + static_cast<size_t>(k) * CR * R + i;
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
#pragma unroll
      for (int li = 0; li < kMaxLights; ++li) {
        if (li >= L) break;
        r[(R_LOK + li) * R] = light_ok[li] ? 1.0f : 0.0f;
      }
      if (kTri) r[res_xrow(L) * R] = static_cast<float>(h.xrow);
      n = k + 1;
    }

    // fold update (rt.rs:966-992 composed forward)
    const bool b_emit = u_emit < emi_c;
    const V3 a_f = b_emit ? v3(0.0f, 0.0f, 0.0f)
                          : v3(pwr * (0.5f + alb_c.x), pwr * (0.5f + alb_c.y),
                               pwr * (0.5f + alb_c.z));
    const V3 b_f = b_emit ? alb_c : scale(l_col, pwr);
    B = add(B, mul(A, b_f));
    A = mul(A, a_f);

    o = add(from_p, scale(next_dir, kEps));  // Ray::cast
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
  if constexpr (kTrain) n_live[i] = n;
}

}  // namespace mrt

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

template <bool kRefract, bool kTrain, bool kTri>
__global__ void trace_fwd_kernel(const float* __restrict__ tab, int P,
                                 mrt::Layout lay,
                                 const float* __restrict__ tri,
                                 const float* __restrict__ bb,
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
                                 float* __restrict__ fl_out,
                                 float* __restrict__ resid,
                                 int* __restrict__ n_live) {
  extern __shared__ float smem[];
  float* s_tab = smem;
  float* s_lt = smem + P * mrt::kRowCols;
  float* s_bb = s_lt + L * mrt::kLightCols;
  mrt::stage(s_tab, tab, P, mrt::kRowCols, mrt::kRowCols);
  mrt::stage(s_lt, lights, L, mrt::kLightCols, mrt::kLightCols);
  if (kTri) mrt::stage(s_bb, bb, lay.n_cb, mrt::kBbCols, mrt::kBbCols);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  mrt::trace_ray<kRefract, kTrain, kTri>(
      s_tab, tab, mrt::Tris{tri, s_bb}, lay, s_lt, L, dk, i, R, K, o0, d0,
      mrt::Hit{te0[i], row0[i], tx0[i], xrow0[i]}, u8s, A_out, B_out, fl_out,
      resid, n_live);
}

template <bool kRefract, bool kTrain, bool kTri>
int launch(const float* tab, int P, const mrt::Layout& lay, const float* tri,
           const float* bb, const float* lights, int L, float dk,
           const float* o0, const float* d0, const float* te0,
           const int* row0, const float* tx0, const int* xrow0,
           const float* u8s, int K, int R, float* A, float* B, float* fl,
           float* resid, int* n_live, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(P) * mrt::kRowCols +
       static_cast<size_t>(L) * mrt::kLightCols +
       (kTri ? static_cast<size_t>(lay.n_cb) * mrt::kBbCols : 0)) *
      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        trace_fwd_kernel<kRefract, kTrain, kTri>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int threads = 128;
  const int blocks = (R + threads - 1) / threads;
  trace_fwd_kernel<kRefract, kTrain, kTri><<<blocks, threads, smem, stream>>>(
      tab, P, lay, tri, bb, lights, L, dk, o0, d0, te0, row0, tx0, xrow0, u8s,
      K, R, A, B, fl, resid, n_live);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTrain, bool kTri>
int dispatch_refract(const float* tab, int P, const mrt::Layout& lay,
                     const float* tri, const float* bb, const float* lights,
                     int L, float dk, const float* o0, const float* d0,
                     const float* te0, const int* row0, const float* tx0,
                     const int* xrow0, const float* u8s, int K, int R,
                     int refract, float* A, float* B, float* fl, float* resid,
                     int* n_live, cudaStream_t s) {
  return refract
             ? launch<true, kTrain, kTri>(tab, P, lay, tri, bb, lights, L, dk,
                                          o0, d0, te0, row0, tx0, xrow0, u8s,
                                          K, R, A, B, fl, resid, n_live, s)
             : launch<false, kTrain, kTri>(tab, P, lay, tri, bb, lights, L,
                                           dk, o0, d0, te0, row0, tx0, xrow0,
                                           u8s, K, R, A, B, fl, resid, n_live,
                                           s);
}

template <bool kTrain>
int dispatch(const float* tab, int P, int sph_start, int sph_n,
             int pln_start, int pln_n, int box_start, int box_n,
             const float* tri, int tri_start, int tri_n, const float* bb,
             int n_cb, const float* lights, int L, float dk, const float* o0,
             const float* d0, const float* te0, const int* row0,
             const float* tx0, const int* xrow0, const float* u8s, int K,
             int R, int refract, float* A, float* B, float* fl, float* resid,
             int* n_live, void* stream) {
  const mrt::Layout lay{sph_start, sph_n, pln_start, pln_n, box_start,
                        box_n,     tri_start, tri_n, n_cb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tri_n > 0
             ? dispatch_refract<kTrain, true>(tab, P, lay, tri, bb, lights, L,
                                              dk, o0, d0, te0, row0, tx0,
                                              xrow0, u8s, K, R, refract, A, B,
                                              fl, resid, n_live, s)
             : dispatch_refract<kTrain, false>(tab, P, lay, tri, bb, lights,
                                               L, dk, o0, d0, te0, row0, tx0,
                                               xrow0, u8s, K, R, refract, A,
                                               B, fl, resid, n_live, s);
}

}  // namespace

// P: the dense rows (tri_start), staged in shared memory; tri: the (Pt, 16)
// triangle table, or null with tri_n = 0; bb: the (n_cb, 8) block AABBs,
// or null with n_cb = 0.
extern "C" int mrt_trace_fwd(const float* tab, int P, int sph_start,
                             int sph_n, int pln_start, int pln_n,
                             int box_start, int box_n, const float* tri,
                             int tri_start, int tri_n, const float* bb,
                             int n_cb, const float* lights, int L, float dk,
                             const float* o0, const float* d0,
                             const float* te0, const int* row0,
                             const float* tx0, const int* xrow0,
                             const float* u8s, int K, int R, int refract,
                             float* A, float* B, float* fl, void* stream) {
  return dispatch<false>(tab, P, sph_start, sph_n, pln_start, pln_n,
                         box_start, box_n, tri, tri_start, tri_n, bb, n_cb,
                         lights, L, dk, o0, d0, te0, row0, tx0, xrow0, u8s,
                         K, R, refract, A, B, fl, nullptr, nullptr, stream);
}

extern "C" int mrt_trace_fwd_train(
    const float* tab, int P, int sph_start, int sph_n, int pln_start,
    int pln_n, int box_start, int box_n, const float* tri, int tri_start,
    int tri_n, const float* bb, int n_cb, const float* lights, int L,
    float dk, const float* o0, const float* d0, const float* te0,
    const int* row0, const float* tx0, const int* xrow0, const float* u8s,
    int K, int R, int refract, float* A, float* B, float* fl, float* resid,
    int* n_live, void* stream) {
  return dispatch<true>(tab, P, sph_start, sph_n, pln_start, pln_n,
                        box_start, box_n, tri, tri_start, tri_n, bb, n_cb,
                        lights, L, dk, o0, d0, te0, row0, tx0, xrow0, u8s, K,
                        R, refract, A, B, fl, resid, n_live, stream);
}
#endif  // __CUDACC__
