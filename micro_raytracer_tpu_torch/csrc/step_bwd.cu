// step_bwd: the backward of one bounce step of the per-step path — every
// ray's step transposed in one launch, from the residuals the train
// instance of step_fwd.cu saved, the step's input carry and the cotangent
// of its output carry.
//
// Replaces: micro_raytracer_tpu/ops/pallas_step.py :: _bwd_kernel (l.3139,
// called by _call_step_bwd l.3246, pallas_call l.3341) with the scatter of
// its per-ray attribute cotangents outside the kernel (_scatter_full,
// l.3238, applied at l.3366-3381). The step's transpose is trace_bwd.cu's
// (the fold, the direct light, the sampled direction, the material reads,
// the hit point and normal, the winner t: trace_bwd.cuh's step_bwd, whose
// winner-t, side and normal transposes it calls), at the chosen side of a
// ray that hit; a ray that was dead or missed
// passes its cotangents through (its carry passed through, its pwr
// decayed). Out: the cotangents of the input carry's o, d, pwr, A and B
// ((14, R), the live row 0), of the row table, the light table and the
// triangle table's G[2], h[2] columns.
//
// Lights: any number; a light's occlusion bit is read from its residual
// row when its term is transposed and its cotangent row (11 floats) goes
// straight to the block's accumulator, so no per-light state is kept
// (step_bwd_any below; the whole trace's step_bwd unrolls its light loop
// to kMaxLights, and sharing this loop moved the whole-trace backward's
// registers: 168 to 182 on mesh_opaque, 29% slower).
//
// Row cotangents: accumulated in the kernel, not scattered after it. The
// lights always, and the dense rows when they and the lights fit in 48 KB
// of shared memory (ops/step.py _step_shared_rows: about 540 rows with 8
// lights), add into per-block accumulators with shared atomics; each block
// writes its partial sums, and a second kernel adds them in block order
// (no row bound). Past that, the dense rows add into d_tab with global
// atomics, as triangle rows always do: a table that large spreads its hits
// over many rows. Every row keeps its own cotangent. On the H100 the shared rows
// take 5.7 ms for the nine launches of a lights8 training step (7 hot
// rows), global atomics on the same rows 10.5 (chip_smoke.py
// --step-diagnosis).
//
// Run to run: the per-ray d_o, d_d, d_pwr, d_A and d_B repeat bit for bit;
// the table cotangents vary at float32 rounding level (the order of the
// atomic adds).
//
// What bounds it on the H100: bytes. A ray reads 56 bytes of output
// cotangent, writes 56 of input cotangent, and a ray that hit reads 4*CR
// bytes of residuals, 4*NU of uniforms and its pwr, and does a few
// hundred float ops without a sweep. The rows are read from global memory
// (the winner rows only).
//
// Numerics: float32, -fmad=false, as trace_bwd.cu.
#include "trace_bwd.cuh"

namespace mrt {

// One step's transpose at its chosen side: trace_bwd.cuh's step_bwd, with
// the lights walked one at a time instead of held in registers (any
// number L): a light's occlusion bit is its residual row (`lok`, stride
// R), and a visible light's cotangent row goes to acc.light(li, row) as
// soon as it is transposed. Also out: ct_pwr, the cotangent of the step's
// pwr through the fold.
template <bool kRefract, bool kTex, class Acc>
__device__ __forceinline__ void step_bwd_any(
    const float* at, const Texels& tv, int kind, const float* tr,
    const float* s_lt, int L, const float* lok, V3 o, V3 d, V3 A, float t_c,
    bool choose, const float* u, int R, float pwr, V3 ctB, V3& ct_o,
    V3& ct_d, V3& ct_A, float& ct_pwr, float* d_at, float* d_gh, Acc& acc) {
  // ---- primal recompute at the selected hit ----
  const V3 p = add(o, scale(d, t_c));
  const Normal nm = normal_full(at, p, kind);
  const V3 n = nm.n;
  const Side<kTex> m(at, tv);
  const bool cond = rough_override(m, choose ? u[3 * R] : u[0]);
  const float rough_c = cond ? 1.0f : m.col(A_RGH);
  const V3 v = choose ? sphere_dir(u[4 * R], u[5 * R])
                      : sphere_dir(u[R], u[2 * R]);
  const V3 w1 = add(n, scale(v, rough_c));
  const V3 nrc = safe_norm(w1);
  const V3 alb = m.alb();
  const float rgh = m.col(A_RGH), met = m.col(A_MET);
  const float u_emit = kRefract ? u[7 * R] : u[3 * R];
  const bool b_emit = u_emit < m.col(A_EMI);

  // ---- fold: B2 = B + A*b, A2 = A*a ----
  V3 l_col = v3(0.0f, 0.0f, 0.0f);  // recomputed only when it matters
  V3 ct_alb = v3(0.0f, 0.0f, 0.0f);
  float ct_rgh = 0.0f, ct_met = 0.0f, ct_gls = 0.0f;
  V3 ct_p = ct_o;  // o2 = p + next*EPS
  const V3 ct_next = add(scale(ct_o, kEps), ct_d);
  V3 ct_n = v3(0.0f, 0.0f, 0.0f);
  V3 ct_dd = v3(0.0f, 0.0f, 0.0f);  // cotangent of d from this step
  const V3 ct_af = mul(ct_A, A);
  const V3 ct_bf = mul(ctB, A);
  if (b_emit) {
    // a = 0, b = albedo
    ct_alb = ct_bf;
  } else {
    ct_alb = scale(ct_af, pwr);
    const V3 ct_lcol = scale(ct_bf, pwr);
    const V3 o_col = scale(alb, 1.0f - met);
    for (int li = 0; li < L; ++li) {
      const float* lt = s_lt + li * kLightCols;
      const V3 lv = light_vec(lt, p);
      const float s_lv = dot(lv, lv);
      const float invl = 1.0f / sqrtf(s_lv > 0.0f ? s_lv : 1.0f);
      const V3 ln = scale(lv, invl);
      const float dotln = dot(ln, n);
      const float diff = fmaxf(dotln, 0.0f);
      const V3 lrefl = sub(ln, scale(n, 2.0f * dotln));
      const float dl = dot(d, lrefl);
      const float m = fmaxf(dl, 0.0f);
      const float m2 = m * m, m4 = m2 * m2, m8 = m4 * m4, m16 = m8 * m8;
      const float s32 = m16 * m16;
      const float spec = s32 * (1.0f - rgh);
      const float pl = lt[7];
      const V3 lc = load3(lt + 8);
      const V3 contrib = v3((o_col.x * diff * lc.x + spec) * pl,
                            (o_col.y * diff * lc.y + spec) * pl,
                            (o_col.z * diff * lc.z + spec) * pl);
      const bool ok = lok[li * R] > 0.5f;
      if (ok) l_col = add(l_col, contrib);
      if (!ok) continue;
      float g[kLightCols] = {};  // this light's cotangent row
      const float cc[3] = {ct_lcol.x, ct_lcol.y, ct_lcol.z};
      const float oc[3] = {o_col.x, o_col.y, o_col.z};
      const float lcc[3] = {lc.x, lc.y, lc.z};
      const float ab[3] = {alb.x, alb.y, alb.z};
      float ct_diff = 0.0f, ct_spec = 0.0f;
      float ca[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        g[7] += cc[k] * (oc[k] * diff * lcc[k] + spec);
        const float clp = cc[k] * pl;
        g[8 + k] += oc[k] * diff * clp;
        const float ct_ocol = clp * diff * lcc[k];
        ca[k] = ct_ocol * (1.0f - met);
        ct_met -= ct_ocol * ab[k];
        ct_diff += clp * oc[k] * lcc[k];
        ct_spec += clp;
      }
      ct_alb = add(ct_alb, v3(ca[0], ca[1], ca[2]));
      ct_rgh -= ct_spec * s32;
      const float ct_m =
          ct_spec * (1.0f - rgh) * 32.0f * (m16 * m8 * m4 * m2 * m);
      const float ct_dl = dl >= 0.0f ? ct_m : 0.0f;
      ct_dd = add(ct_dd, scale(lrefl, ct_dl));
      const V3 ct_lrefl = scale(d, ct_dl);
      V3 ct_ln = ct_lrefl;
      float ct_dotln = -2.0f * dot(n, ct_lrefl);
      ct_n = sub(ct_n, scale(ct_lrefl, 2.0f * dotln));
      ct_dotln += dotln >= 0.0f ? ct_diff : 0.0f;
      ct_ln = add(ct_ln, scale(n, ct_dotln));
      ct_n = add(ct_n, scale(ln, ct_dotln));
      // ln = lv * invl
      const float gl =
          (s_lv > 0.0f ? dot(lv, ct_ln) * invl * invl : 0.0f) * invl;
      const V3 ct_lv = sub(scale(ct_ln, invl), scale(lv, gl));
      if (lt[6] > 0.5f) {
        g[3] += ct_lv.x;
        g[4] += ct_lv.y;
        g[5] += ct_lv.z;
      } else {
        g[0] += ct_lv.x;
        g[1] += ct_lv.y;
        g[2] += ct_lv.z;
        ct_p = sub(ct_p, ct_lv);
      }
      acc.light(li, g);
    }
  }
  const V3 a_f = b_emit ? v3(0.0f, 0.0f, 0.0f)
                        : v3(pwr * (0.5f + alb.x), pwr * (0.5f + alb.y),
                             pwr * (0.5f + alb.z));
  const V3 b_f = b_emit ? alb : scale(l_col, pwr);
  // the carry's pwr: a = pwr (0.5 + alb), b = pwr l_col (pwr1 = pwr dk is
  // the caller's)
  ct_pwr = b_emit ? 0.0f
                  : dot(ct_af, v3(0.5f + alb.x, 0.5f + alb.y, 0.5f + alb.z)) +
                        dot(ct_bf, l_col);
  ct_A = add(mul(ct_A, a_f), mul(ctB, b_f));

  // ---- the sampled direction ----
  const float dn_r = dot(d, nrc);
  V3 ct_nr;
  if (!choose) {
    // next = safe_norm(w2), w2 = d - 2 (d.nr) nr
    const V3 w2 = sub(d, scale(nrc, 2.0f * dn_r));
    const V3 ct_w2 = norm_bwd(w2, ct_next);
    const float t_nr = dot(nrc, ct_w2);
    ct_dd = add(ct_dd, sub(ct_w2, scale(nrc, 2.0f * t_nr)));
    ct_nr = scale(add(scale(d, t_nr), scale(ct_w2, dn_r)), -2.0f);
  } else {
    // next = finite0(safe_norm(w3)), w3 = d*eta + nf*(cos*eta + sqrt(k))
    const float eta = 1.0f + 0.5f * m.col(A_GLS);
    const float cs = -dn_r;
    const float kk = 1.0f - eta * eta * (1.0f - cs * cs);
    const float k_safe = kk >= 0.0f ? fmaxf(kk, 1e-12f) : 1.0f;
    const float sq = sqrtf(k_safe);
    const float s3 = cs * eta + sq;
    const V3 w3 = add(scale(d, eta), scale(nrc, s3));
    const V3 nn3 = safe_norm(w3);
    const V3 ct_nn3 = v3(isfinite(nn3.x) ? ct_next.x : 0.0f,
                         isfinite(nn3.y) ? ct_next.y : 0.0f,
                         isfinite(nn3.z) ? ct_next.z : 0.0f);
    const V3 ct_w3 = norm_bwd(w3, ct_nn3);
    float ct_eta = dot(d, ct_w3);
    const float ct_s3 = dot(nrc, ct_w3);
    ct_dd = add(ct_dd, scale(ct_w3, eta));
    ct_nr = scale(ct_w3, s3);
    float ct_cos = ct_s3 * eta;
    ct_eta += ct_s3 * cs;
    const float ct_kk = kk >= 1e-12f ? ct_s3 * 0.5f / sq : 0.0f;
    ct_eta += ct_kk * (-2.0f * eta * (1.0f - cs * cs));
    ct_cos += ct_kk * (eta * eta * 2.0f * cs);
    // cos = -(nrc . d)
    ct_nr = sub(ct_nr, scale(d, ct_cos));
    ct_dd = sub(ct_dd, scale(nrc, ct_cos));
    ct_gls = 0.5f * ct_eta;
  }
  // nrc = safe_norm(w1), w1 = n + rough*v
  const V3 ct_w1 = norm_bwd(w1, ct_nr);
  ct_n = add(ct_n, ct_w1);
  if (!cond) ct_rgh += dot(v, ct_w1);

  // ---- material reads, hit point and normal, winner t ----
  if constexpr (kTex) {
    // the texels are constants (_tex_base_bwd)
    if (tv.id[0] >= 0) ct_alb = mul(ct_alb, v3(tv.v[0], tv.v[1], tv.v[2]));
    if (tv.id[1] >= 0) ct_rgh = 0.0f;
    if (tv.id[2] >= 0) ct_met = 0.0f;
    if (tv.id[3] >= 0) ct_gls = 0.0f;
  }
  d_at[A_ALB + 0] += ct_alb.x;
  d_at[A_ALB + 1] += ct_alb.y;
  d_at[A_ALB + 2] += ct_alb.z;
  d_at[A_RGH] += ct_rgh;
  d_at[A_MET] += ct_met;
  d_at[A_GLS] += ct_gls;
  V3 new_ct_o = v3(0.0f, 0.0f, 0.0f);
  const float ct_t =
      side_bwd(at, kind, nm, d, t_c, ct_p, ct_n, d_at, new_ct_o, ct_dd);
  winner_t_bwd(at, kind, o, d, choose ? 0.0f : ct_t, choose ? ct_t : 0.0f,
               d_at, new_ct_o, ct_dd, tr, d_gh);
  ct_o = new_ct_o;
  ct_d = ct_dd;
}

// One ray's step backward: ct1 the cotangent of the output carry, ct0 that
// of the input carry c0 (both (14, R)); resid (CR, R) and hit (R,) from
// the train instance; u8 (NU, R) the step's uniforms. `acc` adds into the
// row, triangle and light accumulators.
template <bool kRefract, bool kTri, bool kTex, class Acc>
__device__ __forceinline__ void step_ray_bwd(
    const float* tab, const Tris& T, const Layout& lay, const float* s_lt,
    int L, float dk, const Tex& tex, int i, int R,
    const float* __restrict__ resid, const float* __restrict__ hit,
    const float* __restrict__ c0, const float* __restrict__ u8,
    const float* __restrict__ ct1, float* __restrict__ ct0, Acc& acc) {
  const float* g1 = ct1 + i;
  V3 ct_o = v3(g1[(kC_O + 0) * R], g1[(kC_O + 1) * R], g1[(kC_O + 2) * R]);
  V3 ct_d = v3(g1[(kC_D + 0) * R], g1[(kC_D + 1) * R], g1[(kC_D + 2) * R]);
  V3 ct_A = v3(g1[(kC_A + 0) * R], g1[(kC_A + 1) * R], g1[(kC_A + 2) * R]);
  const V3 ct_B =
      v3(g1[(kC_B + 0) * R], g1[(kC_B + 1) * R], g1[(kC_B + 2) * R]);
  float ct_pwr = g1[kC_PWR * R] * dk;  // pwr1 = pwr0 * dk on every lane
  if (hit[i] > 0.5f) {
    const float* r = resid + i;
    const int side_rows = kTex ? tex_side_rows(tex.slots) : 0;
    const V3 o = v3(r[(R_O + 0) * R], r[(R_O + 1) * R], r[(R_O + 2) * R]);
    const V3 d = v3(r[(R_D + 0) * R], r[(R_D + 1) * R], r[(R_D + 2) * R]);
    const V3 A = v3(r[(R_A + 0) * R], r[(R_A + 1) * R], r[(R_A + 2) * R]);
    const bool choose = kRefract && r[R_CHOOSE * R] > 0.5f;
    // the chosen side's row (trace_bwd.cu trace_ray_bwd)
    const int row = static_cast<int>(
        r[((kTri && choose) ? res_xrow(L) : static_cast<int>(R_ROW)) * R]);
    const int kind = row_kind<kTri>(row, lay);
    const float* at = tab + row * kRowCols;
    const float* tr =
        kind == kRowTri ? T.tab + (row - lay.tri_start) * kTriCols : nullptr;
    Texels tv{};
    if constexpr (kTex) {
#pragma unroll
      for (int s = 0; s < kMapSlots; ++s)
        tv.id[s] = __ldg(tex.maps + row * kMapSlots + s);
      read_texels(r, res_rows<kTri>(L) + (choose ? side_rows : 0), R,
                  tex.slots, tv);
    }
    float d_at[kRowCols];
#pragma unroll
    for (int k = 0; k < kRowCols; ++k) d_at[k] = 0.0f;
    float d_gh[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float ct_pwr_fold;
    step_bwd_any<kRefract, kTex>(
        at, tv, kind, tr, s_lt, L, r + R_LOK * R, o, d, A,
        choose ? r[R_TX * R] : r[R_TE * R], choose, u8 + i, R,
        c0[kC_PWR * R + i], ct_B, ct_o, ct_d, ct_A, ct_pwr_fold, d_at, d_gh,
        acc);
    ct_pwr += ct_pwr_fold;
    acc.row(row, d_at);
    if (kTri && kind == kRowTri) acc.tri(row - lay.tri_start, d_gh);
  }
  float* g0 = ct0 + i;
  const float v[kCarryRows] = {ct_o.x, ct_o.y, ct_o.z, ct_d.x, ct_d.y,
                               ct_d.z, ct_pwr, 0.0f, ct_A.x, ct_A.y,
                               ct_A.z, ct_B.x, ct_B.y, ct_B.z};
#pragma unroll
  for (int k = 0; k < kCarryRows; ++k) g0[k * R] = v[k];
}

}  // namespace mrt

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

// accumulators of one block: the lights, and the dense rows when `rows` is
// set, in shared memory; otherwise dense rows, and with kTri triangle rows
// always, straight into the global d_tab and d_tri (zeroed by the wrapper)
template <bool kTri>
struct StepAcc {
  float* rows;    // (n_dense, kGradCols), or null
  float* lights;  // (L, kLightCols)
  int n_dense;
  float* g_tab;   // (P, kRowCols)
  float* g_tri;   // (Pt, 4)
  __device__ void row(int row, const float* d_at) {
    if (!rows || (kTri && row >= n_dense)) {
      float* dst = g_tab + static_cast<size_t>(row) * mrt::kRowCols;
#pragma unroll
      for (int g = 0; g < mrt::kGradCols; ++g) {
        const int c = mrt::tab_col(g);
        if (d_at[c] != 0.0f) atomicAdd(dst + c, d_at[c]);
      }
      return;
    }
    float* dst = rows + row * mrt::kGradCols;
#pragma unroll
    for (int g = 0; g < mrt::kGradCols; ++g)
      atomicAdd(dst + g, d_at[mrt::tab_col(g)]);
  }
  __device__ void tri(int t, const float* d_gh) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (d_gh[k] != 0.0f) atomicAdd(g_tri + 4 * t + k, d_gh[k]);
  }
  __device__ void light(int li, const float* g) {
#pragma unroll
    for (int c = 0; c < mrt::kLightCols; ++c)
      if (c != 6) atomicAdd(lights + li * mrt::kLightCols + c, g[c]);
  }
};

template <bool kRefract, bool kTri, bool kTex>
__global__ void step_bwd_kernel(const float* __restrict__ tab, int P,
                                mrt::Layout lay,
                                const float* __restrict__ tri,
                                const float* __restrict__ lights, int L,
                                float dk, mrt::Tex tex,
                                const float* __restrict__ resid,
                                const float* __restrict__ hit,
                                const float* __restrict__ c0,
                                const float* __restrict__ u8, int R,
                                const float* __restrict__ ct1,
                                float* __restrict__ ct0, int shared_rows,
                                float* __restrict__ partials,
                                float* __restrict__ d_tab,
                                float* __restrict__ d_tri) {
  extern __shared__ float smem[];
  float* s_lt = smem;
  float* s_acc = s_lt + L * mrt::kLightCols;
  const int n_rows = shared_rows ? P * mrt::kGradCols : 0;
  const int n_acc = n_rows + L * mrt::kLightCols;
  mrt::stage(s_lt, lights, L, mrt::kLightCols, mrt::kLightCols);
  for (int c = threadIdx.x; c < n_acc; c += blockDim.x) s_acc[c] = 0.0f;
  __syncthreads();
  StepAcc<kTri> acc{shared_rows ? s_acc : nullptr, s_acc + n_rows, P, d_tab,
                    d_tri};
  const mrt::Tris T{tri, nullptr};
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < R;
       i += gridDim.x * blockDim.x)
    mrt::step_ray_bwd<kRefract, kTri, kTex>(tab, T, lay, s_lt, L, dk, tex, i,
                                            R, resid, hit, c0, u8, ct1, ct0,
                                            acc);
  __syncthreads();
  float* part = partials + static_cast<size_t>(blockIdx.x) * n_acc;
  for (int c = threadIdx.x; c < n_acc; c += blockDim.x) part[c] = s_acc[c];
}

// the shared accumulators' sums in block order: the dense rows of d_tab
// (P, 26) when they were shared, and d_lights (L, 11)
__global__ void reduce_kernel(const float* __restrict__ partials, int blocks,
                              int P, int L, int shared_rows,
                              float* __restrict__ d_tab,
                              float* __restrict__ d_lights) {
  const int n_tab = shared_rows ? P * mrt::kRowCols : 0;
  const int n_out = n_tab + L * mrt::kLightCols;
  const int n_rows = shared_rows ? P * mrt::kGradCols : 0;
  const int n_acc = n_rows + L * mrt::kLightCols;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_out) return;
  int src;  // accumulator index, or -1 for a column with no cotangent
  if (j < n_tab) {
    const int row = j / mrt::kRowCols, c = j % mrt::kRowCols;
    const bool none = c == mrt::C_VALID || c == mrt::C_GID ||
                      c == mrt::A_OPA || c == mrt::A_EMI;
    src = none ? -1 : row * mrt::kGradCols + mrt::grad_col(c);
  } else {
    src = n_rows + (j - n_tab);
  }
  float s = 0.0f;
  if (src >= 0)
    for (int b = 0; b < blocks; ++b)
      s += partials[static_cast<size_t>(b) * n_acc + src];
  if (j < n_tab)
    d_tab[j] = s;
  else
    d_lights[j - n_tab] = s;
}

// The arguments every instance takes.
struct Args {
  const float* tab;
  int P;
  mrt::Layout lay;
  const float* tri;
  const float* lights;
  int L;
  float dk;
  mrt::Tex tex;
  const float* resid;
  const float* hit;
  const float* c0;
  const float* u8;
  int R;
  const float* ct1;
  float* ct0;
  int shared_rows;
  float* partials;
  int blocks;
  float* d_tab;
  float* d_lights;
  float* d_tri;
};

template <bool kRefract, bool kTri, bool kTex>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(a.shared_rows ? a.P : 0) * mrt::kGradCols +
       static_cast<size_t>(a.L) * 2 * mrt::kLightCols) *
      sizeof(float);
  auto kernel = step_bwd_kernel<kRefract, kTri, kTex>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<a.blocks, mrt::kBwdThreads, smem, stream>>>(
      a.tab, a.P, a.lay, a.tri, a.lights, a.L, a.dk, a.tex, a.resid, a.hit,
      a.c0, a.u8, a.R, a.ct1, a.ct0, a.shared_rows, a.partials, a.d_tab,
      a.d_tri);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_out =
      (a.shared_rows ? a.P * mrt::kRowCols : 0) + a.L * mrt::kLightCols;
  if (n_out)
    reduce_kernel<<<(n_out + 127) / 128, 128, 0, stream>>>(
        a.partials, a.blocks, a.P, a.L, a.shared_rows, a.d_tab, a.d_lights);
  return static_cast<int>(cudaGetLastError());
}

// the instance for the scene: refraction, triangles, textures
int dispatch(const Args& a, int refract, cudaStream_t s) {
  const bool tri = a.lay.tri_n > 0, tex = a.tex.slots != 0;
  if (refract) {
    if (tri)
      return tex ? launch<true, true, true>(a, s)
                 : launch<true, true, false>(a, s);
    return tex ? launch<true, false, true>(a, s)
               : launch<true, false, false>(a, s);
  }
  if (tri)
    return tex ? launch<false, true, true>(a, s)
               : launch<false, true, false>(a, s);
  return tex ? launch<false, false, true>(a, s)
             : launch<false, false, false>(a, s);
}

}  // namespace

// The tables as in mrt_trace_bwd (P: the dense rows; the cull blocks are
// not read); resid (CR, R) and hit (R,) from mrt_step_fwd_train, the input
// carry c0 (14, R) (its pwr row is read), the step's uniforms u8 (NU, R),
// the output carry's cotangent ct1 (14, R); out the input carry's ct0
// (14, R). shared_rows: the dense rows accumulate in shared memory
// (else with global atomics into d_tab); blocks: the grid size the wrapper
// sized `partials` for, (blocks, shared_rows ? P*22 : 0 + L*11) floats;
// d_tab (all rows) and d_tri (Pt, 4) zeroed by the wrapper.
extern "C" int mrt_step_bwd(const float* tab, int P, int sph_start,
                            int sph_n, int pln_start, int pln_n,
                            int box_start, int box_n, const float* tri,
                            int tri_start, int tri_n, const float* bb,
                            int n_cb, const float* sbb, int n_sb,
                            const float* lights, int L, float dk,
                            const int* maps, const float* atlas,
                            const int* tmeta, int slots, const float* resid,
                            const float* hit, const float* c0,
                            const float* u8, int R, int refract,
                            const float* ct1, float* ct0, int shared_rows,
                            float* partials, int blocks, float* d_tab,
                            float* d_lights, float* d_tri, void* stream) {
  (void)bb;
  (void)sbb;
  const Args a{tab, P,
               mrt::Layout{sph_start, sph_n, pln_start, pln_n, box_start,
                           box_n, tri_start, tri_n, n_cb, n_sb},
               tri, lights, L, dk, mrt::Tex{maps, atlas, tmeta, slots},
               resid, hit, c0, u8, R, ct1, ct0, shared_rows, partials,
               blocks, d_tab, d_lights, d_tri};
  return dispatch(a, refract, static_cast<cudaStream_t>(stream));
}
#endif  // __CUDACC__
