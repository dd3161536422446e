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
// straight to the accumulator, so no per-light state is kept
// (step_bwd_any below; the whole trace's step_bwd unrolls its light loop
// to kMaxLights, and sharing this loop moved the whole-trace backward's
// registers: 168 to 182 on mesh_opaque, 29% slower).
//
// The kernel scatters as trace_bwd.cu does (trace_bwd.cuh warp_rows). A
// warp takes 32 rays, and each lane holds one step, so every lane of a
// warp runs the step together: a lane whose ray missed or was dead runs it
// on zeros and adds nothing (a warp with no hit only passes its
// cotangents through). Rows shared by enough lanes of the warp are summed
// by a reduce-scatter and added once per nonzero column; the dense rows
// go into float64 sums, per block in shared memory while they fit beside
// the lights (ops/step.py _step_shared_rows; lights8's 24 rows), else
// straight into the global float64 sums (inst_grid3k's 3,384 rows);
// triangle rows and their (Pt, 4) Woop cotangents go lane by lane into
// d_tab and d_tri with float atomics. Each light's row, as every lane
// walks the lights in the same order, is summed over the warp by a
// reduce-scatter of its 11 columns (26 shuffles; skipped where no lane
// sees the light) and added by the column's lane to the warp's own
// float64 slots in shared memory, (warps, L, 11), with plain adds: 5.5 KB
// a block for 8 lights, 704 B a light; where the slots and the rows do not
// fit, to the global float64 sums. Blocks persist and add their sums once;
// a second kernel writes d_tab's dense rows and d_lights. Lane-by-lane
// float atomics on shared rows and lights serialise up to 32 ways
// (lights8: 7 hot rows, 8 lights), and a kernel that sums per-block
// partials serially costs a launch more (PERF.md, row 5's ablation).
//
// Run to run: the per-ray d_o, d_d, d_pwr, d_A and d_B repeat bit for bit
// and equal the per-ray walk's; the table cotangents are float64 sums of
// float32 terms (a warp's sums are float32) in an order that varies,
// rounded to float32 once; triangle rows are float32 atomic sums.
//
// What bounds it on the H100: bytes. A ray reads 56 bytes of output
// cotangent, writes 56 of input cotangent, and a ray that hit reads 4*CR
// bytes of residuals, 4*NU of uniforms and its pwr, and does a few
// hundred float ops without a sweep. The rows are read from global memory
// (the winner rows only). Registers: __launch_bounds__(kThreads,
// kMinBlocks) holds a thread to 128.
//
// Numerics: float32, -fmad=false, as trace_bwd.cu.
#include "trace_bwd.cuh"

namespace mrt {

// One step's transpose at its chosen side: trace_bwd.cuh's step_bwd, with
// the lights walked one at a time instead of held in registers (any
// number L): a light's occlusion bit is its residual row (`lok`, stride
// R), and a visible light's cotangent row goes to acc.light(li, row) as
// soon as it is transposed. Also out: ct_pwr, the cotangent of the step's
// pwr through the fold. Every light calls acc.light(li, row) in light order
// (a zero row for an occluded light, on an emit draw, or where `act` is
// false: a lane that runs the step on zeros beside its warp).
template <bool kRefract, bool kTex, class Acc>
__device__ __forceinline__ void step_bwd_any(
    const float* at, const Texels& tv, int kind, const float* tr,
    const LightTab& s_lt, int L, const float* lok, V3 o, V3 d, V3 A,
    float t_c,
    bool choose, const float* u, int R, float pwr, V3 ctB, V3& ct_o,
    V3& ct_d, V3& ct_A, float& ct_pwr, float* d_at, float* d_gh, Acc& acc,
    bool act = true) {
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
  // a = 0, b = albedo on an emit draw
  ct_alb = b_emit ? ct_bf : scale(ct_af, pwr);
  const V3 ct_lcol = scale(ct_bf, pwr);
  const V3 o_col = scale(alb, 1.0f - met);
  for (int li = 0; li < L; ++li) {
    float g[kLightCols] = {};  // this light's cotangent row
    if (act && !b_emit && lok[li * R] > 0.5f) {
      const float* lt = s_lt.row(li);
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
      l_col = add(l_col, contrib);
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
    }
    acc.light(li, g);
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
// row, triangle and light accumulators: acc.row(row, d_at) once (row -1
// for none), acc.tri for a triangle row, acc.light for every light.
// kWarp: every lane of a warp calls it together (lanes past R too), and a
// lane whose ray missed or was dead runs the step on zeros (row 0 of the
// table, nothing added), so that acc's light and row sums are warp-wide;
// otherwise a ray that missed returns after passing its cotangents
// through.
template <bool kRefract, bool kTri, bool kTex, bool kWarp = false, class Acc>
__device__ __forceinline__ void step_ray_bwd(
    const float* tab, const Tris& T, const Layout& lay, const LightTab& s_lt,
    int L, float dk, const Tex& tex, int i, int R,
    const float* __restrict__ resid, const float* __restrict__ hit,
    const float* __restrict__ c0, const float* __restrict__ u8,
    const float* __restrict__ ct1, float* __restrict__ ct0, Acc& acc) {
  const bool in = !kWarp || i < R;
  const int j = in ? i : 0;  // the column read (a lane past R reads ray 0)
  const float* g1 = ct1 + j;
  V3 ct_o = v3(g1[(kC_O + 0) * R], g1[(kC_O + 1) * R], g1[(kC_O + 2) * R]);
  V3 ct_d = v3(g1[(kC_D + 0) * R], g1[(kC_D + 1) * R], g1[(kC_D + 2) * R]);
  V3 ct_A = v3(g1[(kC_A + 0) * R], g1[(kC_A + 1) * R], g1[(kC_A + 2) * R]);
  const V3 ct_B =
      v3(g1[(kC_B + 0) * R], g1[(kC_B + 1) * R], g1[(kC_B + 2) * R]);
  float ct_pwr = g1[kC_PWR * R] * dk;  // pwr1 = pwr0 * dk on every lane
  const bool on = in && hit[j] > 0.5f;
  if (kWarp || on) {
    const float* r = resid + j;
    const int side_rows = kTex ? tex_side_rows(tex.slots) : 0;
    // the rows an unwritten residual column holds are never read
    const V3 zero = v3(0.0f, 0.0f, 0.0f);
    const V3 o =
        on ? v3(r[(R_O + 0) * R], r[(R_O + 1) * R], r[(R_O + 2) * R]) : zero;
    const V3 d =
        on ? v3(r[(R_D + 0) * R], r[(R_D + 1) * R], r[(R_D + 2) * R]) : zero;
    const V3 A =
        on ? v3(r[(R_A + 0) * R], r[(R_A + 1) * R], r[(R_A + 2) * R]) : zero;
    const bool choose = on && kRefract && r[R_CHOOSE * R] > 0.5f;
    // the chosen side's row (trace_bwd.cu trace_ray_bwd)
    const int row =
        on ? static_cast<int>(r[((kTri && choose) ? res_xrow(L)
                                                  : static_cast<int>(R_ROW)) *
                                R])
           : 0;
    const int kind = row_kind<kTri>(row, lay);
    const float* at = tab + row * kRowCols;
    const float* tr =
        kind == kRowTri ? T.tab + (row - lay.tri_start) * kTriCols : nullptr;
    Texels tv{};
    if constexpr (kTex) {
#pragma unroll
      for (int s = 0; s < kMapSlots; ++s)
        tv.id[s] = __ldg(tex.maps + row * kMapSlots + s);
      if (on)
        read_texels(r, res_rows<kTri>(L) + (choose ? side_rows : 0), R,
                    tex.slots, tv);
    }
    float d_at[kRowCols];
#pragma unroll
    for (int k = 0; k < kRowCols; ++k) d_at[k] = 0.0f;
    float d_gh[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float ct_pwr_fold;
    V3 s_o = ct_o, s_d = ct_d, s_A = ct_A;
    step_bwd_any<kRefract, kTex>(
        at, tv, kind, tr, s_lt, L, r + R_LOK * R, o, d, A,
        on ? (choose ? r[R_TX * R] : r[R_TE * R]) : 0.0f, choose, u8 + j, R,
        c0[kC_PWR * R + j], ct_B, s_o, s_d, s_A, ct_pwr_fold, d_at, d_gh, acc,
        on);
    if (on) {
      ct_o = s_o;
      ct_d = s_d;
      ct_A = s_A;
      ct_pwr += ct_pwr_fold;
      if (kTri && kind == kRowTri) acc.tri(row - lay.tri_start, d_gh);
    }
    acc.row(on ? row : -1, d_at);
  }
  if (!in) return;
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

#include <algorithm>

#include "grid.cuh"

namespace {

using mrt::kFull;
constexpr int kThreads = 256;  // threads per block
constexpr int kMinBlocks = 2;  // blocks per SM the register budget keeps
// lanes on one row from which the warp sums them before adding: into
// shared memory and into global memory (trace_bwd.cu's values)
constexpr int kAggShared = 8;
constexpr int kAggGlobal = 2;

// The accumulators of one warp: dense rows (trace_bwd.cuh warp_rows) into
// the block's float64 rows in shared memory (`s_rows`, or null: the global
// float64 sums `g_rows`), triangle rows and their Woop cotangents lane by
// lane into the global float32 d_tab and d_tri, each light's row summed
// over the warp into the warp's float64 slots `lights` (L, 11) in shared
// memory or, where they did not fit, into the global float64 sums.
template <bool kTri>
struct WarpAcc {
  double* s_rows;
  double* g_rows;
  double* lights;
  bool lights_shared;
  int n_dense;
  float* g_tab;  // (P, kRowCols) float32
  float* g_tri;  // (Pt, 4)
  int lane;
  __device__ __forceinline__ void row(int row, const float* d_at) {
    if (kTri && row >= n_dense) {
      // a triangle row: straight into the global table
      float* dst = g_tab + static_cast<size_t>(row) * mrt::kRowCols;
#pragma unroll
      for (int g = 0; g < mrt::kGradCols; ++g) {
        const int c = mrt::tab_col(g);
        if (d_at[c] != 0.0f) atomicAdd(dst + c, d_at[c]);
      }
      row = -1;
    }
    mrt::warp_rows<kAggShared, kAggGlobal>(s_rows != nullptr, s_rows, g_rows,
                                           row, d_at, lane);
  }
  __device__ __forceinline__ void tri(int t, const float* d_gh) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (d_gh[k] != 0.0f) atomicAdd(g_tri + 4 * t + k, d_gh[k]);
  }
  __device__ __forceinline__ void light(int li, const float* g) {
    bool any = false;
#pragma unroll
    for (int c = 0; c < mrt::kLightCols; ++c) any |= g[c] != 0.0f;
    if (!__any_sync(kFull, any)) return;
    float v[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) v[c] = c < mrt::kLightCols ? g[c] : 0.0f;
    const float s = mrt::warp_transpose_sum16<mrt::kLightCols>(v, lane);
    if (lane < mrt::kLightCols && lane != 6 && s != 0.0f) {
      double* dst = lights + li * mrt::kLightCols + lane;
      if (lights_shared)
        *dst += static_cast<double>(s);  // this lane's column alone
      else
        atomicAdd(dst, static_cast<double>(s));
    }
  }
};

// The shared memory of a block: the warps' light slots (warps, L, 11) and
// the dense rows (P, 26) in float64 where asked (rows_shared) and they
// fit kSharedBytes beside the slots, and the lights (L, 11) in float32.
constexpr size_t kSharedBytes = 100 * 1024;

size_t slot_bytes(int L) {
  return static_cast<size_t>(kThreads / 32) * L * mrt::kLightCols *
         sizeof(double);
}

bool slots_shared(int P, int L, int rows_shared) {
  return slot_bytes(L) + (rows_shared ? static_cast<size_t>(P) *
                                            mrt::kRowCols * sizeof(double)
                                      : 0) <=
         kSharedBytes;
}

size_t smem_bytes(int P, int L, int rows_shared) {
  return (rows_shared
              ? static_cast<size_t>(P) * mrt::kRowCols * sizeof(double)
              : 0) +
         (slots_shared(P, L, rows_shared) ? slot_bytes(L) : 0) +
         static_cast<size_t>(std::min(L, mrt::kStagedLights)) *
             mrt::kLightCols * sizeof(float);
}

// kMany: more lights than the block stages (kStagedLights); the rest are
// read from global memory (a kernel of its own, so that the others keep
// their code: reading the lights through two pointers spilled 36 B more
// on lights8 and cost its step 3.9%, PERF.md)
template <bool kRefract, bool kTri, bool kTex, bool kMany>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    step_bwd_kernel(const float* __restrict__ tab, int P, mrt::Layout lay,
                    const float* __restrict__ tri,
                    const float* __restrict__ lights, int L, float dk,
                    mrt::Tex tex, const float* __restrict__ resid,
                    const float* __restrict__ hit,
                    const float* __restrict__ c0,
                    const float* __restrict__ u8, int R,
                    const float* __restrict__ ct1, float* __restrict__ ct0,
                    int rows_shared, int lights_shared,
                    double* __restrict__ acc, float* __restrict__ d_tab,
                    float* __restrict__ d_tri) {
  extern __shared__ double smem[];
  const int nl = L * mrt::kLightCols;
  const int warps = blockDim.x >> 5;
  const int n_rows = rows_shared ? P * mrt::kRowCols : 0;
  const int n_slots = lights_shared ? warps * nl : 0;
  double* s_rows = smem;                // (P, 26) when rows_shared
  double* s_slots = smem + n_rows;      // (warps, L, 11) when lights_shared
  // (min(L, kStagedLights), 11): the rest read from global memory
  float* s_lt = reinterpret_cast<float*>(s_slots + n_slots);
  mrt::stage(s_lt, lights, mrt::staged_lights(L), mrt::kLightCols,
             mrt::kLightCols);
  const mrt::LightTab lts =
      kMany ? mrt::LightTab{s_lt, lights} : mrt::LightTab{s_lt};
  for (int c = threadIdx.x; c < n_rows + n_slots; c += blockDim.x)
    smem[c] = 0.0;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double* g_lights = acc + P * mrt::kRowCols;
  WarpAcc<kTri> wacc{rows_shared ? s_rows : nullptr,
                     acc,
                     lights_shared ? s_slots + warp * nl : g_lights,
                     lights_shared != 0,
                     P,
                     d_tab,
                     d_tri,
                     lane};
  const mrt::Tris T{tri, nullptr};
  for (int base = (blockIdx.x * warps + warp) * 32; base < R;
       base += gridDim.x * warps * 32) {
    const int i = base + lane;
    const bool on = i < R && hit[i] > 0.5f;
    if (__any_sync(kFull, on)) {
      mrt::step_ray_bwd<kRefract, kTri, kTex, true>(
          tab, T, lay, lts, L, dk, tex, i, R, resid, hit, c0, u8, ct1, ct0,
          wacc);
    } else if (i < R) {
      // no lane of the warp hit: the cotangents pass through
#pragma unroll
      for (int k = 0; k < mrt::kCarryRows; ++k) {
        const float g = ct1[k * R + i];
        ct0[k * R + i] = k == mrt::kC_PWR ? g * dk
                         : k == mrt::kC_LIVE ? 0.0f
                                             : g;
      }
    }
  }
  __syncthreads();
  // the block's sums, once, into acc: each light column over the warps'
  // slots (in a fixed order), then the shared rows' nonzero entries
  if (lights_shared)
    for (int c = threadIdx.x; c < nl; c += blockDim.x) {
      if (c % mrt::kLightCols == 6) continue;
      double s = 0.0;
      for (int w = 0; w < warps; ++w) s += s_slots[w * nl + c];
      if (s != 0.0) atomicAdd(g_lights + c, s);
    }
  if (rows_shared)
    for (int c = threadIdx.x; c < n_rows; c += blockDim.x)
      if (s_rows[c] != 0.0) atomicAdd(acc + c, s_rows[c]);
}

// d_tab's dense rows and d_lights from the float64 sums
__global__ void finish_kernel(const double* __restrict__ acc, int P, int L,
                              float* __restrict__ d_tab,
                              float* __restrict__ d_lights) {
  const int n_rows = P * mrt::kRowCols;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < n_rows)
    d_tab[j] = static_cast<float>(acc[j]);
  else if (j < n_rows + L * mrt::kLightCols)
    d_lights[j - n_rows] = static_cast<float>(acc[j]);
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
  int rows_shared;
  double* acc;
  float* d_tab;
  float* d_lights;
  float* d_tri;
};

template <bool kRefract, bool kTri, bool kTex, bool kMany>
int launch(const Args& a, cudaStream_t stream) {
  const auto kernel = step_bwd_kernel<kRefract, kTri, kTex, kMany>;
  const size_t smem = smem_bytes(a.P, a.L, a.rows_shared);
  int per_sm = 0, sms = 0;
  int e = mrt::resident_blocks(kernel, kThreads, smem, &per_sm, &sms);
  if (e) return e;
  // persistent: as many blocks as the card keeps resident (grid.cuh)
  const int blocks = std::max(
      1, std::min((a.R + kThreads - 1) / kThreads, sms * per_sm));
  kernel<<<blocks, kThreads, smem, stream>>>(
      a.tab, a.P, a.lay, a.tri, a.lights, a.L, a.dk, a.tex, a.resid, a.hit,
      a.c0, a.u8, a.R, a.ct1, a.ct0, a.rows_shared,
      slots_shared(a.P, a.L, a.rows_shared) ? 1 : 0, a.acc, a.d_tab,
      a.d_tri);
  e = static_cast<int>(cudaGetLastError());
  if (e != cudaSuccess) return e;
  const int n_out = a.P * mrt::kRowCols + a.L * mrt::kLightCols;
  finish_kernel<<<(n_out + 255) / 256, 256, 0, stream>>>(
      a.acc, a.P, a.L, a.d_tab, a.d_lights);
  return static_cast<int>(cudaGetLastError());
}

// the launch and the occupancy query of one instance
struct Launch {
  const Args& a;
  cudaStream_t s;
  template <bool kRefract, bool kTri, bool kTex>
  int run() const {
    return a.L > mrt::kStagedLights
               ? launch<kRefract, kTri, kTex, true>(a, s)
               : launch<kRefract, kTri, kTex, false>(a, s);
  }
};

struct Occupancy {
  int P, L, rows_shared;
  int* per_sm;
  template <bool kRefract, bool kTri, bool kTex>
  int run() const {
    const size_t smem = smem_bytes(P, L, rows_shared);
    return L > mrt::kStagedLights
               ? mrt::resident_blocks(
                     step_bwd_kernel<kRefract, kTri, kTex, true>, kThreads,
                     smem, per_sm)
               : mrt::resident_blocks(
                     step_bwd_kernel<kRefract, kTri, kTex, false>, kThreads,
                     smem, per_sm);
  }
};

// the instance for the scene: refraction, triangles, textures
template <class F>
int dispatch(bool refract, bool tri, bool tex, const F& f) {
  if (refract) {
    if (tri)
      return tex ? f.template run<true, true, true>()
                 : f.template run<true, true, false>();
    return tex ? f.template run<true, false, true>()
               : f.template run<true, false, false>();
  }
  if (tri)
    return tex ? f.template run<false, true, true>()
               : f.template run<false, true, false>();
  return tex ? f.template run<false, false, true>()
             : f.template run<false, false, false>();
}

}  // namespace

// The tables as in mrt_trace_bwd (P: the dense rows; the cull blocks are
// not read); resid (CR, R) and hit (R,) from mrt_step_fwd_train, the input
// carry c0 (14, R) (its pwr row is read), the step's uniforms u8 (NU, R),
// the output carry's cotangent ct1 (14, R); out the input carry's ct0
// (14, R). rows_shared: the dense rows accumulate per block in shared
// memory (else straight into the global float64 sums); acc: P * 26 + L *
// 11 float64 sums, d_tab (all rows) and d_tri (Pt, 4), all zeroed by the
// wrapper; the kernel writes d_tab's dense rows and d_lights from acc.
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
                            const float* ct1, float* ct0, int rows_shared,
                            double* acc, float* d_tab, float* d_lights,
                            float* d_tri, void* stream) {
  (void)bb;
  (void)sbb;
  const Args a{tab, P,
               mrt::Layout{sph_start, sph_n, pln_start, pln_n, box_start,
                           box_n, tri_start, tri_n, n_cb, n_sb},
               tri, lights, L, dk, mrt::Tex{maps, atlas, tmeta, slots},
               resid, hit, c0, u8, R, ct1, ct0, rows_shared, acc, d_tab,
               d_lights, d_tri};
  return dispatch(refract != 0, tri_n > 0, slots != 0,
                  Launch{a, static_cast<cudaStream_t>(stream)});
}

// Resident warps per SM of the instance a scene of P dense rows and L
// lights launches (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into
// *warps; returns a CUDA error code.
extern "C" int mrt_step_bwd_occupancy(int P, int L, int rows_shared,
                                      int refract, int tri, int tex,
                                      int* warps) {
  int per_sm = 0;
  const int e = dispatch(refract != 0, tri != 0, tex != 0,
                         Occupancy{P, L, rows_shared, &per_sm});
  *warps = per_sm * (kThreads / 32);
  return e;
}
#endif  // __CUDACC__
