// The per-step transposes of the whole-trace backward (trace_bwd.cu): the
// winner t, the hit point and normal, the fold, the direct light and the
// sampled direction of one step (step_bwd), with the whole trace's light
// loop unrolled to kMaxLights. The per-step backward (step_bwd.cu)
// shares the transposes around them and walks any number of lights. See
// trace_bwd.cu for what each transposes and its numerics. Both backward
// kernels scatter their cotangents with the warp-wide sums at the end of
// this file (device code only).
#pragma once

#include "trace_step.cuh"

namespace mrt {

constexpr int kGradCols = 22;  // differentiable columns of a row

// accumulator column of row-table column c (c not in 16, 17, 24, 25)
__device__ __forceinline__ int grad_col(int c) { return c < 16 ? c : c - 2; }

// row-table column of accumulator column g
__device__ __forceinline__ int tab_col(int g) { return g < 16 ? g : g + 2; }

// cotangent of v from the cotangent ct of safe_norm(v) (_norm_bwd)
__device__ __forceinline__ V3 norm_bwd(V3 v, V3 ct) {
  const float s = dot(v, v);
  const float inv = 1.0f / sqrtf(fmaxf(s, kNormEps));
  const float g = (s >= kNormEps ? dot(v, ct) * inv * inv : 0.0f) * inv;
  return sub(scale(ct, inv), scale(v, g));
}

// Winner-t transpose (_winner_t_bwd_both, and _winner_t_bwd_math on one
// side): the cotangents ce of the entry t and cx of the exit t of one row
// (same_row: both sides share the row's primal chain), into d_at[0..15]
// (frame, ip, na, radius) and the ray; a triangle row's (the Woop plane
// form of its triangle-table row `tr`) into d_gh = (d g (3), d h).
// kSplitTies: a box t attained by several axes shares its cotangent evenly
// among them (autograd of jnp.max / jnp.min, the closest hit's VJP
// pallas_hit3._winner_t_all, hit3_bwd.cu), where the fused backward gives
// it all to the first (pallas_step.py:2021-2024).
template <bool kSplitTies = false>
__device__ __forceinline__ void winner_t_bwd(const float* at, int kind, V3 o,
                                             V3 d, float ce, float cx,
                                             float* d_at, V3& ct_o, V3& ct_d,
                                             const float* tr = nullptr,
                                             float* d_gh = nullptr) {
  if (kind == kRowTri) {
    // t = -(g.o + h) / (g.d); the exit t of a triangle is its entry t
    const float ctm = ce + cx;
    const V3 g = v3(__ldg(tr + 6), __ldg(tr + 7), __ldg(tr + 8));
    const float oz = dot(o, g) + __ldg(tr + T_H + 2);
    const float dz = dot(d, g);
    const bool dz_ok = dz != 0.0f;
    const float inv_dz = 1.0f / (dz_ok ? dz : 1.0f);
    const float t = -oz * inv_dz;
    const float ct_oz = -ctm * inv_dz;
    const float ct_dz = dz_ok ? -ctm * t * inv_dz : 0.0f;
    d_gh[0] += o.x * ct_oz + d.x * ct_dz;
    d_gh[1] += o.y * ct_oz + d.y * ct_dz;
    d_gh[2] += o.z * ct_oz + d.z * ct_dz;
    d_gh[3] += ct_oz;
    ct_o = add(ct_o, scale(g, ct_oz));
    ct_d = add(ct_d, scale(g, ct_dz));
    return;
  }
  const float* f = at + A_FR;
  const V3 ip = load3(at + A_IP);
  const V3 na = load3(at + A_NA);
  const V3 rel = sub(o, ip);
  const V3 op = add(ip, matvec(f, rel));
  const V3 dp = matvec(f, d);
  V3 ct_op = v3(0.0f, 0.0f, 0.0f), ct_dp = ct_op, ct_ip = ct_op,
     ct_na = ct_op;
  float ct_r = 0.0f;
  if (kind == kRowSphere) {
    const float r = at[A_PR];
    const V3 oc = sub(op, ip);
    const float a = dot(dp, dp);
    const float b = 2.0f * dot(oc, dp);
    const float c = dot(oc, oc) - r * r;
    const float disc = b * b - 4.0f * a * c;
    const float sq = sqrtf(disc >= 0.0f ? fmaxf(disc, 1e-12f) : 1.0f);
    const float inv_a2 = 1.0f / (a == 0.0f ? 1.0f : 2.0f * a);
    const float t_en = (-b - sq) * inv_a2;
    const float t_ex = (-b + sq) * inv_a2;
    const float g_disc =
        disc >= 1e-12f ? (cx - ce) * inv_a2 * (0.5f / sq) : 0.0f;
    const float ct_b = -(ce + cx) * inv_a2 + g_disc * (2.0f * b);
    const float ct_a =
        (a == 0.0f ? 0.0f : -2.0f * inv_a2 * (ce * t_en + cx * t_ex)) +
        g_disc * (-4.0f * c);
    const float ct_c = g_disc * (-4.0f * a);
    ct_dp = add(scale(dp, 2.0f * ct_a), scale(oc, 2.0f * ct_b));
    const V3 ct_oc = add(scale(dp, 2.0f * ct_b), scale(oc, 2.0f * ct_c));
    ct_op = ct_oc;
    ct_ip = scale(ct_oc, -1.0f);
    ct_r = ct_c * (-2.0f * r);
  } else if (kind == kRowPlane) {
    // the exit t of a plane is its entry t: one chain, summed cotangent
    const float ctm = ce + cx;
    const float nn = dot(na, na);
    const bool nn_ok = nn > 0.0f;
    const float inv = 1.0f / sqrtf(nn_ok ? nn : 1.0f);
    const V3 nr = scale(na, inv);
    const float dn = dot(dp, nr);
    const bool dn_ok = dn != 0.0f;
    const float inv_dn = 1.0f / (dn_ok ? dn : 1.0f);
    const float num = -(dot(op, nr) - dot(nr, ip));
    const float t = num * inv_dn;
    const float ct_num = ctm * inv_dn;
    const float ct_dn = dn_ok ? -ctm * t * inv_dn : 0.0f;
    ct_op = scale(nr, -ct_num);
    ct_ip = scale(nr, ct_num);
    ct_dp = scale(nr, ct_dn);
    const V3 ct_nr = add(add(scale(op, -ct_num), scale(ip, ct_num)),
                         scale(dp, ct_dn));
    const float ct_inv = dot(na, ct_nr);
    const float ct_nn = nn_ok ? ct_inv * (-0.5f) * inv * inv * inv : 0.0f;
    ct_na = add(scale(ct_nr, inv), scale(na, 2.0f * ct_nn));
  } else {
    // box slabs: the gradient of t0 = max(lo) / t1 = min(hi) goes to the
    // first axis that attains it (kSplitTies: to each, evenly)
    const float dpa[3] = {dp.x, dp.y, dp.z};
    const float opa[3] = {op.x, op.y, op.z};
    const float ipa[3] = {ip.x, ip.y, ip.z};
    const float naa[3] = {na.x, na.y, na.z};
    float mm[3], te[3], tx[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const bool z = dpa[k] == 0.0f;
      mm[k] = z ? kInvEps : 1.0f / (z ? 1.0f : dpa[k]);
      const float nb = (opa[k] - ipa[k]) * mm[k];
      const float kb = 0.5f * naa[k] * fabsf(mm[k]);
      te[k] = -nb - kb;
      tx[k] = -nb + kb;
    }
    const float t_lo = fmaxf(fmaxf(te[0], te[1]), te[2]);
    const float t_hi = fminf(fminf(tx[0], tx[1]), tx[2]);
    bool taken_e = false, taken_x = false;
    float co[3], cip[3], cna[3], cdp[3];
    float ce_k = ce, cx_k = cx;
    if constexpr (kSplitTies) {
      const int n_e = (te[0] == t_lo) + (te[1] == t_lo) + (te[2] == t_lo);
      const int n_x = (tx[0] == t_hi) + (tx[1] == t_hi) + (tx[2] == t_hi);
      ce_k = n_e > 1 ? ce / static_cast<float>(n_e) : ce;
      cx_k = n_x > 1 ? cx / static_cast<float>(n_x) : cx;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const bool ak_e = te[k] == t_lo && (kSplitTies || !taken_e);
      taken_e = taken_e || ak_e;
      const bool ak_x = tx[k] == t_hi && (kSplitTies || !taken_x);
      taken_x = taken_x || ak_x;
      const float cae = ak_e ? ce_k : 0.0f;
      const float cax = ak_x ? cx_k : 0.0f;
      const float cboth = cae + cax;
      co[k] = cboth * (-mm[k]);
      cip[k] = cboth * mm[k];
      cna[k] = (cax - cae) * (0.5f * fabsf(mm[k]));
      cdp[k] = dpa[k] == 0.0f ? 0.0f : -(cae * te[k] + cax * tx[k]) * mm[k];
    }
    ct_op = v3(co[0], co[1], co[2]);
    ct_ip = v3(cip[0], cip[1], cip[2]);
    ct_na = v3(cna[0], cna[1], cna[2]);
    ct_dp = v3(cdp[0], cdp[1], cdp[2]);
  }
  // op = ip + M (o - ip), dp = M d
  const V3 mt_op = matTvec(f, ct_op);
  ct_o = add(ct_o, mt_op);
  ct_d = add(ct_d, matTvec(f, ct_dp));
  const V3 d_ip = add(ct_ip, sub(ct_op, mt_op));
  const float rl[3] = {rel.x, rel.y, rel.z};
  const float dd[3] = {d.x, d.y, d.z};
  const float cop[3] = {ct_op.x, ct_op.y, ct_op.z};
  const float cdp[3] = {ct_dp.x, ct_dp.y, ct_dp.z};
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      d_at[A_FR + 3 * k + j] += cop[k] * rl[j] + cdp[k] * dd[j];
  d_at[A_IP + 0] += d_ip.x;
  d_at[A_IP + 1] += d_ip.y;
  d_at[A_IP + 2] += d_ip.z;
  d_at[A_NA + 0] += ct_na.x;
  d_at[A_NA + 1] += ct_na.y;
  d_at[A_NA + 2] += ct_na.z;
  d_at[A_PR] += ct_r;
}

// Transpose of the hit point p = o + d*t and its normal chain (_side_bwd):
// ct_p and ct_n are the cotangents of the point and of the normal; returns
// the cotangent of t and adds into d_at and the ray.
__device__ __forceinline__ float side_bwd(const float* at, int kind,
                                          const Normal& nm, V3 d, float t,
                                          V3 ct_p, V3 ct_n, float* d_at,
                                          V3& ct_o, V3& ct_d) {
  const float* f = at + A_FR;
  // n = finite0(nn): the cotangent passes where the normalized value was
  // finite
  const V3 ct_nn = v3(isfinite(nm.nn.x) ? ct_n.x : 0.0f,
                      isfinite(nm.nn.y) ? ct_n.y : 0.0f,
                      isfinite(nm.nn.z) ? ct_n.z : 0.0f);
  const V3 ct_mv = norm_bwd(nm.mv, ct_nn);
  const float cm[3] = {ct_mv.x, ct_mv.y, ct_mv.z};
  const float no[3] = {nm.n_obj.x, nm.n_obj.y, nm.n_obj.z};
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int j = 0; j < 3; ++j) d_at[A_FR + 3 * k + j] += cm[k] * no[j];
  const V3 ct_nobj = matTvec(f, ct_mv);
  if (kind == kRowSphere) {
    // n_obj = hp - ip, hp = ip + M (p - ip): d/dp = M, d/dip = -M
    const float ch[3] = {ct_nobj.x, ct_nobj.y, ct_nobj.z};
    const float rl[3] = {nm.rel.x, nm.rel.y, nm.rel.z};
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int j = 0; j < 3; ++j) d_at[A_FR + 3 * k + j] += ch[k] * rl[j];
    const V3 mt_hp = matTvec(f, ct_nobj);
    ct_p = add(ct_p, mt_hp);
    d_at[A_IP + 0] -= mt_hp.x;
    d_at[A_IP + 1] -= mt_hp.y;
    d_at[A_IP + 2] -= mt_hp.z;
  } else if (kind == kRowPlane || kind == kRowTri) {
    d_at[A_NA + 0] += ct_nobj.x;
    d_at[A_NA + 1] += ct_nobj.y;
    d_at[A_NA + 2] += ct_nobj.z;
  }  // box: the object-space normal is piecewise constant
  ct_o = add(ct_o, ct_p);
  ct_d = add(ct_d, scale(ct_p, t));
  return dot(d, ct_p);
}

// One step's transpose at its chosen side: the row `at` of kind `kind`
// (with `tr`, its triangle-table row, for a triangle) hit at t_c, with
// the saved texels `tv` of that side (kTex). In: the
// step's residuals, uniforms u (stride R), pwr, the cotangents ct_o, ct_d
// of the step's output ray, ct_A of its output A, and ctB. Out: ct_o,
// ct_d, ct_A of the step's input; d_at (the chosen row's 26 columns) and
// d_gh (its triangle cotangents) accumulate, and each visible light's
// cotangent row (11 floats) goes to lacc.light(li, row) as soon as it is
// transposed, so no light's row is held past its own term.
template <bool kRefract, bool kTex, class LightAcc>
__device__ __forceinline__ void step_bwd(const float* at, const Texels& tv,
                                         int kind,
                                         const float* tr, const float* s_lt,
                                         int L, V3 o, V3 d, V3 A, float t_c,
                                         bool choose, const bool* lok,
                                         const float* u, int R, float pwr,
                                         V3 ctB, V3& ct_o, V3& ct_d, V3& ct_A,
                                         float* d_at, float* d_gh,
                                         LightAcc& lacc) {
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
#pragma unroll
    for (int li = 0; li < kMaxLights; ++li) {
      if (li >= L) break;
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
      if (lok[li]) l_col = add(l_col, contrib);
      if (!lok[li]) continue;
      float g[kLightCols] = {};
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
      const float ct_m = ct_spec * (1.0f - rgh) * 32.0f * (m16 * m8 * m4 * m2 * m);
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
      const float gl = (s_lv > 0.0f ? dot(lv, ct_ln) * invl * invl : 0.0f) * invl;
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
      lacc.light(li, g);
    }
  }
  const V3 a_f = b_emit ? v3(0.0f, 0.0f, 0.0f)
                        : v3(pwr * (0.5f + alb.x), pwr * (0.5f + alb.y),
                             pwr * (0.5f + alb.z));
  const V3 b_f = b_emit ? alb : scale(l_col, pwr);
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

}  // namespace mrt

#ifdef __CUDACC__
namespace mrt {

constexpr unsigned kFull = 0xffffffffu;

// A lane's light accumulator: its own column of the warp's (L * 11, 32)
// float64 slots in shared memory, so plain adds (no atomics, no bank
// conflicts).
struct LaneLights {
  double* s;  // the lane's slot of light column 0
  __device__ __forceinline__ void light(int li, const float* g) {
#pragma unroll
    for (int c = 0; c < kLightCols; ++c)
      if (c != 6) s[(li * kLightCols + c) * 32] += g[c];
  }
};

// Reduce-scatter of 32 values per lane over the warp: returns on lane l
// the sum over the lanes of v[l] (a butterfly that halves the values each
// round: 31 shuffles). v is overwritten.
__device__ __forceinline__ float warp_transpose_sum(float (&v)[32],
                                                    int lane) {
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1) {
    const bool upper = (lane & h) != 0;
#pragma unroll
    for (int j = 0; j < h; ++j) {
      const float send = upper ? v[j] : v[h + j];
      const float keep = upper ? v[h + j] : v[j];
      v[j] = keep + __shfl_xor_sync(kFull, send, h);
    }
  }
  return v[0];
}

// The same for the first kN of 16 values (the rest zero): the two
// half-warps added first (kN shuffles), then the butterfly over 16 lanes
// (15); lane l gets the sum of v[l % 16]. v is overwritten.
template <int kN>
__device__ __forceinline__ float warp_transpose_sum16(float (&v)[16],
                                                      int lane) {
#pragma unroll
  for (int j = 0; j < kN; ++j) v[j] += __shfl_xor_sync(kFull, v[j], 16);
#pragma unroll
  for (int h = 8; h >= 1; h >>= 1) {
    const bool upper = (lane & h) != 0;
#pragma unroll
    for (int j = 0; j < h; ++j) {
      const float send = upper ? v[j] : v[h + j];
      const float keep = upper ? v[h + j] : v[j];
      v[j] = keep + __shfl_xor_sync(kFull, send, h);
    }
  }
  return v[0];
}

// Adds each lane's row cotangents d_at (row `row`, -1 for none) into the
// (P, 26) float64 accumulator: `s_rows` in shared memory when `shared`,
// else `g_rows` in global memory. A row held by kAggShared (shared) or
// kAggGlobal (global) lanes or more is summed over the warp first and
// added once per nonzero column; the other lanes add their own nonzero
// columns. Every lane of the warp calls it.
template <int kAggShared, int kAggGlobal>
__device__ __forceinline__ void warp_rows(bool shared, double* s_rows,
                                          double* g_rows, int row,
                                          const float* d_at, int lane) {
  const int agg = shared ? kAggShared : kAggGlobal;
  const unsigned peers = __match_any_sync(kFull, row);
  const bool big = row >= 0 && __popc(peers) >= agg;
  unsigned leads = __ballot_sync(kFull, big && lane == __ffs(peers) - 1);
  while (leads) {
    const int l = __ffs(leads) - 1;
    leads &= leads - 1;
    const int r = __shfl_sync(kFull, row, l);
    float v[32];
#pragma unroll
    for (int g = 0; g < 32; ++g)
      v[g] = (g < kGradCols && row == r) ? d_at[tab_col(g)] : 0.0f;
    const float s = warp_transpose_sum(v, lane);
    if (lane < kGradCols && s != 0.0f) {
      const int e = r * kRowCols + tab_col(lane);
      if (shared)
        atomicAdd(s_rows + e, static_cast<double>(s));
      else
        atomicAdd(g_rows + e, static_cast<double>(s));
    }
  }
  if (row >= 0 && !big) {
#pragma unroll
    for (int g = 0; g < kGradCols; ++g) {
      const int c = tab_col(g);
      if (d_at[c] == 0.0f) continue;
      const int e = row * kRowCols + c;
      if (shared)
        atomicAdd(s_rows + e, static_cast<double>(d_at[c]));
      else
        atomicAdd(g_rows + e, static_cast<double>(d_at[c]));
    }
  }
}

}  // namespace mrt
#endif  // __CUDACC__
