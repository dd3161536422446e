// trace_bwd: the whole-trace backward — every live step of a ray,
// transposed in reverse order, in one launch, from the residuals that the
// train instance of trace_fwd.cu saved.
//
// Replaces: micro_raytracer_tpu/ops/pallas_step.py :: _trace_bwd_kernel
// (called by _call_trace_bwd), with its hand transposes:
// _step_comp_bwd_same + _winner_t_bwd_both when the scene refracts without
// triangles (every group is one row, so the exit winner is the entry
// winner), _step_comp_bwd with need_exit and _winner_t_bwd_math on each
// side when it refracts with triangles (a mesh group has many rows, so the
// exit side has its own row, normal and material at xrow), and the entry
// side of _step_comp_bwd + _winner_t_bwd_math when it does not refract;
// _side_bwd, _norm_bwd and _sphere_dir come with them. Only the chosen side
// of a step (entry, or exit when the refract branch was taken) gets a
// cotangent: the other side's values reach the step only through the
// discrete choice. A triangle winner's t is the Woop plane form t = -(g.o +
// h)/(g.d) with g = G[2], h = h[2] of its triangle-table row; its
// cotangents scatter per row onto a (Pt, 4) table (the kernel's dATg /
// dHTg, l.3579-3594 and 3686-3694). The one-hot MXU fetch and scatter of
// the Pallas kernel become an exact row read and per-row accumulation.
//
// One thread per ray walks its steps from the last live one (the ray's
// n_live) down to 0, carrying the cotangents of o, d and A in registers;
// the cotangent of B is the trace output's ctB at every step (B is never
// saved: it enters only additively). pwr = dk^k is recomputed. Each step
// recomputes its primal values at the selected hit (entry, or exit when the
// refract branch was chosen) from the residuals o, d, A, te, tx, the winner
// row, the saved choice and the occlusion bits — no sweep — and then
// transposes the fold, the direct light, the sampled direction, the
// material reads, the hit point and normal, and the winner t.
//
// Textures (kTex; pallas_step.py _tex_base_bwd l.2564 as used by
// _step_comp_bwd l.2837, 2865 and _step_comp_bwd_same l.2920, the saved
// texels read at l.3606-3649): the chosen side's material is the row's
// columns with the texels the train instance saved applied as constants,
// so the replay uses the mapped albedo, rough, metal, glass, opacity and
// emit the forward used. Then the albedo's cotangent is multiplied by the
// rgb texel where slot 0 is mapped, and the rough, metal and glass
// cotangents are 0 where their slot is mapped; opacity and emission feed
// only comparisons and get none. No uv, no texel fetch: the map ids of the
// chosen row are read from global memory.
//
// Cotangents of the row table (its 22 differentiable columns: frame,
// position, plane normal / box sizes / raw normal, radius, albedo, rough,
// metal, glass; valid, group id, opacity and emit get none) and of the
// light table: for the dense rows (spheres, planes, boxes) and the lights
// they accumulate per block in shared memory; each block writes its
// partial sums, and a second kernel adds the partials in block order. The
// dense rows hit are few (a room is a dozen rows), so per-ray global
// atomics would serialise on them; shared atomics serialise only within a
// block. Triangle rows (and their (Pt, 4) Woop cotangents) add with global
// atomics straight into d_tab / d_tri: a mesh's hits spread over hundreds
// of rows, so the atomics rarely meet, and a shared accumulator of every
// row would not fit beside the dense rows. Every row keeps its own
// cotangent (none is folded onto a group's first row).
//
// Run to run: d_o and d_d are per ray and bitwise repeatable. d_tab,
// d_lights and d_tri are not: the order in which a block's threads add into
// shared memory, and the order of the global atomics on triangle rows,
// vary, so those sums vary at float32 rounding level (the cross-block sum
// of the dense partials is in fixed order). The card test bounds the
// difference of two runs.
//
// What bounds it on the H100: bytes. A live step reads 4*CR bytes of
// residuals (res_rows_all) and 4*NU of uniforms and does a few hundred float ops without
// a sweep; the dense rows, the lights and their accumulators live in
// shared memory: P*(26 + 22)*4 bytes, so step.BWD_MAX_ROWS = 1024 dense
// rows (192 KB); triangle rows are read from global memory (no bound).
// Blocks of 128 threads loop over rays (grid-stride) so that the partials
// stay at most 1024 blocks deep.
//
// Numerics: float32, -fmad=false; every division and sqrt is guarded
// before the op, so that no NaN reaches a cotangent through an unselected
// branch; the linearization point is the forward's exact values (the
// residuals and the same row table).
#include "trace_step.cuh"

namespace mrt {

constexpr int kGradCols = 22;  // differentiable columns of a row
// threads per block; ops/step.py sizes the grid and the partials with it
constexpr int kBwdThreads = 128;

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
    // first axis that attains it
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
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const bool ak_e = te[k] == t_lo && !taken_e;
      taken_e = taken_e || ak_e;
      const bool ak_x = tx[k] == t_hi && !taken_x;
      taken_x = taken_x || ak_x;
      const float cae = ak_e ? ce : 0.0f;
      const float cax = ak_x ? cx : 0.0f;
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
// ct_d, ct_A of the step's input; d_at (the chosen row's 26 columns), d_gh
// (its triangle cotangents) and d_lt (the lights') accumulate.
template <bool kRefract, bool kTex>
__device__ __forceinline__ void step_bwd(const float* at, const Texels& tv,
                                         int kind,
                                         const float* tr, const float* s_lt,
                                         int L, V3 o, V3 d, V3 A, float t_c,
                                         bool choose, const bool* lok,
                                         const float* u, int R, float pwr,
                                         V3 ctB, V3& ct_o, V3& ct_d, V3& ct_A,
                                         float* d_at, float* d_gh,
                                         float* d_lt) {
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
      float* g = d_lt + li * kLightCols;
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

// One ray's whole backward. `s_tab` holds the dense rows, `g_tab` the whole
// row table. `acc` adds into the row, triangle and light accumulators:
// acc.row(row, d_at), acc.tri(local row, d_gh) and acc.light(d_lt).
template <bool kRefract, bool kTri, bool kTex, class Acc>
__device__ __forceinline__ void trace_ray_bwd(
    const float* s_tab, const float* g_tab, const Tris& T, const Layout& lay,
    const float* s_lt, int L, float dk, const Tex& tex,
    int i, int R, const float* __restrict__ resid, int n,
    const float* __restrict__ u8s, V3 ctA, V3 ctB, V3& ct_o, V3& ct_d,
    Acc& acc) {
  constexpr int NU = kRefract ? 8 : 4;
  const int CR = res_rows_all<kRefract, kTri, kTex>(L, tex.slots);
  const int side_rows = kTex ? tex_side_rows(tex.slots) : 0;
  ct_o = v3(0.0f, 0.0f, 0.0f);
  ct_d = ct_o;
  V3 ct_A = ctA;
  for (int k = n - 1; k >= 0; --k) {
    const float* r = resid + static_cast<size_t>(k) * CR * R + i;
    const V3 o = v3(r[(R_O + 0) * R], r[(R_O + 1) * R], r[(R_O + 2) * R]);
    const V3 d = v3(r[(R_D + 0) * R], r[(R_D + 1) * R], r[(R_D + 2) * R]);
    const V3 A = v3(r[(R_A + 0) * R], r[(R_A + 1) * R], r[(R_A + 2) * R]);
    const bool choose = kRefract && r[R_CHOOSE * R] > 0.5f;
    // the chosen side's row: the exit row when the refract branch was
    // taken (without triangles every group is one row, so it is the entry
    // row and no exit row is saved)
    const int row = static_cast<int>(
        r[((kTri && choose) ? res_xrow(L) : static_cast<int>(R_ROW)) * R]);
    const int kind = row_kind<kTri>(row, lay);
    const float* at = row_at<kTri>(s_tab, g_tab, row, lay);
    const float* tr =
        kind == kRowTri ? T.tab + (row - lay.tri_start) * kTriCols : nullptr;
    // the chosen side's map ids and saved texels (the exit side's rows
    // follow the entry side's)
    Texels tv{};
    if constexpr (kTex) {
#pragma unroll
      for (int s = 0; s < kMapSlots; ++s)
        tv.id[s] = __ldg(tex.maps + row * kMapSlots + s);
      read_texels(r, res_rows<kTri>(L) + (choose ? side_rows : 0), R,
                  tex.slots, tv);
    }
    bool lok[kMaxLights];
#pragma unroll
    for (int li = 0; li < kMaxLights; ++li)
      lok[li] = li < L && r[(R_LOK + li) * R] > 0.5f;
    float pwr = 1.0f;  // dk^k as the forward computed it
    for (int j = 0; j < k; ++j) pwr = pwr * dk;
    const float* u = u8s + static_cast<size_t>(k) * NU * R + i;
    float d_at[kRowCols];
#pragma unroll
    for (int c = 0; c < kRowCols; ++c) d_at[c] = 0.0f;
    float d_lt[kMaxLights * kLightCols];
#pragma unroll
    for (int c = 0; c < kMaxLights * kLightCols; ++c) d_lt[c] = 0.0f;
    float d_gh[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    step_bwd<kRefract, kTex>(at, tv, kind, tr, s_lt, L, o, d, A,
                       choose ? r[R_TX * R] : r[R_TE * R], choose, lok, u, R,
                       pwr, ctB, ct_o, ct_d, ct_A, d_at, d_gh, d_lt);
    acc.row(row, d_at);
    if (kTri && kind == kRowTri) acc.tri(row - lay.tri_start, d_gh);
    acc.light(d_lt);
  }
}

}  // namespace mrt

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

// accumulators of one block: the dense rows and the lights in shared
// memory; with kTri, triangle rows straight into the global d_tab and
// d_tri (zeroed by the wrapper)
template <bool kTri>
struct SharedAcc {
  float* rows;    // (n_dense, kGradCols)
  float* lights;  // (L, kLightCols)
  int L;
  int n_dense;
  float* g_tab;   // (P, kRowCols)
  float* g_tri;   // (Pt, 4)
  __device__ void row(int row, const float* d_at) {
    if (kTri && row >= n_dense) {
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
  __device__ void light(const float* d_lt) {
#pragma unroll
    for (int li = 0; li < mrt::kMaxLights; ++li) {
      if (li >= L) break;
#pragma unroll
      for (int c = 0; c < mrt::kLightCols; ++c)
        if (c != 6) atomicAdd(lights + li * mrt::kLightCols + c,
                              d_lt[li * mrt::kLightCols + c]);
    }
  }
};

template <bool kRefract, bool kTri, bool kTex>
__global__ void trace_bwd_kernel(const float* __restrict__ tab, int P,
                                 mrt::Layout lay,
                                 const float* __restrict__ tri,
                                 const float* __restrict__ lights, int L,
                                 float dk, mrt::Tex tex,
                                 const float* __restrict__ resid,
                                 const int* __restrict__ n_live,
                                 const float* __restrict__ u8s, int R,
                                 const float* __restrict__ ctA,
                                 const float* __restrict__ ctB,
                                 float* __restrict__ d_o,
                                 float* __restrict__ d_d,
                                 float* __restrict__ partials,
                                 float* __restrict__ d_tab,
                                 float* __restrict__ d_tri) {
  extern __shared__ float smem[];
  float* s_tab = smem;
  float* s_lt = s_tab + P * mrt::kRowCols;
  float* s_acc = s_lt + L * mrt::kLightCols;
  const int n_acc = P * mrt::kGradCols + L * mrt::kLightCols;
  mrt::stage(s_tab, tab, P, mrt::kRowCols, mrt::kRowCols);
  mrt::stage(s_lt, lights, L, mrt::kLightCols, mrt::kLightCols);
  for (int c = threadIdx.x; c < n_acc; c += blockDim.x) s_acc[c] = 0.0f;
  __syncthreads();
  SharedAcc<kTri> acc{s_acc, s_acc + P * mrt::kGradCols, L, P, d_tab, d_tri};
  const mrt::Tris T{tri, nullptr};
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < R;
       i += gridDim.x * blockDim.x) {
    mrt::V3 ct_o, ct_d;
    mrt::trace_ray_bwd<kRefract, kTri, kTex>(
        s_tab, tab, T, lay, s_lt, L, dk, tex, i, R, resid, n_live[i], u8s,
        mrt::v3(ctA[i], ctA[R + i], ctA[2 * R + i]),
        mrt::v3(ctB[i], ctB[R + i], ctB[2 * R + i]), ct_o, ct_d, acc);
    d_o[i] = ct_o.x;
    d_o[R + i] = ct_o.y;
    d_o[2 * R + i] = ct_o.z;
    d_d[i] = ct_d.x;
    d_d[R + i] = ct_d.y;
    d_d[2 * R + i] = ct_d.z;
  }
  __syncthreads();
  float* part = partials + static_cast<size_t>(blockIdx.x) * n_acc;
  for (int c = threadIdx.x; c < n_acc; c += blockDim.x) part[c] = s_acc[c];
}

// the dense rows of d_tab (P, 26) and d_lights (L, 11): the partials
// summed in block order
__global__ void reduce_kernel(const float* __restrict__ partials, int blocks,
                              int P, int L, float* __restrict__ d_tab,
                              float* __restrict__ d_lights) {
  const int n_rows = P * mrt::kRowCols;
  const int n_out = n_rows + L * mrt::kLightCols;
  const int n_acc = P * mrt::kGradCols + L * mrt::kLightCols;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_out) return;
  int src;  // accumulator index, or -1 for a column with no cotangent
  if (j < n_rows) {
    const int row = j / mrt::kRowCols, c = j % mrt::kRowCols;
    const bool none = c == mrt::C_VALID || c == mrt::C_GID ||
                      c == mrt::A_OPA || c == mrt::A_EMI;
    src = none ? -1 : row * mrt::kGradCols + mrt::grad_col(c);
  } else {
    src = P * mrt::kGradCols + (j - n_rows);
  }
  float s = 0.0f;
  if (src >= 0)
    for (int b = 0; b < blocks; ++b)
      s += partials[static_cast<size_t>(b) * n_acc + src];
  if (j < n_rows)
    d_tab[j] = s;
  else
    d_lights[j - n_rows] = s;
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
  const int* n_live;
  const float* u8s;
  int R;
  const float* ctA;
  const float* ctB;
  float* d_o;
  float* d_d;
  float* partials;
  int blocks;
  float* d_tab;
  float* d_lights;
  float* d_tri;
};

template <bool kRefract, bool kTri, bool kTex>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(a.P) * (mrt::kRowCols + mrt::kGradCols) +
       static_cast<size_t>(a.L) * 2 * mrt::kLightCols) *
      sizeof(float);
  auto kernel = trace_bwd_kernel<kRefract, kTri, kTex>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<a.blocks, mrt::kBwdThreads, smem, stream>>>(
      a.tab, a.P, a.lay, a.tri, a.lights, a.L, a.dk, a.tex, a.resid,
      a.n_live, a.u8s, a.R, a.ctA, a.ctB, a.d_o, a.d_d, a.partials, a.d_tab,
      a.d_tri);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_out = a.P * mrt::kRowCols + a.L * mrt::kLightCols;
  reduce_kernel<<<(n_out + 127) / 128, 128, 0, stream>>>(
      a.partials, a.blocks, a.P, a.L, a.d_tab, a.d_lights);
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

// P: the dense rows (tri_start); maps, atlas, tmeta and slots as in
// mrt_trace_fwd (nulls and 0 without textures); blocks: the grid size the
// wrapper sized `partials` for, (blocks, P*22 + L*11) floats; d_tab (all
// rows) and d_tri (Pt, 4) zeroed by the wrapper. The cull blocks are not
// read (the backward does not sweep).
extern "C" int mrt_trace_bwd(const float* tab, int P, int sph_start,
                             int sph_n, int pln_start, int pln_n,
                             int box_start, int box_n, const float* tri,
                             int tri_start, int tri_n, const float* bb,
                             int n_cb, const float* sbb, int n_sb,
                             const float* lights, int L, float dk,
                             const int* maps, const float* atlas,
                             const int* tmeta, int slots, const float* resid,
                             const int* n_live, const float* u8s, int R,
                             int refract, const float* ctA, const float* ctB,
                             float* d_o, float* d_d, float* partials,
                             int blocks, float* d_tab, float* d_lights,
                             float* d_tri, void* stream) {
  (void)bb;
  (void)sbb;
  const Args a{tab, P,
               mrt::Layout{sph_start, sph_n, pln_start, pln_n, box_start,
                           box_n, tri_start, tri_n, n_cb, n_sb},
               tri, lights, L, dk, mrt::Tex{maps, atlas, tmeta, slots},
               resid, n_live, u8s, R, ctA, ctB, d_o, d_d, partials, blocks,
               d_tab, d_lights, d_tri};
  return dispatch(a, refract, static_cast<cudaStream_t>(stream));
}
#endif  // __CUDACC__
