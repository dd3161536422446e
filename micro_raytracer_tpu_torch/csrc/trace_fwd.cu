// trace_fwd: the whole forward path trace — all bounce + 1 steps of a ray
// in one launch. Two instances share one step body: the render instance
// (mrt_trace_fwd, no residuals) and the train instance
// (mrt_trace_fwd_train), which also writes the residuals the backward
// kernel (trace_bwd.cu) reads and each ray's live-step count. The render
// instance also runs one segment [k0, k1) of the steps, resuming from a
// carry and writing one (tracer.trace_fused's live-first compaction,
// below), in kSeg instances of its own.
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
// Textures (kTex, textured scenes; pallas_step.py _uv_rows l.569,
// _tex_sample_rows l.652, _apply_maps_rows l.699 as used in _step_math
// l.1016-1075, and in train mode the texel residuals of _step_comp,
// _tex_res_rows_side l.1800): at the entry point and, on a refractive
// scene, at the exit point, the row's map ids are read from global memory,
// the point's uv computed, and each mapped slot's nearest texel read from
// the flat float32 atlas through the read-only cache (one 12-byte texel,
// one 32-byte sector, per fetch). The TPU kernel's channel-planar bf16
// hi/lo atlas and its one-hot MXU fetch have no counterpart: the texel is
// exact, as in the jnp sample_texture, and the sphere map's atan2 is
// atan2f. The dielectric test reads the raw metal and the mapped opacity;
// the train instance saves the texels (texel values are piecewise constant
// in every differentiable input, so the backward replays them as
// constants). A scene without textures runs the kTex = false instances.
//
// Segments (pallas_step._call_trace's c0 / cout, l.1435-1493, as
// models/tracer.py uses it, tracer.py:505-552): the render instance runs
// steps [k0, k1). With a carry c0 (14, R) — o, d, pwr, live, A, B per lane
// — it resumes there instead of from the primaries, and with cout it
// writes its carry at the end; lane i then holds ray rid[i] and reads that
// ray's uniform column, so every ray keeps its uniform stream and its
// radiance is the unsegmented trace's bit for bit. Between segments the
// caller packs live lanes first, so the next segment's warps are full and
// a block whose lanes are all dead skips staging the tables (it only
// passes its carry through). A whole trace is the segment [0, K) with no
// carry.
//
// Inputs: the (P, 26) row table and (L, 11) light table (trace_step.cuh),
// the triangle table (Pt, 16) and cull-block AABBs (n_cb, 8), the sphere
// segment's cull-block AABBs (n_sb, 8) (hit3.cuh),
// on a textured scene the map ids (P, 6), atlas (N, 3) and texture table
// (T, 3) (trace_step.cuh),
// primaries o0, d0 (3, R), their hits te0, row0, tx0, xrow0 (R,), and
// uniforms u8s (K, NU, R) with NU = 8 ([u0..u6, u_emit]) when the scene
// refracts and 4 ([u0, u1, u2, u_emit]) otherwise. Outputs: A, B (3, R)
// and first_live (R,), the pre-kill hit liveness of step 0; in train mode
// also resid (K, CR, R) (res_rows_all) and n_live (R,) int32.
//
// What bounds it on the H100: arithmetic and divergence. A ray costs 40
// bytes of primaries and hits, 4*NU bytes of uniforms per step and 28
// bytes out (train mode: 4*CR bytes of residuals per live step),
// while each step runs 1 + L sweeps over all dense rows (~65 float ops per
// row) and the triangle rows the cull leaves (~30 ops per row), plus ~300
// ops of shading; a long sphere segment's sweeps test only the blocks the
// ray enters before its best t (hit3.cuh). The design keeps the dense rows
// (P*104 bytes, at most step.MAX_ROWS = 2048 rows, 208 KB), the lights and
// the cull-block AABBs (at most hit3.MAX_TRI_BLOCKS + 32, 9 KB) in shared
// memory, reads the triangle
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

// The carry of a segmented render (pallas_step's c0 rows): o, d, pwr,
// live, A, B.
enum CarryRow { kC_O = 0, kC_D = 3, kC_PWR = 6, kC_LIVE = 7, kC_A = 8,
                kC_B = 11, kCarryRows = 14 };

// The steps [k0, k1) a launch runs, the carry it resumes from (null: the
// primaries, k0 = 0), each lane's ray (its uniform column; null: the lane)
// and the carry it writes (null: none).
struct Seg {
  int k0, k1;
  const float* c0 = nullptr;
  const int* rid = nullptr;
  float* cout = nullptr;
};

// One ray's trace over the steps of `sg` (the body of both instances;
// the train instance runs the whole trace). `s_tab` holds the dense rows,
// `g_tab` the whole row table (triangle rows are read there).
template <bool kRefract, bool kTrain, bool kTri = false, bool kTex = false>
__device__ __forceinline__ void trace_ray(
    const float* s_tab, const float* g_tab, const Tris& T, const Layout& lay,
    const float* s_lt, int L, float dk, const Tex& tex,
    int i, int R, const Seg& sg, const float* __restrict__ o0,
    const float* __restrict__ d0, Hit h0, const float* __restrict__ u8s,
    float* __restrict__ A_out, float* __restrict__ B_out,
    float* __restrict__ fl_out, float* __restrict__ resid,
    int* __restrict__ n_live) {
  constexpr int NU = kRefract ? 8 : 4;
  constexpr bool kSph = !kTri && !kTex;  // the sphere blocks (hit3.cuh)
  const int CR = res_rows_all<kRefract, kTri, kTex>(L, tex.slots);
  const int side_rows = kTex ? tex_side_rows(tex.slots) : 0;
  V3 o, d, A, B;
  float pwr;
  bool live = true;
  if (sg.c0) {
    const float* c = sg.c0 + i;
    o = v3(c[(kC_O + 0) * R], c[(kC_O + 1) * R], c[(kC_O + 2) * R]);
    d = v3(c[(kC_D + 0) * R], c[(kC_D + 1) * R], c[(kC_D + 2) * R]);
    pwr = c[kC_PWR * R];
    live = c[kC_LIVE * R] > 0.5f;
    A = v3(c[(kC_A + 0) * R], c[(kC_A + 1) * R], c[(kC_A + 2) * R]);
    B = v3(c[(kC_B + 0) * R], c[(kC_B + 1) * R], c[(kC_B + 2) * R]);
  } else {
    o = v3(o0[i], o0[R + i], o0[2 * R + i]);
    d = v3(d0[i], d0[R + i], d0[2 * R + i]);
    pwr = 1.0f;
    A = v3(1.0f, 1.0f, 1.0f);
    B = v3(0.0f, 0.0f, 0.0f);
  }
  const int col = sg.rid ? sg.rid[i] : i;
  float first_live = 0.0f;
  int n = 0;

  for (int k = sg.k0; live && k < sg.k1; ++k) {
    const float* u = u8s + static_cast<size_t>(k) * NU * R + col;
    const Hit h = k == 0 ? h0
                         : closest_hit<kRefract, kTri, kSph>(
                               s_tab, kRowCols, lay, o.x, o.y, o.z, d.x, d.y,
                               d.z, T);
    const bool hit = h.te < kBig * 0.5f;
    if (k == 0) first_live = hit ? 1.0f : 0.0f;
    if (!hit) {  // dead from here on: a = 1, b = 0 every later step
      live = false;
      break;
    }

    const float* atE = row_at<kTri>(s_tab, g_tab, h.row, lay);
    const V3 p_e = add(o, scale(d, h.te));
    float* r = kTrain ? resid + static_cast<size_t>(k) * CR * R + i : nullptr;

    // per-light occlusion from the entry point (rt.rs:1027-1046)
    bool light_ok[kMaxLights];
#pragma unroll
    for (int li = 0; li < kMaxLights; ++li) {
      if (li >= L) break;
      const V3 lv = light_vec(s_lt + li * kLightCols, p_e);
      const V3 ln = scale(lv, 1.0f / sqrtf(dot(lv, lv)));
      const V3 so = add(p_e, scale(ln, kEps));
      light_ok[li] = !any_hit<kTri, kSph>(s_tab, kRowCols, lay, so.x, so.y,
                                          so.z, ln.x, ln.y, ln.z, T);
    }

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
      const float* atX = row_at<kTri>(s_tab, g_tab, h.xrow, lay);
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
    const float emi_c = sC.col(A_EMI);

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
    if (b_emit) {  // emit kill: A == 0, nothing later contributes
      live = false;
      break;
    }
  }
  A_out[i] = A.x;
  A_out[R + i] = A.y;
  A_out[2 * R + i] = A.z;
  B_out[i] = B.x;
  B_out[R + i] = B.y;
  B_out[2 * R + i] = B.z;
  fl_out[i] = first_live;
  if constexpr (kTrain) n_live[i] = n;
  if (sg.cout) {
    float* c = sg.cout + i;
    const float v[kCarryRows] = {o.x, o.y, o.z, d.x, d.y, d.z, pwr,
                                 live ? 1.0f : 0.0f, A.x, A.y, A.z,
                                 B.x, B.y, B.z};
#pragma unroll
    for (int r = 0; r < kCarryRows; ++r) c[r * R] = v[r];
  }
}

}  // namespace mrt

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

template <bool kRefract, bool kTrain, bool kSeg, bool kTri, bool kTex>
__global__ void trace_fwd_kernel(const float* __restrict__ tab, int P,
                                 mrt::Layout lay,
                                 const float* __restrict__ tri,
                                 const float* __restrict__ bb,
                                 const float* __restrict__ sbb,
                                 const float* __restrict__ lights, int L,
                                 float dk, mrt::Tex tex,
                                 const float* __restrict__ o0,
                                 const float* __restrict__ d0,
                                 const float* __restrict__ te0,
                                 const int* __restrict__ row0,
                                 const float* __restrict__ tx0,
                                 const int* __restrict__ xrow0,
                                 const float* __restrict__ u8s, int K, int R,
                                 int k0, int k1,
                                 const float* __restrict__ c0,
                                 const int* __restrict__ rid,
                                 float* __restrict__ A_out,
                                 float* __restrict__ B_out,
                                 float* __restrict__ fl_out,
                                 float* __restrict__ cout,
                                 float* __restrict__ resid,
                                 int* __restrict__ n_live) {
  extern __shared__ float smem[];
  float* s_tab = smem;
  float* s_lt = smem + P * mrt::kRowCols;
  float* s_bb = s_lt + L * mrt::kLightCols;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // the train instance and the whole render run the whole trace (their
  // code is the unsegmented kernel's); a resumed segment's block whose
  // lanes are all dead only passes its carry through
  const mrt::Seg sg = kSeg ? mrt::Seg{k0, k1, c0, rid, cout}
                           : mrt::Seg{0, K};
  if (!sg.c0 ||
      __syncthreads_or(i < R && sg.c0[mrt::kC_LIVE * R + i] > 0.5f)) {
    mrt::stage(s_tab, tab, P, mrt::kRowCols, mrt::kRowCols);
    mrt::stage(s_lt, lights, L, mrt::kLightCols, mrt::kLightCols);
    if (kTri)
      mrt::stage(s_bb, bb, lay.n_cb, mrt::kBbCols, mrt::kBbCols);
    else if (!kTex)
      mrt::stage(s_bb, sbb, lay.n_sb, mrt::kBbCols, mrt::kBbCols);
    __syncthreads();
  }
  if (i >= R) return;
  const mrt::Hit h0 = sg.k0 == 0
                          ? mrt::Hit{te0[i], row0[i], tx0[i], xrow0[i]}
                          : mrt::Hit{};
  mrt::trace_ray<kRefract, kTrain, kTri, kTex>(
      s_tab, tab, mrt::Tris{tri, s_bb}, lay, s_lt, L, dk, tex, i, R, sg, o0,
      d0, h0, u8s, A_out, B_out, fl_out, resid, n_live);
}

// The arguments every instance takes.
struct Args {
  const float* tab;
  int P;
  mrt::Layout lay;
  const float* tri;
  const float* bb;
  const float* sbb;
  const float* lights;
  int L;
  float dk;
  mrt::Tex tex;
  const float* o0;
  const float* d0;
  const float* te0;
  const int* row0;
  const float* tx0;
  const int* xrow0;
  const float* u8s;
  int K, R;
  int k0, k1;
  const float* c0;
  const int* rid;
  float* A;
  float* B;
  float* fl;
  float* cout;
  float* resid;
  int* n_live;
};

template <bool kRefract, bool kTrain, bool kSeg, bool kTri, bool kTex>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(a.P) * mrt::kRowCols +
       static_cast<size_t>(a.L) * mrt::kLightCols +
       static_cast<size_t>(kTri ? a.lay.n_cb : kTex ? 0 : a.lay.n_sb) *
           mrt::kBbCols) *
      sizeof(float);
  auto kernel = trace_fwd_kernel<kRefract, kTrain, kSeg, kTri, kTex>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int threads = 128;
  const int blocks = (a.R + threads - 1) / threads;
  kernel<<<blocks, threads, smem, stream>>>(
      a.tab, a.P, a.lay, a.tri, a.bb, a.sbb, a.lights, a.L, a.dk, a.tex,
      a.o0, a.d0, a.te0, a.row0, a.tx0, a.xrow0, a.u8s, a.K, a.R, a.k0, a.k1,
      a.c0, a.rid, a.A, a.B, a.fl, a.cout, a.resid, a.n_live);
  return static_cast<int>(cudaGetLastError());
}

// the instance for the scene: refraction, triangles, textures; kSeg: a
// segment of a render (its own instances, so that a whole render runs the
// unsegmented code and keeps its registers)
template <bool kTrain, bool kSeg>
int dispatch(const Args& a, int refract, cudaStream_t s) {
  const bool tri = a.lay.tri_n > 0, tex = a.tex.slots != 0;
  if (refract) {
    if (tri)
      return tex ? launch<true, kTrain, kSeg, true, true>(a, s)
                 : launch<true, kTrain, kSeg, true, false>(a, s);
    return tex ? launch<true, kTrain, kSeg, false, true>(a, s)
               : launch<true, kTrain, kSeg, false, false>(a, s);
  }
  if (tri)
    return tex ? launch<false, kTrain, kSeg, true, true>(a, s)
               : launch<false, kTrain, kSeg, true, false>(a, s);
  return tex ? launch<false, kTrain, kSeg, false, true>(a, s)
             : launch<false, kTrain, kSeg, false, false>(a, s);
}

}  // namespace

// P: the dense rows (tri_start), staged in shared memory; tri: the (Pt, 16)
// triangle table, or null with tri_n = 0; bb: the (n_cb, 8) block AABBs,
// or null with n_cb = 0; sbb: the sphere segment's (n_sb, 8) block AABBs,
// or null with n_sb = 0; maps (P, 6), atlas (N, 3), tmeta (T, 3) and the
// slot mask `slots` of a textured scene, or nulls and slots = 0. The render
// instance runs steps [k0, k1) of the K in u8s; c0 / rid / cout: the carry
// in, the lanes' rays and the carry out of a segment, or nulls (te0..xrow0
// are read only when k0 = 0).
extern "C" int mrt_trace_fwd(const float* tab, int P, int sph_start,
                             int sph_n, int pln_start, int pln_n,
                             int box_start, int box_n, const float* tri,
                             int tri_start, int tri_n, const float* bb,
                             int n_cb, const float* sbb, int n_sb,
                             const float* lights, int L, float dk,
                             const int* maps, const float* atlas,
                             const int* tmeta, int slots, const float* o0,
                             const float* d0, const float* te0,
                             const int* row0, const float* tx0,
                             const int* xrow0, const float* u8s, int K, int R,
                             int refract, int k0, int k1, const float* c0,
                             const int* rid, float* A, float* B, float* fl,
                             float* cout, void* stream) {
  const Args a{tab, P,
               mrt::Layout{sph_start, sph_n, pln_start, pln_n, box_start,
                           box_n, tri_start, tri_n, n_cb, n_sb},
               tri, bb, sbb, lights, L, dk,
               mrt::Tex{maps, atlas, tmeta, slots}, o0, d0, te0, row0, tx0,
               xrow0, u8s, K, R, k0, k1, c0, rid, A, B, fl, cout, nullptr,
               nullptr};
  const bool seg = k0 != 0 || k1 != K || c0 || rid || cout;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return seg ? dispatch<false, true>(a, refract, s)
             : dispatch<false, false>(a, refract, s);
}

extern "C" int mrt_trace_fwd_train(
    const float* tab, int P, int sph_start, int sph_n, int pln_start,
    int pln_n, int box_start, int box_n, const float* tri, int tri_start,
    int tri_n, const float* bb, int n_cb, const float* sbb, int n_sb,
    const float* lights, int L, float dk, const int* maps,
    const float* atlas, const int* tmeta, int slots, const float* o0,
    const float* d0, const float* te0, const int* row0, const float* tx0,
    const int* xrow0, const float* u8s, int K, int R, int refract, float* A,
    float* B, float* fl, float* resid, int* n_live, void* stream) {
  const Args a{tab, P,
               mrt::Layout{sph_start, sph_n, pln_start, pln_n, box_start,
                           box_n, tri_start, tri_n, n_cb, n_sb},
               tri, bb, sbb, lights, L, dk,
               mrt::Tex{maps, atlas, tmeta, slots}, o0, d0, te0, row0, tx0,
               xrow0, u8s, K, R, 0, K, nullptr, nullptr, A, B, fl, nullptr,
               resid, n_live};
  return dispatch<true, false>(a, refract,
                              static_cast<cudaStream_t>(stream));
}
#endif  // __CUDACC__
