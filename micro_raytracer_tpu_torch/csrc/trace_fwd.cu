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
// uniforms and writes the residuals coalesced (rays on the fastest axis).
// The dense-row whole traces (no triangles, no textures, not a segment:
// the room's and the Instance class's renders and train instances) run
// their steps through ray_step, which computes the exit side of a
// refractive step (its row, point, normal, jittered normal and
// refraction) only where the draw can choose it, u6 < min(1 - opacity,
// 0.85): in the room, on the glass sphere. Their renders, and their train
// instances where the sphere segment has cull blocks (ops/step.py
// refills), refill lanes: blocks persist, and a lane whose ray ended
// takes the next ray index from a global counter (one atomic per warp for
// all its free lanes), so a warp runs one step of up to 32 rays at a time
// until the counter passes R; the last block to finish zeroes the counter
// for the next launch. Outputs and residuals are stored per ray, so they
// are the same whichever lane ran the ray. On the room's frame a warp of
// the one-ray-per-thread schedule ran 1.46x the lane-steps its rays need,
// on inst_grid's 2.40x; the room's train instance refilled was slower
// (its lanes' residual stores scatter), so it runs one ray per thread
// (tools/torch_compare_trees.py ablate). The mesh, textured and segment
// instances run trace_ray, one ray per thread, and let a warp's threads
// drop out of the step loop independently, so a warp with one long path
// runs at the pace of that path (sharing ray_step had cost their train
// instances 1-2.3%). Staging a 960-triangle mesh's row and triangle
// tables per block (~100 KB) would leave one or two blocks per SM and copy
// them from L2 ~9,100 times per 1080x1080 launch; the triangle rows a warp
// tests together are one L1 broadcast instead. A scene without triangles runs
// the kTri = false instances: the code of the dense-only kernel.
//
// A scene without triangles or textures whose sphere segment has cull
// blocks (the Instance class) runs the kWalk instances (render, segment and
// train): staging its row table (104 B a row, 105 KB for the 1,000-sphere
// grid) left 2 blocks, 8 warps, per SM. They stage the sphere segment's
// 8-row sub-blocks' and 64-row blocks' AABBs, each lane's column of block
// entry t, the lights and the planes' and boxes' sweep rows, and walk the
// spheres through sph_walk.cuh (nearest first from inside the grid, the
// packed rows srows read with 16-byte loads through the read-only cache;
// on a refractive scene the exit is the winner row's own t1); the winners'
// attributes come from the global row table. Their hits are those of the
// lowest-first walk of whole 64-row blocks (hit3.cuh, and the plain culled
// sweep), so their outputs are that design's bit for bit
// (tools/torch_compare_trees.py compare) and the per-step path's.
//
// A textured scene without triangles whose box segment holds at least
// hit3.BOX_CULL_MIN valid boxes (hit3.box_culled, the Minecraft class)
// runs the kBox instances (render, segment and train): every one of its
// sweeps tested all the box rows, 98% of its bound (on an H100 a flat
// per-box cull took 40% off: tools/torch_compare_trees.py ablate ...
// tex). They stage the box walk's node and leaf AABBs and packed rows
// (box_walk.cuh; 18 KB for 256 boxes), each lane's column of node and
// leaf entry t, the sweep rows before the box segment and the lights,
// walk the boxes nearest first, and take a refractive step's exit from
// the winner's own entry test (the group scan over every row cost 5-7%);
// the winners' attributes come from the global row table. Their whole
// render always refills lanes through ray_step (textured: each side's
// texels applied as trace_ray applies them, the exit side's only where
// the draw can choose it): a warp of one ray per thread ran 2.42x the
// lane-steps its rays need (tools/torch_compare_trees.py ablate ... tex),
// and on an H100 the render went from 0.178 to 0.128 of the dense
// instance's time (chip_smoke.py --gate before and after the refill);
// the train instance keeps trace_ray, which saves both sides' texels at
// every hit. The walk gives the dense sweep's t and row,
// so their outputs are the dense instances' bit for bit.
//
// Numerics: float32 throughout; 1/sqrt as 1.0f/sqrtf, sincosf at full
// precision, -fmad=false (see hit3.cuh). The train instance's A, B and
// first_live equal the render instance's bit for bit: the residual stores
// are the only difference.
#include "trace_step.cuh"
#include "sph_walk.cuh"
#include "box_walk.cuh"

namespace mrt {

// The steps [k0, k1) a launch runs, the carry it resumes from (null: the
// primaries, k0 = 0), each lane's ray (its uniform column; null: the lane)
// and the carry it writes (null: none).
struct Seg {
  int k0, k1;
  const float* c0 = nullptr;
  const int* rid = nullptr;
  float* cout = nullptr;
};

// The closest hit and the occlusion of a step: hit3.cuh's sweeps over the
// dense rows `s_tab` (and with kTri the triangle segment), or with kWalk (a
// culled sphere segment, no triangles or textures) sph_walk.cuh's walks
// of W, or with kBox (a walked box segment, textured, no triangles)
// box_walk.cuh's walks of B.
template <bool kRefract, bool kTri, bool kSph, bool kWalk, bool kBox = false>
__device__ __forceinline__ Hit sweep_hit(const float* s_tab, const Tris& T,
                                         const Layout& lay,
                                         const SphWalk& W, const V3& o,
                                         const V3& d,
                                         const BoxWalk& B = BoxWalk{}) {
  if constexpr (kBox)
    return box_closest_hit<kRefract>(lay, B, o.x, o.y, o.z, d.x, d.y, d.z);
  else if constexpr (kWalk)
    return walk_closest_hit<kRefract>(lay, W, o.x, o.y, o.z, d.x, d.y, d.z);
  else
    return closest_hit<kRefract, kTri, kSph>(s_tab, kRowCols, lay, o.x, o.y,
                                             o.z, d.x, d.y, d.z, T);
}

template <bool kTri, bool kSph, bool kWalk, bool kBox = false>
__device__ __forceinline__ bool sweep_any(const float* s_tab, const Tris& T,
                                          const Layout& lay,
                                          const SphWalk& W, const V3& o,
                                          const V3& d,
                                          const BoxWalk& B = BoxWalk{}) {
  if constexpr (kBox)
    return box_any_hit(lay, B, o.x, o.y, o.z, d.x, d.y, d.z);
  else if constexpr (kWalk)
    return walk_any_hit(lay, W, o.x, o.y, o.z, d.x, d.y, d.z);
  else
    return any_hit<kTri, kSph>(s_tab, kRowCols, lay, o.x, o.y, o.z, d.x,
                               d.y, d.z, T);
}

// One ray's trace over the steps of `sg` (the body of both instances;
// the train instance runs the whole trace). `s_tab` holds the dense rows,
// `g_tab` the whole row table (triangle rows are read there); kWalk (a
// culled sphere segment, no triangles or textures) or kBox (a walked box
// segment, textured, no triangles): the sweeps walk W or B and `s_tab` is
// the global row table.
template <bool kRefract, bool kTrain, bool kTri = false, bool kTex = false,
          bool kWalk = false, bool kBox = false>
__device__ __forceinline__ void trace_ray(
    const float* s_tab, const float* g_tab, const Tris& T, const Layout& lay,
    const float* s_lt, int L, float dk, const Tex& tex,
    int i, int R, const Seg& sg, const float* __restrict__ o0,
    const float* __restrict__ d0, Hit h0, const float* __restrict__ u8s,
    float* __restrict__ A_out, float* __restrict__ B_out,
    float* __restrict__ fl_out, float* __restrict__ resid,
    int* __restrict__ n_live, const SphWalk& W = SphWalk{},
    const BoxWalk& BW = BoxWalk{}) {
  constexpr int NU = kRefract ? 8 : 4;
  constexpr bool kSph = !kTri && !kTex;  // the sphere blocks (hit3.cuh)
  static_assert(kSph || !kWalk, "only scenes without triangles or "
                                "textures walk a culled sphere segment");
  static_assert(!kBox || (kTex && !kTri), "only textured scenes without "
                                          "triangles walk a box segment");
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
                         : sweep_hit<kRefract, kTri, kSph, kWalk, kBox>(
                               s_tab, T, lay, W, o, d, BW);
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
      light_ok[li] =
          !sweep_any<kTri, kSph, kWalk, kBox>(s_tab, T, lay, W, so, ln, BW);
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

// A ray's carry between steps: its ray, throughput A, radiance B and
// pwr = dk^k.
struct Carry {
  V3 o, d, A, B;
  float pwr;
};

// Step k of ray i on a dense-row scene (no triangles, no textures): the
// body of trace_ray's loop for one step, with the exit side computed only
// where the draw can choose it (the outcome is the same).
// Advances the carry `c`; `h0` is the primary hit (read at k = 0 only).
// Sets first_live at k = 0 and, in train mode, writes the step's
// residuals and n = k + 1. Returns whether the ray lives on: false when it
// missed (the carry unchanged) or its emit draw ended the path. kWalk: the
// sweeps walk the culled sphere segment of W (sph_walk.cuh), and `s_tab`
// is the global row table (the winners' attributes are read there). kTex
// and kBox (a textured scene whose box segment is walked, BW; render mode
// only: the train instance saves the exit side's texels at every hit): the
// sides' texels `tex` applied as trace_ray applies them.
template <bool kRefract, bool kTrain, bool kWalk = false, bool kTex = false,
          bool kBox = false>
__device__ __forceinline__ bool ray_step(
    const float* s_tab, const Tris& T, const Layout& lay, const float* s_lt,
    int L, float dk, int i, int R, int k, const Hit& h0,
    const float* __restrict__ u8s, Carry& c, float& first_live,
    float* __restrict__ resid, int& n, const SphWalk& W = SphWalk{},
    const Tex& tex = Tex{}, const BoxWalk& BW = BoxWalk{}) {
  static_assert(!kTex || (kBox && !kTrain), "a textured step: the box "
                                            "walk's render instance");
  constexpr int NU = kRefract ? 8 : 4;
  const int CR = res_rows_all<kRefract, false, false>(L, 0);
  const float* u = u8s + static_cast<size_t>(k) * NU * R + i;
  const Hit h =
      k == 0 ? h0
             : sweep_hit<kRefract, false, !kTex, kWalk, kBox>(
                   s_tab, T, lay, W, c.o, c.d, BW);
  const bool hit = h.te < kBig * 0.5f;
  if (k == 0) first_live = hit ? 1.0f : 0.0f;
  if (!hit) return false;  // dead from here on: a = 1, b = 0 every later step

  const float* atE = s_tab + h.row * kRowCols;
  const V3 p_e = add(c.o, scale(c.d, h.te));
  float* r = kTrain ? resid + static_cast<size_t>(k) * CR * R + i : nullptr;

  // per-light occlusion from the entry point (rt.rs:1027-1046)
  bool light_ok[kMaxLights];
#pragma unroll
  for (int li = 0; li < kMaxLights; ++li) {
    if (li >= L) break;
    const V3 lv = light_vec(s_lt + li * kLightCols, p_e);
    const V3 ln = scale(lv, 1.0f / sqrtf(dot(lv, lv)));
    const V3 so = add(p_e, scale(ln, kEps));
    light_ok[li] =
        !sweep_any<false, !kTex, kWalk, kBox>(s_tab, T, lay, W, so, ln, BW);
  }

  const int kind_e = row_kind<false>(h.row, lay);
  const V3 n_e = normal_full(atE, p_e, kind_e).n;
  Texels tE{};
  if constexpr (kTex) side_texels(tex, h.row, atE, p_e, kind_e, tE);
  const Side<kTex> sE(atE, tE);
  const float opa_e = sE.col(A_OPA);

  // reflect from the entry hit (rt.rs:559-572)
  const float rough_r = rough_override(sE, u[0]) ? 1.0f : sE.col(A_RGH);
  const V3 nr = sphere_rand(n_e, rough_r, u[R], u[2 * R]);
  const V3 refl = safe_norm(sub(c.d, scale(nr, 2.0f * dot(c.d, nr))));

  V3 next_dir = refl, from_p = p_e, norm_c = n_e;
  Side<kTex> sC = sE;  // the chosen side's material
  bool choose = false;
  if (kRefract && u[6 * R] < fminf(1.0f - opa_e, 0.85f)) {
    // refract from the exit hit (rt.rs:574-589, 1054-1058), only where
    // the draw can choose it
    const float* atX = s_tab + h.xrow * kRowCols;
    const V3 p_x = add(c.o, scale(c.d, h.tx));
    const int kind_x = row_kind<false>(h.xrow, lay);
    const V3 n_x = normal_full(atX, p_x, kind_x).n;
    Texels tX{};
    if constexpr (kTex) side_texels(tex, h.xrow, atX, p_x, kind_x, tX);
    const Side<kTex> sX(atX, tX);
    const float rough_f =
        rough_override(sX, u[3 * R]) ? 1.0f : sX.col(A_RGH);
    const V3 nf = sphere_rand(n_x, rough_f, u[4 * R], u[5 * R]);
    const float eta = 1.0f + 0.5f * sX.col(A_GLS);
    const float cs = -dot(nf, c.d);
    const float kk = 1.0f - eta * eta * (1.0f - cs * cs);
    const bool refr_ok = kk >= 0.0f;
    const float k_safe = refr_ok ? fmaxf(kk, 1e-12f) : 1.0f;
    const V3 refr = finite0(safe_norm(
        add(scale(c.d, eta), scale(nf, cs * eta + sqrtf(k_safe)))));
    choose = refr_ok;
    if (choose) {
      next_dir = refr;
      from_p = p_x;
      norm_c = n_x;
      sC = sX;
    }
  }
  const float u_emit = u[kRefract ? 7 * R : 3 * R];
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
    const float spec = pow32(fmaxf(dot(c.d, lrefl), 0.0f)) * (1.0f - rgh_c);
    const V3 o_col = scale(alb_c, 1.0f - met_c);
    const float pl = lt[7];
    const V3 contrib = v3((o_col.x * diff * lt[8] + spec) * pl,
                          (o_col.y * diff * lt[9] + spec) * pl,
                          (o_col.z * diff * lt[10] + spec) * pl);
    if (light_ok[li]) l_col = add(l_col, contrib);
  }

  if constexpr (kTrain) {
    r[(R_O + 0) * R] = c.o.x;
    r[(R_O + 1) * R] = c.o.y;
    r[(R_O + 2) * R] = c.o.z;
    r[(R_D + 0) * R] = c.d.x;
    r[(R_D + 1) * R] = c.d.y;
    r[(R_D + 2) * R] = c.d.z;
    r[(R_A + 0) * R] = c.A.x;
    r[(R_A + 1) * R] = c.A.y;
    r[(R_A + 2) * R] = c.A.z;
    r[R_TE * R] = h.te;
    r[R_TX * R] = h.tx;
    r[R_ROW * R] = static_cast<float>(h.row);
    r[R_CHOOSE * R] = choose ? 1.0f : 0.0f;
#pragma unroll
    for (int li = 0; li < kMaxLights; ++li) {
      if (li >= L) break;
      r[(R_LOK + li) * R] = light_ok[li] ? 1.0f : 0.0f;
    }
    n = k + 1;
  }

  // fold update (rt.rs:966-992 composed forward)
  const bool b_emit = u_emit < emi_c;
  const V3 a_f = b_emit ? v3(0.0f, 0.0f, 0.0f)
                        : v3(c.pwr * (0.5f + alb_c.x),
                             c.pwr * (0.5f + alb_c.y),
                             c.pwr * (0.5f + alb_c.z));
  const V3 b_f = b_emit ? alb_c : scale(l_col, c.pwr);
  c.B = add(c.B, mul(c.A, b_f));
  c.A = mul(c.A, a_f);

  c.o = add(from_p, scale(next_dir, kEps));  // Ray::cast
  c.d = next_dir;
  c.pwr = c.pwr * dk;
  // emit kill: A == 0, nothing later contributes
  return !b_emit;
}

}  // namespace mrt

#ifdef __CUDACC__
#include <cuda_runtime.h>

#include <algorithm>

#include "grid.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;  // threads per block

// ray i's outputs: A, B, first_live and (kTrain) its live-step count
template <bool kTrain>
__device__ __forceinline__ void store_ray(int i, int R, const mrt::Carry& c,
                                          float first_live, int n,
                                          float* __restrict__ A_out,
                                          float* __restrict__ B_out,
                                          float* __restrict__ fl_out,
                                          int* __restrict__ n_live) {
  A_out[i] = c.A.x;
  A_out[R + i] = c.A.y;
  A_out[2 * R + i] = c.A.z;
  B_out[i] = c.B.x;
  B_out[R + i] = c.B.y;
  B_out[2 * R + i] = c.B.z;
  fl_out[i] = first_live;
  if constexpr (kTrain) n_live[i] = n;
}

// ray i's carry at its primary: o, d, A = 1, B = 0, pwr = 1
__device__ __forceinline__ mrt::Carry primary(int i, int R,
                                              const float* __restrict__ o0,
                                              const float* __restrict__ d0) {
  mrt::Carry c;
  c.o = mrt::v3(o0[i], o0[R + i], o0[2 * R + i]);
  c.d = mrt::v3(d0[i], d0[R + i], d0[2 * R + i]);
  c.A = mrt::v3(1.0f, 1.0f, 1.0f);
  c.B = mrt::v3(0.0f, 0.0f, 0.0f);
  c.pwr = 1.0f;
  return c;
}

// kDense: a dense-row whole trace (ray_step); kRefill: its lanes refill
// from next[0], next[1] counting the blocks that finished (module comment);
// kWalk: a scene without triangles or textures whose sphere segment has
// cull blocks, walked through sph_walk.cuh; kBox: a textured scene without
// triangles whose box segment is walked through box_walk.cuh (module
// comment)
template <bool kRefract, bool kTrain, bool kSeg, bool kTri, bool kTex,
          bool kRefill, bool kWalk, bool kBox>
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
                                 int* __restrict__ n_live,
                                 int* __restrict__ next,
                                 const float* __restrict__ srows,
                                 const float* __restrict__ ssb,
                                 const float* __restrict__ bw, int n_bw) {
  constexpr bool kDense = !kSeg && !kTri && !kTex;
  static_assert(kDense || (kBox && !kSeg && !kTrain) || !kRefill,
                "only dense-row whole traces and the box walk's whole "
                "render refill");
  static_assert(!kWalk || (!kTri && !kTex), "kWalk: spheres, planes, boxes");
  static_assert(!kBox || (kTex && !kTri && !kWalk), "kBox: textured, no "
                                                    "triangles");
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
  mrt::SphWalk W{};
  mrt::BoxWalk BW{};
  if constexpr (kWalk) {
    // the sphere sub-blocks' and blocks' AABBs, the AABB of all the blocks,
    // the lanes' columns of block entry t, the lights and the planes' and
    // boxes' sweep rows in shared memory (smem_bytes); the sphere rows are
    // read from srows, the winners' attributes from the global table
    const int ns = (lay.sph_n + mrt::kSubRows - 1) / mrt::kSubRows;
    float* s_sub = smem;
    s_bb = s_sub + ns * mrt::kBbCols;
    float* s_seg = s_bb + lay.n_sb * mrt::kBbCols;
    float* s_tb = s_seg + mrt::kBbCols;
    s_lt = s_tb + lay.n_sb * kThreads;
    float* s_pb = s_lt + L * mrt::kLightCols;
    if (!sg.c0 ||
        __syncthreads_or(i < R && sg.c0[mrt::kC_LIVE * R + i] > 0.5f)) {
      mrt::stage(s_sub, ssb, ns, mrt::kBbCols, mrt::kBbCols);
      mrt::stage(s_bb, sbb, lay.n_sb, mrt::kBbCols, mrt::kBbCols);
      mrt::stage(s_lt, lights, L, mrt::kLightCols, mrt::kLightCols);
      mrt::stage(s_pb, tab + lay.pln_start * mrt::kRowCols,
                 P - lay.pln_start, mrt::kRowCols, mrt::kSweepCols);
      __syncthreads();
      mrt::chunk_bounds(s_bb, lay.n_sb, s_seg, threadIdx.x, 6);
      __syncthreads();
    }
    W = mrt::SphWalk{mrt::SphPack{srows, s_sub, s_seg}, s_bb,
                     s_tb + threadIdx.x, kThreads,
                     s_pb - lay.pln_start * mrt::kSweepCols};
  } else if constexpr (kBox) {
    // the box walk's tables (its rows where they fit), the lanes' columns
    // of entry t, the sweep rows before the box segment and the lights in
    // shared memory (smem_bytes); the winners' attributes come from the
    // global table
    const int nt = mrt::box_nodes(n_bw) + mrt::kBoxFan;
    float* s_tb = smem + mrt::box_staged_floats(n_bw);
    float* s_pb = s_tb + nt * kThreads;
    s_lt = s_pb + lay.box_start * mrt::kSweepCols;
    const float* rows_at = mrt::box_rows_at(smem, bw, n_bw);
    if (!sg.c0 ||
        __syncthreads_or(i < R && sg.c0[mrt::kC_LIVE * R + i] > 0.5f)) {
      mrt::box_stage(smem, bw, n_bw);
      mrt::stage(s_pb, tab, lay.box_start, mrt::kRowCols, mrt::kSweepCols);
      mrt::stage(s_lt, lights, L, mrt::kLightCols, mrt::kLightCols);
      __syncthreads();
    }
    BW = mrt::BoxWalk{smem, rows_at, s_tb + threadIdx.x, kThreads, s_pb,
                      n_bw};
  } else if (!sg.c0 ||
             __syncthreads_or(i < R && sg.c0[mrt::kC_LIVE * R + i] > 0.5f)) {
    mrt::stage(s_tab, tab, P, mrt::kRowCols, mrt::kRowCols);
    mrt::stage(s_lt, lights, L, mrt::kLightCols, mrt::kLightCols);
    if (kTri)
      mrt::stage(s_bb, bb, lay.n_cb, mrt::kBbCols, mrt::kBbCols);
    else if (!kTex)
      mrt::stage(s_bb, sbb, lay.n_sb, mrt::kBbCols, mrt::kBbCols);
    __syncthreads();
  }
  // the rows the steps sweep and fetch: the staged dense rows, or the
  // global table where the walk reads its own
  const float* rows = kWalk || kBox ? tab : s_tab;
  const mrt::Tris T{tri, s_bb};
  if constexpr (kRefill) {
    // Persistent lanes: each holds one ray at a time and runs it one step
    // per pass; a lane whose ray ended writes it out, and the warp's free
    // lanes take the next ray indices from *next together (one atomic
    // per warp, consecutive rays in lane order).
    const int lane = threadIdx.x & 31;
    int ray = 0, k = 0, n = 0;
    bool live = false, done = false;
    float first_live = 0.0f;
    mrt::Carry c;
    mrt::Hit h0{};
    while (true) {
      const unsigned want = __ballot_sync(kFull, !live && !done);
      if (want) {
        const int first = __ffs(want) - 1;
        int base = 0;
        if (lane == first) base = atomicAdd(next, __popc(want));
        base = __shfl_sync(kFull, base, first);
        if (!live && !done) {
          ray = base + __popc(want & ((1u << lane) - 1u));
          if (ray < R) {
            c = primary(ray, R, o0, d0);
            h0 = mrt::Hit{te0[ray], row0[ray], tx0[ray], xrow0[ray]};
            k = 0;
            n = 0;
            first_live = 0.0f;
            live = true;
          } else {
            done = true;
          }
        }
      }
      if (__all_sync(kFull, done)) break;
      if (!live) continue;
      live = mrt::ray_step<kRefract, kTrain, kWalk, kTex, kBox>(
          rows, T, lay, s_lt, L, dk, ray, R, k, h0, u8s, c, first_live,
          resid, n, W, tex, BW);
      if (++k == K) live = false;
      if (!live)
        store_ray<kTrain>(ray, R, c, first_live, n, A_out, B_out, fl_out,
                          n_live);
    }
    // the last block to finish zeroes the counters for the next launch
    // (every block's atomics on next[0] have returned by then)
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      if (atomicAdd(next + 1, 1) == static_cast<int>(gridDim.x) - 1) {
        next[0] = 0;
        next[1] = 0;
      }
    }
  } else if constexpr (kDense) {
    if (i >= R) return;
    mrt::Carry c = primary(i, R, o0, d0);
    const mrt::Hit h0{te0[i], row0[i], tx0[i], xrow0[i]};
    float first_live = 0.0f;
    int n = 0;
    for (int k = 0; k < K; ++k)
      if (!mrt::ray_step<kRefract, kTrain, kWalk>(rows, T, lay, s_lt, L, dk,
                                                  i, R, k, h0, u8s, c,
                                                  first_live, resid, n, W))
        break;
    store_ray<kTrain>(i, R, c, first_live, n, A_out, B_out, fl_out, n_live);
  } else {
    if (i >= R) return;
    const mrt::Hit h0 = sg.k0 == 0
                            ? mrt::Hit{te0[i], row0[i], tx0[i], xrow0[i]}
                            : mrt::Hit{};
    mrt::trace_ray<kRefract, kTrain, kTri, kTex, kWalk, kBox>(
        rows, tab, T, lay, s_lt, L, dk, tex, i, R, sg, o0, d0, h0, u8s,
        A_out, B_out, fl_out, resid, n_live, W, BW);
  }
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
  int* next;  // the refill counters, zeroed, or null: no refill
  // a culled sphere segment's packed rows and sub-block AABBs
  // (hit3.sph_walk_tables), or nulls
  const float* srows;
  const float* ssb;
  // a walked box segment's tables (hit3.box_walk_tables) and its boxes,
  // or null and 0
  const float* bw;
  int n_bw;
};

template <bool kSeg, bool kTri, bool kTex, bool kWalk, bool kBox>
size_t smem_bytes(const Args& a) {
  if constexpr (kBox) {
    return (static_cast<size_t>(mrt::box_smem_floats(a.n_bw, kThreads)) +
            static_cast<size_t>(a.lay.box_start) * mrt::kSweepCols +
            static_cast<size_t>(a.L) * mrt::kLightCols) *
           sizeof(float);
  }
  if constexpr (kWalk) {
    const int ns = (a.lay.sph_n + mrt::kSubRows - 1) / mrt::kSubRows;
    return (static_cast<size_t>(ns + a.lay.n_sb + 1) * mrt::kBbCols +
            static_cast<size_t>(a.lay.n_sb) * kThreads +
            static_cast<size_t>(a.L) * mrt::kLightCols +
            static_cast<size_t>(a.P - a.lay.pln_start) * mrt::kSweepCols) *
           sizeof(float);
  }
  return (static_cast<size_t>(a.P) * mrt::kRowCols +
          static_cast<size_t>(a.L) * mrt::kLightCols +
          static_cast<size_t>(kTri ? a.lay.n_cb : kTex ? 0 : a.lay.n_sb) *
              mrt::kBbCols) *
         sizeof(float);
}

// the launch of one instance: a block per 128 rays, or, refilling, as
// many blocks as the card keeps resident (grid.cuh)
struct Launch {
  cudaStream_t stream;
  template <bool kRefract, bool kTrain, bool kSeg, bool kTri, bool kTex,
            bool kRefill, bool kWalk, bool kBox>
  int run(const Args& a) const {
    const size_t smem = smem_bytes<kSeg, kTri, kTex, kWalk, kBox>(a);
    auto kernel = trace_fwd_kernel<kRefract, kTrain, kSeg, kTri, kTex,
                                   kRefill, kWalk, kBox>;
    int per_sm = 0, sms = 0;
    const int e = mrt::resident_blocks(kernel, kThreads, smem, &per_sm, &sms);
    if (e) return e;
    int blocks = (a.R + kThreads - 1) / kThreads;
    if (kRefill) blocks = std::max(1, std::min(blocks, sms * per_sm));
    kernel<<<blocks, kThreads, smem, stream>>>(
        a.tab, a.P, a.lay, a.tri, a.bb, a.sbb, a.lights, a.L, a.dk, a.tex,
        a.o0, a.d0, a.te0, a.row0, a.tx0, a.xrow0, a.u8s, a.K, a.R, a.k0,
        a.k1, a.c0, a.rid, a.A, a.B, a.fl, a.cout, a.resid, a.n_live, a.next,
        a.srows, a.ssb, a.bw, a.n_bw);
    return static_cast<int>(cudaGetLastError());
  }
};

// resident blocks per SM of one instance
struct Occupancy {
  int* per_sm;
  template <bool kRefract, bool kTrain, bool kSeg, bool kTri, bool kTex,
            bool kRefill, bool kWalk, bool kBox>
  int run(const Args& a) const {
    return mrt::resident_blocks(
        trace_fwd_kernel<kRefract, kTrain, kSeg, kTri, kTex, kRefill, kWalk,
                         kBox>,
        kThreads, smem_bytes<kSeg, kTri, kTex, kWalk, kBox>(a), per_sm);
  }
};

// the refill choice: a dense-row whole trace's render always refills (it
// needs the counter), its train instance where it is given one; the
// other instances never do. The walk: a scene without triangles or
// textures whose sphere segment has cull blocks (its whole traces
// refill); the box walk: a textured scene without triangles whose box
// segment has walk tables (its whole render always refills)
template <bool kRefract, bool kTrain, bool kSeg, bool kTri, bool kTex,
          class Op>
int pick(const Args& a, const Op& op) {
  const bool walk = a.lay.n_sb > 0;
  if constexpr (!kSeg && !kTri && !kTex) {
    if (a.next)
      return walk ? op.template run<kRefract, kTrain, kSeg, kTri, kTex, true,
                                    true, false>(a)
                  : op.template run<kRefract, kTrain, kSeg, kTri, kTex, true,
                                    false, false>(a);
    if constexpr (kTrain)
      if (!walk)
        return op.template run<kRefract, kTrain, kSeg, kTri, kTex, false,
                               false, false>(a);
    return static_cast<int>(cudaErrorInvalidValue);
  } else if constexpr (!kTri && !kTex) {
    return walk ? op.template run<kRefract, kTrain, kSeg, kTri, kTex, false,
                                  true, false>(a)
                : op.template run<kRefract, kTrain, kSeg, kTri, kTex, false,
                                  false, false>(a);
  } else if constexpr (kTex && !kTri) {
    if (a.n_bw == 0)
      return op.template run<kRefract, kTrain, kSeg, kTri, kTex, false, false,
                             false>(a);
    if constexpr (!kSeg && !kTrain)
      return a.next ? op.template run<kRefract, kTrain, kSeg, kTri, kTex,
                                      true, false, true>(a)
                    : static_cast<int>(cudaErrorInvalidValue);
    else
      return op.template run<kRefract, kTrain, kSeg, kTri, kTex, false,
                             false, true>(a);
  } else {
    return op.template run<kRefract, kTrain, kSeg, kTri, kTex, false, false,
                           false>(a);
  }
}

// the instance for the scene: refraction, triangles, textures; kSeg: a
// segment of a render (its own instances, so that a whole render runs the
// unsegmented code and keeps its registers)
template <bool kTrain, bool kSeg, class Op>
int dispatch(const Args& a, int refract, const Op& op) {
  const bool tri = a.lay.tri_n > 0, tex = a.tex.slots != 0;
  if (refract) {
    if (tri)
      return tex ? pick<true, kTrain, kSeg, true, true>(a, op)
                 : pick<true, kTrain, kSeg, true, false>(a, op);
    return tex ? pick<true, kTrain, kSeg, false, true>(a, op)
               : pick<true, kTrain, kSeg, false, false>(a, op);
  }
  if (tri)
    return tex ? pick<false, kTrain, kSeg, true, true>(a, op)
               : pick<false, kTrain, kSeg, true, false>(a, op);
  return tex ? pick<false, kTrain, kSeg, false, true>(a, op)
             : pick<false, kTrain, kSeg, false, false>(a, op);
}

}  // namespace

// P: the dense rows (tri_start), staged in shared memory; tri: the (Pt, 16)
// triangle table, or null with tri_n = 0; bb: the (n_cb, 8) block AABBs,
// or null with n_cb = 0; sbb: the sphere segment's (n_sb, 8) block AABBs,
// or null with n_sb = 0; maps (P, 6), atlas (N, 3), tmeta (T, 3) and the
// slot mask `slots` of a textured scene, or nulls and slots = 0; bw / n_bw:
// a textured scene's walked box segment (hit3.box_walk_tables, 16-byte
// aligned) and its boxes, or null and 0 (the box rows swept dense). The render
// instance runs steps [k0, k1) of the K in u8s; c0 / rid / cout: the carry
// in, the lanes' rays and the carry out of a segment, or nulls (te0..xrow0
// are read only when k0 = 0); next: two zeroed int32 counters for the
// lane refill of a dense-row or box-walk whole trace (which leaves them
// zeroed; a whole render of one needs them), or null.
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
                             float* cout, int* next, const float* srows,
                             const float* ssb, const float* bw, int n_bw,
                             void* stream) {
  if ((n_sb > 0 && (srows == nullptr || ssb == nullptr)) ||
      (n_bw > 0 && (bw == nullptr || slots == 0 || tri_n > 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{tab, P,
               mrt::Layout{sph_start, sph_n, pln_start, pln_n, box_start,
                           box_n, tri_start, tri_n, n_cb, n_sb},
               tri, bb, sbb, lights, L, dk,
               mrt::Tex{maps, atlas, tmeta, slots}, o0, d0, te0, row0, tx0,
               xrow0, u8s, K, R, k0, k1, c0, rid, A, B, fl, cout, nullptr,
               nullptr, next, srows, ssb, bw, n_bw};
  const bool seg = k0 != 0 || k1 != K || c0 || rid || cout;
  const Launch op{static_cast<cudaStream_t>(stream)};
  return seg ? dispatch<false, true>(a, refract, op)
             : dispatch<false, false>(a, refract, op);
}

extern "C" int mrt_trace_fwd_train(
    const float* tab, int P, int sph_start, int sph_n, int pln_start,
    int pln_n, int box_start, int box_n, const float* tri, int tri_start,
    int tri_n, const float* bb, int n_cb, const float* sbb, int n_sb,
    const float* lights, int L, float dk, const int* maps,
    const float* atlas, const int* tmeta, int slots, const float* o0,
    const float* d0, const float* te0, const int* row0, const float* tx0,
    const int* xrow0, const float* u8s, int K, int R, int refract, float* A,
    float* B, float* fl, float* resid, int* n_live, int* next,
    const float* srows, const float* ssb, const float* bw, int n_bw,
    void* stream) {
  if ((n_sb > 0 && (srows == nullptr || ssb == nullptr)) ||
      (n_bw > 0 && (bw == nullptr || slots == 0 || tri_n > 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{tab, P,
               mrt::Layout{sph_start, sph_n, pln_start, pln_n, box_start,
                           box_n, tri_start, tri_n, n_cb, n_sb},
               tri, bb, sbb, lights, L, dk,
               mrt::Tex{maps, atlas, tmeta, slots}, o0, d0, te0, row0, tx0,
               xrow0, u8s, K, R, 0, K, nullptr, nullptr, A, B, fl, nullptr,
               resid, n_live, next, srows, ssb, bw, n_bw};
  return dispatch<true, false>(a, refract,
                               Launch{static_cast<cudaStream_t>(stream)});
}

// Resident warps per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) of
// the instance a whole trace of these tables launches: the render (train
// = 0) or train instance, refilling its lanes or not, walking n_bw boxes
// or not (0), into *warps; returns a CUDA error code.
extern "C" int mrt_trace_fwd_occupancy(
    int P, int sph_start, int sph_n, int pln_start, int pln_n, int box_start,
    int box_n, int tri_start, int tri_n, int n_cb, int n_sb, int L,
    int slots, int refract, int train, int refill, int n_bw, int* warps) {
  int counter[2] = {};  // only its being set is read
  Args a{};
  a.next = refill ? counter : nullptr;
  a.P = P;
  a.lay = mrt::Layout{sph_start, sph_n, pln_start, pln_n, box_start,
                      box_n, tri_start, tri_n, n_cb, n_sb};
  a.L = L;
  a.tex.slots = slots;
  a.n_bw = n_bw;
  int per_sm = 0;
  const Occupancy op{&per_sm};
  const int e = train ? dispatch<true, false>(a, refract, op)
                      : dispatch<false, false>(a, refract, op);
  *warps = per_sm * (kThreads / 32);
  return e;
}
#endif  // __CUDACC__
