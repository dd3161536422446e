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
// Each ray walks its steps from the last live one (the ray's n_live) down
// to 0, carrying the cotangents of o, d and A; the cotangent of B is the
// trace output's ctB at every step (B is never saved: it enters only
// additively). pwr = dk^k is recomputed. Each step recomputes its primal
// values at the selected hit (entry, or exit when the refract branch was
// chosen) from the residuals o, d, A, te, tx, the winner row, the saved
// choice and the occlusion bits — no sweep — and then transposes the fold,
// the direct light, the sampled direction, the material reads, the hit
// point and normal, and the winner t (ray_step_bwd, one step;
// trace_ray_bwd, a ray's whole walk).
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
// light table. Every row keeps its own cotangent (none is folded onto a
// group's first row).
//
// The kernel. A warp takes 32 rays and walks k from its longest ray's
// last live step down, one step at a time for all its lanes; a lane whose
// ray has no step k sits that step out (the longest lane set the warp's
// pace before too). So at each k the warp's lanes hold one step each, and
// their row cotangents are scattered together (warp_rows): lanes that
// share a row with enough others (kAggShared, kAggGlobal) are summed
// across the warp first (a reduce-scatter over 31 shuffles that leaves
// column g's sum on lane g) and added once per nonzero column; the other
// lanes add their own nonzero columns. A dense room puts most of a warp on
// one to three rows, where per-lane adds on one address serialise 32 ways
// (the parent design's shared float atomics: 7.97 ms of the room's frame,
// 1.45 with those adds made racy plain adds; tools/torch_compare_trees.py
// ablate). The dense rows accumulate in float64, per block in shared
// memory while they and the lane slots fit kSharedBytes, else (the
// Instance grid's 1,008 rows) straight into the global float64 sums;
// triangle rows (and their (Pt, 4) Woop cotangents) go to d_tab and d_tri
// lane by lane with float atomics: a mesh's hits spread over hundreds of
// rows. Each visible light's cotangent row goes, as soon as its term is
// transposed, into the lane's own float64 slots in shared memory (plain
// adds, no atomics), so no light's row is held in registers. Blocks
// persist (as many as fit on the card, warps striding over the rays) and
// add their shared sums into the global float64 sums once, at the end; a
// second kernel writes them to d_tab's dense rows and d_lights.
//
// Run to run: d_o and d_d are per ray and bitwise repeatable, and equal
// the per-ray walk's (trace_ray_bwd) bit for bit. The table cotangents
// are float64 sums of float32 terms (a warp's row sums are float32) in an
// order that varies, rounded to float32 once; triangle rows are float32
// atomic sums. The card test bounds the difference of two runs.
//
// What bounds it on the H100: bytes. A live step reads 4*CR bytes of
// residuals (res_rows_all) and 4*NU of uniforms and does a few hundred
// float ops without a sweep. The winner rows are read from global memory
// through L1 (a table of a dozen rows stays there; step.BWD_MAX_ROWS =
// 1024 dense rows is 104 KB); the lights are staged in shared memory.
// Registers: __launch_bounds__(kThreads, kMinBlocks) holds a thread to
// 128, so that 16 warps fit on an SM.
//
// Numerics: float32, -fmad=false; every division and sqrt is guarded
// before the op, so that no NaN reaches a cotangent through an unselected
// branch; the linearization point is the forward's exact values (the
// residuals and the same row table).
//
// The per-step transposes (step_bwd and the winner-t, side and normal
// transposes) live in trace_bwd.cuh, which the per-step backward
// (step_bwd.cu) includes too.
#include "trace_bwd.cuh"

namespace mrt {

// Step k of ray i transposed: the step's residuals and uniforms read,
// pwr = dk^k recomputed, step_bwd run at the chosen side. Returns the
// chosen row; d_at and d_gh (zeroed by the caller) take its cotangents,
// lacc.light(li, row) each visible light's. `s_tab` holds the dense rows,
// `g_tab` the whole row table.
template <bool kRefract, bool kTri, bool kTex, class LightAcc>
__device__ __forceinline__ int ray_step_bwd(
    const float* s_tab, const float* g_tab, const Tris& T, const Layout& lay,
    const float* s_lt, int L, float dk, const Tex& tex, int i, int R,
    const float* __restrict__ resid, int k, const float* __restrict__ u8s,
    V3 ctB, V3& ct_o, V3& ct_d, V3& ct_A, float* d_at, float* d_gh,
    LightAcc& lacc) {
  constexpr int NU = kRefract ? 8 : 4;
  const int CR = res_rows_all<kRefract, kTri, kTex>(L, tex.slots);
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
    const int side_rows = tex_side_rows(tex.slots);
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
  step_bwd<kRefract, kTex>(at, tv, kind, tr, s_lt, L, o, d, A,
                           choose ? r[R_TX * R] : r[R_TE * R], choose, lok,
                           u, R, pwr, ctB, ct_o, ct_d, ct_A, d_at, d_gh,
                           lacc);
  return row;
}

// One ray's whole backward, step by step from its last live one. `acc`
// adds into the row, triangle and light accumulators: acc.row(row, d_at),
// acc.tri(local row, d_gh) and acc.light(li, light row).
template <bool kRefract, bool kTri, bool kTex, class Acc>
__device__ __forceinline__ void trace_ray_bwd(
    const float* s_tab, const float* g_tab, const Tris& T, const Layout& lay,
    const float* s_lt, int L, float dk, const Tex& tex,
    int i, int R, const float* __restrict__ resid, int n,
    const float* __restrict__ u8s, V3 ctA, V3 ctB, V3& ct_o, V3& ct_d,
    Acc& acc) {
  ct_o = v3(0.0f, 0.0f, 0.0f);
  ct_d = ct_o;
  V3 ct_A = ctA;
  for (int k = n - 1; k >= 0; --k) {
    float d_at[kRowCols] = {};
    float d_gh[4] = {};
    const int row = ray_step_bwd<kRefract, kTri, kTex>(
        s_tab, g_tab, T, lay, s_lt, L, dk, tex, i, R, resid, k, u8s, ctB,
        ct_o, ct_d, ct_A, d_at, d_gh, acc);
    acc.row(row, d_at);
    if (kTri && row >= lay.tri_start) acc.tri(row - lay.tri_start, d_gh);
  }
}

}  // namespace mrt

#ifdef __CUDACC__
#include <cuda_runtime.h>

#include <algorithm>

#include "grid.cuh"

namespace {

using mrt::kFull;
using mrt::LaneLights;
constexpr int kThreads = 256;    // threads per block
constexpr int kMinBlocks = 2;    // blocks per SM the register budget keeps
// lanes on one row from which the warp sums them before adding: into
// shared memory (a conflicting add there retries) and into global memory
// (each add is an L2 operation)
constexpr int kAggShared = 8;
constexpr int kAggGlobal = 2;
// a block's lane slots and dense-row accumulator stay in shared memory
// while they fit this (two blocks per SM)
constexpr int kSharedBytes = 100 * 1024;

template <bool kRefract, bool kTri, bool kTex>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    trace_bwd_kernel(const float* __restrict__ tab, int P, mrt::Layout lay,
                     const float* __restrict__ tri,
                     const float* __restrict__ lights, int L, float dk,
                     mrt::Tex tex, const float* __restrict__ resid,
                     const int* __restrict__ n_live,
                     const float* __restrict__ u8s, int R,
                     const float* __restrict__ ctA,
                     const float* __restrict__ ctB, float* __restrict__ d_o,
                     float* __restrict__ d_d, int shared_rows,
                     double* __restrict__ acc, float* __restrict__ d_tab,
                     float* __restrict__ d_tri) {
  extern __shared__ double smem[];
  const int nl = L * mrt::kLightCols;
  const int warps = blockDim.x >> 5;
  double* s_lane = smem;                     // (warps, L * 11, 32)
  double* s_rows = s_lane + warps * nl * 32;  // (P, 26) when shared_rows
  const int n_acc = warps * nl * 32 + (shared_rows ? P * mrt::kRowCols : 0);
  float* s_lt = reinterpret_cast<float*>(smem + n_acc);  // (L, 11)
  mrt::stage(s_lt, lights, L, mrt::kLightCols, mrt::kLightCols);
  for (int c = threadIdx.x; c < n_acc; c += blockDim.x) smem[c] = 0.0;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  LaneLights lacc{s_lane + warp * nl * 32 + lane};
  const mrt::Tris T{tri, nullptr};
  const mrt::V3 zero = mrt::v3(0.0f, 0.0f, 0.0f);
  for (int base = (blockIdx.x * warps + warp) * 32; base < R;
       base += gridDim.x * warps * 32) {
    const int i = base + lane;
    const bool in = i < R;
    const int n = in ? n_live[i] : 0;
    const int top = __reduce_max_sync(kFull, n);
    mrt::V3 ct_o = zero, ct_d = zero;
    mrt::V3 ct_A = in ? mrt::v3(ctA[i], ctA[R + i], ctA[2 * R + i]) : zero;
    const mrt::V3 cB =
        in ? mrt::v3(ctB[i], ctB[R + i], ctB[2 * R + i]) : zero;
    for (int k = top - 1; k >= 0; --k) {
      float d_at[mrt::kRowCols] = {};
      float d_gh[4] = {};
      int row = -1;
      if (k < n)
        row = mrt::ray_step_bwd<kRefract, kTri, kTex>(
            tab, tab, T, lay, s_lt, L, dk, tex, i, R, resid, k, u8s, cB,
            ct_o, ct_d, ct_A, d_at, d_gh, lacc);
      if (kTri && row >= lay.tri_start) {
        // a triangle row: straight into the global tables
        float* dst = d_tab + static_cast<size_t>(row) * mrt::kRowCols;
#pragma unroll
        for (int g = 0; g < mrt::kGradCols; ++g) {
          const int c = mrt::tab_col(g);
          if (d_at[c] != 0.0f) atomicAdd(dst + c, d_at[c]);
        }
        const int t = row - lay.tri_start;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (d_gh[j] != 0.0f) atomicAdd(d_tri + 4 * t + j, d_gh[j]);
        row = -1;
      }
      mrt::warp_rows<kAggShared, kAggGlobal>(shared_rows != 0, s_rows, acc,
                                             row, d_at, lane);
    }
    if (in) {
      d_o[i] = ct_o.x;
      d_o[R + i] = ct_o.y;
      d_o[2 * R + i] = ct_o.z;
      d_d[i] = ct_d.x;
      d_d[R + i] = ct_d.y;
      d_d[2 * R + i] = ct_d.z;
    }
  }
  __syncthreads();
  // the block's sums, once, into acc: each light column over every lane's
  // slot (in a fixed order), then the shared rows' nonzero entries
  double* g_lights = acc + P * mrt::kRowCols;
  for (int c = threadIdx.x; c < nl; c += blockDim.x) {
    if (c % mrt::kLightCols == 6) continue;
    double s = 0.0;
    for (int w = 0; w < warps; ++w)
      for (int l = 0; l < 32; ++l) s += s_lane[(w * nl + c) * 32 + l];
    if (s != 0.0) atomicAdd(g_lights + c, s);
  }
  if (shared_rows)
    for (int c = threadIdx.x; c < P * mrt::kRowCols; c += blockDim.x)
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
  const int* n_live;
  const float* u8s;
  int R;
  const float* ctA;
  const float* ctB;
  float* d_o;
  float* d_d;
  double* acc;
  float* d_tab;
  float* d_lights;
  float* d_tri;
};

// shared memory of a block: each lane's light slots, the dense rows'
// accumulator while both fit kSharedBytes, and the lights
size_t lane_bytes(int L) {
  return static_cast<size_t>(kThreads) * L * mrt::kLightCols * sizeof(double);
}

bool rows_shared(int P, int L) {
  return lane_bytes(L) + static_cast<size_t>(P) * mrt::kRowCols *
                             sizeof(double) <=
         static_cast<size_t>(kSharedBytes);
}

size_t smem_bytes(int P, int L) {
  return lane_bytes(L) +
         (rows_shared(P, L)
              ? static_cast<size_t>(P) * mrt::kRowCols * sizeof(double)
              : 0) +
         static_cast<size_t>(L) * mrt::kLightCols * sizeof(float);
}

template <bool kRefract, bool kTri, bool kTex>
int launch(const Args& a, cudaStream_t stream) {
  const auto kernel = trace_bwd_kernel<kRefract, kTri, kTex>;
  const size_t smem = smem_bytes(a.P, a.L);
  int per_sm = 0, sms = 0;
  int e = mrt::resident_blocks(kernel, kThreads, smem, &per_sm, &sms);
  if (e) return e;
  // persistent: as many blocks as the card keeps resident (grid.cuh)
  const int blocks = std::max(
      1, std::min((a.R + kThreads - 1) / kThreads, sms * per_sm));
  kernel<<<blocks, kThreads, smem, stream>>>(
      a.tab, a.P, a.lay, a.tri, a.lights, a.L, a.dk, a.tex, a.resid,
      a.n_live, a.u8s, a.R, a.ctA, a.ctB, a.d_o, a.d_d,
      rows_shared(a.P, a.L) ? 1 : 0, a.acc, a.d_tab, a.d_tri);
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
    return launch<kRefract, kTri, kTex>(a, s);
  }
};

struct Occupancy {
  int P, L;
  int* per_sm;
  template <bool kRefract, bool kTri, bool kTex>
  int run() const {
    return mrt::resident_blocks(trace_bwd_kernel<kRefract, kTri, kTex>,
                                kThreads, smem_bytes(P, L), per_sm);
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

// P: the dense rows (tri_start); maps, atlas, tmeta and slots as in
// mrt_trace_fwd (nulls and 0 without textures); acc: P * 26 + L * 11
// float64 sums, d_tab (all rows) and d_tri (Pt, 4), all zeroed by the
// wrapper; the kernel writes d_tab's dense rows and d_lights from acc.
// The cull blocks are not read (the backward does not sweep).
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
                             float* d_o, float* d_d, double* acc,
                             float* d_tab, float* d_lights, float* d_tri,
                             void* stream) {
  (void)bb;
  (void)sbb;
  const Args a{tab, P,
               mrt::Layout{sph_start, sph_n, pln_start, pln_n, box_start,
                           box_n, tri_start, tri_n, n_cb, n_sb},
               tri, lights, L, dk, mrt::Tex{maps, atlas, tmeta, slots},
               resid, n_live, u8s, R, ctA, ctB, d_o, d_d, acc, d_tab,
               d_lights, d_tri};
  return dispatch(refract != 0, tri_n > 0, slots != 0,
                  Launch{a, static_cast<cudaStream_t>(stream)});
}

// Resident warps per SM of the instance a scene of P dense rows and L
// lights launches (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into
// *warps; returns a CUDA error code.
extern "C" int mrt_trace_bwd_occupancy(int P, int L, int refract, int tri,
                                       int tex, int* warps) {
  int per_sm = 0;
  const int e =
      dispatch(refract != 0, tri != 0, tex != 0, Occupancy{P, L, &per_sm});
  *warps = per_sm * (kThreads / 32);
  return e;
}
#endif  // __CUDACC__
