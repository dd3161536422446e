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
//
// The per-step transposes (step_bwd and the winner-t, side and normal
// transposes) live in trace_bwd.cuh, which the per-step backward
// (step_bwd.cu) includes too.
#include "trace_bwd.cuh"

namespace mrt {

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
