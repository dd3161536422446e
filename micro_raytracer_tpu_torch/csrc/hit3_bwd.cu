// hit3_bwd: the VJP of the closest hit (hit3.cu), the backward of the
// record path's differentiable closest hit (ops/hit3.py ClosestHit).
//
// Replaces: micro_raytracer_tpu/ops/pallas_hit3.py :: make_closest_hit's
// bwd (l.1164) with _winner_t_all (l.1077): the winner row's entry t, and
// the exit row's exit t when the sweep took the group exit, recomputed
// from the same row and the same ray as the forward and transposed, the
// row attributes read exactly (the one-hot MXU fetch of the Pallas
// version becomes a row read).
//
// Semantics: the cotangent ce of te reaches the entry row where the ray
// hit, cx of tx the exit row where it hit and has an exit (the wrapper
// masks both; in the entry-only mode tx is te, so ce + cx goes to the
// entry t). The transposes are trace_bwd.cuh's winner_t_bwd, with its box
// branch's kSplitTies: a box t attained by several slab axes shares its
// cotangent evenly among them, as autograd of the jnp.max / jnp.min in
// _winner_t_all does (the fused backward gives it all to the first axis).
// When the entry and exit rows are the same row (every row of a scene
// without triangles is its own group) one call takes both cotangents;
// otherwise each row gets its own. A winner tie across rows gave the
// lowest row in the forward, and the recompute is at that row.
//
// Outputs: d_o and d_d per ray (every ray written, zeros where nothing
// reached it); the dense rows' sweep columns 0-15 summed in float64
// through the warp-aggregated scatter trace_bwd.cu and step_bwd.cu share
// (warp_rows: per block in shared memory while the rows fit kSharedBytes,
// else into the global sums), then written to d_tab's dense rows (26
// floats a row, the whole trace's row-table width) by a second kernel;
// a triangle winner's Woop cotangents (G[2], h[2]) into d_tri4 (Pt, 4)
// with float atomics, as those kernels do. Every row keeps its own
// cotangent (none is folded onto a shared one).
//
// The kernel: one thread per ray, warps of 32 consecutive rays, persistent
// blocks striding over the rays. What bounds it on the H100: bytes (a ray
// reads 12 + 12 bytes of rays, 16 of rows and cotangents, writes 24) and
// the row sums' atomics where many rays share a row (the room: most of a
// warp on one to three rows, which warp_rows sums across the warp first).
// Simple and correct first: no staging of the rows (a few hundred float
// ops per ray, rows read through L1).
//
// Numerics: float32, -fmad=false; every division and sqrt guarded before
// the op, so a missed or dead ray (skipped: no cotangent) and an
// unselected branch give no NaN.
#include <cuda_runtime.h>

#include <algorithm>

#include "grid.cuh"
#include "trace_bwd.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kAggShared = 8;
constexpr int kAggGlobal = 2;
// the block's float64 row sums stay in shared memory while they fit this
constexpr int kSharedBytes = 100 * 1024;

// The transposes of one ray: the entry row `re` with cotangent ce and the
// exit row `rx` with cx (need_exit: rx is the exit row; else the entry
// t takes both) into d_e / gh_e and d_x / gh_x, and the ray's cotangents.
template <bool kTri>
__device__ __forceinline__ void ray_bwd(const float* __restrict__ tab,
                                        int stride,
                                        const float* __restrict__ tri,
                                        const mrt::Layout& lay, mrt::V3 o,
                                        mrt::V3 d, int re, int rx, float ce,
                                        float cx, bool need_exit, float* d_e,
                                        float* gh_e, float* d_x, float* gh_x,
                                        mrt::V3& ct_o, mrt::V3& ct_d) {
  const auto at = [&](int r) { return tab + static_cast<size_t>(r) * stride; };
  const auto tr = [&](int r) {
    return kTri && r >= lay.tri_start
               ? tri + static_cast<size_t>(r - lay.tri_start) * mrt::kTriCols
               : nullptr;
  };
  if (!need_exit) {
    mrt::winner_t_bwd<true>(at(re), mrt::row_kind<kTri>(re, lay), o, d,
                            ce + cx, 0.0f, d_e, ct_o, ct_d, tr(re), gh_e);
    return;
  }
  if (re == rx) {
    mrt::winner_t_bwd<true>(at(re), mrt::row_kind<kTri>(re, lay), o, d, ce,
                            cx, d_e, ct_o, ct_d, tr(re), gh_e);
    return;
  }
  if (ce != 0.0f)
    mrt::winner_t_bwd<true>(at(re), mrt::row_kind<kTri>(re, lay), o, d, ce,
                            0.0f, d_e, ct_o, ct_d, tr(re), gh_e);
  if (cx != 0.0f)
    mrt::winner_t_bwd<true>(at(rx), mrt::row_kind<kTri>(rx, lay), o, d,
                            0.0f, cx, d_x, ct_o, ct_d, tr(rx), gh_x);
}

// One row's cotangents of every lane of the warp: a triangle row's Woop
// cotangents straight into d_tri4, a dense row's columns through the
// warp-aggregated float64 scatter (row -1: none). Every lane calls it.
template <bool kTri>
__device__ __forceinline__ void scatter(const mrt::Layout& lay, int row,
                                        const float* d_at, const float* gh,
                                        bool shared, double* s_rows,
                                        double* acc, float* d_tri4,
                                        int lane) {
  if (kTri && row >= lay.tri_start) {
    const int t = row - lay.tri_start;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (gh[j] != 0.0f) atomicAdd(d_tri4 + 4 * t + j, gh[j]);
    row = -1;
  }
  mrt::warp_rows<kAggShared, kAggGlobal>(shared, s_rows, acc, row, d_at,
                                         lane);
}

template <bool kTri>
__global__ void __launch_bounds__(kThreads) hit3_bwd_kernel(
    const float* __restrict__ tab, int P, int stride, mrt::Layout lay,
    const float* __restrict__ tri, const float* __restrict__ o,
    const float* __restrict__ d, int ray_stride, int comp_stride, int R,
    int need_exit, const int* __restrict__ row,
    const int* __restrict__ xrow, const float* __restrict__ ct_te,
    const float* __restrict__ ct_tx, float* __restrict__ d_o,
    float* __restrict__ d_d, int shared_rows, double* __restrict__ acc,
    float* __restrict__ d_tri4) {
  extern __shared__ double s_rows[];  // (P, 26) when shared_rows
  if (shared_rows) {
    for (int c = threadIdx.x; c < P * mrt::kRowCols; c += blockDim.x)
      s_rows[c] = 0.0;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const mrt::V3 zero = mrt::v3(0.0f, 0.0f, 0.0f);
  for (int base = (blockIdx.x * warps + warp) * 32; base < R;
       base += gridDim.x * warps * 32) {
    const int i = base + lane;
    const bool in = i < R;
    const float ce = in ? ct_te[i] : 0.0f;
    const float cx = in ? ct_tx[i] : 0.0f;
    int re = -1, rx = -1;
    float d_e[mrt::kRowCols] = {}, d_x[mrt::kRowCols] = {};
    float gh_e[4] = {}, gh_x[4] = {};
    mrt::V3 ct_o = zero, ct_d = zero;
    if (in && (ce != 0.0f || cx != 0.0f)) {
      const size_t b = static_cast<size_t>(i) * ray_stride;
      const mrt::V3 oi = mrt::v3(o[b], o[b + comp_stride],
                                 o[b + 2 * comp_stride]);
      const mrt::V3 di = mrt::v3(d[b], d[b + comp_stride],
                                 d[b + 2 * comp_stride]);
      re = row[i];
      rx = need_exit ? xrow[i] : re;
      ray_bwd<kTri>(tab, stride, tri, lay, oi, di, re, rx, ce, cx,
                    need_exit != 0, d_e, gh_e, d_x, gh_x, ct_o, ct_d);
      if (!need_exit || rx == re) rx = -1;
    }
    scatter<kTri>(lay, re, d_e, gh_e, shared_rows != 0, s_rows, acc, d_tri4,
                  lane);
    scatter<kTri>(lay, rx, d_x, gh_x, shared_rows != 0, s_rows, acc, d_tri4,
                  lane);
    if (in) {
      d_o[3 * i] = ct_o.x;
      d_o[3 * i + 1] = ct_o.y;
      d_o[3 * i + 2] = ct_o.z;
      d_d[3 * i] = ct_d.x;
      d_d[3 * i + 1] = ct_d.y;
      d_d[3 * i + 2] = ct_d.z;
    }
  }
  if (shared_rows) {
    __syncthreads();
    for (int c = threadIdx.x; c < P * mrt::kRowCols; c += blockDim.x)
      if (s_rows[c] != 0.0) atomicAdd(acc + c, s_rows[c]);
  }
}

// d_tab's dense rows from the float64 sums
__global__ void finish_kernel(const double* __restrict__ acc, int n,
                              float* __restrict__ d_tab) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < n) d_tab[j] = static_cast<float>(acc[j]);
}

template <bool kTri>
int launch(const float* tab, int P, int stride, const mrt::Layout& lay,
           const float* tri, const float* o, const float* d, int ray_stride,
           int comp_stride, int R, int need_exit, const int* row,
           const int* xrow, const float* ct_te, const float* ct_tx,
           float* d_o, float* d_d, double* acc, float* d_tab, float* d_tri4,
           cudaStream_t stream) {
  const auto kernel = hit3_bwd_kernel<kTri>;
  const size_t rows_bytes =
      static_cast<size_t>(P) * mrt::kRowCols * sizeof(double);
  const bool shared = rows_bytes <= static_cast<size_t>(kSharedBytes);
  const size_t smem = shared ? rows_bytes : 0;
  int per_sm = 0, sms = 0;
  int e = mrt::resident_blocks(kernel, kThreads, smem, &per_sm, &sms);
  if (e) return e;
  const int blocks = std::max(
      1, std::min((R + kThreads - 1) / kThreads, sms * std::max(per_sm, 1)));
  kernel<<<blocks, kThreads, smem, stream>>>(
      tab, P, stride, lay, tri, o, d, ray_stride, comp_stride, R, need_exit,
      row, xrow, ct_te, ct_tx, d_o, d_d, shared ? 1 : 0, acc, d_tri4);
  e = static_cast<int>(cudaGetLastError());
  if (e != cudaSuccess) return e;
  const int n = P * mrt::kRowCols;
  if (n > 0) {
    finish_kernel<<<(n + 255) / 256, 256, 0, stream>>>(acc, n, d_tab);
    e = static_cast<int>(cudaGetLastError());
  }
  return e;
}

}  // namespace

// tab: the row table (rows of `stride` >= 18 floats, its sweep columns
// first), P its dense rows (tri_start); the six dense ints as
// mrt_closest_hit's; tri: the (Pt, 16) triangle table, or null with
// tri_n = 0; o, d: rays as mrt_closest_hit reads them; need_exit: the
// forward's mode was the group exit (1) or entry only (0); row, xrow the
// forward's winner rows; ct_te, ct_tx the masked cotangents; d_o, d_d (R,
// 3) written; acc: P * 26 float64 sums and d_tab (at least P rows of 26),
// d_tri4 (Pt, 4), zeroed by the wrapper.
extern "C" int mrt_hit3_bwd(const float* tab, int P, int stride,
                            int sph_start, int sph_n, int pln_start,
                            int pln_n, int box_start, int box_n,
                            const float* tri, int tri_start, int tri_n,
                            const float* o, const float* d, int ray_stride,
                            int comp_stride, int R, int need_exit,
                            const int* row, const int* xrow,
                            const float* ct_te, const float* ct_tx,
                            float* d_o, float* d_d, double* acc,
                            float* d_tab, float* d_tri4, void* stream) {
  const mrt::Layout lay{sph_start, sph_n, pln_start, pln_n, box_start,
                        box_n,     tri_start, tri_n, 0,       0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tri_n > 0) {
    if (tri == nullptr || d_tri4 == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch<true>(tab, P, stride, lay, tri, o, d, ray_stride,
                        comp_stride, R, need_exit, row, xrow, ct_te, ct_tx,
                        d_o, d_d, acc, d_tab, d_tri4, s);
  }
  return launch<false>(tab, P, stride, lay, tri, o, d, ray_stride,
                       comp_stride, R, need_exit, row, xrow, ct_te, ct_tx,
                       d_o, d_d, acc, d_tab, d_tri4, s);
}
