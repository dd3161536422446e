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
// hit, cx of tx the exit row where it hit and has an exit (masked_cts, the
// rule of ops/hit3.py _masked_cts; in the entry-only mode tx is te, so
// ce + cx goes to the entry t). The transposes are trace_bwd.cuh's
// winner_t_bwd, with its box branch's kSplitTies: a box t attained by
// several slab axes shares its cotangent evenly among them, as autograd of
// the jnp.max / jnp.min in _winner_t_all does (the fused backward gives it
// all to the first axis). When the entry and exit rows are the same row
// (every row of a scene without triangles is its own group) one call
// takes both cotangents; otherwise each row gets its own. A winner tie
// across rows gave the lowest row in the forward, and the recompute is at
// that row.
//
// Outputs, every entry written by the one launch (the wrapper allocates
// them uninitialized): d_o and d_d per ray (zeros where nothing reached
// it); d_tab (P_all, 26): the dense rows' sweep columns 0-15 summed in
// float64 through the warp-aggregated scatter of trace_bwd.cu and
// step_bwd.cu, over those 16 columns alone (warp_rows16: per block in
// shared memory while the rows fit kSharedBytes, else into the global
// sums), zeros elsewhere; d_tri (Pt, 16): a triangle winner's Woop
// cotangents (G[2], h[2]) summed with float atomics, as those kernels do,
// in columns 6-8 and 11, zeros elsewhere. Every row keeps its own
// cotangent (none is folded onto a shared one). The sums live in a
// workspace per device and stream that is zero between launches:
// the last block to finish (a ticket counter after a __threadfence) writes
// them into d_tab / d_tri and zeroes them, and the ticket wraps back to 0,
// so no launch needs a memset and no second kernel finishes the sums.
//
// The kernel: one thread per ray, warps of 32 consecutive rays, persistent
// blocks striding over the rays, each of which first stages the dense
// rows' sweep columns 0-15 in shared memory (up to kStagedRows rows; past
// it they are read from global memory through L1); a lane loads all of
// its ray's inputs at once. What bounds it on the H100: bytes (a ray
// reads 12 + 12 bytes of rays, 8 of t, 8 of rows and 8 of cotangents,
// writes 24) and the row sums' atomics where many rays share a row (the
// room: most of a warp on one to three rows, which warp_rows16 sums
// across the warp first). Measured on the room's frame, neither the
// transposes nor the atomics set its time but the rays' loads and
// stores, at about 2.4x their byte bound.
//
// Numerics: float32, -fmad=false; every division and sqrt guarded before
// the op, so a missed or dead ray (skipped: no cotangent) and an
// unselected branch give no NaN.
#include "trace_bwd.cuh"

namespace mrt {

// The cotangents of a ray's winner rows (ops/hit3.py _masked_cts): te's
// where the ray hit (te < BIG/2), tx's where it hit and has an exit (tx >
// -BIG/2); without the exit (need_exit false) tx is te, so ce + cx goes to
// the entry row and cx is 0.
__device__ __forceinline__ void masked_cts(bool need_exit, float te, float tx,
                                           float ct_te, float ct_tx,
                                           float& ce, float& cx) {
  const bool hit_e = te < 0.5f * kBig;
  const float e = hit_e ? ct_te : 0.0f;
  const float x = hit_e && tx > -0.5f * kBig ? ct_tx : 0.0f;
  ce = need_exit ? e : e + x;
  cx = need_exit ? x : 0.0f;
}

// The transposes of one ray: the entry row `re` with cotangent ce and the
// exit row `rx` with cx (need_exit: rx is the exit row; else the entry
// t takes both) into d_e / gh_e and d_x / gh_x, and the ray's cotangents.
// A dense row's sweep columns are read at rows + r * rs, a triangle row's
// Woop form in tri.
template <bool kTri>
__device__ __forceinline__ void ray_bwd(const float* rows, int rs,
                                        const float* __restrict__ tri,
                                        const Layout& lay, V3 o, V3 d,
                                        int re, int rx, float ce, float cx,
                                        bool need_exit, float* d_e,
                                        float* gh_e, float* d_x, float* gh_x,
                                        V3& ct_o, V3& ct_d) {
  const auto at = [&](int r) {
    return kTri && r >= lay.tri_start ? nullptr
                                      : rows + static_cast<size_t>(r) * rs;
  };
  const auto tr = [&](int r) {
    return kTri && r >= lay.tri_start
               ? tri + static_cast<size_t>(r - lay.tri_start) * kTriCols
               : nullptr;
  };
  if (!need_exit) {
    winner_t_bwd<true>(at(re), row_kind<kTri>(re, lay), o, d, ce + cx, 0.0f,
                       d_e, ct_o, ct_d, tr(re), gh_e);
    return;
  }
  if (re == rx) {
    winner_t_bwd<true>(at(re), row_kind<kTri>(re, lay), o, d, ce, cx, d_e,
                       ct_o, ct_d, tr(re), gh_e);
    return;
  }
  if (ce != 0.0f)
    winner_t_bwd<true>(at(re), row_kind<kTri>(re, lay), o, d, ce, 0.0f, d_e,
                       ct_o, ct_d, tr(re), gh_e);
  if (cx != 0.0f)
    winner_t_bwd<true>(at(rx), row_kind<kTri>(rx, lay), o, d, 0.0f, cx, d_x,
                       ct_o, ct_d, tr(rx), gh_x);
}

}  // namespace mrt

#ifdef __CUDACC__
#include <cuda_runtime.h>

#include <algorithm>

#include "grid.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kAggShared = 8;
constexpr int kAggGlobal = 2;
// the block's float64 row sums stay in shared memory while they fit this
constexpr int kSharedBytes = 100 * 1024;
// the sweep columns a row's cotangent fills (winner_t_bwd: frame,
// position, plane normal / box sizes, radius), and the dense rows whose
// columns a block stages (64 B a row)
constexpr int kCols = 16;
constexpr int kStagedRows = 1024;
// the workspace: the ticket, then the float64 row sums (P * kCols), then
// the triangle rows' float32 Woop sums (Pt * 4)
constexpr int kTicketBytes = 16;

// Adds each lane's row cotangents d_at (kCols columns; row -1: none) into
// the (P, kCols) float64 sums, in shared memory (s_rows) when `shared`,
// else in global memory (g_rows): trace_bwd.cuh warp_rows over the sweep
// columns alone. A row held by kAggShared (shared) or kAggGlobal (global)
// lanes or more is summed over the warp first (warp_transpose_sum16: the
// half-warps, then 16 lanes) and added once per nonzero column; the other
// lanes add their own nonzero columns. Every lane of the warp calls it.
__device__ __forceinline__ void warp_rows16(bool shared, double* s_rows,
                                            double* g_rows, int row,
                                            const float* d_at, int lane) {
  double* sums = shared ? s_rows : g_rows;
  const int agg = shared ? kAggShared : kAggGlobal;
  const unsigned peers = __match_any_sync(mrt::kFull, row);
  const bool big = row >= 0 && __popc(peers) >= agg;
  unsigned leads =
      __ballot_sync(mrt::kFull, big && lane == __ffs(peers) - 1);
  while (leads) {
    const int l = __ffs(leads) - 1;
    leads &= leads - 1;
    const int r = __shfl_sync(mrt::kFull, row, l);
    float v[kCols];
#pragma unroll
    for (int g = 0; g < kCols; ++g) v[g] = row == r ? d_at[g] : 0.0f;
    const float s = mrt::warp_transpose_sum16<kCols>(v, lane);
    if (lane < kCols && s != 0.0f)
      atomicAdd(sums + r * kCols + lane, static_cast<double>(s));
  }
  if (row >= 0 && !big) {
#pragma unroll
    for (int g = 0; g < kCols; ++g)
      if (d_at[g] != 0.0f)
        atomicAdd(sums + row * kCols + g, static_cast<double>(d_at[g]));
  }
}

// One row's cotangents of every lane of the warp: a triangle row's Woop
// cotangents straight into the float32 sums tacc, a dense row's columns
// through warp_rows16 (row -1: none). Every lane calls it.
template <bool kTri>
__device__ __forceinline__ void scatter(const mrt::Layout& lay, int row,
                                        const float* d_at, const float* gh,
                                        bool shared, double* s_rows,
                                        double* acc, float* tacc, int lane) {
  if (kTri && row >= lay.tri_start) {
    const int t = row - lay.tri_start;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (gh[j] != 0.0f) atomicAdd(tacc + 4 * t + j, gh[j]);
    row = -1;
  }
  warp_rows16(shared, s_rows, acc, row, d_at, lane);
}

// triangle-table column of Woop sum k (G[2] of the rows of G, then h[2])
__device__ __forceinline__ int woop_col(int k) {
  return k < 3 ? 6 + k : mrt::T_H + 2;
}

// triangle-table column of the j-th column that gets no cotangent
__device__ __forceinline__ int plain_col(int j) {
  return j < 6 ? j : (j < 8 ? j + 3 : j + 4);
}

template <bool kTri>
__global__ void __launch_bounds__(kThreads) hit3_bwd_kernel(
    const float* __restrict__ tab, int P, int stride, mrt::Layout lay,
    const float* __restrict__ tri, const float* __restrict__ o,
    const float* __restrict__ d, int ray_stride, int comp_stride, int R,
    int need_exit, const float* __restrict__ te,
    const float* __restrict__ tx, const int* __restrict__ row,
    const int* __restrict__ xrow, const float* __restrict__ ct_te,
    const float* __restrict__ ct_tx, float* __restrict__ d_o,
    float* __restrict__ d_d, int shared_rows, int staged, int P_all,
    float* __restrict__ d_tab, float* __restrict__ d_tri, int Pt,
    char* __restrict__ ws) {
  // (P, kCols) float64 sums when shared_rows, then (P, kCols) staged rows
  extern __shared__ double s_rows[];
  unsigned* ticket = reinterpret_cast<unsigned*>(ws);
  double* acc = reinterpret_cast<double*>(ws + kTicketBytes);
  float* tacc = reinterpret_cast<float*>(acc + P * kCols);
  float* s_tab =
      reinterpret_cast<float*>(s_rows + (shared_rows ? P * kCols : 0));
  if (shared_rows)
    for (int c = threadIdx.x; c < P * kCols; c += blockDim.x) s_rows[c] = 0.0;
  if (staged)
    for (int c = threadIdx.x; c < P * kCols; c += blockDim.x)
      s_tab[c] = tab[(c / kCols) * stride + c % kCols];
  __syncthreads();
  const float* rows = staged ? s_tab : tab;
  const int rs = staged ? kCols : stride;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const mrt::V3 zero = mrt::v3(0.0f, 0.0f, 0.0f);
  for (int base = (blockIdx.x * warps + warp) * 32; base < R;
       base += gridDim.x * warps * 32) {
    const int i = base + lane;
    const bool in = i < R;
    // every input of the lane's ray loaded at once (a lane past R loads
    // the last ray's and takes no cotangent), so that the loads are in
    // flight together
    const int k = in ? i : R - 1;
    const size_t b = static_cast<size_t>(k) * ray_stride;
    const float te_k = te[k], tx_k = tx[k];
    const float ct_e = ct_te ? ct_te[k] : 0.0f;
    const float ct_x = ct_tx ? ct_tx[k] : 0.0f;
    const int row_k = row[k], xrow_k = need_exit ? xrow[k] : row_k;
    const mrt::V3 oi =
        mrt::v3(o[b], o[b + comp_stride], o[b + 2 * comp_stride]);
    const mrt::V3 di =
        mrt::v3(d[b], d[b + comp_stride], d[b + 2 * comp_stride]);
    float ce = 0.0f, cx = 0.0f;
    if (in) mrt::masked_cts(need_exit != 0, te_k, tx_k, ct_e, ct_x, ce, cx);
    int re = -1, rx = -1;
    float d_e[kCols] = {}, d_x[kCols] = {};
    float gh_e[4] = {}, gh_x[4] = {};
    mrt::V3 ct_o = zero, ct_d = zero;
    if (in && (ce != 0.0f || cx != 0.0f)) {
      re = row_k;
      rx = xrow_k;
      mrt::ray_bwd<kTri>(rows, rs, tri, lay, oi, di, re, rx, ce, cx,
                         need_exit != 0, d_e, gh_e, d_x, gh_x, ct_o, ct_d);
      if (!need_exit || rx == re) rx = -1;
    }
    scatter<kTri>(lay, re, d_e, gh_e, shared_rows != 0, s_rows, acc, tacc,
                  lane);
    // the exit rows: only where a lane of the warp has one apart from its
    // entry row (none in a scene without triangles)
    if (__any_sync(mrt::kFull, rx >= 0))
      scatter<kTri>(lay, rx, d_x, gh_x, shared_rows != 0, s_rows, acc, tacc,
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
    for (int c = threadIdx.x; c < P * kCols; c += blockDim.x)
      if (s_rows[c] != 0.0) atomicAdd(acc + c, s_rows[c]);
  }
  // the entries no sum reaches, spread over the grid: d_tab's columns
  // 16-25 of the dense rows and every column of the rows past them,
  // d_tri's columns outside G[2] and h[2]
  const int t0 = blockIdx.x * blockDim.x + threadIdx.x;
  const int nt = gridDim.x * blockDim.x;
  const int rest = mrt::kRowCols - kCols;
  for (int j = t0; j < P * rest; j += nt)
    d_tab[(j / rest) * mrt::kRowCols + kCols + j % rest] = 0.0f;
  for (int j = P * mrt::kRowCols + t0; j < P_all * mrt::kRowCols; j += nt)
    d_tab[j] = 0.0f;
  if (kTri)
    for (int j = t0; j < Pt * 12; j += nt)
      d_tri[(j / 12) * mrt::kTriCols + plain_col(j % 12)] = 0.0f;
  // the last block to finish writes the sums out and returns the
  // workspace to zero
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int j = threadIdx.x; j < P * kCols; j += blockDim.x) {
    d_tab[(j / kCols) * mrt::kRowCols + j % kCols] =
        static_cast<float>(__ldcg(acc + j));
    acc[j] = 0.0;
  }
  if (kTri)
    for (int j = threadIdx.x; j < Pt * 4; j += blockDim.x) {
      d_tri[(j / 4) * mrt::kTriCols + woop_col(j % 4)] = __ldcg(tacc + j);
      tacc[j] = 0.0f;
    }
}

// The dynamic shared memory of a launch at P dense rows and whether it
// keeps the sums (shared) and the rows (staged) there.
size_t launch_smem(int P, bool* shared, bool* staged) {
  const size_t rows_bytes = static_cast<size_t>(P) * kCols * sizeof(double);
  *shared = rows_bytes <= static_cast<size_t>(kSharedBytes);
  *staged = P <= kStagedRows;
  return (*shared ? rows_bytes : 0) +
         (*staged ? static_cast<size_t>(P) * kCols * sizeof(float) : 0);
}

template <bool kTri>
int launch(const float* tab, int P, int stride, const mrt::Layout& lay,
           const float* tri, const float* o, const float* d, int ray_stride,
           int comp_stride, int R, int need_exit, const float* te,
           const float* tx, const int* row, const int* xrow,
           const float* ct_te, const float* ct_tx, float* d_o, float* d_d,
           int P_all, float* d_tab, float* d_tri, int Pt, char* ws,
           cudaStream_t stream) {
  const auto kernel = hit3_bwd_kernel<kTri>;
  bool shared = false, staged = false;
  const size_t smem = launch_smem(P, &shared, &staged);
  int per_sm = 0, sms = 0;
  int e = mrt::resident_blocks(kernel, kThreads, smem, &per_sm, &sms);
  if (e) return e;
  const int blocks = std::max(
      1, std::min((R + kThreads - 1) / kThreads, sms * std::max(per_sm, 1)));
  kernel<<<blocks, kThreads, smem, stream>>>(
      tab, P, stride, lay, tri, o, d, ray_stride, comp_stride, R, need_exit,
      te, tx, row, xrow, ct_te, ct_tx, d_o, d_d, shared ? 1 : 0,
      staged ? 1 : 0, P_all, d_tab, d_tri, Pt, ws);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Into *warps the warps per SM the card keeps resident of the kernel's
// instance (tri: its triangle instance) at P dense rows.
extern "C" int mrt_hit3_bwd_warps(int P, int tri, int* warps) {
  bool shared = false, staged = false;
  const size_t smem = launch_smem(P, &shared, &staged);
  int per_sm = 0;
  const int e =
      tri ? mrt::resident_blocks(hit3_bwd_kernel<true>, kThreads, smem,
                                 &per_sm)
          : mrt::resident_blocks(hit3_bwd_kernel<false>, kThreads, smem,
                                 &per_sm);
  *warps = per_sm * kThreads / 32;
  return e;
}

// t: the table arguments, packed once per table as 64-bit integers
// (ops/hit3.py HitArgs): the row table (rows of `stride` >= 18 floats, its
// sweep columns first), its dense rows P (tri_start), the six dense ints
// as mrt_closest_hit's, the (Pt, 16) triangle table (or 0), the triangle
// segment's first row and its rows to sweep (0 without), the row table's
// rows P_all (those of d_tab) and the triangle table's rows Pt (0
// without). o, d: rays as mrt_closest_hit reads them;
// need_exit: the forward's mode was the group exit (1) or entry only (0);
// te, tx, row, xrow: the forward's outputs; ct_te, ct_tx: the cotangents
// of te and tx (null: zeros), masked here; d_o, d_d (R, 3), d_tab (P_all,
// 26) and d_tri (Pt, 16; null without triangles) written whole; ws: the
// device's workspace, 16 + 8 * 16 P + 16 Pt bytes, zero (and left zero).
extern "C" int mrt_hit3_bwd(const long long* t, const float* o,
                            const float* d, int ray_stride, int comp_stride,
                            int R, int need_exit, const float* te,
                            const float* tx, const int* row, const int* xrow,
                            const float* ct_te, const float* ct_tx,
                            float* d_o, float* d_d, float* d_tab,
                            float* d_tri, char* ws, void* stream) {
  if (t == nullptr || ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* tab = reinterpret_cast<const float*>(t[0]);
  const int P = static_cast<int>(t[1]), stride = static_cast<int>(t[2]);
  const auto* tri = reinterpret_cast<const float*>(t[9]);
  const mrt::Layout lay{static_cast<int>(t[3]),  static_cast<int>(t[4]),
                        static_cast<int>(t[5]),  static_cast<int>(t[6]),
                        static_cast<int>(t[7]),  static_cast<int>(t[8]),
                        static_cast<int>(t[10]), static_cast<int>(t[11]),
                        0,                       0};
  const int P_all = static_cast<int>(t[12]), Pt = static_cast<int>(t[13]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Pt > 0) {
    if (tri == nullptr || d_tri == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch<true>(tab, P, stride, lay, tri, o, d, ray_stride,
                        comp_stride, R, need_exit, te, tx, row, xrow, ct_te,
                        ct_tx, d_o, d_d, P_all, d_tab, d_tri, Pt, ws, s);
  }
  return launch<false>(tab, P, stride, lay, tri, o, d, ray_stride,
                       comp_stride, R, need_exit, te, tx, row, xrow, ct_te,
                       ct_tx, d_o, d_d, P_all, d_tab, d_tri, 0, ws, s);
}
#endif  // __CUDACC__
