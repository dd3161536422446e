// closest_hit: the closest-hit query as a kernel of its own, over a batch
// of rays. On the render path it is the primary-hit pass: it finds every
// camera ray's first hit, and the whole-trace kernel (trace_fwd.cu) starts
// its step loop from that hit.
//
// Replaces: micro_raytracer_tpu/ops/pallas_hit3.py :: _call_hit / _hit_kernel
// (dense segments, the long sphere segment's block cull, the triangle
// segment with its candidate-block cull, the group exit; the winner-t VJP
// _winner_t_all is not ported). The sweep
// itself lives in hit3.cuh, shared with the whole-trace kernel; see there
// for the semantics, the per-ray cull and what bounds it.
//
// One thread per ray, 256 threads per block; the block stages the sweep
// columns of the dense rows (spheres, planes, boxes) of the row table into
// a dense (n_dense, 18) shared table once (n_dense*72 bytes of dynamic
// shared memory; the wrapper raises above hit3.MAX_ROWS rows), and the
// triangle segment's block AABBs after it (n_cb*32 bytes, at most
// hit3.MAX_TRI_BLOCKS) or, without triangles, the sphere segment's
// (n_sb*32 bytes, at most 32); the triangle table stays in global memory.
// The
// table's rows are `stride` floats apart, so the trace kernel's wider row
// table serves as it is. Ray component c of ray i is read at
// o[i * ray_stride + c * comp_stride]: (R, 3) row-major rays and views of
// (3, R) lane-major ones both pass without a copy.
// mode 0: entry only (tx = te, xrow = row); 1: entry and group exit;
// 2: any-hit (te = -BIG on a hit, BIG otherwise; row = xrow = 0).
// A scene without triangles runs the kTri = false instance, the code of
// the dense-only kernel. A scene without triangles or textures whose sphere
// segment has cull blocks runs the kWalk instance (sph_walk.cuh): the
// block stages the sphere sub-blocks' and blocks' AABBs, the lanes'
// columns of block entry t and the planes' and boxes' sweep rows, and
// reads the packed sphere rows srows from global memory, where it staged
// the whole dense table (72 KB for the 1,000-sphere grid) and swept whole
// 64-row blocks. A textured scene without triangles whose box segment has
// walk tables (hit3.box_culled, the Minecraft class) runs the kBox instance
// (box_walk.cuh): the block stages the walk's node and leaf AABBs and its
// packed rows (16 KB for 256 boxes), the lanes' columns of entry t and the
// sweep rows before the box segment, and walks the boxes nearest first,
// where it swept every box row of the staged table.
#include <cuda_runtime.h>

#include "box_walk.cuh"
#include "hit3.cuh"
#include "sph_walk.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kTri, bool kWalk, bool kBox>
__global__ void closest_hit_kernel(const float* __restrict__ tab, int P,
                                   int stride, mrt::Layout lay,
                                   const float* __restrict__ tri,
                                   const float* __restrict__ bb,
                                   const float* __restrict__ sbb,
                                   const float* __restrict__ o,
                                   const float* __restrict__ d,
                                   int ray_stride, int comp_stride, int R,
                                   int mode, float* __restrict__ te,
                                   int* __restrict__ row,
                                   float* __restrict__ tx,
                                   int* __restrict__ xrow,
                                   const float* __restrict__ srows,
                                   const float* __restrict__ ssb,
                                   const float* __restrict__ bw, int n_bw) {
  extern __shared__ float s_tab[];
  mrt::SphWalk W{};
  mrt::BoxWalk BW{};
  if constexpr (kBox) {
    // the walk's tables (its rows where they fit), the lanes' entry-t
    // columns, then the sweep rows before the box segment (launch's smem)
    float* s_tb = s_tab + mrt::box_staged_floats(n_bw);
    float* s_pb = s_tb + (mrt::box_nodes(n_bw) + mrt::kBoxFan) * kThreads;
    mrt::box_stage(s_tab, bw, n_bw);
    mrt::stage(s_pb, tab, lay.box_start, stride, mrt::kSweepCols);
    __syncthreads();
    BW = mrt::BoxWalk{s_tab, mrt::box_rows_at(s_tab, bw, n_bw),
                      s_tb + threadIdx.x, kThreads, s_pb, n_bw};
  } else if constexpr (kWalk) {
    // sub-block AABBs, block AABBs, the blocks' AABB, the lanes' entry-t
    // columns, then the planes' and boxes' sweep rows (launch's smem)
    const int ns = (lay.sph_n + mrt::kSubRows - 1) / mrt::kSubRows;
    float* s_sub = s_tab;
    float* s_bb = s_sub + ns * mrt::kBbCols;
    float* s_seg = s_bb + lay.n_sb * mrt::kBbCols;
    float* s_tb = s_seg + mrt::kBbCols;
    float* s_pb = s_tb + lay.n_sb * kThreads;
    mrt::stage(s_sub, ssb, ns, mrt::kBbCols, mrt::kBbCols);
    mrt::stage(s_bb, sbb, lay.n_sb, mrt::kBbCols, mrt::kBbCols);
    mrt::stage(s_pb, tab + lay.pln_start * stride, P - lay.pln_start, stride,
               mrt::kSweepCols);
    __syncthreads();
    mrt::chunk_bounds(s_bb, lay.n_sb, s_seg, threadIdx.x, 6);
    __syncthreads();
    W = mrt::SphWalk{mrt::SphPack{srows, s_sub, s_seg}, s_bb,
                     s_tb + threadIdx.x, kThreads,
                     s_pb - lay.pln_start * mrt::kSweepCols};
  } else {
    mrt::stage(s_tab, tab, P, stride, mrt::kSweepCols);
    if (kTri)
      mrt::stage(s_tab + P * mrt::kSweepCols, bb, lay.n_cb, mrt::kBbCols,
                 mrt::kBbCols);
    else
      mrt::stage(s_tab + P * mrt::kSweepCols, sbb, lay.n_sb, mrt::kBbCols,
                 mrt::kBbCols);
    __syncthreads();
  }
  mrt::Tris T{tri, s_tab + P * mrt::kSweepCols};
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const size_t b = static_cast<size_t>(i) * ray_stride;
  const float ox = o[b], oy = o[b + comp_stride], oz = o[b + 2 * comp_stride];
  const float dx = d[b], dy = d[b + comp_stride], dz = d[b + 2 * comp_stride];
  mrt::Hit h;
  if constexpr (kBox) {
    if (mode == 2) {
      const bool hit = mrt::box_any_hit(lay, BW, ox, oy, oz, dx, dy, dz);
      h = mrt::Hit{hit ? -mrt::kBig : mrt::kBig, 0,
                   hit ? -mrt::kBig : mrt::kBig, 0};
    } else if (mode == 1) {
      h = mrt::box_closest_hit<true>(lay, BW, ox, oy, oz, dx, dy, dz);
    } else {
      h = mrt::box_closest_hit<false>(lay, BW, ox, oy, oz, dx, dy, dz);
    }
  } else if constexpr (kWalk) {
    if (mode == 2) {
      const bool hit = mrt::walk_any_hit(lay, W, ox, oy, oz, dx, dy, dz);
      h = mrt::Hit{hit ? -mrt::kBig : mrt::kBig, 0,
                   hit ? -mrt::kBig : mrt::kBig, 0};
    } else if (mode == 1) {
      h = mrt::walk_closest_hit<true>(lay, W, ox, oy, oz, dx, dy, dz);
    } else {
      h = mrt::walk_closest_hit<false>(lay, W, ox, oy, oz, dx, dy, dz);
    }
  } else if (mode == 2) {
    const bool hit = mrt::any_hit<kTri>(s_tab, mrt::kSweepCols, lay, ox, oy,
                                        oz, dx, dy, dz, T);
    h.te = hit ? -mrt::kBig : mrt::kBig;
    h.row = 0;
    h.tx = h.te;
    h.xrow = 0;
  } else if (mode == 1) {
    h = mrt::closest_hit<true, kTri>(s_tab, mrt::kSweepCols, lay, ox, oy, oz,
                                     dx, dy, dz, T);
  } else {
    h = mrt::closest_hit<false, kTri>(s_tab, mrt::kSweepCols, lay, ox, oy,
                                      oz, dx, dy, dz, T);
  }
  te[i] = h.te;
  row[i] = h.row;
  tx[i] = h.tx;
  xrow[i] = h.xrow;
}

template <bool kTri, bool kWalk, bool kBox>
int launch(const float* tab, int P, int stride, const mrt::Layout& lay,
           const float* tri, const float* bb, const float* sbb,
           const float* o, const float* d,
           int ray_stride, int comp_stride, int R, int mode, float* te,
           int* row, float* tx, int* xrow, const float* srows,
           const float* ssb, const float* bw, int n_bw,
           cudaStream_t stream) {
  const int ns = (lay.sph_n + mrt::kSubRows - 1) / mrt::kSubRows;
  const size_t smem =
      kBox ? (static_cast<size_t>(mrt::box_smem_floats(n_bw, kThreads)) +
              static_cast<size_t>(lay.box_start) * mrt::kSweepCols) *
                 sizeof(float)
      : kWalk ? (static_cast<size_t>(ns + lay.n_sb + 1) * mrt::kBbCols +
               static_cast<size_t>(lay.n_sb) * kThreads +
               static_cast<size_t>(P - lay.pln_start) * mrt::kSweepCols) *
                  sizeof(float)
            : (static_cast<size_t>(P) * mrt::kSweepCols +
               static_cast<size_t>(kTri ? lay.n_cb : lay.n_sb) *
                   mrt::kBbCols) *
                  sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        closest_hit_kernel<kTri, kWalk, kBox>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (R + kThreads - 1) / kThreads;
  closest_hit_kernel<kTri, kWalk, kBox><<<blocks, kThreads, smem, stream>>>(
      tab, P, stride, lay, tri, bb, sbb, o, d, ray_stride, comp_stride, R,
      mode, te, row, tx, xrow, srows, ssb, bw, n_bw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// P: the dense rows (tri_start); tri: the (Pt, 16) triangle table, or null
// with tri_n = 0; bb: the (n_cb, 8) block AABBs, or null with n_cb = 0;
// sbb: the sphere segment's (n_sb, 8) block AABBs, or null with n_sb = 0;
// with sbb, srows and ssb its packed rows and sub-block AABBs
// (hit3.sph_walk_tables, 16-byte aligned), else nulls; bw / n_bw: a walked
// box segment's tables (hit3.box_walk_tables, 16-byte aligned) and its
// boxes, or null and 0.
extern "C" int mrt_closest_hit(const float* tab, int P, int stride,
                               int sph_start, int sph_n, int pln_start,
                               int pln_n, int box_start, int box_n,
                               const float* tri, int tri_start, int tri_n,
                               const float* bb, int n_cb, const float* sbb,
                               int n_sb, const float* o,
                               const float* d, int ray_stride,
                               int comp_stride, int R, int mode, float* te,
                               int* row, float* tx, int* xrow,
                               const float* srows, const float* ssb,
                               const float* bw, int n_bw, void* stream) {
  const mrt::Layout lay{sph_start, sph_n, pln_start, pln_n, box_start,
                        box_n,     tri_start, tri_n, n_cb,    n_sb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_bw > 0 && (bw == nullptr || tri_n > 0 || n_sb > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tri_n > 0)
    return launch<true, false, false>(tab, P, stride, lay, tri, bb, sbb, o,
                                      d, ray_stride, comp_stride, R, mode,
                                      te, row, tx, xrow, srows, ssb, bw,
                                      n_bw, s);
  if (n_sb > 0) {
    if (srows == nullptr || ssb == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch<false, true, false>(tab, P, stride, lay, tri, bb, sbb, o,
                                      d, ray_stride, comp_stride, R, mode,
                                      te, row, tx, xrow, srows, ssb, bw,
                                      n_bw, s);
  }
  if (n_bw > 0)
    return launch<false, false, true>(tab, P, stride, lay, tri, bb, sbb, o,
                                      d, ray_stride, comp_stride, R, mode,
                                      te, row, tx, xrow, srows, ssb, bw,
                                      n_bw, s);
  return launch<false, false, false>(tab, P, stride, lay, tri, bb, sbb, o, d,
                                     ray_stride, comp_stride, R, mode, te,
                                     row, tx, xrow, srows, ssb, bw, n_bw, s);
}
