// closest_hit: the closest-hit query as a kernel of its own, over a batch
// of rays. On the render path it is the primary-hit pass: it finds every
// camera ray's first hit, and the whole-trace kernel (trace_fwd.cu) starts
// its step loop from that hit.
//
// Replaces: micro_raytracer_tpu/ops/pallas_hit3.py :: _call_hit / _hit_kernel
// (dense segments, the triangle segment with its candidate-block cull, the
// group exit; the winner-t VJP _winner_t_all is not ported). The sweep
// itself lives in hit3.cuh, shared with the whole-trace kernel; see there
// for the semantics, the per-ray cull and what bounds it.
//
// One thread per ray, 256 threads per block; the block stages the sweep
// columns of the dense rows (spheres, planes, boxes) of the row table into
// a dense (n_dense, 18) shared table once (n_dense*72 bytes of dynamic
// shared memory; the wrapper raises above hit3.MAX_ROWS rows), and the
// triangle segment's block AABBs after it (n_cb*32 bytes, at most
// hit3.MAX_TRI_BLOCKS); the triangle table stays in global memory. The
// table's rows are `stride` floats apart, so the trace kernel's wider row
// table serves as it is. Ray component c of ray i is read at
// o[i * ray_stride + c * comp_stride]: (R, 3) row-major rays and views of
// (3, R) lane-major ones both pass without a copy.
// mode 0: entry only (tx = te, xrow = row); 1: entry and group exit;
// 2: any-hit (te = -BIG on a hit, BIG otherwise; row = xrow = 0).
// A scene without triangles runs the kTri = false instance, the code of
// the dense-only kernel.
#include <cuda_runtime.h>

#include "hit3.cuh"

namespace {

template <bool kTri>
__global__ void closest_hit_kernel(const float* __restrict__ tab, int P,
                                   int stride, mrt::Layout lay,
                                   const float* __restrict__ tri,
                                   const float* __restrict__ bb,
                                   const float* __restrict__ o,
                                   const float* __restrict__ d,
                                   int ray_stride, int comp_stride, int R,
                                   int mode, float* __restrict__ te,
                                   int* __restrict__ row,
                                   float* __restrict__ tx,
                                   int* __restrict__ xrow) {
  extern __shared__ float s_tab[];
  mrt::stage(s_tab, tab, P, stride, mrt::kSweepCols);
  mrt::Tris T{tri, s_tab + P * mrt::kSweepCols};
  if (kTri)
    mrt::stage(s_tab + P * mrt::kSweepCols, bb, lay.n_cb, mrt::kBbCols,
               mrt::kBbCols);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const size_t b = static_cast<size_t>(i) * ray_stride;
  const float ox = o[b], oy = o[b + comp_stride], oz = o[b + 2 * comp_stride];
  const float dx = d[b], dy = d[b + comp_stride], dz = d[b + 2 * comp_stride];
  mrt::Hit h;
  if (mode == 2) {
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

template <bool kTri>
int launch(const float* tab, int P, int stride, const mrt::Layout& lay,
           const float* tri, const float* bb, const float* o, const float* d,
           int ray_stride, int comp_stride, int R, int mode, float* te,
           int* row, float* tx, int* xrow, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(P) * mrt::kSweepCols +
       (kTri ? static_cast<size_t>(lay.n_cb) * mrt::kBbCols : 0)) *
      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        closest_hit_kernel<kTri>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int threads = 256;
  const int blocks = (R + threads - 1) / threads;
  closest_hit_kernel<kTri><<<blocks, threads, smem, stream>>>(
      tab, P, stride, lay, tri, bb, o, d, ray_stride, comp_stride, R, mode,
      te, row, tx, xrow);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// P: the dense rows (tri_start); tri: the (Pt, 16) triangle table, or null
// with tri_n = 0; bb: the (n_cb, 8) block AABBs, or null with n_cb = 0.
extern "C" int mrt_closest_hit(const float* tab, int P, int stride,
                               int sph_start, int sph_n, int pln_start,
                               int pln_n, int box_start, int box_n,
                               const float* tri, int tri_start, int tri_n,
                               const float* bb, int n_cb, const float* o,
                               const float* d, int ray_stride,
                               int comp_stride, int R, int mode, float* te,
                               int* row, float* tx, int* xrow, void* stream) {
  const mrt::Layout lay{sph_start, sph_n, pln_start, pln_n, box_start,
                        box_n,     tri_start, tri_n, n_cb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tri_n > 0 ? launch<true>(tab, P, stride, lay, tri, bb, o, d,
                                  ray_stride, comp_stride, R, mode, te, row,
                                  tx, xrow, s)
                   : launch<false>(tab, P, stride, lay, tri, bb, o, d,
                                   ray_stride, comp_stride, R, mode, te, row,
                                   tx, xrow, s);
}
