// The triangle segment on its own: the nearest valid triangle of each ray
// (mrt_tri_entry), the nearest plus the farthest valid triangle of the
// winner's own group (mrt_tri_entry_exit), and the farthest valid triangle
// of a given group (mrt_tri_exit). The per-step path launches the first or
// the second before each bounce step of a scene whose triangle segment has
// more cull blocks than the step kernel stages (ops/step.py, a mesh of more
// than 16,384 triangles), and step_fwd.cu's kTriIn instances read their
// output.
//
// Replaces: micro_raytracer_tpu/ops/pallas_tri.py :: _entry_kernel (l.207,
// called by _call_entry, pallas_call l.336), _entry_exit_kernel (l.226,
// _call_entry_exit, l.352) and _exit_kernel (l.274, _call_exit, l.370).
// Semantics as there: the Woop test of _tri_block in its operation order
// (hit3.cuh tri_hit), entry = min t over valid rows with the first row on
// ties (rows ascend, strict `<`), exit = max t over the valid rows of the
// group, ties to the lowest row (strict `>`); misses give te = BIG, row = 0,
// tx = -BIG, xrow = 0. Rows are triangle-local.
//
// What differs from the TPU kernel, by design:
//  * one thread per ray and no tiles: the TPU kernel swept (512-row x
//    512-ray) blocks held in VMEM and reduced them with min / argmin; here
//    a lane walks the rows and keeps its best in registers;
//  * the entry sweeps cull per ray (hit3.cuh block_touch over the 64-row
//    blocks' world AABBs, ascending blocks, a block skipped when the ray
//    misses it or enters it beyond its best t), as the port's other
//    triangle sweeps do. The TPU kernel swept every row; the two differ only
//    on "phantom" |det| >= E hits outside their block's AABB, and the plain
//    versions (ops/tri.py) apply the same rule;
//  * the exit never culls and tests only the winner group's rows: a mesh's
//    rows are contiguous and each row holds its group's [start, end), so
//    the fused exit needs no (Pt x rays) scratch (the TPU kernel's
//    _FUSED_MAX_PT bound) and the group exit skips every other group's run
//    with one read;
//  * with `refr` (a float per row, 1 where the row's material can refract)
//    the fused exit runs only for a winner that can refract; any other
//    winner takes its own row as its exit (tx = te, xrow = row, what a
//    one-row group gives), which the step never reads: an opaque mesh in a
//    scene with glass elsewhere costs an entry, not a whole-group walk;
//  * the triangle table (64 B a row, 4 MB for 65,536 rows) and the block
//    AABBs (32 B a block) are read from global memory through L1 and L2, not
//    staged in shared memory, so there is no bound on the rows or blocks.
//
// Rays are (R, 3) views of any stride (o[i * s_ray + k * s_comp]), such as
// the rows o and d of the per-step carry (14, R) (s_ray 1, s_comp R); with
// `live` (a float per ray at live[i * s_ray], the carry's live row) a dead
// lane writes the miss values and tests nothing.
//
// What bounds it on the H100: operations. A ray slab-tests every block
// (about 30 float operations each) and runs ~47 per row of the blocks it
// enters; a refracting ray adds its group's rows (65,536 for one mesh of
// that size). A ray costs 28 bytes in and 8 (entry) or 16 out. Neighbouring
// rays walk the same blocks, so a warp's rows are L1 broadcasts; divergence
// (lanes entering different blocks, the exit of some lanes only) is what
// the design does not address: the block walk is linear, not a tree.
//
// Numerics: float32, -fmad=false, as every source here.
#include "hit3.cuh"

namespace mrt {

// Rays of the triangle kernels (see the header).
struct TriRays {
  const float* o;
  const float* d;
  int s_ray, s_comp;
  const float* live;
};

// Ray i of `q` into (o, d); false for a dead lane.
__device__ __forceinline__ bool tri_ray(const TriRays& q, int i, float* o,
                                        float* d) {
  const size_t b = static_cast<size_t>(i) * q.s_ray;
  if (q.live != nullptr && !(q.live[b] > 0.5f)) return false;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = q.o[b + static_cast<size_t>(k) * q.s_comp];
    d[k] = q.d[b + static_cast<size_t>(k) * q.s_comp];
  }
  return true;
}

// The triangle segment is a Layout of its own: rows [0, tri_n) in n_cb
// blocks (no dense rows), so its rows are triangle-local.

// Row 6: the nearest valid triangle, culled per ray where the segment has
// blocks; a miss keeps te = BIG and row 0.
__device__ __forceinline__ void tri_entry_ray(const Tris& T, const Layout& L,
                                              const float* o, const float* d,
                                              float& te, int& row) {
  te = kBig;
  row = 0;
  tri_entry(T, L, L.n_cb > 0, o[0], o[1], o[2], d[0], d[1], d[2], te, row);
}

// Row 7: the entry, then the farthest valid row of the winner's group
// (hit3.cuh tri_exit over its [start, end)); no group on a miss. With
// `refr` (null: every row refracts) a winner whose row cannot refract is
// its own exit.
__device__ __forceinline__ Hit tri_entry_exit_ray(const Tris& T,
                                                  const Layout& L,
                                                  const float* refr,
                                                  const float* o,
                                                  const float* d) {
  Hit h{kBig, 0, -kBig, 0};
  tri_entry_ray(T, L, o, d, h.te, h.row);
  if (!(h.te < kBig)) return h;
  if (refr != nullptr && !(__ldg(refr + h.row) > 0.5f)) {
    h.tx = h.te;
    h.xrow = h.row;
  } else {
    tri_exit(T, L, h.row, o[0], o[1], o[2], d[0], d[1], d[2], h.tx, h.xrow);
  }
  return h;
}

// Row 8: the farthest valid row of group `wg`, run by run: a run of
// another group is skipped at its first row (its end column).
__device__ __forceinline__ void tri_group_exit_ray(const Tris& T,
                                                   const Layout& L, float wg,
                                                   const float* o,
                                                   const float* d, float& tx,
                                                   int& row) {
  tx = -kBig;
  row = 0;
  for (int i = 0; i < L.tri_n;) {
    const float* r = T.tab + i * kTriCols;
    if (__ldg(r + T_GID) == wg)
      tri_exit(T, L, i, o[0], o[1], o[2], d[0], d[1], d[2], tx, row);
    const int end = static_cast<int>(__ldg(r + T_GE));
    i = end > i ? end : i + 1;
  }
}

}  // namespace mrt

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

enum Mode { kEntry = 0, kEntryExit = 1, kGroupExit = 2 };

// One thread per ray. kEntry writes (te, row), kEntryExit (te, row, tx,
// xrow), kGroupExit (tx, xrow) of group wg[i].
template <int kMode>
__global__ void tri_kernel(mrt::Tris T, mrt::Layout L, mrt::TriRays q,
                           const float* __restrict__ refr,
                           const float* __restrict__ wg, int R,
                           float* __restrict__ te, int* __restrict__ row,
                           float* __restrict__ tx, int* __restrict__ xrow) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  float o[3], d[3];
  mrt::Hit h{mrt::kBig, 0, -mrt::kBig, 0};
  if (mrt::tri_ray(q, i, o, d)) {
    if (kMode == kEntry)
      mrt::tri_entry_ray(T, L, o, d, h.te, h.row);
    else if (kMode == kEntryExit)
      h = mrt::tri_entry_exit_ray(T, L, refr, o, d);
    else
      mrt::tri_group_exit_ray(T, L, wg[i], o, d, h.tx, h.xrow);
  }
  if (kMode != kGroupExit) {
    te[i] = h.te;
    row[i] = h.row;
  }
  if (kMode != kEntry) {
    tx[i] = h.tx;
    xrow[i] = h.xrow;
  }
}

template <int kMode>
int launch(const float* tri, int n, const float* bb, int n_cb,
           const float* o, const float* d, int s_ray, int s_comp,
           const float* live, const float* refr, const float* wg, int R,
           float* te, int* row, float* tx, int* xrow, void* stream) {
  const int threads = 128;
  const int blocks = (R + threads - 1) / threads;
  tri_kernel<kMode><<<blocks, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      mrt::Tris{tri, bb},
      mrt::Layout{0, 0, 0, 0, 0, 0, 0, n, kMode == kGroupExit ? 0 : n_cb, 0},
      mrt::TriRays{o, d, s_ray, s_comp, live}, refr, wg, R, te, row, tx,
      xrow);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The triangle table tri (Pt, 16) (hit3.tri_tables), its first n rows
// swept; its n_cb cull blocks bb (n_cb, 8) (null and 0: no culling); the
// rays o, d at o[i * s_ray + k * s_comp]; live (null: every ray) the
// liveness of each ray at live[i * s_ray]; out te (R,) and row (R,).
extern "C" int mrt_tri_entry(const float* tri, int n, const float* bb,
                             int n_cb, const float* o, const float* d,
                             int s_ray, int s_comp, const float* live, int R,
                             float* te, int* row, void* stream) {
  return launch<kEntry>(tri, n, bb, n_cb, o, d, s_ray, s_comp, live,
                        nullptr, nullptr, R, te, row, nullptr, nullptr,
                        stream);
}

// As mrt_tri_entry, and out the winner group's exit tx (R,), xrow (R,);
// refr (Pt,) (null: every row) 1 on the rows whose group exit is swept,
// the others their own exit.
extern "C" int mrt_tri_entry_exit(const float* tri, int n, const float* bb,
                                  int n_cb, const float* o, const float* d,
                                  int s_ray, int s_comp, const float* live,
                                  const float* refr, int R, float* te,
                                  int* row, float* tx, int* xrow,
                                  void* stream) {
  return launch<kEntryExit>(tri, n, bb, n_cb, o, d, s_ray, s_comp, live,
                            refr, nullptr, R, te, row, tx, xrow, stream);
}

// The exit of group wg (R,) (a group id as the table holds it, float) over
// the first n rows of tri, never culled; out tx (R,), row (R,).
extern "C" int mrt_tri_exit(const float* tri, int n, const float* o,
                            const float* d, int s_ray, int s_comp,
                            const float* live, const float* wg, int R,
                            float* tx, int* row, void* stream) {
  return launch<kGroupExit>(tri, n, nullptr, 0, o, d, s_ray, s_comp, live,
                            nullptr, wg, R, nullptr, nullptr, tx, row,
                            stream);
}
#endif  // __CUDACC__
