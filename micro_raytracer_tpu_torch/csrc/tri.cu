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
//  * rows 6 and 7 cull per ray over the 64-row blocks' world AABBs
//    (hit3.tri_blockbounds), walked in two levels (tri_walk): superblocks
//    of kSupBlocks blocks, whose AABBs bound their blocks' (ops/tri.py
//    superbounds, built once per table), are tested first, and a lane
//    descends only into the superblocks it touches. The entry skips a
//    block the ray misses or enters beyond its best t, exactly as the
//    one-level walk of hit3.cuh tri_entry (which the port's other
//    triangle sweeps run): the same blocks in the same order, so the same
//    t and row bit for bit. The TPU kernel swept every row; the two differ
//    only on "phantom" |det| >= E hits outside their block's AABB, and the
//    plain versions (ops/tri.py) apply the same rule;
//  * row 7's group exit culls too, through the same two levels: a block
//    the ray misses, or leaves before the best exit t so far, is skipped
//    (ops/hit3.py _tri_exit with the cull blocks, the plain version's
//    rule). A group's farthest hit lies inside its block's AABB, so the
//    culled exit differs from the unculled one (row 8, and the TPU kernel)
//    only on a phantom exit hit;
//  * the exits test only the winner group's rows: a mesh's rows are
//    contiguous and each row holds its group's [start, end), so the fused
//    exit needs no (Pt x rays) scratch (the TPU kernel's _FUSED_MAX_PT
//    bound) and row 8 skips every other group's run with one read;
//  * with `refr` (a float per row, 1 where the row's material can refract)
//    the fused exit runs only for a winner that can refract; any other
//    winner takes its own row as its exit (tx = te, xrow = row, what a
//    one-row group gives), which the step never reads: an opaque mesh in a
//    scene with glass elsewhere costs an entry, not a group walk;
//  * the triangle table (64 B a row, 4 MB for 65,536 rows) and the block
//    AABBs (32 B a block) are read from global memory through L1 and L2;
//    the superblock AABBs (2 KB for 65,536 rows) are staged in shared
//    memory by each block of threads (cp.async), up to kSupStaged of them.
//
// Rays are (R, 3) views of any stride (o[i * s_ray + k * s_comp]), such as
// the rows o and d of the per-step carry (14, R) (s_ray 1, s_comp R); with
// `live` (a float per ray at live[i * s_ray]) a dead lane writes the miss
// values and tests nothing.
//
// What bounds it on the H100: operations. The one-level walk slab-tested
// every block (1,024 for 65,536 rows; ~23 float operations each) for every
// live ray, and its cost was those tests: with its rows removed it ran
// 2.4 ms of 2.8 at step 0 of mesh_big's frame, while the rows alone (a
// ray's winner block) ran 0.13 ms. At later steps bounced rays part ways,
// and a warp ran the rows of every block any lane entered. Row 7 swept a
// refracting winner's whole group (65,536 rows), so a warp paid that for
// one refracting lane: 97% of its time. The two-level walk tests one
// bound per 64 superblocks, the superblocks where a ray meets it
// (broadcasts from shared memory) and the blocks of the few superblocks it
// touches; each lane walks its own superblock and block masks, so a warp
// pays for its busiest lane, not for the union of its lanes' blocks; rows
// and AABBs are 16-byte loads; and the exit culls to the blocks the ray
// meets. A ray costs 28
// bytes in and 8 (entry) or 16 out. Tensor cores do not apply: the tests
// are float32 with -fmad=false and no TF32 (ROADMAP.md, the precision
// regression class), and a walk is branches, not products.
//
// The walk (tri_walk, with its superblock staging) lives in tri_walk.cuh,
// which step_fwd.cu's kTriIn shadow sweeps share (tri_any_walk).
//
// Numerics: float32, -fmad=false, as every source here.
#include "tri_walk.cuh"

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

// Row 6: the nearest valid triangle, through the two-level walk where the
// segment has cull blocks (hit3.cuh tri_entry unculled where it has
// none); a miss keeps te = BIG and row 0.
__device__ __forceinline__ void tri_entry_ray(const Tris& T, const Layout& L,
                                              const Supers& S,
                                              const float* o, const float* d,
                                              float& te, int& row) {
  te = kBig;
  row = 0;
  if (L.n_cb == 0) {
    tri_entry(T, L, false, o[0], o[1], o[2], d[0], d[1], d[2], te, row);
    return;
  }
  if (L.tri_n > 0)
    tri_walk<false>(T, L, S, walk_blocks(L), 0, L.tri_n, 0.0f, o[0], o[1],
                    o[2], d[0], d[1], d[2], te, row);
}

// Row 7: the entry, then the farthest valid row of the winner's group
// [start, end): culled through the same two levels where the segment has
// cull blocks (a block the ray misses, or leaves before the best exit t
// so far, is skipped), hit3.cuh tri_exit unculled where it has none; no
// group on a miss. With `refr` (null: every row refracts) a winner whose
// row cannot refract is its own exit.
__device__ __forceinline__ Hit tri_entry_exit_ray(const Tris& T,
                                                  const Layout& L,
                                                  const Supers& S,
                                                  const float* refr,
                                                  const float* o,
                                                  const float* d) {
  Hit h{kBig, 0, -kBig, 0};
  tri_entry_ray(T, L, S, o, d, h.te, h.row);
  if (!(h.te < kBig)) return h;
  if (refr != nullptr && !(__ldg(refr + h.row) > 0.5f)) {
    h.tx = h.te;
    h.xrow = h.row;
  } else if (L.n_cb == 0) {
    tri_exit(T, L, h.row, o[0], o[1], o[2], d[0], d[1], d[2], h.tx, h.xrow);
  } else {
    const float* wr = T.tab + h.row * kTriCols;
    const int gs = static_cast<int>(__ldg(wr + T_GS));
    const int ge = imin(static_cast<int>(__ldg(wr + T_GE)), L.tri_n);
    if (gs < ge)
      tri_walk<true>(T, L, S, walk_blocks(L), gs, ge, __ldg(wr + T_GID),
                     o[0], o[1], o[2], d[0], d[1], d[2], h.tx, h.xrow);
  }
  return h;
}

// Row 8: the farthest valid row of group `wg`, run by run: a run of
// another group is skipped at its first row (its end column). Never
// culled.
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

enum Mode { kEntry = 0, kEntryExit = 1 };

constexpr int kThreads = 128;

// Rows 6 (kEntry: te, row) and 7 (kEntryExit: te, row, tx, xrow), one
// thread per ray, after the block has staged the superblocks. (A queue of
// row 7's refracting winners, swept in full warps by a second kernel, was
// no faster: PERF.md, the triangle walk's ablations.)
template <int kMode>
__global__ void __launch_bounds__(kThreads)
    tri_walk_kernel(mrt::Tris T, mrt::Layout L, const float* __restrict__ sb,
                    int n_sb, mrt::TriRays q, const float* __restrict__ refr,
                    int R, float* __restrict__ te, int* __restrict__ row,
                    float* __restrict__ tx, int* __restrict__ xrow) {
  __shared__ __align__(16) mrt::Staged st;
  const mrt::Supers S = mrt::stage_supers(st, sb, n_sb);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  float o[3], d[3];
  mrt::Hit h{mrt::kBig, 0, -mrt::kBig, 0};
  if (mrt::tri_ray(q, i, o, d)) {
    if (kMode == kEntry)
      mrt::tri_entry_ray(T, L, S, o, d, h.te, h.row);
    else
      h = mrt::tri_entry_exit_ray(T, L, S, refr, o, d);
  }
  te[i] = h.te;
  row[i] = h.row;
  if (kMode == kEntryExit) {
    tx[i] = h.tx;
    xrow[i] = h.xrow;
  }
}

// Row 8, one thread per ray: the exit of group wg[i], never culled.
__global__ void tri_exit_kernel(mrt::Tris T, mrt::Layout L, mrt::TriRays q,
                                const float* __restrict__ wg, int R,
                                float* __restrict__ tx,
                                int* __restrict__ xrow) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  float o[3], d[3];
  mrt::Hit h{mrt::kBig, 0, -mrt::kBig, 0};
  if (mrt::tri_ray(q, i, o, d))
    mrt::tri_group_exit_ray(T, L, wg[i], o, d, h.tx, h.xrow);
  tx[i] = h.tx;
  xrow[i] = h.xrow;
}

mrt::Layout tri_layout(int n, int n_cb) {
  return mrt::Layout{0, 0, 0, 0, 0, 0, 0, n, n_cb, 0};
}

template <int kMode>
int launch_walk(const float* tri, int n, const float* bb, int n_cb,
                const float* sb, int n_sb, const float* o, const float* d,
                int s_ray, int s_comp, const float* live, const float* refr,
                int R, float* te, int* row, float* tx, int* xrow,
                void* stream) {
  tri_walk_kernel<kMode><<<(R + kThreads - 1) / kThreads, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      mrt::Tris{tri, bb}, tri_layout(n, n_cb), sb, n_sb,
      mrt::TriRays{o, d, s_ray, s_comp, live}, refr, R, te, row, tx, xrow);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The triangle table tri (Pt, 16) (hit3.tri_tables), its first n rows
// swept; its n_cb cull blocks bb (n_cb, 8) and their n_sb superblocks sb
// (n_sb, 8) (ops/tri.py superbounds) (null and 0: no culling), all 16-byte
// aligned; the rays o, d at o[i * s_ray + k * s_comp]; live (null: every
// ray) the liveness of each ray at live[i * s_ray]; out te (R,) and row
// (R,).
extern "C" int mrt_tri_entry(const float* tri, int n, const float* bb,
                             int n_cb, const float* sb, int n_sb,
                             const float* o, const float* d, int s_ray,
                             int s_comp, const float* live, int R, float* te,
                             int* row, void* stream) {
  return launch_walk<kEntry>(tri, n, bb, n_cb, sb, n_sb, o, d, s_ray,
                             s_comp, live, nullptr, R, te, row, nullptr,
                             nullptr, stream);
}

// As mrt_tri_entry, and out the winner group's exit tx (R,), xrow (R,);
// refr (Pt,) (null: every row) 1 on the rows whose group exit is swept,
// the others their own exit.
extern "C" int mrt_tri_entry_exit(const float* tri, int n, const float* bb,
                                  int n_cb, const float* sb, int n_sb,
                                  const float* o, const float* d, int s_ray,
                                  int s_comp, const float* live,
                                  const float* refr, int R, float* te,
                                  int* row, float* tx, int* xrow,
                                  void* stream) {
  return launch_walk<kEntryExit>(tri, n, bb, n_cb, sb, n_sb, o, d, s_ray,
                                 s_comp, live, refr, R, te, row, tx, xrow,
                                 stream);
}

// The exit of group wg (R,) (a group id as the table holds it, float) over
// the first n rows of tri, never culled; out tx (R,), row (R,).
extern "C" int mrt_tri_exit(const float* tri, int n, const float* o,
                            const float* d, int s_ray, int s_comp,
                            const float* live, const float* wg, int R,
                            float* tx, int* row, void* stream) {
  const int threads = 128;
  const int blocks = (R + threads - 1) / threads;
  tri_exit_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      mrt::Tris{tri, nullptr}, tri_layout(n, 0),
      mrt::TriRays{o, d, s_ray, s_comp, live}, wg, R, tx, row);
  return static_cast<int>(cudaGetLastError());
}
#endif  // __CUDACC__
