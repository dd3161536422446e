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
//  * the exits test only the group's rows: a mesh's rows are contiguous
//    and each row holds its group's [start, end), so the fused exit needs
//    no (Pt x rays) scratch (the TPU kernel's _FUSED_MAX_PT bound); row 8
//    finds a ray's group by its id in a run table sorted by id
//    (ops/tri.py group_runs), once per ray;
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
// Row 8 (mrt_tri_exit) is the unculled witness of row 7's culled exit and
// the counterpart of pallas_tri.tri_group_exit; no render route runs it.
// Its first design gave each ray a thread that walked its group's rows
// alone: only the rays with a group worked (about 4.8e4 of mesh_big's
// 1.17M camera rays, some 11 warps an SM), and every test of a miss paid
// the IEEE division. It ran at 6% of its bound (operations: 47 a ray and
// row). Its design now: five launches in one call, no host sync. The live
// rays with a group are counted into their groups and queued, bucketed by
// group (exit_count_kernel, exit_plan_kernel, exit_fill_kernel), so a ray
// without one costs a binary search and nothing after; persistent blocks
// (exit_sweep_kernel) split the work over (tile of 256 queued rays x
// slice of 128 rows of their group) items, stage each item's rows in
// shared memory by cp.async (double-buffered), test a ray a thread
// against each row by broadcast reads (exit_hit: tri_hit's operations,
// the division included), and merge the slices exactly through a 64-bit
// atomicMax on (|t| bits, ~row) (exit_key); exit_finish_kernel then takes
// the winner row's own t. Outputs equal the plain version bit for bit and
// do not depend on the order of the atomics.
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

// --- Row 8: the exit of a given group, never culled -----------------------
//
// The rays that have a group are gathered into one queue, bucketed by
// group; a work item is a tile of kExitThreads queued rays of one group
// against a slice of kExitRows of that group's rows, staged in shared
// memory. Each ray keeps its farthest hit of a slice, and the slices merge
// through a 64-bit atomicMax on the packed key exit_key: the bits of |t|
// above ~row, so the larger key is the farther hit and, of equal t, the
// lower row (-0 and +0 tie, as under the plain version's `>`). The merge
// is exact and does not depend on the order the slices arrive in.

// Threads of a sweep block, a ray each (the rays of a work item), and
// rows of a work item (staged: 8 KB, twice for the double buffer). Two to
// four rays a thread, 64 or 256 rows and 64 or 128 threads measured
// slower, 512 threads 2% faster (PERF.md, PR 15).
constexpr int kExitThreads = 256;
constexpr int kExitRows = 128;

// hit3.cuh tri_hit (tri_walk.cuh tri_hit4) on the triangle row whose
// first twelve columns are r0, r1, r2 and whose threshold is thr: the
// same operations in the same order, so the same t bit for bit. Straight
// through: no pre-test before the IEEE division. Three conservative ones
// were built and measured at mesh_big's frame (PERF.md, PR 15): a ray
// that heads at a closed mesh crosses nearly every plane of it ahead of
// its origin (a t-sign test rejects little), and a test on where u and v
// move (or on beating the ray's best t) rejects for some lanes of a warp
// only, which then runs the division anyway and pays for the branches:
// each was slower than no test.
__device__ __forceinline__ bool exit_hit(const F4& r0, const F4& r1,
                                         const F4& r2, float thr, float ox,
                                         float oy, float oz, float dx,
                                         float dy, float dz, float& t) {
  const float pox = r0.x * ox + r0.y * oy + r0.z * oz + r2.y;
  const float poy = r0.w * ox + r1.x * oy + r1.y * oz + r2.z;
  const float poz = r1.z * ox + r1.w * oy + r2.x * oz + r2.w;
  const float pdx = r0.x * dx + r0.y * dy + r0.z * dz;
  const float pdy = r0.w * dx + r1.x * dy + r1.y * dz;
  const float pdz = r1.z * dx + r1.w * dy + r2.x * dz;
  if (!(fabsf(pdz) >= thr)) return false;
  t = -poz / pdz;
  const float u = pox + t * pdx;
  const float v = poy + t * pdy;
  return u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f && t >= 0.0f;
}

// The farthest hit of the ray (o, d) among n staged rows `rows`
// (kTriCols floats each, one group's rows in ascending order) that are
// the table's rows `ids`: (bt, br) moves where a row's t is larger
// (strict `>`, so the lower row keeps a tie, -0 and +0 alike); br stays
// -1 without a hit.
__device__ __forceinline__ void exit_rows(const float* rows, const int* ids,
                                          int n, const float* o,
                                          const float* d, float& bt,
                                          int& br) {
  for (int p = 0; p < n; ++p) {
    const float* r = rows + p * kTriCols;
    float t;
    if (exit_hit(ld4(r), ld4(r + 4), ld4(r + 8), r[T_THR], o[0], o[1], o[2],
                 d[0], d[1], d[2], t) &&
        t > bt) {
      bt = t;
      br = ids[p];
    }
  }
}

// The merge key of a hit at t (>= 0 or -0: every hit's) on row `row`, and
// the row of a key; 0 is no hit (a hit's low half, ~row, is not 0).
__device__ __forceinline__ unsigned long long exit_key(float t, int row) {
  const unsigned tb = static_cast<unsigned>(__float_as_int(t)) & 0x7fffffffu;
  return (static_cast<unsigned long long>(tb) << 32) |
         static_cast<unsigned>(~row);
}

__device__ __forceinline__ int exit_key_row(unsigned long long key) {
  return ~static_cast<int>(static_cast<unsigned>(key));
}

// The run table of ops/tri.py group_runs: the runs of equal group ids among
// the rows swept, sorted by id (NaN last), then by row; run k holds rows
// [start[k], end[k]) of id key[k].
struct Runs {
  const float* key;
  const int* start;
  const int* end;
  int n;
};

// The group of id wg: its first run (a binary search: found once per ray,
// not per row run), -1 if no run has that id. The group's runs are that
// run and the next ones of the same id.
__device__ __forceinline__ int exit_group(const Runs& G, float wg) {
  int lo = 0, hi = G.n;
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if (G.key[m] < wg)
      lo = m + 1;
    else
      hi = m;
  }
  return lo < G.n && G.key[lo] == wg ? lo : -1;
}

// The rows of group g (its runs' lengths summed), and the table row at
// position p of them (its runs' rows in ascending order).
__device__ __forceinline__ int exit_group_rows(const Runs& G, int g) {
  int rows = 0;
  for (int k = g; k < G.n && G.key[k] == G.key[g]; ++k)
    rows += G.end[k] - G.start[k];
  return rows;
}

__device__ __forceinline__ int exit_group_row(const Runs& G, int g, int p) {
  for (int k = g;; ++k) {
    const int len = G.end[k] - G.start[k];
    if (p < len) return G.start[k] + p;
    p -= len;
  }
}

// A ray's (tx, xrow) from its merged key: the winner row's own t (tri_hit's
// bits, so a -0 stays -0), -BIG and 0 without a hit.
__device__ __forceinline__ void exit_finish(const float* tri,
                                            unsigned long long key,
                                            const float* o, const float* d,
                                            float& tx, int& xrow) {
  tx = -kBig;
  xrow = 0;
  if (key == 0ull) return;
  const int row = exit_key_row(key);
  const float* r = tri + static_cast<size_t>(row) * kTriCols;
  float t;
  if (exit_hit(ld4g(r), ld4g(r + 4), ld4g(r + 8), __ldg(r + T_THR), o[0],
               o[1], o[2], d[0], d[1], d[2], t)) {
    tx = t;
    xrow = row;
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

// Row 8's workspace (device memory the wrapper allocates; ints, then the
// keys): per run-table entry g the rays of group g (cnt), the cursor that
// fills its part of the queue (cur) and its part's offset (roff); the
// groups that have rays (act, n_act of them) with, per such group, its rows,
// row slices, queue offset and first work item; the items in all; each
// ray's group (grp, -1: none) and the queue; each ray's merged key. cnt,
// cur, n_act and n_items are zeroed before the first kernel.
struct ExitWork {
  mrt::Runs G;
  int* cnt;
  int* cur;
  int* n_act;
  int* n_items;
  int* act;
  int* a_rows;
  int* a_slices;
  int* a_roff;
  int* a_ioff;
  int* roff;
  int* grp;
  int* queue;
  unsigned long long* key;
};

constexpr int kRayThreads = 256;
constexpr int kPlanThreads = 256;

// Step 1, a thread per ray: a live ray finds its group (exit_group), counts
// itself into it, and the group's first ray lists the group as active.
__global__ void exit_count_kernel(ExitWork w, mrt::TriRays q,
                                  const float* __restrict__ wg, int R) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const size_t b = static_cast<size_t>(i) * q.s_ray;
  int g = -1;
  if (q.live == nullptr || q.live[b] > 0.5f) g = mrt::exit_group(w.G, wg[i]);
  w.grp[i] = g;
  w.key[i] = 0ull;
  if (g >= 0 && atomicAdd(w.cnt + g, 1) == 0) w.act[atomicAdd(w.n_act, 1)] = g;
}

// Step 2, one block: each active group's rows, slices, queue offset and
// first item (exclusive sums over the active list, in its order, which is
// the atomics' and does not change any ray's result).
__global__ void __launch_bounds__(kPlanThreads) exit_plan_kernel(ExitWork w) {
  __shared__ int s_r[kPlanThreads], s_i[kPlanThreads];
  const int na = *w.n_act;
  int base_r = 0, base_i = 0;
  for (int a0 = 0; a0 < na; a0 += kPlanThreads) {
    const int a = a0 + threadIdx.x;
    int nr = 0, ni = 0;
    if (a < na) {
      const int g = w.act[a];
      const int rows = mrt::exit_group_rows(w.G, g);
      const int slices = (rows + mrt::kExitRows - 1) / mrt::kExitRows;
      nr = w.cnt[g];
      ni = (nr + mrt::kExitThreads - 1) / mrt::kExitThreads * slices;
      w.a_rows[a] = rows;
      w.a_slices[a] = slices;
    }
    s_r[threadIdx.x] = nr;
    s_i[threadIdx.x] = ni;
    __syncthreads();
    // inclusive sums, Hillis-Steele
    for (int off = 1; off < kPlanThreads; off <<= 1) {
      const int vr = threadIdx.x >= off ? s_r[threadIdx.x - off] : 0;
      const int vi = threadIdx.x >= off ? s_i[threadIdx.x - off] : 0;
      __syncthreads();
      s_r[threadIdx.x] += vr;
      s_i[threadIdx.x] += vi;
      __syncthreads();
    }
    if (a < na) {
      const int ro = base_r + s_r[threadIdx.x] - nr;
      w.a_roff[a] = ro;
      w.a_ioff[a] = base_i + s_i[threadIdx.x] - ni;
      w.roff[w.act[a]] = ro;
    }
    base_r += s_r[kPlanThreads - 1];
    base_i += s_i[kPlanThreads - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) *w.n_items = base_i;
}

// Step 3, a thread per ray: a ray with a group takes a slot of its group's
// part of the queue. The lanes of a warp that share a group take
// consecutive slots in lane order (one atomic a group and warp), so a
// sweep warp's rays come from a few runs of neighbouring rays.
__global__ void exit_fill_kernel(ExitWork w, int R) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = i < R ? w.grp[i] : -1;
  const unsigned queued = __ballot_sync(0xffffffffu, g >= 0);
  if (g < 0) return;
  const unsigned peers = __match_any_sync(queued, g);
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(w.cur + g, __popc(peers));
  base = __shfl_sync(peers, base, leader);
  w.queue[w.roff[g] + base + __popc(peers & ((1u << lane) - 1u))] = i;
}

// Step 4, the sweep: persistent blocks, block b taking the items [W b / G,
// W (b + 1) / G) of the W in all. Item order is slice fastest, so a block's
// consecutive items share their rays, which stay in registers until the
// tile changes and then merge into their keys. Each item's rows are staged
// by cp.async, 16 bytes a copy, the next item's while this one's are
// tested (two buffers).
__global__ void __launch_bounds__(mrt::kExitThreads)
    exit_sweep_kernel(const float* __restrict__ tri, ExitWork w,
                      mrt::TriRays q) {
  __shared__ __align__(16) float rows[2][mrt::kExitRows * mrt::kTriCols];
  __shared__ int ids[2][mrt::kExitRows];
  const int W = *w.n_items, na = *w.n_act;
  const int w0 = static_cast<int>(static_cast<long long>(W) * blockIdx.x /
                                  gridDim.x);
  const int w1 = static_cast<int>(static_cast<long long>(W) *
                                  (blockIdx.x + 1) / gridDim.x);
  if (w0 >= w1) return;
  // item -> (active group a, ray tile, row slice)
  auto locate = [&](int it, int& a, int& tile, int& slice) {
    int lo = 0, hi = na - 1;
    while (lo < hi) {
      const int m = (lo + hi + 1) >> 1;
      if (w.a_ioff[m] <= it)
        lo = m;
      else
        hi = m - 1;
    }
    a = lo;
    const int local = it - w.a_ioff[a];
    tile = local / w.a_slices[a];
    slice = local - tile * w.a_slices[a];
  };
  auto stage = [&](int it, int buf) {
    int a, tile, slice;
    locate(it, a, tile, slice);
    const int g = w.act[a];
    const int p0 = slice * mrt::kExitRows;
    const int m = mrt::imin(mrt::kExitRows, w.a_rows[a] - p0);
    for (int p = threadIdx.x; p < m; p += blockDim.x) {
      const int row = mrt::exit_group_row(w.G, g, p0 + p);
      ids[buf][p] = row;
      const float* src = tri + static_cast<size_t>(row) * mrt::kTriCols;
      float* dst = rows[buf] + p * mrt::kTriCols;
#pragma unroll
      for (int c = 0; c < mrt::kTriCols; c += 4)
        __pipeline_memcpy_async(dst + c, src + c, 16);
    }
    __pipeline_commit();
  };
  float o[3], d[3], bt = -mrt::kBig;
  int br = -1, ray = -1;
  auto flush = [&]() {
    if (br >= 0) atomicMax(w.key + ray, mrt::exit_key(bt, br));
  };
  int q_at = -1;
  stage(w0, 0);
  for (int it = w0; it < w1; ++it) {
    const int buf = (it - w0) & 1;
    if (it + 1 < w1) {
      stage(it + 1, buf ^ 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    int a, tile, slice;
    locate(it, a, tile, slice);
    const int q0 = w.a_roff[a] + tile * mrt::kExitThreads;
    if (q0 != q_at) {
      flush();
      q_at = q0;
      const int nq = mrt::imin(mrt::kExitThreads,
                               w.cnt[w.act[a]] - tile * mrt::kExitThreads);
      bt = -mrt::kBig;
      br = -1;
      ray = static_cast<int>(threadIdx.x) < nq ? w.queue[q0 + threadIdx.x]
                                               : -1;
      if (ray < 0 || !mrt::tri_ray(q, ray, o, d)) {
        // an empty slot: a NaN direction fails every row's test
        for (int c = 0; c < 3; ++c) {
          o[c] = 0.0f;
          d[c] = __int_as_float(0x7fc00000);
        }
      }
    }
    mrt::exit_rows(
        rows[buf], ids[buf],
        mrt::imin(mrt::kExitRows, w.a_rows[a] - slice * mrt::kExitRows), o,
        d, bt, br);
    __syncthreads();
  }
  flush();
}

// Step 5, a thread per ray: tx and xrow from the merged key (exit_finish);
// a ray without a group misses.
__global__ void exit_finish_kernel(const float* __restrict__ tri,
                                   ExitWork w, mrt::TriRays q, int R,
                                   float* __restrict__ tx,
                                   int* __restrict__ xrow) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  float o[3], d[3], t = -mrt::kBig;
  int r = 0;
  if (w.grp[i] >= 0 && mrt::tri_ray(q, i, o, d))
    mrt::exit_finish(tri, w.key[i], o, d, t, r);
  tx[i] = t;
  xrow[i] = r;
}

// Sweep blocks resident per SM (computed once per device).
int exit_blocks_per_sm(int* sms) {
  static int cached[64][2];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && cached[dev][0] > 0) {
    *sms = cached[dev][1];
    return cached[dev][0];
  }
  int blocks = 0, n_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, exit_sweep_kernel,
                                                mrt::kExitThreads, 0);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (dev < 64) {
    cached[dev][0] = blocks;
    cached[dev][1] = n_sm;
  }
  *sms = n_sm;
  return blocks;
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
// the rows of the run table (key, start, end) (n_runs entries, ops/tri.py
// group_runs), never culled; ws the workspace of 8 n_runs + 2 + 2 R ints
// and keys (R,) 64-bit; out tx (R,), row (R,).
extern "C" int mrt_tri_exit(const float* tri, const float* rkey,
                            const int* rstart, const int* rend, int n_runs,
                            const float* o, const float* d, int s_ray,
                            int s_comp, const float* live, const float* wg,
                            int R, int* ws, unsigned long long* keys,
                            float* tx, int* row, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int m = n_runs;
  ExitWork w{mrt::Runs{rkey, rstart, rend, m}, ws, ws + m, ws + 2 * m,
             ws + 2 * m + 1, ws + 2 * m + 2, ws + 3 * m + 2, ws + 4 * m + 2,
             ws + 5 * m + 2, ws + 6 * m + 2, ws + 7 * m + 2, ws + 8 * m + 2,
             ws + 8 * m + 2 + R, keys};
  const mrt::TriRays q{o, d, s_ray, s_comp, live};
  cudaMemsetAsync(ws, 0, (2 * static_cast<size_t>(m) + 2) * sizeof(int), st);
  const int rb = (R + kRayThreads - 1) / kRayThreads;
  exit_count_kernel<<<rb, kRayThreads, 0, st>>>(w, q, wg, R);
  exit_plan_kernel<<<1, kPlanThreads, 0, st>>>(w);
  exit_fill_kernel<<<rb, kRayThreads, 0, st>>>(w, R);
  int sms = 0;
  const int per_sm = exit_blocks_per_sm(&sms);
  exit_sweep_kernel<<<per_sm * sms, mrt::kExitThreads, 0, st>>>(tri, w, q);
  exit_finish_kernel<<<rb, kRayThreads, 0, st>>>(tri, w, q, R, tx, row);
  return static_cast<int>(cudaGetLastError());
}

// Warps per SM that the card keeps resident of row 8's sweep kernel.
extern "C" int mrt_tri_exit_occupancy(int* warps) {
  int sms = 0;
  *warps = exit_blocks_per_sm(&sms) * mrt::kExitThreads / 32;
  return static_cast<int>(cudaGetLastError());
}
#endif  // __CUDACC__
