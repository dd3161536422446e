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

// Cull blocks per superblock (ops/tri.py SUPER), superblocks per chunk
// (a lane's mask), and the superblocks a kernel block stages in shared
// memory (8 KB) with the bounds of their chunks; past them a lane reads
// superblock AABBs from global memory and tests no chunk bound.
constexpr int kSupBlocks = 16;
constexpr int kChunk = 64;
constexpr int kSupStaged = 256;
constexpr int kChunksStaged = kSupStaged / kChunk;

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// Four floats at a 16-byte aligned address: one 16-byte load. ld4g reads
// global memory through the read-only cache; ld4 any address space.
struct F4 {
  float x, y, z, w;
};

__device__ __forceinline__ F4 ld4(const float* p) {
#ifdef __CUDA_ARCH__
  const float4 v = *reinterpret_cast<const float4*>(p);
  return F4{v.x, v.y, v.z, v.w};
#else
  return F4{p[0], p[1], p[2], p[3]};
#endif
}

__device__ __forceinline__ F4 ld4g(const float* p) {
#ifdef __CUDA_ARCH__
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  return F4{v.x, v.y, v.z, v.w};
#else
  return F4{p[0], p[1], p[2], p[3]};
#endif
}

// The superblocks' AABBs [lo | hi | pad] (n, kBbCols) (ops/tri.py
// superbounds): the first n_staged from `staged` (shared memory in the
// kernels), the rest from `all` (global memory); `chunks` the bounds of
// the staged runs of kChunk superblocks (chunk_bounds).
struct Supers {
  const float* staged;
  const float* all;
  const float* chunks;
  int n, n_staged;
  __device__ __forceinline__ const float* at(int s) const {
    return (s < n_staged ? staged : all) + s * kBbCols;
  }
};

// The AABB of each run of kChunk of the n staged superblock AABBs `sup`
// into `out` (ceil(n / kChunk), kBbCols): the componentwise min of their
// lo, max of their hi (a superblock's lo never passes its hi), no
// arithmetic; component j of chunk c by thread (c * 6 + j) % nthreads.
__device__ __forceinline__ void chunk_bounds(const float* sup, int n,
                                             float* out, int tid,
                                             int nthreads) {
  const int nc = (n + kChunk - 1) / kChunk;
  for (int k = tid; k < nc * 6; k += nthreads) {
    const int c = k / 6, j = k % 6;
    const int s1 = imin(n, (c + 1) * kChunk);
    float v = sup[c * kChunk * kBbCols + j];
    for (int s = c * kChunk + 1; s < s1; ++s) {
      const float x = sup[s * kBbCols + j];
      v = j < 3 ? fminf(v, x) : fmaxf(v, x);
    }
    out[c * kBbCols + j] = v;
  }
}

// The slab interval (tmin, tmax) of the ray (o, 1/d) against AABB `bb`,
// read as two 16-byte loads (`global`: through the read-only cache):
// hit3.cuh block_touch's operations in its order, so the same bits.
template <bool kGlobal>
__device__ __forceinline__ void slab(const float* bb, float ox, float oy,
                                     float oz, float ix, float iy, float iz,
                                     float& tmin, float& tmax) {
  const F4 a = kGlobal ? ld4g(bb) : ld4(bb);
  const F4 b = kGlobal ? ld4g(bb + 4) : ld4(bb + 4);
  const float lo[3] = {a.x, a.y, a.z}, hi[3] = {a.w, b.x, b.y};
  const float o[3] = {ox, oy, oz};
  const float inv[3] = {ix, iy, iz};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float t1 = (lo[k] - o[k]) * inv[k];
    const float t2 = (hi[k] - o[k]) * inv[k];
    const float near = nan_min(t1, t2), far = nan_max(t1, t2);
    tmin = k == 0 ? near : nan_max(tmin, near);
    tmax = k == 0 ? far : nan_min(tmax, far);
  }
}

// The walk's test of an AABB: the entry's (hit3.cuh block_touch: does the
// ray enter it at or before `best`?) or the exit's (does it meet it and
// leave it at or after `best`?).
template <bool kExit, bool kGlobal>
__device__ __forceinline__ bool walk_test(const float* bb, float ox,
                                          float oy, float oz, float ix,
                                          float iy, float iz, float best) {
  float tmin, tmax;
  slab<kGlobal>(bb, ox, oy, oz, ix, iy, iz, tmin, tmax);
  return tmax >= nan_max(tmin, 0.0f) && (kExit ? tmax >= best : tmin <= best);
}

// hit3.cuh tri_hit (the Woop test of _tri_block) with the row read as four
// 16-byte loads: the same operations in the same order, so the same t bit
// for bit. `gid` gets the row's group id.
__device__ __forceinline__ bool tri_hit4(const float* a, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz, float& t, float& gid) {
  const F4 r0 = ld4g(a), r1 = ld4g(a + 4), r2 = ld4g(a + 8),
           r3 = ld4g(a + 12);
  gid = r3.y;
  const float pox = r0.x * ox + r0.y * oy + r0.z * oz + r2.y;
  const float poy = r0.w * ox + r1.x * oy + r1.y * oz + r2.z;
  const float poz = r1.z * ox + r1.w * oy + r2.x * oz + r2.w;
  const float pdx = r0.x * dx + r0.y * dy + r0.z * dz;
  const float pdy = r0.w * dx + r1.x * dy + r1.y * dz;
  const float pdz = r1.z * dx + r1.w * dy + r2.x * dz;
  if (!(fabsf(pdz) >= r3.x)) return false;
  t = -poz / pdz;
  const float u = pox + t * pdx;
  const float v = poy + t * pdy;
  return u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f && t >= 0.0f;
}

// The two-level walk over cull blocks [0, nb) of the triangle segment,
// restricted to rows [r0, r1) (rows of group `wg` only where kExit). Per
// run of kChunk superblocks a lane tests the run's bound (where staged),
// then its superblocks against its best so far (staged AABBs, a warp-wide
// broadcast) into a mask, and takes the set bits lowest first: the
// superblock is tested again at the lane's best then, its blocks are
// tested into a second mask, and each set block, lowest first, is tested
// again and its rows swept. Entry: the smallest t, strict `<`; exit: the
// largest, strict `>`. A lane walks its own masks, so a warp whose rays
// part ways (bounced rays) pays for its busiest lane's superblocks and
// blocks, not for the union of its lanes'.
//
// Why the walk is the one-level walk (hit3.cuh tri_entry; the culled exit
// of ops/hit3.py _tri_exit), bit for bit: a superblock's AABB is the
// componentwise min / max of its blocks' corners, a chunk's of its
// superblocks', and the slab test is monotone in the box under IEEE
// rounding (a difference and a product by the same inverse per axis, then
// minima and maxima), so an outer AABB's tmin is never above and its tmax
// never below any inner one's. Both tests are monotone in `best` too,
// which only falls (entry) or rises (exit) as the walk goes on. So an
// AABB that fails, at a mask or later, holds no block the one-level walk
// would sweep from then on, and each block the walk reaches is tested at
// the best the one-level walk would test it with: the same blocks, in the
// same order, the same rows.
template <bool kExit>
__device__ __forceinline__ void tri_walk(const Tris& T, const Layout& L,
                                         const Supers& S, int nb, int r0,
                                         int r1, float wg, float ox,
                                         float oy, float oz, float dx,
                                         float dy, float dz, float& best,
                                         int& row) {
  static_assert(kSupBlocks <= 32, "a block mask is 32 bits");
  static_assert(kChunk == 64, "a superblock mask is 64 bits");
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  const int b0 = r0 / kCullRows, b1 = imin(nb, (r1 - 1) / kCullRows + 1);
  const int s0 = b0 / kSupBlocks, s1 = (b1 - 1) / kSupBlocks + 1;
  for (int c = s0 / kChunk * kChunk; c < s1; c += kChunk) {
    const bool chunked =
        c + kChunk <= S.n_staged || (S.n_staged == S.n && c < S.n);
    if (chunked && !walk_test<kExit, false>(S.chunks + c / kChunk * kBbCols,
                                            ox, oy, oz, ix, iy, iz, best))
      continue;
    unsigned long long m = 0u;
    for (int k = imax(s0 - c, 0); k < kChunk && c + k < s1; ++k)
      if (walk_test<kExit, false>(S.at(c + k), ox, oy, oz, ix, iy, iz,
                                  best))
        m |= 1ull << k;
    for (; m; m &= m - 1u) {
      const int s = c + low_bit(m);
      if (!walk_test<kExit, false>(S.at(s), ox, oy, oz, ix, iy, iz, best))
        continue;
      const int bs = imax(s * kSupBlocks, b0);
      const int be = imin((s + 1) * kSupBlocks, b1);
      unsigned bm = 0u;
      for (int b = bs; b < be; ++b)
        if (walk_test<kExit, true>(T.bb + b * kBbCols, ox, oy, oz, ix, iy,
                                   iz, best))
          bm |= 1u << (b - bs);
      for (; bm; bm &= bm - 1u) {
        const int b = bs + low_bit(bm);
        if (!walk_test<kExit, true>(T.bb + b * kBbCols, ox, oy, oz, ix, iy,
                                    iz, best))
          continue;
        const int hi = imin(b * kCullRows + kCullRows, r1);
        for (int i = imax(b * kCullRows, r0); i < hi; ++i) {
          float t, gid;
          const bool hit =
              tri_hit4(T.tab + i * kTriCols, ox, oy, oz, dx, dy, dz, t, gid);
          if (kExit) {
            const float v = hit ? t : -kBig;
            if (gid == wg && v > best) {
              best = v;
              row = L.tri_start + i;
            }
          } else if (hit && t < best) {
            best = t;
            row = L.tri_start + i;
          }
        }
      }
    }
  }
}

// The cull blocks the walk covers: those of the first tri_n rows.
__device__ __forceinline__ int walk_blocks(const Layout& L) {
  return imin(L.n_cb, (L.tri_n + kCullRows - 1) / kCullRows);
}

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
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

enum Mode { kEntry = 0, kEntryExit = 1 };

constexpr int kThreads = 128;

// Shared memory of a walking block: the first kSupStaged superblock AABBs
// and their chunks' bounds.
struct Staged {
  float sup[mrt::kSupStaged * mrt::kBbCols];
  float chunks[mrt::kChunksStaged * mrt::kBbCols];
};

// Stage the first kSupStaged superblock AABBs of `sb` (n_sb of them, 16
// bytes a cp.async) and their chunks' bounds, block-wide; the Supers that
// reads them.
__device__ __forceinline__ mrt::Supers stage_supers(Staged& st,
                                                    const float* sb,
                                                    int n_sb) {
  const int staged = n_sb < mrt::kSupStaged ? n_sb : mrt::kSupStaged;
  for (int k = threadIdx.x; k < staged * mrt::kBbCols / 4; k += blockDim.x)
    __pipeline_memcpy_async(st.sup + 4 * k, sb + 4 * k, 16);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  mrt::chunk_bounds(st.sup, staged, st.chunks, threadIdx.x, blockDim.x);
  __syncthreads();
  return mrt::Supers{st.sup, sb, st.chunks, n_sb, staged};
}

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
  __shared__ __align__(16) Staged st;
  const mrt::Supers S = stage_supers(st, sb, n_sb);
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
