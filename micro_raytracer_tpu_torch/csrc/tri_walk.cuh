// The two-level walk over the triangle segment's 64-row cull blocks:
// superblocks of kSupBlocks blocks (ops/tri.py superbounds), their chunks'
// bounds, 16-byte loads of AABBs and rows. tri.cu's rows 6-7 (the entry
// and the culled group exit, tri_walk) and step_fwd.cu's kTriIn shadow
// sweeps (the any-hit, tri_any_walk) walk it; see tri.cu for the design
// and why it is the one-level walk of hit3.cuh bit for bit.
//
// Numerics: float32, -fmad=false, as every source here.
#pragma once

#include "hit3.cuh"

namespace mrt {

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

// Division-free occlusion test of triangle row `a` (hit3.cuh tri_any,
// _tri_block_any) with the row read as four 16-byte loads: the same
// operations in the same order.
__device__ __forceinline__ bool tri_any4(const float* a, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz) {
  const F4 r0 = ld4g(a), r1 = ld4g(a + 4), r2 = ld4g(a + 8),
           r3 = ld4g(a + 12);
  const float pox = r0.x * ox + r0.y * oy + r0.z * oz + r2.y;
  const float poy = r0.w * ox + r1.x * oy + r1.y * oz + r2.z;
  const float poz = r1.z * ox + r1.w * oy + r2.x * oz + r2.w;
  const float pdx = r0.x * dx + r0.y * dy + r0.z * dz;
  const float pdy = r0.w * dx + r1.x * dy + r1.y * dz;
  const float D = r1.z * dx + r1.w * dy + r2.x * dz;
  if (!(fabsf(D) >= r3.x)) return false;
  const float D2 = D * D;
  const float Pu = (pox * D - poz * pdx) * D;
  const float Pv = (poy * D - poz * pdy) * D;
  return Pu >= 0.0f && Pu <= D2 && Pv >= 0.0f && Pu + Pv <= D2 &&
         poz * D <= 0.0f;
}

// Any-hit over the triangle segment's rows in cull blocks [0, nb) through
// the two levels (the kTriIn shadow sweeps): per run of kChunk
// superblocks the run's bound (where staged), then its superblocks into a
// mask, each met superblock's blocks into a second mask, and each met
// block's rows until the first hit. The one-level walk (hit3.cuh
// tri_any_seg) sweeps the rows of every block the ray touches until a
// hit; an outer AABB the ray misses holds no block it touches (the slab
// test is monotone in the box, tri_walk), and an any-hit over the same
// rows does not depend on their order, so the two agree on every ray.
__device__ __forceinline__ bool tri_any_walk(const Tris& T, const Layout& L,
                                             const Supers& S, int nb,
                                             float ox, float oy, float oz,
                                             float dx, float dy, float dz) {
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  const int s1 = (nb - 1) / kSupBlocks + 1;
  for (int c = 0; c < s1; c += kChunk) {
    const bool chunked =
        c + kChunk <= S.n_staged || (S.n_staged == S.n && c < S.n);
    if (chunked && !walk_test<false, false>(S.chunks + c / kChunk * kBbCols,
                                            ox, oy, oz, ix, iy, iz, kBig))
      continue;
    unsigned long long m = 0u;
    for (int k = 0; k < kChunk && c + k < s1; ++k)
      if (walk_test<false, false>(S.at(c + k), ox, oy, oz, ix, iy, iz, kBig))
        m |= 1ull << k;
    for (; m; m &= m - 1u) {
      const int s = c + low_bit(m);
      const int bs = s * kSupBlocks, be = imin(bs + kSupBlocks, nb);
      unsigned bm = 0u;
      for (int b = bs; b < be; ++b)
        if (walk_test<false, true>(T.bb + b * kBbCols, ox, oy, oz, ix, iy,
                                   iz, kBig))
          bm |= 1u << (b - bs);
      for (; bm; bm &= bm - 1u) {
        const int lo = (bs + low_bit(bm)) * kCullRows;
        const int hi = imin(lo + kCullRows, L.tri_n);
        for (int i = lo; i < hi; ++i)
          if (tri_any4(T.tab + i * kTriCols, ox, oy, oz, dx, dy, dz))
            return true;
      }
    }
  }
  return false;
}

}  // namespace mrt

#ifdef __CUDACC__
#include <cuda_pipeline.h>

namespace mrt {

// Shared memory of a walking block: the first kSupStaged superblock AABBs
// and their chunks' bounds.
struct Staged {
  float sup[kSupStaged * kBbCols];
  float chunks[kChunksStaged * kBbCols];
};

// Stage the first kSupStaged superblock AABBs of `sb` (n_sb of them, 16
// bytes a cp.async) and their chunks' bounds, block-wide; the Supers that
// reads them.
__device__ __forceinline__ Supers stage_supers(Staged& st, const float* sb,
                                               int n_sb) {
  const int staged = n_sb < kSupStaged ? n_sb : kSupStaged;
  for (int k = threadIdx.x; k < staged * kBbCols / 4; k += blockDim.x)
    __pipeline_memcpy_async(st.sup + 4 * k, sb + 4 * k, 16);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  chunk_bounds(st.sup, staged, st.chunks, threadIdx.x, blockDim.x);
  __syncthreads();
  return Supers{st.sup, sb, st.chunks, n_sb, staged};
}

}  // namespace mrt
#endif  // __CUDACC__
