// closest_hit: the closest-hit query as a kernel of its own, over a batch
// of rays. On the render path it is the primary-hit pass: it finds every
// camera ray's first hit, and the whole-trace kernel (trace_fwd.cu) starts
// its step loop from that hit.
//
// Replaces: micro_raytracer_tpu/ops/pallas_hit3.py :: _call_hit / _hit_kernel
// (dense segments, the long sphere segment's block cull, the triangle
// segment with its candidate-block cull, the group exit; the winner-t VJP
// of make_closest_hit, _winner_t_all, is hit3_bwd.cu). The sweep
// itself lives in hit3.cuh, shared with the whole-trace kernel; see there
// for the semantics, the per-ray cull and what bounds it.
//
// The instances with a cull, a walk or triangles: one thread per ray, 256
// threads per block; the block stages the sweep columns of the dense rows
// (spheres, planes, boxes) of the row table into a dense (n_dense, 18)
// shared table once (n_dense*72 bytes of dynamic shared memory, at most
// hit3.MAX_ROWS rows), and the triangle segment's block AABBs after it
// (n_cb*32 bytes, at most hit3.MAX_TRI_BLOCKS) or, without triangles, the
// sphere segment's (n_sb*32 bytes, at most 32); the triangle table stays
// in global memory. The table's rows are `stride` floats apart, so the trace kernel's wider row
// table serves as it is. Ray component c of ray i is read at
// o[i * ray_stride + c * comp_stride]: (R, 3) row-major rays and views of
// (3, R) lane-major ones both pass without a copy.
// mode 0: entry only (tx = te, xrow = row); 1: entry and group exit;
// 2: any-hit (te = -BIG on a hit, BIG otherwise; row = xrow = 0).
// A scene without triangles, cull blocks or walks runs the dense
// schedule below. A scene without triangles or textures whose sphere
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
// The dense instance (no triangles, no cull blocks, no walk, at most
// kMaxStaged rows: the room, tex_dof, the record path's shadow rays on
// them) runs a schedule of its own, closest_hit_dense_kernel: a persistent
// grid (mrt::resident_blocks) whose blocks stage the sweep rows once,
// kRowStride floats a row so that a row is five 16-byte shared loads, and
// whose warps then take kPair * 32 rays at a time, lane l rays base + l
// and base + 32 + l (coalesced), the two rays' row tests interleaved on
// the row they share (dense_hit_pair below). What bounds it on the H100:
// instruction issue (a box row is three IEEE divisions and about a
// hundred instructions a ray; the room's ray tests eight rows), not its
// 40 bytes a ray. So the schedule cuts instructions: a row loaded once
// for two rays, the part of a row test that depends on the frame and the
// direction alone (d' = M d, a box's slab reciprocals, a sphere's a)
// computed once for the rows of one frame (the staged rows carry a flag
// where a row's frame equals the previous row's: the room's walls and
// spheres share the identity), and the group exit, every group of such a
// layout being one row, the winner row's own t1 from its entry test (no
// exit pass). Each ray's tested values, its rows' order and the strict
// `<` tie rule are mrt::closest_hit's, so te, row, tx and xrow equal the
// per-ray instances' bit for bit.
// Past kMaxStaged dense rows (the record path takes every scene size, as
// the JAX package's pallas_hit3 up to 4,096 padded rows and its jnp sweep
// past them): a culled sphere segment of more than 32 blocks (up to
// hit3.SPH_MAX_BLOCKS = 64, the 3,384-row inst_grid3k: 53) runs the kWalk
// instance with a 64-bit block mask (kWide), which stages no dense table;
// a scene with no walk runs the kGlobal instance, which stages nothing and
// reads the dense sweep rows from global memory through L1/L2 (as
// step_fwd.cu does), `stride` floats a row, and its cull blocks there too,
// so it also takes a triangle segment past hit3.MAX_TRI_BLOCKS (the record
// path's shadow rays on the big meshes). The instances below the bounds
// keep their code.
#include "hit3.cuh"

namespace mrt {

// The dense schedule's staged row: the kSweepCols sweep columns, a flag
// (kSameFrame: the row's frame equals the previous row's bit for bit) and
// a float of padding, 16-byte aligned.
constexpr int kRowStride = 20;
constexpr int kSameFrame = kSweepCols;
// rays a thread carries through one sweep of the rows
constexpr int kPair = 2;

// Column k of staged row r from the row table `tab` (rows of `stride`
// floats): the sweep columns, the frame flag, 0 for the padding.
__device__ __forceinline__ float staged_col(const float* tab, int stride,
                                            int r, int k) {
  if (k < kSweepCols) return tab[r * stride + k];
  if (k != kSameFrame || r == 0) return 0.0f;
  bool same = true;
  for (int c = C_FR; c < C_FR + 9; ++c)
    same &= __float_as_int(tab[r * stride + c]) ==
            __float_as_int(tab[(r - 1) * stride + c]);
  return same ? 1.0f : 0.0f;
}

// Row `r` of the staged table (kRowStride floats, 16-byte aligned) into
// registers.
__device__ __forceinline__ void load_row(const float* r,
                                         float (&v)[kRowStride]) {
#ifdef __CUDACC__
  const float4* q = reinterpret_cast<const float4*>(r);
#pragma unroll
  for (int k = 0; k < kRowStride / 4; ++k) {
    const float4 x = q[k];
    v[4 * k] = x.x;
    v[4 * k + 1] = x.y;
    v[4 * k + 2] = x.z;
    v[4 * k + 3] = x.w;
  }
#else
  for (int k = 0; k < kRowStride; ++k) v[k] = r[k];
#endif
}

// max / min that give NaN when either input is NaN (nan_max / nan_min's
// rule; the NaN's bits may differ, and no NaN t reaches a hit: row_hit
// rejects a non-finite t)
__device__ __forceinline__ float max_nan(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return nan_max(a, b);
#endif
}

__device__ __forceinline__ float min_nan(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return nan_min(a, b);
#endif
}

// What row_hit<K> computes from a row's frame and the ray's direction
// alone: d' = M d and, for a sphere, its quadratic's a and guarded 2a,
// for a box, its three guarded slab reciprocals. Rows of one frame share
// it (kSameFrame).
struct DirPart {
  float dpx, dpy, dpz, m[3];
};

template <int K>
__device__ __forceinline__ DirPart row_dir(const float* r, float dx,
                                           float dy, float dz) {
  DirPart q;
  q.dpx = r[0] * dx + r[1] * dy + r[2] * dz;
  q.dpy = r[3] * dx + r[4] * dy + r[5] * dz;
  q.dpz = r[6] * dx + r[7] * dy + r[8] * dz;
  if (K == kSphere) {
    q.m[0] = q.dpx * q.dpx + q.dpy * q.dpy + q.dpz * q.dpz;
    q.m[1] = q.m[0] == 0.0f ? 1.0f : 2.0f * q.m[0];
  } else if (K == kBox) {
    const float dp[3] = {q.dpx, q.dpy, q.dpz};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float mm = 1.0f / (dp[c] == 0.0f ? 1.0f : dp[c]);
      q.m[c] = dp[c] == 0.0f ? kInvEps : mm;
    }
  }
  return q;
}

// row_hit<K> of row `r` from its direction part q (row_dir<K> of the
// row's frame): every value as row_hit computes it, so the same hit and t
// bit for bit.
template <int K>
__device__ __forceinline__ bool row_hit_dir(const float* r, const DirPart& q,
                                            float ox, float oy, float oz,
                                            float& t0, float& t1) {
  const float ix = r[C_IP], iy = r[C_IP + 1], iz = r[C_IP + 2];
  const float rx = ox - ix, ry = oy - iy, rz = oz - iz;
  const float opx = r[0] * rx + r[1] * ry + r[2] * rz + ix;
  const float opy = r[3] * rx + r[4] * ry + r[5] * rz + iy;
  const float opz = r[6] * rx + r[7] * ry + r[8] * rz + iz;
  const float dpx = q.dpx, dpy = q.dpy, dpz = q.dpz;
  bool ok;
  if (K == kSphere) {
    const float rad = r[C_PR];
    const float ox_ = opx - ix, oy_ = opy - iy, oz_ = opz - iz;
    const float a = q.m[0];
    const float bq = 2.0f * (ox_ * dpx + oy_ * dpy + oz_ * dpz);
    const float c = ox_ * ox_ + oy_ * oy_ + oz_ * oz_ - rad * rad;
    const float disc = bq * bq - 4.0f * a * c;
    const float sq = sqrtf(disc >= 0.0f ? nan_max(disc, 1e-12f) : 1.0f);
    const float a2 = q.m[1];
    t0 = (-bq - sq) / a2;
    t1 = (-bq + sq) / a2;
    ok = (disc >= 0.0f) && (t0 >= 0.0f);
  } else if (K == kPlane) {
    const float a0 = r[C_PA], a1 = r[C_PA + 1], a2 = r[C_PA + 2];
    const float nn = a0 * a0 + a1 * a1 + a2 * a2;
    const float inv = 1.0f / sqrtf(nn > 0.0f ? nn : 1.0f);
    const float nx = a0 * inv, ny = a1 * inv, nz = a2 * inv;
    const float dd = -(nx * ix + ny * iy + nz * iz);
    const float dn = dpx * nx + dpy * ny + dpz * nz;
    t0 = -(opx * nx + opy * ny + opz * nz + dd) / (dn == 0.0f ? 1.0f : dn);
    t1 = t0;
    ok = (t0 > 0.0f) && (dn != 0.0f);
  } else {
    const float op[3] = {opx, opy, opz};
    const float ip[3] = {ix, iy, iz};
    float lo = 0.0f, hi = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float mm = q.m[c];
      const float nb = (op[c] - ip[c]) * mm;
      const float kk = 0.5f * r[C_PA + c] * fabsf(mm);
      const float lo_c = -nb - kk, hi_c = -nb + kk;
      lo = c == 0 ? lo_c : max_nan(lo, lo_c);
      hi = c == 0 ? hi_c : min_nan(hi, hi_c);
    }
    t0 = lo;
    t1 = hi;
    ok = !((t0 > t1) || (t1 < 0.0f));
  }
  return ok && r[C_VALID] > 0.5f && isfinite(t0) && isfinite(t1);
}

// kPair rays: their origins and directions.
struct RayPair {
  float ox[kPair], oy[kPair], oz[kPair], dx[kPair], dy[kPair], dz[kPair];
};

// entry_seg of the pair: each row loaded once and tested for both rays,
// the rays' direction parts kept across the segment's rows of one frame;
// kExit: the winner's exit t1 kept beside its t0 in xt.
template <int K, bool kExit>
__device__ __forceinline__ void entry_seg_pair(const float* rows, int start,
                                               int n, const RayPair& p,
                                               float (&best)[kPair],
                                               int (&row)[kPair],
                                               float (&xt)[kPair]) {
  DirPart q[kPair];
  for (int i = start; i < start + n; ++i) {
    float v[kRowStride];
    load_row(rows + i * kRowStride, v);
    const bool same = i > start && v[kSameFrame] != 0.0f;
#pragma unroll
    for (int k = 0; k < kPair; ++k) {
      if (!same) q[k] = row_dir<K>(v, p.dx[k], p.dy[k], p.dz[k]);
      float t0, t1;
      if (row_hit_dir<K>(v, q[k], p.ox[k], p.oy[k], p.oz[k], t0, t1) &&
          t0 < best[k]) {
        best[k] = t0;
        row[k] = i;
        if (kExit) xt[k] = t1;
      }
    }
  }
}

// The entry sweep of the pair over the three dense segments.
template <bool kExit>
__device__ __forceinline__ void entry_pair(const float* rows,
                                           const Layout& L, const RayPair& p,
                                           float (&best)[kPair],
                                           int (&row)[kPair],
                                           float (&xt)[kPair]) {
#pragma unroll
  for (int k = 0; k < kPair; ++k) {
    best[k] = kBig;
    row[k] = 0;
    xt[k] = -kBig;
  }
  entry_seg_pair<kSphere, kExit>(rows, L.sph_start, L.sph_n, p, best, row,
                                 xt);
  entry_seg_pair<kPlane, kExit>(rows, L.pln_start, L.pln_n, p, best, row,
                                xt);
  entry_seg_pair<kBox, kExit>(rows, L.box_start, L.box_n, p, best, row, xt);
}

// any_seg of the pair: the rows until both rays are occluded, the
// direction parts kept as in entry_seg_pair.
template <int K>
__device__ __forceinline__ void any_seg_pair(const float* rows, int start,
                                             int n, const RayPair& p,
                                             bool (&hit)[kPair]) {
  DirPart q[kPair];
  for (int i = start; i < start + n; ++i) {
    bool all = true;
#pragma unroll
    for (int k = 0; k < kPair; ++k) all &= hit[k];
    if (all) return;
    float v[kRowStride];
    load_row(rows + i * kRowStride, v);
    const bool same = i > start && v[kSameFrame] != 0.0f;
#pragma unroll
    for (int k = 0; k < kPair; ++k) {
      if (!same) q[k] = row_dir<K>(v, p.dx[k], p.dy[k], p.dz[k]);
      float t0, t1;
      if (!hit[k])
        hit[k] = row_hit_dir<K>(v, q[k], p.ox[k], p.oy[k], p.oz[k], t0, t1);
    }
  }
}

// closest_hit<kNeedExit, false> and any_hit<false> of kPair rays over the
// staged dense rows `rows` (kRowStride floats a row; the layout without
// triangles or cull blocks): mode 0 entry only, 1 entry and group exit, 2
// any-hit (te = tx = -BIG on a hit, BIG otherwise; row = xrow = 0). Per
// ray the same tests on the same values in the same order as those, so
// the same hits bit for bit. Every group of such a layout is one row (the
// compiler gives each non-mesh object instance its own group), so the
// group exit is the winner row's own t1 from its entry test, which is
// what closest_hit's exit pass finds there (a miss: -BIG, row 0).
__device__ __forceinline__ void dense_hit_pair(const float* rows,
                                               const Layout& L, int mode,
                                               const RayPair& p,
                                               Hit (&h)[kPair]) {
  if (mode == 2) {
    bool hit[kPair];
#pragma unroll
    for (int k = 0; k < kPair; ++k) hit[k] = false;
    any_seg_pair<kSphere>(rows, L.sph_start, L.sph_n, p, hit);
    any_seg_pair<kPlane>(rows, L.pln_start, L.pln_n, p, hit);
    any_seg_pair<kBox>(rows, L.box_start, L.box_n, p, hit);
#pragma unroll
    for (int k = 0; k < kPair; ++k) {
      const float t = hit[k] ? -kBig : kBig;
      h[k] = Hit{t, 0, t, 0};
    }
    return;
  }
  float best[kPair], xt[kPair];
  int row[kPair];
  if (mode == 0) {
    entry_pair<false>(rows, L, p, best, row, xt);
#pragma unroll
    for (int k = 0; k < kPair; ++k)
      h[k] = Hit{best[k], row[k], best[k], row[k]};
    return;
  }
  entry_pair<true>(rows, L, p, best, row, xt);
#pragma unroll
  for (int k = 0; k < kPair; ++k) h[k] = Hit{best[k], row[k], xt[k], row[k]};
}

}  // namespace mrt

#ifdef __CUDACC__
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

#include "box_walk.cuh"
#include "grid.cuh"
#include "sph_walk.cuh"

namespace {

constexpr int kThreads = 256;
// the dense rows and triangle cull blocks the staged instances hold in
// shared memory (hit3.MAX_ROWS, hit3.MAX_TRI_BLOCKS)
constexpr int kMaxStaged = 2048;
constexpr int kMaxStagedBlocks = 256;

template <bool kTri, bool kWalk, bool kBox, bool kWide = false,
          bool kGlobal = false>
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
  } else if constexpr (!kGlobal) {
    mrt::stage(s_tab, tab, P, stride, mrt::kSweepCols);
    if (kTri)
      mrt::stage(s_tab + P * mrt::kSweepCols, bb, lay.n_cb, mrt::kBbCols,
                 mrt::kBbCols);
    else
      mrt::stage(s_tab + P * mrt::kSweepCols, sbb, lay.n_sb, mrt::kBbCols,
                 mrt::kBbCols);
    __syncthreads();
  }
  // the sweep rows and the cull blocks (kGlobal: both in global memory)
  const float* rows = kGlobal ? tab : s_tab;
  const int rs = kGlobal ? stride : mrt::kSweepCols;
  mrt::Tris T{tri, kGlobal ? (kTri ? bb : sbb) : s_tab + P * mrt::kSweepCols};
  using Mask = typename std::conditional<kWide || kGlobal,
                                         unsigned long long, unsigned>::type;
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
      const bool hit =
          mrt::walk_any_hit<Mask>(lay, W, ox, oy, oz, dx, dy, dz);
      h = mrt::Hit{hit ? -mrt::kBig : mrt::kBig, 0,
                   hit ? -mrt::kBig : mrt::kBig, 0};
    } else if (mode == 1) {
      h = mrt::walk_closest_hit<true, Mask>(lay, W, ox, oy, oz, dx, dy, dz);
    } else {
      h = mrt::walk_closest_hit<false, Mask>(lay, W, ox, oy, oz, dx, dy, dz);
    }
  } else if (mode == 2) {
    const bool hit = mrt::any_hit<kTri, !kTri, Mask>(rows, rs, lay, ox, oy,
                                                     oz, dx, dy, dz, T);
    h.te = hit ? -mrt::kBig : mrt::kBig;
    h.row = 0;
    h.tx = h.te;
    h.xrow = 0;
  } else if (mode == 1) {
    h = mrt::closest_hit<true, kTri, !kTri, Mask>(rows, rs, lay, ox, oy, oz,
                                                  dx, dy, dz, T);
  } else {
    h = mrt::closest_hit<false, kTri, !kTri, Mask>(rows, rs, lay, ox, oy, oz,
                                                   dx, dy, dz, T);
  }
  te[i] = h.te;
  row[i] = h.row;
  tx[i] = h.tx;
  xrow[i] = h.xrow;
}

// The dense instance's schedule (see the top of the file): a persistent
// grid; each block stages the P sweep rows (kRowStride floats a row) once,
// then each warp takes kPair * 32 rays at a time, striding over the warps
// of the grid.
__global__ void __launch_bounds__(kThreads) closest_hit_dense_kernel(
    const float* __restrict__ tab, int P, int stride, mrt::Layout lay,
    const float* __restrict__ o, const float* __restrict__ d,
    int ray_stride, int comp_stride, int R, int mode,
    float* __restrict__ te, int* __restrict__ row, float* __restrict__ tx,
    int* __restrict__ xrow) {
  extern __shared__ float4 s_rows4[];
  float* s_rows = reinterpret_cast<float*>(s_rows4);
  for (int c = threadIdx.x; c < P * mrt::kRowStride; c += blockDim.x) {
    const int r = c / mrt::kRowStride;
    s_rows[c] = mrt::staged_col(tab, stride, r, c - r * mrt::kRowStride);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int span = 32 * mrt::kPair;
  for (int base = (blockIdx.x * warps + (threadIdx.x >> 5)) * span;
       base < R; base += gridDim.x * warps * span) {
    mrt::RayPair p;
    int id[mrt::kPair];
#pragma unroll
    for (int k = 0; k < mrt::kPair; ++k) {
      // a lane past R tests the last ray (its result is not written)
      id[k] = base + 32 * k + lane;
      const size_t b = static_cast<size_t>(id[k] < R ? id[k] : R - 1) *
                       ray_stride;
      p.ox[k] = o[b];
      p.oy[k] = o[b + comp_stride];
      p.oz[k] = o[b + 2 * comp_stride];
      p.dx[k] = d[b];
      p.dy[k] = d[b + comp_stride];
      p.dz[k] = d[b + 2 * comp_stride];
    }
    mrt::Hit h[mrt::kPair];
    mrt::dense_hit_pair(s_rows, lay, mode, p, h);
#pragma unroll
    for (int k = 0; k < mrt::kPair; ++k) {
      if (id[k] >= R) continue;
      te[id[k]] = h[k].te;
      row[id[k]] = h[k].row;
      tx[id[k]] = h[k].tx;
      xrow[id[k]] = h[k].xrow;
    }
  }
}

int launch_dense(const float* tab, int P, int stride, const mrt::Layout& lay,
                 const float* o, const float* d, int ray_stride,
                 int comp_stride, int R, int mode, float* te, int* row,
                 float* tx, int* xrow, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(P) * mrt::kRowStride * sizeof(float);
  int per_sm = 0, sms = 0;
  const int e = mrt::resident_blocks(closest_hit_dense_kernel, kThreads,
                                     smem, &per_sm, &sms);
  if (e) return e;
  const int span = kThreads * mrt::kPair;
  const int blocks = std::max(
      1, std::min((R + span - 1) / span, sms * std::max(per_sm, 1)));
  closest_hit_dense_kernel<<<blocks, kThreads, smem, stream>>>(
      tab, P, stride, lay, o, d, ray_stride, comp_stride, R, mode, te, row,
      tx, xrow);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTri, bool kWalk, bool kBox, bool kWide = false,
          bool kGlobal = false>
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
      : kGlobal ? 0
            : (static_cast<size_t>(P) * mrt::kSweepCols +
               static_cast<size_t>(kTri ? lay.n_cb : lay.n_sb) *
                   mrt::kBbCols) *
                  sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        closest_hit_kernel<kTri, kWalk, kBox, kWide, kGlobal>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (R + kThreads - 1) / kThreads;
  closest_hit_kernel<kTri, kWalk, kBox, kWide, kGlobal>
      <<<blocks, kThreads, smem, stream>>>(
      tab, P, stride, lay, tri, bb, sbb, o, d, ray_stride, comp_stride, R,
      mode, te, row, tx, xrow, srows, ssb, bw, n_bw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Into *warps the warps per SM the card keeps resident of the dense
// schedule's kernel at P staged rows.
extern "C" int mrt_closest_hit_dense_warps(int P, int* warps) {
  int per_sm = 0;
  const int e = mrt::resident_blocks(
      closest_hit_dense_kernel, kThreads,
      static_cast<size_t>(P) * mrt::kRowStride * sizeof(float), &per_sm);
  *warps = per_sm * kThreads / 32;
  return e;
}

// t: the table arguments, packed once per table as 64-bit integers
// (ops/hit3.py HitArgs): the row table `tab` (rows of `stride` floats),
// its dense rows P (tri_start), the six dense ints (start and rows to
// sweep of the sphere, plane and box segments); the (Pt, 16) triangle
// table `tri` (or 0 with tri_n = 0), the triangle segment's first row and
// rows to sweep; bb: the (n_cb, 8) block AABBs (or 0 with n_cb = 0); sbb:
// the sphere segment's (n_sb, 8) block AABBs (or 0 with n_sb = 0), with
// sbb, srows and ssb its packed rows and sub-block AABBs
// (hit3.sph_walk_tables, 16-byte aligned), else 0s; bw / n_bw: a walked
// box segment's tables (hit3.box_walk_tables, 16-byte aligned) and its
// boxes, or 0 and 0.
extern "C" int mrt_closest_hit(const long long* t, const float* o,
                               const float* d, int ray_stride,
                               int comp_stride, int R, int mode, float* te,
                               int* row, float* tx, int* xrow,
                               void* stream) {
  if (t == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const auto at = [&](int k) { return reinterpret_cast<const float*>(t[k]); };
  const auto n = [&](int k) { return static_cast<int>(t[k]); };
  const float *tab = at(0), *tri = at(9), *bb = at(12), *sbb = at(14),
              *srows = at(16), *ssb = at(17), *bw = at(18);
  const int P = n(1), stride = n(2), sph_start = n(3), sph_n = n(4),
            pln_start = n(5), pln_n = n(6), box_start = n(7), box_n = n(8),
            tri_start = n(10), tri_n = n(11), n_cb = n(13), n_sb = n(15),
            n_bw = n(19);
  const mrt::Layout lay{sph_start, sph_n, pln_start, pln_n, box_start,
                        box_n,     tri_start, tri_n, n_cb,    n_sb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_bw > 0 && (bw == nullptr || tri_n > 0 || n_sb > 0 ||
                   P > kMaxStaged))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_sb > 64) return static_cast<int>(cudaErrorInvalidValue);
  if (tri_n > 0 && (P > kMaxStaged || n_cb > kMaxStagedBlocks))
    return launch<true, false, false, false, true>(
        tab, P, stride, lay, tri, bb, sbb, o, d, ray_stride, comp_stride, R,
        mode, te, row, tx, xrow, srows, ssb, bw, n_bw, s);
  if (tri_n > 0)
    return launch<true, false, false>(tab, P, stride, lay, tri, bb, sbb, o,
                                      d, ray_stride, comp_stride, R, mode,
                                      te, row, tx, xrow, srows, ssb, bw,
                                      n_bw, s);
  if (n_sb > 0) {
    if (srows == nullptr || ssb == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    if (n_sb > 32)
      return launch<false, true, false, true>(
          tab, P, stride, lay, tri, bb, sbb, o, d, ray_stride, comp_stride,
          R, mode, te, row, tx, xrow, srows, ssb, bw, n_bw, s);
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
  if (P > kMaxStaged)
    return launch<false, false, false, false, true>(
        tab, P, stride, lay, tri, bb, sbb, o, d, ray_stride, comp_stride, R,
        mode, te, row, tx, xrow, srows, ssb, bw, n_bw, s);
  return launch_dense(tab, P, stride, lay, o, d, ray_stride, comp_stride, R,
                      mode, te, row, tx, xrow, s);
}
#endif  // __CUDACC__
