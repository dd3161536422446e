"""Closest-hit over the sphere/plane/box segments and the triangle segment:
the hand-written CUDA kernel ``csrc/hit3.cu`` (sweeps in ``csrc/hit3.cuh``),
its wrapper, and its plain PyTorch version.

The counterpart of ``micro_raytracer_tpu.ops.pallas_hit3``:
:func:`pack_scene` builds the per-row sweep tables (``fr, ipos, pa, pr,
valid, gid``) as the columns of one ``(P, 18)`` row table (a triangle
row's ``pa`` holds its raw normal, the shading normal's source),
:func:`tri_tables` the triangle segment's Woop table ``(Pt, 16)`` and the
world AABBs of its 64-row cull blocks, :func:`closest_hit` returns the
same ``(te, row, tx, xrow)`` quadruple — misses give ``te = BIG``, ``row =
0``, ``tx = -BIG``, ``xrow = 0`` — and :func:`any_hit` the occlusion bit.
Both take any row table whose first 18 columns are the sweep columns, such
as the whole-trace kernel's.

Long sphere segments (at least :data:`DENSE_CULL_MIN` rows and at most
:data:`SPH_MAX_BLOCKS` blocks, :func:`sph_cull_rows`) of scenes without
triangles or textures are cut into 64-row blocks too, behind world AABBs
(:func:`sph_blockbounds`): a
sphere's hit point lies inside its block's AABB, so skipping a block the
ray does not enter before its best t drops no hit, and the culled sweep
gives the dense sweep's t and row. Entry-only and any-hit sweeps cull
(the shadow sweeps of refractive scenes too); exit sweeps stay dense.

Triangles: the entry test is pallas_tri._tri_block's Woop form (``|d'_z| >=
thr``, then ``t = -o'_z / d'_z`` and the barycentric bounds), the any-hit
test its division-free ``_tri_block_any``, and a triangle's exit t is its
entry t. Culling is per ray: the ray slab-tests each 64-row block's AABB
and skips the block when it misses it, or when the block begins beyond the
ray's best t so far. It applies where the JAX package culls — entry-only
sweeps and any-hit sweeps of a segment of more than one block, never an
exit pass — and the kernel and the plain version apply the same rule, so
they agree ray by ray. (The JAX package culls per 1024-ray tile; the two
differ only on "phantom" grazing hits outside their block's AABB, which the
``|det| >= E`` rule admits.)

:func:`closest_hit` launches the kernel for CUDA tensors and runs
:func:`closest_hit_plain` for CPU tensors; there is no other path. On the
render path it is the primary-hit pass of :func:`step.trace_packed`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..models import schema
from ..utils.kernels import (CudaKernel, ptr, require_cuda_tensor,
                             stream_ptr)
from . import intersect
from .linalg import EPS

BIG = 3.0e38
SWEEP_COLS = 18          # fr(9) ipos(3) pa(3) pr valid gid
_C_FR, _C_IP, _C_PA, _C_PR, _C_VALID, _C_GID = 0, 9, 12, 15, 16, 17
# shared-memory bound of the kernel on the dense rows: 2048 rows * 72 B
MAX_ROWS = 2048
# triangle table columns: G (9, row-major: o'_k = G[k] . o + h_k), h (3),
# thr (BIG on invalid or degenerate rows), group id (-3 on invalid rows),
# and the triangle-local [start, end) rows of the row's group
TRI_COLS = 16
_T_G, _T_H, _T_THR, _T_GID, _T_GS, _T_GE = 0, 9, 12, 13, 14, 15
CB = 64                  # rows per cull block (the compiler's split leaf)
BB_COLS = 8              # block AABB: lo (3), hi (3), padding (2)
# shared-memory bound on the block AABBs the whole-trace, primary-hit and
# per-step kernels stage: 256 * 32 B; past it the per-step path takes the
# triangle segment's hits from csrc/tri.cu (ops/step.py route)
MAX_TRI_BLOCKS = 256
# a sphere segment of at least this many rows gets cull blocks
# (pallas_hit3._DENSE_CULL_MIN), at most SPH_MAX_BLOCKS of them
# (pallas_hit3._CAND_MAX); the whole-trace and primary-hit kernels, whose
# dense rows are at most MAX_ROWS, see at most MAX_ROWS // CB = 32 (a
# 32-bit mask per lane), the per-step kernel up to 64 (csrc/hit3.cuh)
DENSE_CULL_MIN = 256
SPH_MAX_BLOCKS = 64
# rows per sub-block of a culled sphere segment: the per-step forward
# tests a swept block's sub-blocks before their rows (csrc/step_fwd.cu)
SPH_SUB = 8

_c_int, _c_ptr = ctypes.c_int, ctypes.c_void_p
KERNEL = CudaKernel(
    "hit3", "hit3.cu", ("hit3.cuh",), "mrt_closest_hit",
    [_c_ptr, _c_int, _c_int] + [_c_int] * 6 + [_c_ptr, _c_int, _c_int,
                                                  _c_ptr, _c_int, _c_ptr,
                                                  _c_int]
    + [_c_ptr, _c_ptr] + [_c_int] * 4 + [_c_ptr] * 4 + [_c_ptr])
# entry only (tx = te); entry and group exit; any-hit (te = -BIG on a hit)
MODE_ENTRY, MODE_EXIT, MODE_ANY = 0, 1, 2


def seg_layout(kind_counts, kind_sweep=None):
    """Static ``((kind, start, count, sweep), ...)`` of the non-empty dense
    segments, the triangle start, the triangle count and the triangle
    rows to sweep. ``sweep`` (default ``count``) is the segment's rows up
    to its last valid one (``SceneArrays.kind_sweep``): the rows the
    kernels test."""
    segs, start = [], 0
    for kind in (schema.KIND_SPHERE, schema.KIND_PLANE, schema.KIND_BOX):
        c = kind_counts[kind]
        if c:
            segs.append((kind, start, c,
                         c if kind_sweep is None else kind_sweep[kind]))
        start += c
    n_tri = kind_counts[schema.KIND_TRIANGLE]
    tri_n = n_tri if kind_sweep is None else kind_sweep[schema.KIND_TRIANGLE]
    return tuple(segs), start, n_tri, tri_n


def layout_ints(layout):
    """The six ints (start, rows to sweep per dense kind) the kernels take.
    An absent kind starts where the previous segment ends, so the kernels'
    row-bound kind tests stay ordered; a row past a segment's sweep is
    invalid padding, which no hit returns."""
    bounds = {kind: (s, c, n) for kind, s, c, n in layout[0]}
    ints, prev = [], 0
    for kind in (schema.KIND_SPHERE, schema.KIND_PLANE, schema.KIND_BOX):
        s, c, n = bounds.get(kind, (prev, 0, 0))
        ints += [s, n]
        prev = s + c
    return ints


def cull_ints(layout, tbb, sbb):
    """The four ints of the triangle segment and the cull the kernels'
    ``Layout`` takes after the dense ones: the triangle segment's first row
    and rows to sweep, its cull blocks and the sphere segment's (0: no
    culling)."""
    return [layout[1], layout[3], 0 if tbb is None else tbb.shape[0],
            0 if sbb is None else sbb.shape[0]]


@functools.lru_cache(maxsize=None)
def _table_ints(layout):
    """layout_ints as a tuple, computed once per layout (every launch of
    a kernel passes them)."""
    return tuple(layout_ints(layout))


def table_args(layout, tri, tbb, sbb=None):
    """The kernels' C arguments for the kind segments: the six dense ints,
    then the triangle table, its first row and rows to sweep, its cull
    blocks and their count (null pointers and zeros without triangles),
    and the sphere segment's cull blocks and their count (null and 0
    without)."""
    sph = (None, 0) if sbb is None else (ptr(sbb), sbb.shape[0])
    if not layout[2]:
        return (*_table_ints(layout), None, layout[1], 0, None, 0, *sph)
    return (*_table_ints(layout), ptr(tri), layout[1], layout[3],
            None if tbb is None else ptr(tbb),
            0 if tbb is None else tbb.shape[0], *sph)


def pack_scene(scene, frames):
    """The ``(P, 18)`` float32 sweep table: columns ``fr (9), ipos (3), pa
    (3), pr, valid, gid``, the dense part of pallas_hit3.pack_scene; a
    triangle row's ``pa`` is its raw normal (pallas_step's normal source
    column)."""
    P = scene.n_prims
    pa = scene.prim_a
    if scene.kind_counts[schema.KIND_TRIANGLE]:
        s = scene.seg(schema.KIND_TRIANGLE)
        pa = torch.cat([pa[:s.start], intersect.triangle_normals(scene)])
    return torch.cat([
        frames.reshape(P, 9), scene.inst_pos, pa,
        scene.prim_r[:, None], scene.prim_valid.to(torch.float32)[:, None],
        scene.group_id.to(torch.float32)[:, None]], dim=1)


def _group_ranges(gid):
    """Triangle-local ``[start, end)`` of each row's run of equal group
    ids (a mesh instance's rows are contiguous in the compiled table)."""
    n = gid.shape[0]
    idx = torch.arange(n, device=gid.device)
    first = torch.ones(n, dtype=torch.bool, device=gid.device)
    first[1:] = gid[1:] != gid[:-1]
    last = torch.ones_like(first)
    last[:-1] = first[1:]
    start = torch.cummax(torch.where(first, idx, 0), 0).values
    end = torch.flip(torch.cummin(torch.flip(
        torch.where(last, idx + 1, n), (0,)), 0).values, (0,))
    return start, end


def tri_blockbounds(scene, frames):
    """World AABBs ``(n_cb, 8)`` ``[lo (3) | hi (3) | 0 0]`` of the
    triangle segment's 64-row blocks (pallas_hit3._tri_superbounds without
    its padding to 8 rows), with the inverse of the instance frame as the
    cross-product adjugate; invalid rows add nothing, the bounds get a 1e-4
    slack, and a non-finite bound tests always. Culling data, built without
    a gradient.

    The world vertex is ``ip + M^-1 v``: the Woop test maps a ray to ``M (o
    - ip)`` and compares it with the stored vertices, so a mesh's vertices
    are relative to its instance position. (``_tri_superbounds`` takes ``ip
    + M^-1 (v - ip)``, which omits the translation; its tile-wide cull
    hides that wherever one ray of a 1024-ray tile touches the true block,
    but a per-ray cull would drop real hits of a translated mesh.)"""
    with torch.no_grad():
        s = scene.seg(schema.KIND_TRIANGLE)
        M, ip = frames[s].detach(), scene.inst_pos[s].detach()
        valid = scene.prim_valid[s]
        c0, c1, c2 = M[:, :, 0], M[:, :, 1], M[:, :, 2]
        r0 = torch.linalg.cross(c1, c2)
        r1 = torch.linalg.cross(c2, c0)
        r2 = torch.linalg.cross(c0, c1)
        det = (c0 * r0).sum(-1, keepdim=True)
        det = torch.where(det == 0.0, 1.0, det)
        ws = []
        for v in (scene.prim_a[s], scene.prim_b[s], scene.prim_c[s]):
            rel = v.detach()
            ws.append(ip + torch.stack([(r0 * rel).sum(-1),
                                        (r1 * rel).sum(-1),
                                        (r2 * rel).sum(-1)], -1) / det)
        W = torch.stack(ws, 0)                            # (3, Pt, 3)
        vm = valid[None, :, None]
        lo = torch.where(vm, W, BIG)
        hi = torch.where(vm, W, -BIG)
        pad = (-lo.shape[1]) % CB
        lo = torch.nn.functional.pad(lo, (0, 0, 0, pad), value=BIG)
        hi = torch.nn.functional.pad(hi, (0, 0, 0, pad), value=-BIG)
        n_cb = lo.shape[1] // CB
        lo = lo.reshape(3, n_cb, CB, 3).amin(dim=(0, 2))
        hi = hi.reshape(3, n_cb, CB, 3).amax(dim=(0, 2))
        eps = 1e-4 + 1e-4 * torch.clamp(hi - lo, min=0.0)
        lo, hi = lo - eps, hi + eps
        bad = ~(torch.isfinite(lo) & torch.isfinite(hi))
        lo = torch.where(bad, -BIG, lo)
        hi = torch.where(bad, BIG, hi)
        return torch.cat([lo, hi, torch.zeros_like(lo[:, :2])], 1)


def sph_cull_rows(layout):
    """``(start, count)`` of the sphere segment when it gets cull blocks
    (pallas_hit3._sph_cull_rows): at least DENSE_CULL_MIN rows, at most
    SPH_MAX_BLOCKS blocks; else None."""
    for kind, s, c, _n in layout[0]:
        if kind == schema.KIND_SPHERE and c >= DENSE_CULL_MIN \
                and -(-c // CB) <= SPH_MAX_BLOCKS:
            return s, c
    return None


def sph_blockbounds(scene, rows=CB):
    """World AABBs ``(n_sb, 8)`` ``[lo (3) | hi (3) | 0 0]`` of the sphere
    segment's 64-row blocks (pallas_hit3._sphere_blockbounds without its
    padding to 8 rows; ``rows``: blocks of that many rows): centre +- r of
    each valid row (the instance frame is a rotation, so the radius
    holds), a slack of 1e-4 + 1e-4 * extent, and a non-finite bound tests
    always. Culling data, built without a gradient."""
    with torch.no_grad():
        s = scene.seg(schema.KIND_SPHERE)
        ip = scene.inst_pos[s].detach()
        r = scene.prim_r[s].detach()[:, None]
        valid = scene.prim_valid[s][:, None]
        lo = torch.where(valid, ip - r, BIG)
        hi = torch.where(valid, ip + r, -BIG)
        pad = (-lo.shape[0]) % rows
        lo = torch.nn.functional.pad(lo, (0, 0, 0, pad), value=BIG)
        hi = torch.nn.functional.pad(hi, (0, 0, 0, pad), value=-BIG)
        n_sb = lo.shape[0] // rows
        lo = lo.reshape(n_sb, rows, 3).amin(dim=1)
        hi = hi.reshape(n_sb, rows, 3).amax(dim=1)
        eps = 1e-4 + 1e-4 * torch.clamp(hi - lo, min=0.0)
        lo, hi = lo - eps, hi + eps
        bad = ~(torch.isfinite(lo) & torch.isfinite(hi))
        lo = torch.where(bad, -BIG, lo)
        hi = torch.where(bad, BIG, hi)
        return torch.cat([lo, hi, torch.zeros_like(lo[:, :2])], 1)


def sph_culled(scene, layout) -> bool:
    """Whether the kernels cull the sphere segment: it gets cull blocks
    (:func:`sph_cull_rows`) and the scene has no triangles or textures,
    whose kernels sweep the spheres dense (their instances keep the
    Mesh-class and textured code and registers)."""
    return not (layout[2] or scene.has_maps) \
        and sph_cull_rows(layout) is not None


def sph_table(scene, layout):
    """The sphere segment's cull blocks (:func:`sph_blockbounds`) where
    :func:`sph_culled`, else None."""
    return sph_blockbounds(scene) if sph_culled(scene, layout) else None


def sph_walk_tables(scene, layout, tab):
    """What the per-step forward's sphere walks read besides the cull
    blocks, where :func:`sph_culled` (else ``(None, None)``): the sphere
    segment's sweep columns packed 16 floats a row (frame (9), instance
    position (3), radius, valid, 0, 0: four 16-byte loads where the row
    table's 26-float rows take fourteen), and the AABBs of its
    :data:`SPH_SUB`-row sub-blocks (:func:`sph_blockbounds` of those) with
    each box's growth factor g = 1e-3 + 2e-6 / r (r its smallest valid
    radius) in column 6: the kernel grows a sub-block's box by g (1 + |o -
    centre|^2) for a ray from o, past the sphere test's rounding
    (csrc/step_fwd.cu sub_touch). Built once per table, without a
    gradient."""
    if not sph_culled(scene, layout):
        return None, None
    with torch.no_grad():
        _kind, s, c, _n = layout[0][0]
        t = tab.detach()[s:s + c]
        rows = torch.cat([t[:, :_C_PA], t[:, _C_PR:_C_VALID + 1],
                          torch.zeros_like(t[:, :2])], 1).contiguous()
        sub = sph_blockbounds(scene, SPH_SUB)
        seg = scene.seg(schema.KIND_SPHERE)
        r = torch.where(scene.prim_valid[seg], scene.prim_r[seg].detach(),
                        BIG)
        r = torch.nn.functional.pad(r, (0, sub.shape[0] * SPH_SUB
                                        - r.shape[0]), value=BIG)
        r = r.view(-1, SPH_SUB).amin(1)
        sub[:, 6] = 1e-3 + 2e-6 / torch.clamp(r, min=1e-6)
        return rows, sub


def tri_tables(scene, frames):
    """The triangle segment's ``(Pt, 16)`` table (differentiable in ``G``
    and ``h``; pallas_tri.pack_consts' ``AT | HT | thr`` with the group id
    and group range) and its cull blocks' AABBs, or None where the JAX
    package does not cull (a segment of at most one block)."""
    s = scene.seg(schema.KIND_TRIANGLE)
    Pt = s.stop - s.start
    if not Pt:
        return torch.zeros((0, TRI_COLS), dtype=torch.float32,
                           device=frames.device), None
    G, h, thr, ok = intersect.triangle_pack(scene, frames)
    valid = scene.prim_valid[s]
    gid = scene.group_id[s]
    gs, ge = _group_ranges(gid)
    meta = torch.stack([
        torch.where(ok & valid, thr, BIG).detach(),
        torch.where(valid, gid, -3).to(torch.float32),
        gs.to(torch.float32), ge.to(torch.float32)], 1)
    tri = torch.cat([G.reshape(Pt, 9), h, meta], 1)
    tbb = tri_blockbounds(scene, frames) if Pt > CB else None
    return tri, tbb


def split_sweep(tab):
    """Column views ``(fr (P,9), ipos (P,3), pa (P,3), pr (P,1), valid
    (P,1), gid (P,1))`` of a row table, pallas_hit3's six tables."""
    return (tab[:, _C_FR:_C_IP], tab[:, _C_IP:_C_PA], tab[:, _C_PA:_C_PR],
            tab[:, _C_PR:_C_VALID], tab[:, _C_VALID:_C_GID],
            tab[:, _C_GID:SWEEP_COLS])


def _kind_block(kind, s, e, fr, ipos, pa, pr, valid, o, d):
    """``(t0, t1, ok)`` of rows ``[s, e)`` of one dense segment, each
    ``(R, e-s)``; the operation order of pallas_hit3._kind_block and of
    hit3.cuh's row_hit."""
    f = [fr[s:e, k][None] for k in range(9)]
    ix, iy, iz = (ipos[s:e, k][None] for k in range(3))
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    rx, ry, rz = ox - ix, oy - iy, oz - iz
    opx = f[0] * rx + f[1] * ry + f[2] * rz + ix
    opy = f[3] * rx + f[4] * ry + f[5] * rz + iy
    opz = f[6] * rx + f[7] * ry + f[8] * rz + iz
    dpx = f[0] * dx + f[1] * dy + f[2] * dz
    dpy = f[3] * dx + f[4] * dy + f[5] * dz
    dpz = f[6] * dx + f[7] * dy + f[8] * dz
    one = torch.ones((), dtype=o.dtype, device=o.device)
    if kind == schema.KIND_SPHERE:
        r_ = pr[s:e, 0][None]
        ox_, oy_, oz_ = opx - ix, opy - iy, opz - iz
        a = dpx * dpx + dpy * dpy + dpz * dpz
        bq = 2.0 * (ox_ * dpx + oy_ * dpy + oz_ * dpz)
        c = ox_ * ox_ + oy_ * oy_ + oz_ * oz_ - r_ * r_
        disc = bq * bq - 4.0 * a * c
        sq = torch.sqrt(torch.where(disc >= 0.0,
                                    torch.clamp(disc, min=1e-12), one))
        a2 = torch.where(a == 0.0, one, 2.0 * a)
        t0 = (-bq - sq) / a2
        t1 = (-bq + sq) / a2
        ok = (disc >= 0.0) & (t0 >= 0.0)
    elif kind == schema.KIND_PLANE:
        a0, a1, a2 = (pa[s:e, k][None] for k in range(3))
        nn = a0 * a0 + a1 * a1 + a2 * a2
        inv = 1.0 / torch.sqrt(torch.where(nn > 0.0, nn, one))
        nx, ny, nz = a0 * inv, a1 * inv, a2 * inv
        dd = -(nx * ix + ny * iy + nz * iz)
        dn = dpx * nx + dpy * ny + dpz * nz
        t0 = -(opx * nx + opy * ny + opz * nz + dd) / torch.where(
            dn == 0.0, one, dn)
        t1 = t0
        ok = (t0 > 0.0) & (dn != 0.0)
    else:  # box
        lo = hi = None
        for dp_c, op_c, ip_c, k in ((dpx, opx, ix, 0), (dpy, opy, iy, 1),
                                    (dpz, opz, iz, 2)):
            zero = dp_c == 0.0
            mm = 1.0 / torch.where(zero, one, dp_c)
            mm = torch.where(zero, torch.full_like(mm, 1.0 / EPS), mm)
            nb = (op_c - ip_c) * mm
            kk = 0.5 * pa[s:e, k][None] * torch.abs(mm)
            lo_c, hi_c = -nb - kk, -nb + kk
            lo = lo_c if lo is None else torch.maximum(lo, lo_c)
            hi = hi_c if hi is None else torch.minimum(hi, hi_c)
        t0, t1 = lo, hi
        ok = ~((t0 > t1) | (t1 < 0.0))
    ok = ok & (valid[s:e, 0][None] > 0.5)
    ok = ok & torch.isfinite(t0) & torch.isfinite(t1)
    return t0, t1, ok


# --- the triangle segment: Woop tests, cull blocks, winner t ---------------

def _tri_prods(rows, o, d):
    """``o' = G o + h`` and ``d' = G d`` of rays ``(R, 3)`` against table
    rows ``(n, 16)``, each component ``(R, n)`` in pallas_tri._tri_block's
    operation order (hit3.cuh tri_prods)."""
    g = [rows[:, k][None] for k in range(9)]
    h = [rows[:, _T_H + k][None] for k in range(3)]
    oc = [o[:, k:k + 1] for k in range(3)]
    dc = [d[:, k:k + 1] for k in range(3)]

    def prod(k, v):
        return g[3 * k] * v[0] + g[3 * k + 1] * v[1] + g[3 * k + 2] * v[2]

    return ([prod(k, oc) + h[k] for k in range(3)],
            [prod(k, dc) for k in range(3)])


def _tri_block(rows, o, d):
    """``(t, ok)`` ``(R, n)`` of the Woop entry test (pallas_tri._tri_block,
    hit3.cuh tri_hit)."""
    (oxt, oyt, ozt), (dxt, dyt, dzt) = _tri_prods(rows, o, d)
    ok = torch.abs(dzt) >= rows[:, _T_THR][None]
    t = -ozt / torch.where(ok, dzt, 1.0)
    u = oxt + t * dxt
    v = oyt + t * dyt
    ok = ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) \
        & (t >= 0.0)
    return t, ok


def _tri_block_any(rows, o, d):
    """``ok`` ``(R, n)`` of the division-free occlusion test
    (pallas_tri._tri_block_any, hit3.cuh tri_any)."""
    (oxt, oyt, ozt), (dxt, dyt, D) = _tri_prods(rows, o, d)
    ok = torch.abs(D) >= rows[:, _T_THR][None]
    D2 = D * D
    Pu = (oxt * D - ozt * dxt) * D
    Pv = (oyt * D - ozt * dyt) * D
    return ok & (Pu >= 0.0) & (Pu <= D2) & (Pv >= 0.0) & (Pu + Pv <= D2) \
        & (ozt * D <= 0.0)


def _inv_dir(d):
    """``1 / d`` with ``EPS`` for a zero component (the slab test's)."""
    return 1.0 / torch.where(d == 0.0, EPS, d)


def _slab(bb, o, invd):
    """(tmin, tmax) (R,) of each ray's slab interval against block AABB
    ``bb`` ``(8,)`` (pallas_hit3's ``_slab``, per ray)."""
    tmin = tmax = None
    for k in range(3):
        t1 = (bb[k] - o[:, k]) * invd[:, k]
        t2 = (bb[3 + k] - o[:, k]) * invd[:, k]
        near, far = torch.minimum(t1, t2), torch.maximum(t1, t2)
        tmin = near if tmin is None else torch.maximum(tmin, near)
        tmax = far if tmax is None else torch.minimum(tmax, far)
    return tmin, tmax


def _slab_touch(bb, o, invd, best):
    """(R,) bool: does each ray enter block AABB ``bb`` ``(8,)`` at or
    before its ``best`` t? (pallas_hit3's ``_slab`` and ``touch``, per ray;
    hit3.cuh block_touch)."""
    tmin, tmax = _slab(bb, o, invd)
    return (tmax >= torch.maximum(tmin, torch.zeros_like(tmin))) \
        & (tmin <= best)


def _slab_leave(bb, o, invd, best):
    """(R,) bool: does each ray meet block AABB ``bb`` ``(8,)`` and leave
    it at or after its ``best`` exit t? (the culled exit's test; tri.cu
    block_leave)."""
    tmin, tmax = _slab(bb, o, invd)
    return (tmax >= torch.maximum(tmin, torch.zeros_like(tmin))) \
        & (tmax >= best)


def _blocks(n):
    return [(lo, min(lo + CB, n)) for lo in range(0, n, CB)]


def _tri_entry(tri, tbb, n, o, d, best):
    """Entry sweep of the first ``n`` triangle rows after the dense
    segments' ``best`` t, block by block in row order, culled per ray
    when ``tbb`` is given (no gradient). Returns the new best, the
    triangle-local winner (-1: no triangle improved ``best``) and the rows
    each ray tested."""
    R = o.shape[0]
    row = torch.full((R,), -1, dtype=torch.int64, device=o.device)
    tested = torch.zeros(R, dtype=torch.int64, device=o.device)
    invd = _inv_dir(d) if tbb is not None else None
    for b, (lo, hi) in enumerate(_blocks(n)):
        t, ok = _tri_block(tri[lo:hi], o, d)
        if tbb is not None:
            touch = _slab_touch(tbb[b], o, invd, best)
            ok = ok & touch[:, None]
            tested += touch * (hi - lo)
        else:
            tested += hi - lo
        tm = torch.where(ok, t, BIG)
        bm = tm.amin(dim=1)
        br = intersect.first_index(tm == bm[:, None]).long()
        upd = bm < best
        best = torch.where(upd, bm, best)
        row = torch.where(upd, lo + br, row)
    return best, row, tested


def _tri_exit(tri, n, o, d, wg, best, tbb=None):
    """Exit pass over the triangle rows of group ``wg``: the largest t,
    ties to the lowest row, after the dense segments' ``best`` (no
    gradient). With the cull blocks ``tbb``, block by block in row order,
    a block the ray misses or leaves before its best exit t so far is
    skipped (the culled exit of ``csrc/tri.cu``'s row 7; a group's
    farthest hit lies in its block's AABB, so only a phantom hit outside
    it is dropped); without, every row of the group is tested (the
    whole-trace and row 8's exit). Returns the new best and the
    triangle-local exit row (-1: none improved ``best``)."""
    R = o.shape[0]
    row = torch.full((R,), -1, dtype=torch.int64, device=o.device)
    gid = tri[:, _T_GID]
    invd = _inv_dir(d) if tbb is not None else None
    for b, (lo, hi) in enumerate(_blocks(n)):
        t, ok = _tri_block(tri[lo:hi], o, d)
        ok = ok & (gid[None, lo:hi] == wg[:, None])
        if tbb is not None:
            ok = ok & _slab_leave(tbb[b], o, invd, best)[:, None]
        me = torch.where(ok, t, -BIG)
        bm = me.amax(dim=1)
        br = intersect.first_index(me == bm[:, None]).long()
        upd = bm > best
        best = torch.where(upd, bm, best)
        row = torch.where(upd, lo + br, row)
    return best, row


def _tri_any(tri, tbb, n, o, d, done):
    """Occlusion over the first ``n`` triangle rows for rays not ``done``,
    culled per ray when ``tbb`` is given; a ray stops at its first hit.
    Returns the hit mask and the rows each ray tested."""
    hit = done.clone()
    tested = torch.zeros(o.shape[0], dtype=torch.int64, device=o.device)
    invd = _inv_dir(d) if tbb is not None else None
    big = torch.full_like(o[:, 0], BIG)
    for b, (lo, hi) in enumerate(_blocks(n)):
        touch = ~hit
        if tbb is not None:
            touch = touch & _slab_touch(tbb[b], o, invd, big)
        ok = _tri_block_any(tri[lo:hi], o, d) & touch[:, None]
        found = ok.any(dim=1)
        upto = torch.where(found, intersect.first_index(ok).long() + 1,
                           hi - lo)
        tested += torch.where(touch, upto, 0)
        hit = hit | found
    return hit, tested


def _tri_t(tri, row, o, d):
    """Differentiable t of triangle-local rows ``row`` (R,) for rays
    ``o``/``d``: the Woop plane form ``t = -(g.o + h)/(g.d)`` of
    pallas_tri._winner_t, in the sweep's operation order (so its value is
    the sweep's bit for bit); gradients reach ``G[2]``, ``h[2]``, ``o`` and
    ``d``."""
    w = tri[row]
    g = [w[:, 6 + k] for k in range(3)]
    oz = g[0] * o[:, 0] + g[1] * o[:, 1] + g[2] * o[:, 2] + w[:, _T_H + 2]
    dz = g[0] * d[:, 0] + g[1] * d[:, 1] + g[2] * d[:, 2]
    return -oz / torch.where(dz == 0.0, 1.0, dz)


def _sph_cull(sbb, n, o, d, t0, ok, mode):
    """The per-ray cull of the sphere segment's first ``n`` rows, block by
    block in row order (hit3.cuh sph_entry / sph_any): an entry sweep
    skips a block the ray does not enter at or before its best t so far,
    an any-hit sweep a block the ray misses, and stops at its first hit.
    ``t0``, ``ok`` ``(R, c)`` are the segment's row tests. Returns ``ok``
    with the skipped rows cleared and the rows each ray tested (no
    gradient)."""
    R = o.shape[0]
    keep = torch.zeros_like(ok)
    tested = torch.zeros(R, dtype=torch.int64, device=o.device)
    invd = _inv_dir(d)
    best = torch.full((R,), BIG, dtype=o.dtype, device=o.device)
    hit = torch.zeros(R, dtype=torch.bool, device=o.device)
    for b, (lo, hi) in enumerate(_blocks(n)):
        touch = _slab_touch(sbb[b], o, invd, best)
        keep[:, lo:hi] = touch[:, None]
        ok_b = ok[:, lo:hi] & touch[:, None]
        if mode == MODE_ANY:
            found = ok_b.any(dim=1)
            upto = torch.where(found, intersect.first_index(ok_b).long() + 1,
                               hi - lo)
            tested += torch.where(touch & ~hit, upto, 0)
            hit = hit | found
        else:
            tested += touch * (hi - lo)
            best = torch.minimum(best, torch.where(
                ok_b, t0[:, lo:hi], BIG).amin(dim=1))
    return ok & keep, tested


def _need_tri(layout, tri):
    if layout[2] and tri is None:
        raise ValueError("the scene has triangles: pass its triangle table "
                         "(tri_tables)")
    return layout[2] > 0


def closest_hit_plain(tab, layout, o, d, mode=MODE_EXIT, tri=None,
                      tbb=None, sbb=None):
    """Plain PyTorch closest hit of rays ``o``/``d`` ``(R, 3)`` against the
    row table ``tab`` (and the triangle tables, the sphere cull blocks):
    returns ``(te, row, tx, xrow)`` like the kernel (any device)."""
    KERNEL.plain_calls += 1
    return sweep_plain(tab, layout, o, d, mode, tri, tbb, sbb)


def sweep_plain(tab, layout, o, d, mode=MODE_EXIT, tri=None, tbb=None,
                sbb=None):
    """The sweep of :func:`closest_hit_plain` without its call count: the
    plain whole trace runs it for every step. Differentiable: ``te`` and
    ``tx`` carry the winner row's t gradient (the masked min / max over the
    dense rows read at the winner row, the Woop plane form of a triangle
    winner): on a tie the lowest row takes it all, as in the kernels, where
    autograd of the min itself would split it among the tied rows (two
    boxes with a common face, a ray starting on it). With the sphere
    cull blocks ``sbb``, entry-only and any-hit sweeps skip the blocks the
    kernel skips (:func:`_sph_cull`)."""
    fr, ipos, pa, pr, valid, gid = split_sweep(tab)
    segs, tri_start, _n_tri, tri_n = layout
    has_tri = _need_tri(layout, tri)
    R = o.shape[0]
    parts = [_kind_block(kind, s, s + c, fr, ipos, pa, pr, valid, o, d)
             for kind, s, c, _n in segs]
    if sbb is not None and mode != MODE_EXIT:
        # the sphere segment is the first (sph_cull_rows)
        t0s, t1s, oks = parts[0]
        with torch.no_grad():
            oks = _sph_cull(sbb, segs[0][3], o.detach(), d.detach(),
                            t0s.detach(), oks, mode)[0]
        parts[0] = (t0s, t1s, oks)
    if parts:
        t0 = torch.cat([p[0] for p in parts], dim=1)
        t1 = torch.cat([p[1] for p in parts], dim=1)
        ok = torch.cat([p[2] for p in parts], dim=1)
    else:
        t0 = t1 = o.new_zeros((R, 0))
        ok = torch.zeros((R, 0), dtype=torch.bool, device=o.device)
    zero = torch.zeros(R, dtype=torch.int32, device=o.device)
    if mode == MODE_ANY:
        hit = ok.any(dim=1)
        if has_tri:
            with torch.no_grad():
                hit = _tri_any(tri, tbb, tri_n, o, d, hit)[0]
        te = torch.where(hit, -BIG, BIG).to(o.dtype)
        return te, zero, te, zero
    # entry: smallest t0, first row on ties; a miss keeps BIG and row 0
    if parts:
        tm = torch.where(ok, t0, torch.full_like(t0, BIG))
        row = intersect.first_index(tm == tm.amin(dim=1)[:, None])
        te = tm.gather(1, row.long()[:, None])[:, 0]
    else:
        te, row = torch.full((R,), BIG, dtype=o.dtype, device=o.device), zero
    if has_tri:
        with torch.no_grad():
            _b, trow, _n = _tri_entry(
                tri, tbb if mode == MODE_ENTRY else None, tri_n, o, d,
                te.detach())
        won = trow >= 0
        te = torch.where(won, _tri_t(tri, trow.clamp(min=0), o, d), te)
        row = torch.where(won, (tri_start + trow).to(torch.int32), row)
    if mode == MODE_ENTRY:
        return te, row, te, row
    # exit: largest t1 over the winner's group; a miss has no group
    g = gid[:, 0]
    wg = torch.where(te < BIG * 0.5, g[row.long()],
                     torch.full_like(te, BIG)).detach()
    if parts:
        me = torch.where(ok & (g[None, :tri_start] == wg[:, None]), t1,
                         torch.full_like(t1, -BIG))
        xrow = intersect.first_index(me == me.amax(dim=1)[:, None])
        tx = me.gather(1, xrow.long()[:, None])[:, 0]
    else:
        tx, xrow = torch.full((R,), -BIG, dtype=o.dtype,
                              device=o.device), zero
    if has_tri:
        with torch.no_grad():
            _b, xr = _tri_exit(tri, tri_n, o, d, wg, tx.detach())
        won = xr >= 0
        tx = torch.where(won, _tri_t(tri, xr.clamp(min=0), o, d), tx)
        xrow = torch.where(won, (tri_start + xr).to(torch.int32), xrow)
    return te, row, tx, xrow


def tri_rows_tested(tab, layout, o, d, mode, tri, tbb):
    """(R,) int64: the triangle rows the kernel tests for these rays in
    ``mode``, by its culling rule (entry: the rows of each touched block;
    exit: also the winner group's rows when a triangle wins; any-hit: rows
    up to the first hit). Counts the work behind a kernel's bound."""
    R = o.shape[0]
    if not layout[2]:
        return torch.zeros(R, dtype=torch.int64, device=o.device)
    with torch.no_grad():
        o, d = o.detach(), d.detach()
        tri_n = layout[3]
        if mode == MODE_ANY:
            dense = sweep_plain(tab, (layout[0], layout[1], 0, 0), o, d,
                                MODE_ANY)[0] < 0.0
            return _tri_any(tri, tbb, tri_n, o, d, dense)[1]
        te = sweep_plain(tab, (layout[0], layout[1], 0, 0), o, d,
                         MODE_ENTRY)[0]
        best, trow, tested = _tri_entry(
            tri, tbb if mode == MODE_ENTRY else None, tri_n, o, d, te)
        if mode == MODE_EXIT:
            w = trow.clamp(min=0)
            span = (tri[w, _T_GE].clamp(max=tri_n)
                    - tri[w, _T_GS]).to(torch.int64)
            tested += torch.where(trow >= 0, span, 0)
        return tested


def sph_rows_tested(tab, layout, o, d, mode, sbb):
    """(R,) int64: the sphere rows the kernel tests for these rays in
    ``mode``, by its culling rule (entry: the rows of each touched block;
    any-hit: rows up to the first hit; exit, or no cull blocks: every row
    of the sweep). Counts the work behind a kernel's bound."""
    R = o.shape[0]
    segs = layout[0]
    if not segs or segs[0][0] != schema.KIND_SPHERE:
        return torch.zeros(R, dtype=torch.int64, device=o.device)
    n = segs[0][3]
    if sbb is None or mode == MODE_EXIT:
        return torch.full((R,), n, dtype=torch.int64, device=o.device)
    with torch.no_grad():
        o, d = o.detach(), d.detach()
        fr, ipos, pa, pr, valid, _gid = split_sweep(tab.detach())
        t0, _t1, ok = _kind_block(schema.KIND_SPHERE, 0, segs[0][2], fr,
                                  ipos, pa, pr, valid, o, d)
        return _sph_cull(sbb, n, o, d, t0, ok, mode)[1]


def closest_hit(tab, layout, o, d, mode=MODE_EXIT, tri=None, tbb=None,
                sbb=None):
    """``(te, row, tx, xrow)`` of rays ``o``/``d`` ``(R, 3)`` float32
    against the row table ``tab`` ``(P, C >= 18)`` and, for a scene with
    triangles, its :func:`tri_tables` ``tri`` and ``tbb``; with a long
    sphere segment, its cull blocks ``sbb`` (:func:`sph_table`).

    CUDA tensors launch ``mrt_closest_hit``; the rays may be any strided
    view, such as the transpose of lane-major ``(3, R)`` rays. CPU tensors
    run :func:`closest_hit_plain`."""
    if o.device.type == "cpu":
        return closest_hit_plain(tab, layout, o, d, mode, tri, tbb, sbb)
    has_tri = _need_tri(layout, tri)
    R = o.shape[0]
    require_cuda_tensor("o", o, torch.float32, (R, 3), contiguous=False)
    require_cuda_tensor("d", d, torch.float32, (R, 3), contiguous=False)
    if o.stride() != d.stride():
        raise ValueError(f"o and d strides differ: {o.stride()} vs "
                         f"{d.stride()}")
    P, C = tab.shape
    require_cuda_tensor("table", tab, torch.float32)
    if C < SWEEP_COLS:
        raise ValueError(f"table: {C} columns, the sweep needs "
                         f"{SWEEP_COLS}")
    n_dense = layout[1]
    if n_dense > MAX_ROWS:
        raise ValueError(f"closest_hit kernel: {n_dense} sphere, plane and "
                         f"box rows exceed the shared-memory bound of "
                         f"{MAX_ROWS}")
    check_cull_tables(layout, tri, tbb, sbb)
    te = torch.empty(R, dtype=torch.float32, device=o.device)
    tx = torch.empty_like(te)
    row = torch.empty(R, dtype=torch.int32, device=o.device)
    xrow = torch.empty_like(row)
    if R:
        KERNEL.launch(ptr(tab), n_dense, C,
                      *table_args(layout, tri, tbb, sbb),
                      ptr(o), ptr(d), *o.stride(), R, mode, ptr(te),
                      ptr(row), ptr(tx), ptr(xrow), stream_ptr(o.device))
    return te, row, tx, xrow


def tri_blocks(n_tri: int) -> int:
    """Cull blocks of a triangle segment of ``n_tri`` rows
    (:func:`tri_tables`: none for one block or less)."""
    return -(-n_tri // CB) if n_tri > CB else 0


def check_cull_tables(layout, tri, tbb, sbb, max_tri_blocks=MAX_TRI_BLOCKS):
    """Validate the triangle tables and the cull blocks of a kernel
    launch; ``max_tri_blocks``: the most triangle cull blocks the kernel
    stages (None: it stages none, the route's rule for the per-step
    kernels)."""
    if sbb is not None:
        sph = sph_cull_rows(layout)
        if sph is None or layout[2]:
            raise ValueError("sphere cull blocks for a scene that gets none "
                             "(sph_table)")
        require_cuda_tensor("sbb", sbb, torch.float32,
                            (-(-sph[1] // CB), BB_COLS))
    if not layout[2]:
        return
    require_cuda_tensor("tri", tri, torch.float32, (layout[2], TRI_COLS))
    if tbb is not None:
        n_cb = -(-layout[2] // CB)
        require_cuda_tensor("tbb", tbb, torch.float32, (n_cb, BB_COLS))
        if max_tri_blocks is not None and n_cb > max_tri_blocks:
            raise ValueError(f"triangle segment: {n_cb} cull blocks exceed "
                             f"the shared-memory bound of {max_tri_blocks}")


def any_hit(tab, layout, o, d, tri=None, tbb=None, sbb=None):
    """(R,) bool: does each ray hit any valid row?"""
    return closest_hit(tab, layout, o, d, MODE_ANY, tri, tbb,
                       sbb)[0] < BIG * 0.5
