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
gives the dense sweep's t and row. Every entry and any-hit sweep culls;
the exit of such a scene is the winner row's own (every group there is
one row). The kernels walk the blocks through 8-row sub-blocks, nearest
first from inside the segment (``csrc/sph_walk.cuh``, on the packed rows
of :func:`sph_walk_tables`), with the same t and row.

A textured scene without triangles whose box segment holds at least
:data:`BOX_CULL_MIN` valid boxes (:func:`box_culled`; the Minecraft class)
walks its boxes through a spatial index over their row ids
(:func:`box_walk_tables`: the valid box rows in a median-split order, in
leaves of 8 within nodes of 64, behind world AABBs; ``csrc/box_walk.cuh``),
the row table left as it is: nearest first, to the dense sweep's t and
row, since every box's hit lies inside its leaf's and node's boxes as the
walk grows them (no phantom; :func:`box_walk_phantoms` finds any). The
plain version walks the same tables in the same order (:func:`_box_walk_mask`)
and tests the same rows.

Triangles: the entry test is pallas_tri._tri_block's Woop form (``|d'_z| >=
thr``, then ``t = -o'_z / d'_z`` and the barycentric bounds), the any-hit
test its division-free ``_tri_block_any``, and a triangle's exit t is its
entry t. Culling is per ray: the ray slab-tests each 64-row block's AABB
and skips the block when it misses it, or when the block begins beyond the
ray's best t so far. It applies to every entry and any-hit sweep of a
segment of more than one block, and to the group exit of a refractive
scene (a block the ray leaves before its best exit t so far is skipped,
``ops/tri.py``'s row 7 rule), and the kernel and the plain version apply
the same rule, so they agree ray by ray. (The JAX package culls per
1024-ray tile, and never in an exit pass; the two differ only on
"phantom" grazing hits outside their block's AABB, which the ``|det| >=
E`` rule admits: ``tri.culled_exit_phantoms`` marks them.)

:func:`closest_hit` launches the kernel for CUDA tensors and runs
:func:`closest_hit_plain` for CPU tensors; there is no other path. On the
render path it is the primary-hit pass of :func:`step.trace_packed`. Its
tables' C arguments are checked and packed by :func:`hit_args` into a
:class:`HitArgs`, once per ``step.TraceTables`` on the main path
(``step.hits``), so that a call (:func:`launch_hit`) checks only its rays. It
takes any number of dense rows: past the :data:`MAX_ROWS` the kernel
stages, a culled sphere segment is walked as below it, and a scene without
a walk reads its rows from global memory (``csrc/hit3.cu``'s kGlobal
instance).

The differentiable closest hit, pallas_hit3's ``make_closest_hit``, is
:class:`ClosestHit`: its forward is :func:`closest_hit`, its backward
:func:`closest_hit_bwd`, the hand-written kernel ``csrc/hit3_bwd.cu`` on
CUDA tensors (one launch a call, :func:`hit_bwd`: one thread per ray,
the cotangents' mask in the kernel; trace_bwd.cuh's winner-t transposes,
whose box branch splits a tied t's cotangent evenly among its axes; the
row cotangents through the float64 warp-aggregated scatter of the
whole-trace backward, in a per-device workspace that the kernel returns
to zero) and :func:`closest_hit_bwd_plain` on CPU tensors:
autograd of :func:`winner_t_plain`, the entry t recomputed at the winner
row and the exit t at the exit row (pallas_hit3's ``_winner_t_all``). The
cotangent of ``te`` reaches the entry row where the ray hit, that of ``tx``
the exit row where it also has an exit: the row table's sweep columns 0-15,
a triangle row's Woop columns ``G[2]``, ``h[2]``, and the rays. The record
path (``models/tracer.py`` ``trace_records``) is its caller.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..models import schema
from ..utils.kernels import (CudaKernel, ptr, raw_stream,
                             require_cuda_tensor)
from . import intersect
from .linalg import EPS

BIG = 3.0e38
SWEEP_COLS = 18          # fr(9) ipos(3) pa(3) pr valid gid
_C_FR, _C_IP, _C_PA, _C_PR, _C_VALID, _C_GID = 0, 9, 12, 15, 16, 17
# the dense rows the kernel stages in shared memory, 2048 rows * 72 B;
# past it a scene without a walk reads them from global memory (the kGlobal
# instance of csrc/hit3.cu)
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
# (pallas_hit3._CAND_MAX); the whole-trace kernels, whose dense rows are
# at most MAX_ROWS, see at most MAX_ROWS // CB = 32 (a 32-bit mask per
# lane), the closest-hit kernel past MAX_ROWS and the per-step kernel up
# to 64 (a 64-bit mask; csrc/hit3.cuh, csrc/hit3.cu)
DENSE_CULL_MIN = 256
SPH_MAX_BLOCKS = 64
# rows per sub-block of a culled sphere segment: the per-step forward
# tests a swept block's sub-blocks before their rows (csrc/step_fwd.cu)
SPH_SUB = 8
# the box walk (csrc/box_walk.cuh): at least BOX_CULL_MIN valid boxes, a
# node's worth (below it the walk's slab tests cost about what they
# save: a dense sweep of 64 boxes is one node's rows), at most
# MAX_ROWS of them (32 nodes: a lane's 32-bit node mask); leaves of
# BOX_LEAF boxes, BOX_FAN leaves a node; packed rows of BOX_ROW_COLS floats
# (frame, position, sizes, row id) after a BOX_HEAD-float header (the
# boxes' centre and the base growth g0); the kernels stage up to
# BOX_STAGE_MAX packed rows in shared memory (32 KB); a ray from o grows
# every box it tests by g0 + BOX_GROW |o - centre|_1, g0 = BOX_GROW0 +
# BOX_GROW * the boxes' radius
BOX_CULL_MIN = 64
BOX_LEAF, BOX_FAN = 8, 8
BOX_ROW_COLS, BOX_HEAD = 16, 8
BOX_STAGE_MAX = 512
BOX_GROW, BOX_GROW0 = 2e-4, 1e-3

_c_int, _c_ptr = ctypes.c_int, ctypes.c_void_p
# the packed table arguments (HitArgs.fwd), o, d and their strides, R, the
# mode, te, row, tx, xrow, the stream
KERNEL = CudaKernel(
    "hit3", "hit3.cu", ("hit3.cuh", "tri_walk.cuh", "sph_walk.cuh",
                        "box_walk.cuh", "grid.cuh"),
    "mrt_closest_hit",
    [_c_ptr] * 3 + [_c_int] * 4 + [_c_ptr] * 5)
# the dense schedule's resident warps per SM at P staged rows
DENSE_OCCUPANCY = CudaKernel(
    "hit3_dense_occupancy", "hit3.cu", KERNEL.headers,
    "mrt_closest_hit_dense_warps", [_c_int, _c_ptr])
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
        return _sphere_boxes(scene.inst_pos[s].detach(),
                             scene.prim_r[s].detach()[:, None],
                             scene.prim_valid[s][:, None], rows)


def _sphere_boxes(ip, r, valid, rows):
    """:func:`sph_blockbounds` of sphere centres ``ip`` (n, 3), radii
    ``r`` and valid flags ``valid`` (n, 1) in runs of ``rows`` rows (also
    of boxes: ``r`` (n, 3) their half extents, :func:`box_walk_tables`)."""
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
    """What the sphere walks read besides the cull blocks, where
    :func:`sph_culled` (else ``(None, None)``): :func:`walk_tables` of the
    row table."""
    if not sph_culled(scene, layout):
        return None, None
    return walk_tables(tab, layout)


def walk_tables(tab, layout):
    """The walk tables of the culled sphere segment (the first segment) of
    row table ``tab`` (its first 18 columns the sweep columns): its sweep
    columns packed 16 floats a row (frame (9), instance position (3),
    radius, valid, 0, 0: four 16-byte loads where the row table's 26-float
    rows take fourteen), and the AABBs of its :data:`SPH_SUB`-row
    sub-blocks (:func:`sph_blockbounds` of those, from the rows' centres,
    radii and valid flags) with each box's growth factor g = 1e-3 + 2e-6 /
    r (r its smallest valid radius) in column 6: the kernels grow a
    sub-block's box by g (1 + |o - centre|^2) for a ray from o, past the
    sphere test's rounding (csrc/sph_walk.cuh sub_touch). Without a
    gradient; the per-step and whole-trace kernels read them
    (``step.pack_step`` builds them once per table)."""
    with torch.no_grad():
        _kind, s, c, _n = layout[0][0]
        t = tab.detach()[s:s + c]
        rows = torch.cat([t[:, :_C_PA], t[:, _C_PR:_C_VALID + 1],
                          torch.zeros_like(t[:, :2])], 1).contiguous()
        r = t[:, _C_PR:_C_VALID]
        valid = t[:, _C_VALID:_C_GID] > 0.5
        sub = _sphere_boxes(t[:, _C_IP:_C_PA], r, valid, SPH_SUB)
        rr = torch.where(valid[:, 0], r[:, 0], BIG)
        rr = torch.nn.functional.pad(rr, (0, (-c) % SPH_SUB), value=BIG)
        rr = rr.view(-1, SPH_SUB).amin(1)
        sub[:, 6] = 1e-3 + 2e-6 / torch.clamp(rr, min=1e-6)
        return rows, sub


class BoxWalk(NamedTuple):
    """A walked box segment's tables (:func:`box_walk_tables`): ``tab``
    the flat float32 ``[header (BOX_HEAD) | node AABBs (nn, 8) | leaf AABBs
    (nl, 8) | packed rows (n, BOX_ROW_COLS)]`` and ``n`` its boxes."""

    tab: torch.Tensor
    n: int


def box_cull_rows(layout):
    """``(start, rows to sweep)`` of the box segment when it holds at least
    BOX_CULL_MIN rows up to its last valid one, else None."""
    for kind, s, _c, n in layout[0]:
        if kind == schema.KIND_BOX and n >= BOX_CULL_MIN:
            return s, n
    return None


def box_culled(scene, layout) -> bool:
    """Whether the kernels walk the box segment (``csrc/box_walk.cuh``): a
    textured scene without triangles (whose whole-trace instances have the
    walk: the untextured and Mesh-class instances keep their code and
    registers) with :func:`box_cull_rows` and at most MAX_ROWS dense
    rows."""
    return bool(scene.has_maps) and not layout[2] \
        and layout[1] <= MAX_ROWS and box_cull_rows(layout) is not None


def box_order(inst_pos, prim_valid):
    """Segment-local indices (numpy int64) of the valid rows among a box
    segment's swept rows (``inst_pos`` (n, 3) and ``prim_valid`` (n,)
    numpy, the compiled positions) in a median-split order over their
    centres: aligned runs of BOX_LEAF * BOX_FAN are nodes, runs of
    BOX_LEAF within them leaves (models/compiler.py _median_split_order,
    the sphere segment's order). The compiler keeps it on the scene
    (``SceneArrays.box_order``): it only sets which boxes share a leaf,
    the walk's bounds follow the current positions at every pack_step."""
    from ..models.compiler import _median_split_order

    idx = np.flatnonzero(prim_valid)
    ctr = np.asarray(inst_pos, np.float32)[idx]
    node = BOX_LEAF * BOX_FAN

    def split(ix, leaf):
        c = np.repeat(ctr[ix][:, None, :], 3, axis=1)
        return ix[_median_split_order(c, leaf)]

    order = split(np.arange(idx.size), node)
    order = np.concatenate([split(order[k:k + node], BOX_LEAF)
                            for k in range(0, order.size, node)])
    return idx[order]


def box_walk_tables(scene, layout, tab):
    """The box walk's :class:`BoxWalk` where :func:`box_culled`, else None
    (any device, without a gradient; ``step.pack_step`` builds it every
    time, in the compiled scene's walk order ``scene.box_order``): the
    valid box rows' sweep columns packed in walk order, 16 floats a row
    (frame (9), position (3), sizes (3), row id: four 16-byte loads, the
    row id the table's, so the row table keeps its order), each box's
    world AABB ``ip +- |M^-1| |sizes| / 2`` (M^-1 the frame's adjugate over
    its determinant) in runs of BOX_LEAF (leaves) and of BOX_LEAF *
    BOX_FAN (nodes), slacked as the sphere blocks (:func:`_sphere_boxes`),
    and the header: the
    nodes' centre and g0 = BOX_GROW0 + BOX_GROW * their radius (the
    kernels grow every box by g0 + BOX_GROW |o - centre|_1 for a ray from
    o: csrc/box_walk.cuh)."""
    if not box_culled(scene, layout):
        return None
    with torch.no_grad():
        s, n = box_cull_rows(layout)
        perm = scene.box_order
        t = tab.detach()[s:s + n].index_select(0, perm)
        fr, ip, sz = t[:, _C_FR:_C_IP], t[:, _C_IP:_C_PA], t[:, _C_PA:_C_PR]
        M = fr.reshape(-1, 3, 3)
        c0, c1, c2 = M[:, :, 0], M[:, :, 1], M[:, :, 2]
        adj = torch.stack([torch.linalg.cross(c1, c2),
                           torch.linalg.cross(c2, c0),
                           torch.linalg.cross(c0, c1)], 1)   # rows of M^-1 det
        det = (c0 * adj[:, 0]).sum(-1)
        det = torch.where(det == 0.0, 1.0, det)
        half = 0.5 * (torch.abs(adj) * torch.abs(sz)[:, None, :]).sum(-1) \
            / torch.abs(det)[:, None]
        ones = torch.ones_like(half[:, :1], dtype=torch.bool)
        leaves = _sphere_boxes(ip, half, ones, BOX_LEAF)
        nodes = _sphere_boxes(ip, half, ones, BOX_LEAF * BOX_FAN)
        lo, hi = nodes[:, :3].amin(0), nodes[:, 3:6].amax(0)
        ctr = 0.5 * (lo + hi)
        rad = 0.5 * torch.linalg.vector_norm(hi - lo)
        head = torch.cat([ctr, (BOX_GROW0 + BOX_GROW * rad)[None],
                          torch.zeros_like(ctr), torch.zeros_like(rad[None])])
        rows = torch.cat([fr, ip, sz, (s + perm).to(t.dtype)[:, None]], 1)
        flat = torch.cat([head, nodes.reshape(-1), leaves.reshape(-1),
                          rows.reshape(-1)]).contiguous()
        return BoxWalk(flat, int(perm.numel()))


def _box_parts(box):
    """``(header (8,), nodes (nn, 8), leaves (nl, 8), rows (n, 16))``
    views of a :class:`BoxWalk`."""
    nl = -(-box.n // BOX_LEAF)
    nn = -(-nl // BOX_FAN)
    t = box.tab
    a, b = BOX_HEAD + 8 * nn, BOX_HEAD + 8 * (nn + nl)
    return (t[:BOX_HEAD], t[BOX_HEAD:a].view(nn, 8), t[a:b].view(nl, 8),
            t[b:].view(box.n, BOX_ROW_COLS))


def _box_slab(bb, g, o, inv):
    """(tmin, tmax) (R, k) of rays ``o``, ``inv`` = 1/d against the boxes
    ``bb`` (k, 8) grown by ``g`` (R,): csrc/box_walk.cuh box_slab's
    operations in its order."""
    tmin = tmax = None
    for k in range(3):
        lo = bb[None, :, k] - g[:, None]
        hi = bb[None, :, 3 + k] + g[:, None]
        t1 = (lo - o[:, k:k + 1]) * inv[:, k:k + 1]
        t2 = (hi - o[:, k:k + 1]) * inv[:, k:k + 1]
        near, far = torch.minimum(t1, t2), torch.maximum(t1, t2)
        tmin = near if tmin is None else torch.maximum(tmin, near)
        tmax = far if tmax is None else torch.minimum(tmax, far)
    return tmin, tmax


def _box_touch(tmin, tmax, best):
    """box_walk.cuh box_touch: met at t >= 0 and entered at or before
    ``best`` (broadcast); a NaN is a touch."""
    return ~(tmax < torch.maximum(tmin, torch.zeros_like(tmin))) \
        & ~(tmin > best)


def _box_key(tmin):
    return torch.where(torch.isnan(tmin), -BIG, tmin)


def _nearest(mask, key):
    """(index, key) (R,) of each row's lowest key under ``mask`` (ties to
    the lowest index; inf where the mask is empty)."""
    cand = torch.where(mask, key, torch.full_like(key, float("inf")))
    m = cand.amin(dim=1)
    j = intersect.first_index(cand == m[:, None]).long()
    return j, m


def _box_walk(box, o, d, t0, ok, best, row, mode):
    """The box walk of csrc/box_walk.cuh on rays ``o``, ``d`` (R, 3) (no
    gradient): ``t0``, ``ok`` (R, n) are the packed rows' tests, ``best``,
    ``row`` (R,) the hit of the rows before the box segment. Returns the
    (R, n) bool of the packed rows the walk tests, the slab tests each
    ray makes and, for the any-hit, the rows up to its first hit. The
    closest hit visits the nodes nearest first and each node's leaves
    nearest first, ending a level at an entry t beyond the best (t, row)
    so far; the any-hit every node and leaf the ray meets, in order."""
    R, n = t0.shape
    head, nodes, leaves, rows = _box_parts(box)
    nn, nl = nodes.shape[0], leaves.shape[0]
    ids = rows[:, 15].long()
    inv = 1.0 / d
    g = head[3] + BOX_GROW * ((torch.abs(o[:, 0] - head[0])
                               + torch.abs(o[:, 1] - head[1]))
                              + torch.abs(o[:, 2] - head[2]))
    ntmin, ntmax = _box_slab(nodes, g, o, inv)
    ltmin, ltmax = _box_slab(leaves, g, o, inv)
    fan = torch.arange(BOX_FAN, device=o.device)
    leaf_n = torch.clamp(nl - torch.arange(nn, device=o.device) * BOX_FAN,
                         max=BOX_FAN)
    big = torch.full_like(best, BIG)
    if mode == MODE_ANY:
        node_on = _box_touch(ntmin, ntmax, big[:, None])
        leaf_on = _box_touch(ltmin, ltmax, big[:, None]) \
            & node_on[:, torch.arange(nl, device=o.device) // BOX_FAN]
        tested = leaf_on[:, torch.arange(n, device=o.device) // BOX_LEAF]
        hits = tested & ok
        found = hits.any(dim=1)
        first = intersect.first_index(hits).long()
        upto = tested.long().cumsum(1)
        rows_n = torch.where(found, upto.gather(1, first[:, None])[:, 0],
                             upto[:, -1])
        # a node's leaves are all slab-tested once the node is met
        last = torch.where(found, first // (BOX_LEAF * BOX_FAN), nn - 1)
        upto_node = torch.arange(nn, device=o.device)[None] <= last[:, None]
        slabs = nn + (node_on & upto_node).long().mul(leaf_n).sum(1)
        return tested, slabs, rows_n
    ar = torch.arange(R, device=o.device)
    tested = torch.zeros((R, n + 1), dtype=torch.bool, device=o.device)
    nkey, lkey = _box_key(ntmin), _box_key(ltmin)
    nm = _box_touch(ntmin, ntmax, best[:, None])
    slabs = torch.full((R,), nn, dtype=torch.int64, device=o.device)
    inf = torch.full_like(t0, float("inf"))
    tm_all = torch.where(ok, t0, inf)
    big_id = torch.full_like(ids, 1 << 30)
    for _ in range(nn):
        k, kt = _nearest(nm, nkey)
        go = nm.any(dim=1) & ~(kt > best)
        nm = nm & go[:, None]
        nm[ar, k] &= ~go
        slabs += torch.where(go, leaf_n[k], 0)
        lidx = k[:, None] * BOX_FAN + fan[None]
        lval = (lidx < nl) & go[:, None]
        lidx = lidx.clamp(max=nl - 1)
        lm = lval & _box_touch(ltmin.gather(1, lidx), ltmax.gather(1, lidx),
                               best[:, None])
        lk = lkey.gather(1, lidx)
        for _ in range(BOX_FAN):
            j, jt = _nearest(lm, lk)
            lgo = lm.any(dim=1) & ~(jt > best)
            lm = lm & lgo[:, None]
            lm[ar, j] &= ~lgo
            ridx = (k * BOX_FAN + j)[:, None] * BOX_LEAF + fan[None]
            rval = (ridx < n) & lgo[:, None]
            ridx = torch.where(rval, ridx, n)
            tested.scatter_(1, ridx, rval | tested.gather(1, ridx))
            rc = ridx.clamp(max=n - 1)
            tm = torch.where(rval, tm_all.gather(1, rc),
                             torch.full_like(best[:, None], float("inf")))
            m = tm.amin(dim=1)
            idm = torch.where(tm == m[:, None], ids[rc], big_id[rc]).amin(1)
            upd = (m < best) | ((m == best) & (idm < row))
            best = torch.where(upd, m, best)
            row = torch.where(upd, idm, row)
    tested = tested[:, :n]
    return tested, slabs, tested.long().sum(1)


def _box_walk_mask(box, s, o, d, t0, ok, best, row, mode):
    """The rows the box walk tests (:func:`_box_walk`) as an (R, c) bool
    over the box segment's rows (segment-local; ``t0``, ``ok`` its row
    tests in row order), the rest cleared, and its rows and slab tests
    per ray. With the mask the plain sweep's smallest (t, row) is the
    kernels'."""
    with torch.no_grad():
        loc = _box_parts(box)[3][:, 15].long() - s
        tested, slabs, rows = _box_walk(box, o, d, t0[:, loc], ok[:, loc],
                                        best, row.long(), mode)
        mask = torch.zeros(ok.shape, dtype=torch.bool, device=ok.device)
        mask[:, loc] = tested
        return mask, rows, slabs


def box_walk_work(tab, layout, o, d, mode, box):
    """(rows (R,), slabs (R,)) int64: the box rows and the node and leaf
    slab tests the walk (``csrc/box_walk.cuh``) makes for these rays in
    ``mode`` (any-hit: rows up to its first hit, none where a sphere or
    plane hits first; :func:`sweep_plain`'s ``box_work``). Counts the
    work behind a kernel's bound."""
    work = {}
    with torch.no_grad():
        sweep_plain(tab.detach(), layout, o.detach(), d.detach(), mode,
                    box=box, box_work=work)
    return work["rows"], work["slabs"]


def box_walk_phantoms(tab, layout, o, d, te, row, box):
    """(R,) bool: rays whose box winner (``te``, ``row`` of the dense
    sweep) lies outside a box the walk grows around it, its leaf's or its
    node's (the slab test's entry beyond te, or a miss): the only hits a
    walk could drop. The walk's bounds hold every box's hits, so none are
    expected (the host tests and chip_smoke.py count them)."""
    with torch.no_grad():
        s, _n = box_cull_rows(layout)
        head, nodes, leaves, rows = _box_parts(box)
        where = torch.full((int(tab.shape[0]),), -1, dtype=torch.int64,
                           device=o.device)
        where[rows[:, 15].long()] = torch.arange(box.n, device=o.device)
        p = where[row.long()]
        on = (te < BIG * 0.5) & (p >= 0)
        pc = p.clamp(min=0)
        inv = 1.0 / d
        g = head[3] + BOX_GROW * ((torch.abs(o[:, 0] - head[0])
                                   + torch.abs(o[:, 1] - head[1]))
                                  + torch.abs(o[:, 2] - head[2]))
        bad = torch.zeros_like(on)
        for bb, k in ((leaves, pc // BOX_LEAF),
                      (nodes, pc // (BOX_LEAF * BOX_FAN))):
            tmin, tmax = _box_slab(bb, g, o, inv)
            tmin = tmin.gather(1, k[:, None])[:, 0]
            tmax = tmax.gather(1, k[:, None])[:, 0]
            bad |= ~_box_touch(tmin, tmax, te)
        return on & bad


def check_box_walk(box, layout):
    """Validate a launch's box walk tables (a 16-byte aligned CUDA tensor
    of the layout's boxes); their C arguments (null and 0 without)."""
    if box is None:
        return [None, 0]
    nl = -(-box.n // BOX_LEAF)
    size = BOX_HEAD + 8 * (-(-nl // BOX_FAN) + nl) + BOX_ROW_COLS * box.n
    require_cuda_tensor("box walk", box.tab, torch.float32, (size,))
    if box.tab.data_ptr() % 16:
        raise ValueError("box walk tables are not 16-byte aligned")
    if box_cull_rows(layout) is None or layout[2] \
            or box.n > box_cull_rows(layout)[1]:
        raise ValueError("box walk tables for a layout that gets none "
                         "(box_culled)")
    return [ptr(box.tab), box.n]


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


def _tri_t(tri, row, o, d, w=None):
    """Differentiable t of triangle-local rows ``row`` (R,) for rays
    ``o``/``d``: the Woop plane form ``t = -(g.o + h)/(g.d)`` of
    pallas_tri._winner_t, in the sweep's operation order (so its value is
    the sweep's bit for bit); gradients reach ``G[2]``, ``h[2]``, ``o`` and
    ``d``. ``w``: the rows ``tri[row]`` if already gathered."""
    w = tri[row] if w is None else w
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
                      tbb=None, sbb=None, box=None):
    """Plain PyTorch closest hit of rays ``o``/``d`` ``(R, 3)`` against the
    row table ``tab`` (and the triangle tables, the sphere cull blocks,
    the box walk): returns ``(te, row, tx, xrow)`` like the kernel (any
    device)."""
    KERNEL.plain_calls += 1
    return sweep_plain(tab, layout, o, d, mode, tri, tbb, sbb, box)


def sweep_plain(tab, layout, o, d, mode=MODE_EXIT, tri=None, tbb=None,
                sbb=None, box=None, box_work=None):
    """The sweep of :func:`closest_hit_plain` without its call count: the
    plain whole trace runs it for every step. Differentiable: ``te`` and
    ``tx`` carry the winner row's t gradient (the masked min / max over the
    dense rows read at the winner row, the Woop plane form of a triangle
    winner): on a tie the lowest row takes it all, as in the kernels, where
    autograd of the min itself would split it among the tied rows (two
    boxes with a common face, a ray starting on it). With the sphere
    cull blocks ``sbb``, every sweep skips the blocks the kernel skips
    (:func:`_sph_cull`; an exit, the winner's own row, is unaffected);
    with the triangle cull blocks ``tbb`` every triangle entry culls, and
    the group exit too (:func:`_tri_exit`'s culled form: the kernels'
    ``tri_exit_culled``). With the box walk ``box``
    (:func:`box_walk_tables`) the box rows the walk does not test are
    cleared (:func:`_box_walk_mask`), as the kernels skip them, and a dict
    ``box_work`` gets the walk's rows and slab tests per ray under
    ``"rows"`` and ``"slabs"`` (:func:`box_walk_work`)."""
    fr, ipos, pa, pr, valid, gid = split_sweep(tab)
    segs, tri_start, _n_tri, tri_n = layout
    has_tri = _need_tri(layout, tri)
    R = o.shape[0]
    parts = [_kind_block(kind, s, s + c, fr, ipos, pa, pr, valid, o, d)
             for kind, s, c, _n in segs]
    if sbb is not None:
        # the sphere segment is the first (sph_cull_rows)
        t0s, t1s, oks = parts[0]
        with torch.no_grad():
            oks = _sph_cull(sbb, segs[0][3], o.detach(), d.detach(),
                            t0s.detach(), oks, mode)[0]
        parts[0] = (t0s, t1s, oks)
    if box is not None:
        # the box segment is the last dense one (box_culled: no triangles)
        t0b, t1b, okb = parts[-1]
        s = segs[-1][1]
        with torch.no_grad():
            if len(parts) > 1:
                tp = torch.cat([p[0] for p in parts[:-1]], 1).detach()
                op = torch.cat([p[2] for p in parts[:-1]], 1)
                tp = torch.where(op, tp, torch.full_like(tp, BIG))
                best = tp.amin(dim=1)
                prow = intersect.first_index(tp == best[:, None]).long()
                prow = torch.where(best < BIG, prow, 0)
            else:
                best = torch.full((R,), BIG, dtype=o.dtype, device=o.device)
                prow = torch.zeros(R, dtype=torch.int64, device=o.device)
            mask, rows, slabs = _box_walk_mask(box, s, o.detach(),
                                               d.detach(), t0b.detach(), okb,
                                               best, prow, mode)
            if box_work is not None:
                if mode == MODE_ANY:
                    # an any-hit ends at a sphere's or plane's hit before
                    # the boxes
                    pre = best < BIG * 0.5
                    rows = torch.where(pre, 0, rows)
                    slabs = torch.where(pre, 0, slabs)
                box_work["rows"], box_work["slabs"] = rows, slabs
        parts[-1] = (t0b, t1b, okb & mask)
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
            _b, trow, _n = _tri_entry(tri, tbb, tri_n, o, d, te.detach())
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
            _b, xr = _tri_exit(tri, tri_n, o, d, wg, tx.detach(), tbb)
        won = xr >= 0
        tx = torch.where(won, _tri_t(tri, xr.clamp(min=0), o, d), tx)
        xrow = torch.where(won, (tri_start + xr).to(torch.int32), xrow)
    return te, row, tx, xrow


def tri_rows_tested(tab, layout, o, d, mode, tri, tbb):
    """(R,) int64: the triangle rows the kernel tests for these rays in
    ``mode``, by its culling rule (entry: the rows of each touched block;
    exit: also the winner group's rows in each block the culled exit
    sweeps when a triangle wins; any-hit: rows up to the first hit).
    Counts the work behind a kernel's bound."""
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
        best, trow, tested = _tri_entry(tri, tbb, tri_n, o, d, te)
        if mode == MODE_EXIT:
            tested += _tri_exit_rows(tri, tbb, tri_n, o, d, trow)
        return tested


def _tri_exit_rows(tri, tbb, n, o, d, trow):
    """(R,) int64: the rows of the winner's group (triangle-local winner
    ``trow``, -1: none) in the blocks the culled exit sweeps (the kernels'
    ``tri_exit_culled``: every block of the group without ``tbb``)."""
    w = trow.clamp(min=0)
    gs = tri[w, _T_GS].long()
    ge = tri[w, _T_GE].clamp(max=n).long()
    gid = tri[w, _T_GID]
    won = trow >= 0
    tested = torch.zeros_like(trow)
    best = torch.full((o.shape[0],), -BIG, dtype=o.dtype, device=o.device)
    invd = _inv_dir(d) if tbb is not None else None
    for b, (lo, hi) in enumerate(_blocks(n)):
        span = (ge.clamp(max=hi) - gs.clamp(min=lo)).clamp(min=0)
        go = won & (span > 0)
        if tbb is not None:
            go = go & _slab_leave(tbb[b], o, invd, best)
        tested += torch.where(go, span, 0)
        t, ok = _tri_block(tri[lo:hi], o, d)
        ok = ok & (tri[None, lo:hi, _T_GID] == gid[:, None]) & go[:, None]
        best = torch.maximum(best, torch.where(ok, t, -BIG).amax(dim=1))
    return tested


def sph_rows_tested(tab, layout, o, d, mode, sbb):
    """(R,) int64: the sphere rows the lowest-first walk of 64-row blocks
    (``hit3.cuh`` ``sph_entry`` / ``sph_any``) tests for these rays in
    ``mode``, by its culling rule (entry and exit: the rows of each
    touched block; any-hit: rows up to the first hit; no cull blocks:
    every row of the sweep). Counts the work behind a kernel's bound (the
    sub-block walks of ``csrc/sph_walk.cuh``: ``chip_smoke.sph_walk_work``)."""
    R = o.shape[0]
    segs = layout[0]
    if not segs or segs[0][0] != schema.KIND_SPHERE:
        return torch.zeros(R, dtype=torch.int64, device=o.device)
    n = segs[0][3]
    if sbb is None:
        return torch.full((R,), n, dtype=torch.int64, device=o.device)
    with torch.no_grad():
        o, d = o.detach(), d.detach()
        fr, ipos, pa, pr, valid, _gid = split_sweep(tab.detach())
        t0, _t1, ok = _kind_block(schema.KIND_SPHERE, 0, segs[0][2], fr,
                                  ipos, pa, pr, valid, o, d)
        return _sph_cull(sbb, n, o, d, t0, ok, mode)[1]


def check_walk_tables(srows, ssb, layout):
    """Validate the sphere walk tables of a launch (16-byte aligned CUDA
    tensors of the segment's rows and sub-blocks); their pointers."""
    c = layout[0][0][2]
    for name, t, shape in (("srows", srows, (c, 16)),
                           ("ssb", ssb, (-(-c // SPH_SUB), BB_COLS))):
        require_cuda_tensor(name, t, torch.float32, shape)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    return [ptr(srows), ptr(ssb)]


class HitArgs(NamedTuple):
    """The launch arguments of the closest hit and its VJP for one set of
    tables (:func:`hit_args`): checked and packed once, so that a call
    checks only its rays. ``key``: the tables they were built from
    ``(tab, layout, tri, tbb, sbb, srows, ssb, box)``, which they keep
    alive; ``fwd`` / ``bwd``: the addresses of the packed table arguments
    of ``mrt_closest_hit`` and ``mrt_hit3_bwd`` (``bwd`` 0 where the table
    is wider than :data:`BWD_COLS`); ``packed``: those two int64 arrays;
    ``variant``: the counted variant of the launch; ``n_dense``, ``P``,
    ``C``: the dense rows and the table's shape; ``n_tri``: the triangle
    table's rows (0 without)."""

    key: tuple
    device: torch.device
    fwd: int
    bwd: int
    packed: tuple
    variant: str | None
    n_dense: int
    P: int
    C: int
    n_tri: int


def _c_value(v) -> int:
    """A C argument as an integer: a pointer's address, 0 for None."""
    if v is None:
        return 0
    return (v.value or 0) if isinstance(v, ctypes.c_void_p) else int(v)


def _pack(vals):
    """An int64 array of C arguments (:func:`_c_value`) and its address."""
    arr = (ctypes.c_int64 * len(vals))(*map(_c_value, vals))
    return arr, ctypes.addressof(arr)


def hit_args(tab, layout, tri=None, tbb=None, sbb=None, walk=None,
             box=None):
    """Check the tables of a :func:`closest_hit` (the arguments of that
    name) and pack their C arguments once: a :class:`HitArgs` for
    :func:`launch_hit` and :func:`hit_bwd`. ``walk`` None with ``sbb``:
    the walk tables are built here from ``tab``."""
    has_tri = _need_tri(layout, tri)
    require_cuda_tensor("table", tab, torch.float32)
    P, C = tab.shape
    if C < SWEEP_COLS:
        raise ValueError(f"table: {C} columns, the sweep needs "
                         f"{SWEEP_COLS}")
    # past the staged cull blocks the kGlobal instance reads them in place
    check_cull_tables(layout, tri, tbb, sbb, None)
    walk_ptrs = [None, None]
    if sbb is not None:
        walk = walk_tables(tab, layout) if walk is None else walk
        walk_ptrs = check_walk_tables(*walk, layout)
    else:
        walk = (None, None)
    box_args = check_box_walk(box, layout)
    fwd, fwd_at = _pack([ptr(tab), layout[1], C,
                         *table_args(layout, tri, tbb, sbb), *walk_ptrs,
                         *box_args])
    bwd, bwd_at = None, 0
    if C <= BWD_COLS:
        n_tri = layout[2] if has_tri else 0
        bwd, bwd_at = _pack([ptr(tab), layout[1], C, *_table_ints(layout),
                             ptr(tri) if has_tri else None, layout[1],
                             layout[3] if has_tri else 0, P, n_tri])
    return HitArgs((tab, layout, tri, tbb, sbb, *walk, box), tab.device,
                   fwd_at, bwd_at, (fwd, bwd),
                   None if box is None else "box_walk", layout[1], P, C,
                   layout[2] if has_tri else 0)


def _check_rays(dev, o, d):
    """Raise unless ``o`` and ``d`` are (R, 3) float32 tensors on ``dev``
    with the same strides (any strided view: the kernels take strides)."""
    if o.dtype is not torch.float32 or d.dtype is not torch.float32 \
            or o.get_device() != dev.index or d.get_device() != dev.index \
            or o.dim() != 2 or o.shape[1] != 3 or d.shape != o.shape \
            or o.stride() != d.stride():
        raise ValueError(f"rays: expected two (R, 3) float32 tensors of "
                         f"equal strides on {dev}, got {tuple(o.shape)} "
                         f"{o.dtype} {o.stride()} on {o.device} and "
                         f"{tuple(d.shape)} {d.dtype} {d.stride()} on "
                         f"{d.device}")


def launch_hit(args, o, d, mode=MODE_EXIT):
    """:func:`closest_hit` on CUDA rays ``o``, ``d`` (R, 3) through the
    launch arguments ``args`` of its tables (:func:`hit_args`): checks the
    rays, allocates the outputs and launches ``mrt_closest_hit``."""
    dev = args.device
    _check_rays(dev, o, d)
    R = o.shape[0]
    te = torch.empty(R, dtype=torch.float32, device=dev)
    tx = torch.empty(R, dtype=torch.float32, device=dev)
    row = torch.empty(R, dtype=torch.int32, device=dev)
    xrow = torch.empty(R, dtype=torch.int32, device=dev)
    if R:
        KERNEL.launch(args.fwd, o.data_ptr(), d.data_ptr(), *o.stride(), R,
                      mode, te.data_ptr(), row.data_ptr(), tx.data_ptr(),
                      xrow.data_ptr(), raw_stream(dev),
                      variant=args.variant)
    return te, row, tx, xrow


def closest_hit(tab, layout, o, d, mode=MODE_EXIT, tri=None, tbb=None,
                sbb=None, walk=None, box=None):
    """``(te, row, tx, xrow)`` of rays ``o``/``d`` ``(R, 3)`` float32
    against the row table ``tab`` ``(P, C >= 18)`` and, for a scene with
    triangles, its :func:`tri_tables` ``tri`` and ``tbb``; with a long
    sphere segment, its cull blocks ``sbb`` (:func:`sph_table`) and the
    walk tables ``walk`` = ``(srows, ssb)`` (:func:`sph_walk_tables`;
    None: built here from ``tab``); with a walked box segment its
    :class:`BoxWalk` ``box`` (:func:`box_walk_tables`; None: the box rows
    swept dense).

    CUDA tensors launch ``mrt_closest_hit``; the rays may be any strided
    view, such as the transpose of lane-major ``(3, R)`` rays. CPU tensors
    run :func:`closest_hit_plain`. Any number of dense rows: past
    :data:`MAX_ROWS` a culled sphere segment is walked as below it (the
    kWalk instances, up to :data:`SPH_MAX_BLOCKS` blocks), and a scene
    without a walk reads its dense rows from global memory (the kGlobal
    instance, ``csrc/hit3.cu``), as it does the cull blocks of a triangle
    segment past :data:`MAX_TRI_BLOCKS`. No gradient: :class:`ClosestHit`
    is the differentiable closest hit."""
    if o.device.type == "cpu":
        return closest_hit_plain(tab, layout, o, d, mode, tri, tbb, sbb,
                                 box)
    return launch_hit(hit_args(tab, layout, tri, tbb, sbb, walk, box), o, d,
                      mode)


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


def any_hit(tab, layout, o, d, tri=None, tbb=None, sbb=None, walk=None,
            box=None):
    """(R,) bool: does each ray hit any valid row?"""
    return closest_hit(tab, layout, o, d, MODE_ANY, tri, tbb, sbb,
                       walk, box)[0] < BIG * 0.5


# --- the differentiable closest hit: the winner rows' t and its VJP ---------

# the row cotangents the VJP kernel writes: the whole trace's row table's
# columns (step.ROW_COLS), of which it fills the sweep columns 0-15
BWD_COLS = 26
# the VJP kernel: the packed table arguments (HitArgs.bwd), o, d and their
# strides, R, the mode, te, tx, row, xrow, the cotangents of te and tx,
# d_o, d_d, d_tab, d_tri, the workspace, the stream
BWD_KERNEL = CudaKernel(
    "hit3_bwd", "hit3_bwd.cu", ("hit3.cuh", "trace_step.cuh",
                                "trace_bwd.cuh", "grid.cuh"),
    "mrt_hit3_bwd",
    [_c_ptr] * 3 + [_c_int] * 4 + [_c_ptr] * 12)
BWD_OCCUPANCY = CudaKernel(
    "hit3_bwd_occupancy", "hit3_bwd.cu", BWD_KERNEL.headers,
    "mrt_hit3_bwd_warps", [_c_int, _c_int, _c_ptr])


def resident_warps(P: int, bwd: bool = False, tri: bool = False) -> int:
    """Warps per SM the card keeps resident of the dense schedule's kernel
    at P staged rows, or (``bwd``) of the VJP kernel's instance (``tri``:
    with triangles) at P dense rows (``cudaOccupancyMaxActiveBlocksPer
    Multiprocessor``). Builds the kernel if needed."""
    warps = ctypes.c_int(0)
    if bwd:
        rc = BWD_OCCUPANCY.fn()(P, int(tri), ctypes.byref(warps))
    else:
        rc = DENSE_OCCUPANCY.fn()(P, ctypes.byref(warps))
    if rc != 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {rc}")
    return warps.value


# the VJP's workspace on each (device, stream): a ticket, the float64 row
# sums and the triangle rows' float32 sums, zero between launches (the
# kernel returns it to zero); grown, never shrunk
_BWD_WORKSPACE: dict = {}
_TICKET_BYTES = 16


def bwd_workspace(dev, stream: int, n_dense: int, n_tri: int):
    """The zeroed workspace of ``mrt_hit3_bwd`` on device ``dev`` and CUDA
    stream ``stream`` for ``n_dense`` dense and ``n_tri`` triangle rows:
    a uint8 tensor of at least 16 + 8 * 16 * n_dense + 16 * n_tri bytes
    (the sums of the 16 sweep columns of each dense row, of the 4 Woop
    columns of each triangle row),
    zeroed when it is made or grown (the only memset)."""
    need = _TICKET_BYTES + 8 * 16 * n_dense + 16 * n_tri
    key = (dev, stream)
    ws = _BWD_WORKSPACE.get(key)
    if ws is None or ws.numel() < need:
        grow = 0 if ws is None else 2 * ws.numel()
        ws = torch.zeros(max(need, grow), dtype=torch.uint8, device=dev)
        _BWD_WORKSPACE[key] = ws
    return ws


def row_ends(layout):
    """End rows of the sphere and plane segments and the first triangle
    row: the kind of a winner row (the kernels' row_kind)."""
    ints = layout_ints(layout)
    return ints[0] + ints[1], ints[2] + ints[3], layout[1]


def _row_t(tab, layout, o, d, row, exit_side, tri, gathered=None):
    """Differentiable t of each ray's row ``row`` (R,): the entry t, or
    with ``exit_side`` the exit t, by the row's kind (pallas_hit3's
    ``_winner_t_all``): the sphere's near or far root, the plane equation,
    the box's largest slab entry or smallest slab exit (``amax`` / ``amin``
    of the three axes: a tied axis shares the cotangent evenly, as
    autograd of ``jnp.max`` does), the Woop plane form of a triangle row
    (:func:`_tri_t`). Every division and root is guarded before the op, so
    an unselected kind or a missed ray gives no NaN. ``gathered`` (a list)
    gets ``(table, rows, gathered rows)`` of each gather, whose gradients
    are the per-ray terms of the table cotangents."""
    P_nt = layout[1]
    sph_end, pln_end, tri_start = row_ends(layout)
    one = torch.ones((), dtype=o.dtype, device=o.device)
    t = torch.zeros_like(o[:, 0])
    if P_nt:
        rc = row.long().clamp(max=P_nt - 1)
        at = tab[:, :_C_PR + 1][rc]
        if gathered is not None:
            gathered.append(("tab", rc, at))
        f, ip, pa, r = at[:, 0:9], at[:, 9:12], at[:, 12:15], at[:, 15]
        rel = o - ip
        op = torch.stack([f[:, 3 * k] * rel[:, 0] + f[:, 3 * k + 1] * rel[:, 1]
                          + f[:, 3 * k + 2] * rel[:, 2] + ip[:, k]
                          for k in range(3)], 1)
        dp = torch.stack([f[:, 3 * k] * d[:, 0] + f[:, 3 * k + 1] * d[:, 1]
                          + f[:, 3 * k + 2] * d[:, 2] for k in range(3)], 1)
        # sphere
        oc = op - ip
        a = intersect._dot(dp, dp)
        bq = 2.0 * intersect._dot(oc, dp)
        c = intersect._dot(oc, oc) - r * r
        disc = bq * bq - 4.0 * a * c
        sq = torch.sqrt(torch.where(disc >= 0.0,
                                    torch.clamp(disc, min=1e-12), one))
        a2 = torch.where(a == 0.0, one, 2.0 * a)
        t_sph = ((-bq + sq) if exit_side else (-bq - sq)) / a2
        # plane
        nn = intersect._dot(pa, pa)
        nrm = pa / torch.sqrt(torch.where(nn > 0.0, nn, one))[:, None]
        dn = intersect._dot(dp, nrm)
        t_pln = -(intersect._dot(op, nrm) - intersect._dot(nrm, ip)) \
            / torch.where(dn == 0.0, one, dn)
        # box
        zero = dp == 0.0
        mm = torch.where(zero, torch.full_like(dp, 1.0 / EPS),
                         1.0 / torch.where(zero, one, dp))
        nb = (op - ip) * mm
        kb = 0.5 * pa * torch.abs(mm)
        t_box = (-nb + kb).amin(dim=1) if exit_side \
            else (-nb - kb).amax(dim=1)
        t = torch.where(row < sph_end, t_sph,
                        torch.where(row < pln_end, t_pln, t_box))
    if layout[2]:
        rt = (row.long() - tri_start).clamp(0, tri.shape[0] - 1)
        w = tri[rt]
        if gathered is not None:
            gathered.append(("tri", rt, w))
        t = torch.where(row >= tri_start, _tri_t(tri, rt, o, d, w), t)
    return t


def winner_t_plain(tab, layout, o, d, row, xrow=None, tri=None):
    """``(te, tx)``: the entry t of each ray's winner row ``row`` and the
    exit t of its exit row ``xrow`` (None: the entry-only mode, ``tx =
    te``), recomputed differentiably from the row table ``tab`` (its sweep
    columns 0-15), the triangle table ``tri`` (its ``G[2]``, ``h[2]``) and
    the rays ``o``, ``d`` (R, 3): the plain version of the closest hit's
    VJP (pallas_hit3's ``_winner_t_all``, the kernel ``csrc/hit3_bwd.cu``).
    Autograd of it is the backward of :class:`ClosestHit`."""
    te = _row_t(tab, layout, o, d, row, False, tri)
    if xrow is None:
        return te, te
    return te, _row_t(tab, layout, o, d, xrow, True, tri)


def _masked_cts(mode, te, tx, ct_te, ct_tx):
    """The cotangents that reach the winner rows (pallas_hit3's VJP):
    ``te``'s where the ray hit, ``tx``'s where it hit and has an exit; in
    the entry-only mode ``tx`` is ``te``, so both reach its row."""
    hit_e = te < BIG * 0.5
    ct_te = torch.zeros_like(te) if ct_te is None else ct_te
    ct_tx = torch.zeros_like(te) if ct_tx is None else ct_tx
    ce = torch.where(hit_e, ct_te, 0.0)
    cx = torch.where(hit_e & (tx > -BIG * 0.5), ct_tx, 0.0)
    if mode == MODE_ENTRY:
        return ce + cx, torch.zeros_like(cx)
    return ce, cx


def closest_hit_bwd_plain(tab, layout, o, d, mode, te, row, tx, xrow,
                          ct_te, ct_tx, tri=None):
    """Plain version of :func:`closest_hit_bwd`: autograd of
    :func:`winner_t_plain` (any device). Returns ``(d_tab (P, C), d_tri,
    d_o, d_d)``; ``d_tri`` is None without a triangle table."""
    BWD_KERNEL.plain_calls += 1
    ce, cx = _masked_cts(mode, te, tx, ct_te, ct_tx)
    ins = [t.detach().requires_grad_(True) for t in (tab, o, d)]
    if tri is not None:
        ins.append(tri.detach().requires_grad_(True))
    with torch.enable_grad():
        te_r, tx_r = winner_t_plain(
            ins[0], layout, ins[1], ins[2], row,
            None if mode == MODE_ENTRY else xrow,
            ins[3] if tri is not None else None)
        outs, cts = [te_r], [ce]
        if mode != MODE_ENTRY:
            outs, cts = [te_r, tx_r], [ce, cx]
        grads = torch.autograd.grad(outs, ins, cts, allow_unused=True)
    g = [torch.zeros_like(x) if gr is None else gr
         for gr, x in zip(grads, ins)]
    return g[0], g[3] if tri is not None else None, g[1], g[2]


def closest_hit_bwd(tab, layout, o, d, mode, te, row, tx, xrow, ct_te,
                    ct_tx, tri=None):
    """The closest hit's VJP: for the cotangents ``ct_te``, ``ct_tx`` (R,)
    of a :func:`closest_hit` that gave ``(te, row, tx, xrow)`` on rays
    ``o``, ``d`` in ``mode``, the cotangents of the row table ``(P, C)``
    (its sweep columns 0-15 of the winner rows), of the triangle table
    ``(Pt, 16)`` (its ``G[2]``, ``h[2]`` columns; None without one) and of
    ``o`` and ``d`` (R, 3). CUDA tensors launch ``mrt_hit3_bwd`` once
    (:func:`hit_bwd`; the row cotangents float64 sums, so they vary from
    run to run only where their float32 rounding does); CPU tensors run
    :func:`closest_hit_bwd_plain`."""
    if o.device.type == "cpu":
        return closest_hit_bwd_plain(tab, layout, o, d, mode, te, row, tx,
                                     xrow, ct_te, ct_tx, tri)
    return hit_bwd(hit_args(tab, layout, tri), o, d, mode, te, row, tx,
                   xrow, ct_te, ct_tx, tri)


def _vec(name, t, dtype, R, dev):
    """A per-ray (R,) input of the VJP kernel, contiguous (a copy only
    where it is not, such as an expanded cotangent)."""
    if t.dtype is not dtype or t.get_device() != dev.index or t.dim() != 1 \
            or t.shape[0] != R:
        raise ValueError(f"{name}: expected ({R},) {dtype} on {dev}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    return t if t.is_contiguous() else t.contiguous()


def hit_bwd(args, o, d, mode, te, row, tx, xrow, ct_te, ct_tx, tri=None):
    """:func:`closest_hit_bwd` through the launch arguments ``args`` of
    its tables (:func:`hit_args`): one device operation, the kernel, which
    masks the cotangents (``None``: zeros), writes every entry of its
    outputs (allocated uninitialized here) and sums the rows in this
    device's workspace (:func:`bwd_workspace`)."""
    if not args.bwd:
        raise ValueError(f"table: {args.C} columns, the backward takes "
                         f"{SWEEP_COLS} to {BWD_COLS}")
    dev = args.device
    _check_rays(dev, o, d)
    R = o.shape[0]
    te = _vec("te", te, torch.float32, R, dev)
    tx = _vec("tx", tx, torch.float32, R, dev)
    row = _vec("row", row, torch.int32, R, dev)
    xrow = _vec("xrow", xrow, torch.int32, R, dev)
    cts = [None if c is None else _vec(n, c, torch.float32, R, dev)
           for n, c in (("ct_te", ct_te), ("ct_tx", ct_tx))]
    d_tab = torch.empty((args.P, BWD_COLS), dtype=torch.float32, device=dev)
    d_o = torch.empty((R, 3), dtype=torch.float32, device=dev)
    d_d = torch.empty((R, 3), dtype=torch.float32, device=dev)
    d_tri = None
    if args.n_tri:
        d_tri = torch.empty((args.n_tri, TRI_COLS), dtype=torch.float32,
                            device=dev)
    stream = raw_stream(dev)
    ws = bwd_workspace(dev, stream, args.n_dense, args.n_tri)
    BWD_KERNEL.launch(args.bwd, o.data_ptr(), d.data_ptr(), *o.stride(), R,
                      0 if mode == MODE_ENTRY else 1, te.data_ptr(),
                      tx.data_ptr(), row.data_ptr(), xrow.data_ptr(),
                      *(None if c is None else c.data_ptr() for c in cts),
                      d_o.data_ptr(), d_d.data_ptr(), d_tab.data_ptr(),
                      None if d_tri is None else d_tri.data_ptr(),
                      ws.data_ptr(), stream)
    if d_tri is None and tri is not None:
        d_tri = torch.zeros_like(tri)
    return d_tab if args.C == BWD_COLS else d_tab[:, :args.C], d_tri, d_o, \
        d_d


class ClosestHit(torch.autograd.Function):
    """The differentiable closest hit (pallas_hit3's ``make_closest_hit``):
    forward :func:`closest_hit` (the ``hit3.cu`` kernel on CUDA tensors,
    :func:`closest_hit_plain` on CPU tensors), backward
    :func:`closest_hit_bwd`, which recomputes the entry t at ``row`` and
    the exit t at ``xrow`` and sends ``te``'s cotangent where the ray hit
    and ``tx``'s where it also has an exit to those rows' sweep columns
    0-15 (frame, position, plane normal / box sizes, radius), the triangle
    table's Woop columns, ``o`` and ``d``. ``row`` and ``xrow`` get none.

    ``ClosestHit.apply(tab, tri, o, d, layout, mode, tbb, sbb, walk,
    box, args)``: the arguments of :func:`closest_hit` (``tri`` None
    without triangles); the tables are those of ``step.pack_step``, walks
    included, so the forward is the fused path's sweep. ``args``: their
    :class:`HitArgs` (``step.hit_args``) on CUDA tables, which the
    forward and the backward launch through, or None: built per call."""

    @staticmethod
    def forward(ctx, tab, tri, o, d, layout, mode, tbb=None, sbb=None,
                walk=None, box=None, args=None):
        if args is None:
            te, row, tx, xrow = closest_hit(tab, layout, o, d, mode, tri,
                                            tbb, sbb, walk, box)
        else:
            te, row, tx, xrow = launch_hit(args, o, d, mode)
        ctx.save_for_backward(tab, tri, o, d, te, row, tx, xrow)
        ctx.layout, ctx.mode, ctx.args = layout, mode, args
        ctx.mark_non_differentiable(row, xrow)
        return te, row, tx, xrow

    @staticmethod
    def backward(ctx, ct_te, _ct_row, ct_tx, _ct_xrow):
        tab, tri, o, d, te, row, tx, xrow = ctx.saved_tensors
        tri_ = tri if ctx.layout[2] else None
        if ctx.args is None:
            d_tab, d_tri, d_o, d_d = closest_hit_bwd(
                tab, ctx.layout, o, d, ctx.mode, te, row, tx, xrow, ct_te,
                ct_tx, tri_)
        else:
            d_tab, d_tri, d_o, d_d = hit_bwd(ctx.args, o, d, ctx.mode, te,
                                             row, tx, xrow, ct_te, ct_tx,
                                             tri_)
        if tri is not None and d_tri is None:
            d_tri = torch.zeros_like(tri)
        return (d_tab, d_tri, d_o, d_d, None, None, None, None, None, None,
                None)
