"""Closest-hit over the dense sphere/plane/box segments: the hand-written
CUDA kernel ``csrc/hit3.cu`` (sweep in ``csrc/hit3.cuh``), its wrapper, and
its plain PyTorch version.

The counterpart of ``micro_raytracer_tpu.ops.pallas_hit3`` for scenes
without triangles: :func:`pack_scene` builds the same per-row sweep tables
(``fr, ipos, pa, pr, valid, gid``) as the columns of one ``(P, 18)`` row
table, :func:`closest_hit` returns the same ``(te, row, tx, xrow)``
quadruple — misses give ``te = BIG``, ``row = 0``, ``tx = -BIG``, ``xrow =
0`` — and :func:`any_hit` the occlusion bit. Both take any row table whose
first 18 columns are the sweep columns, such as the whole-trace kernel's.

:func:`closest_hit` launches the kernel for CUDA tensors and runs
:func:`closest_hit_plain` for CPU tensors; there is no other path. On the
render path it is the primary-hit pass of :func:`step.trace_packed`.
"""

from __future__ import annotations

import ctypes

import torch

from ..models import schema
from ..utils.kernels import (CudaKernel, ptr, require_cuda_tensor,
                             stream_ptr)
from . import intersect
from .linalg import EPS

BIG = 3.0e38
SWEEP_COLS = 18          # fr(9) ipos(3) pa(3) pr valid gid
_C_FR, _C_IP, _C_PA, _C_PR, _C_VALID, _C_GID = 0, 9, 12, 15, 16, 17
# shared-memory bound of the kernel: 2048 rows * 72 B = 144 KB per block
MAX_ROWS = 2048

_c_int, _c_ptr = ctypes.c_int, ctypes.c_void_p
KERNEL = CudaKernel(
    "hit3", "hit3.cu", ("hit3.cuh",), "mrt_closest_hit",
    [_c_ptr, _c_int, _c_int] + [_c_int] * 6 + [_c_ptr, _c_ptr]
    + [_c_int] * 4 + [_c_ptr] * 4 + [_c_ptr])
# entry only (tx = te); entry and group exit; any-hit (te = -BIG on a hit)
MODE_ENTRY, MODE_EXIT, MODE_ANY = 0, 1, 2


def seg_layout(kind_counts):
    """Static ``((kind, start, count), ...)`` of the non-empty dense
    segments, the triangle start and the triangle count."""
    segs, start = [], 0
    for kind in (schema.KIND_SPHERE, schema.KIND_PLANE, schema.KIND_BOX):
        c = kind_counts[kind]
        if c:
            segs.append((kind, start, c))
        start += c
    return tuple(segs), start, kind_counts[schema.KIND_TRIANGLE]


def layout_ints(layout):
    """The six ints (start, count per dense kind) the kernels take. An
    absent kind starts where the previous segment ends, so the kernels'
    row-bound kind tests stay ordered."""
    bounds = {kind: (s, c) for kind, s, c in layout[0]}
    ints, prev = [], 0
    for kind in (schema.KIND_SPHERE, schema.KIND_PLANE, schema.KIND_BOX):
        s, c = bounds.get(kind, (prev, 0))
        ints += [s, c]
        prev = s + c
    return ints


def pack_scene(scene, frames):
    """The ``(P, 18)`` float32 sweep table: columns ``fr (9), ipos (3), pa
    (3), pr, valid, gid``, the dense part of pallas_hit3.pack_scene."""
    intersect.check_scene_class(scene)
    P = scene.n_prims
    return torch.cat([
        frames.reshape(P, 9), scene.inst_pos, scene.prim_a,
        scene.prim_r[:, None], scene.prim_valid.to(torch.float32)[:, None],
        scene.group_id.to(torch.float32)[:, None]], dim=1)


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


def closest_hit_plain(tab, layout, o, d, mode=MODE_EXIT):
    """Plain PyTorch closest hit of rays ``o``/``d`` ``(R, 3)`` against the
    row table ``tab``: returns ``(te, row, tx, xrow)`` like the kernel (any
    device)."""
    KERNEL.plain_calls += 1
    fr, ipos, pa, pr, valid, gid = split_sweep(tab)
    segs, _tri_start, n_tri = layout
    if n_tri:
        raise NotImplementedError(intersect.UNPORTED_TRIANGLES)
    parts = [_kind_block(kind, s, s + c, fr, ipos, pa, pr, valid, o, d)
             for kind, s, c in segs]
    t0 = torch.cat([p[0] for p in parts], dim=1)
    t1 = torch.cat([p[1] for p in parts], dim=1)
    ok = torch.cat([p[2] for p in parts], dim=1)
    R = o.shape[0]
    big = torch.full_like(t0, BIG)
    if mode == MODE_ANY:
        te = torch.where(ok.any(dim=1), -BIG, BIG).to(o.dtype)
        zero = torch.zeros(R, dtype=torch.int32, device=o.device)
        return te, zero, te, zero
    # entry: smallest t0, first row on ties; a miss keeps BIG and row 0
    tm = torch.where(ok, t0, big)
    te = tm.amin(dim=1)
    row = intersect.first_index(tm == te[:, None])
    if mode == MODE_ENTRY:
        return te, row, te, row
    # exit: largest t1 over the winner's group; a miss has no group
    g = gid[:, 0]
    wg = torch.where(ok.any(dim=1), g[row.long()], torch.full_like(te, BIG))
    me = torch.where(ok & (g[None, :] == wg[:, None]), t1, -big)
    tx = me.amax(dim=1)
    xrow = intersect.first_index(me == tx[:, None])
    return te, row, tx, xrow


def closest_hit(tab, layout, o, d, mode=MODE_EXIT):
    """``(te, row, tx, xrow)`` of rays ``o``/``d`` ``(R, 3)`` float32
    against the row table ``tab`` ``(P, C >= 18)``.

    CUDA tensors launch ``mrt_closest_hit``; the rays may be any strided
    view, such as the transpose of lane-major ``(3, R)`` rays. CPU tensors
    run :func:`closest_hit_plain`."""
    if o.device.type == "cpu":
        return closest_hit_plain(tab, layout, o, d, mode)
    if layout[2]:
        raise NotImplementedError(intersect.UNPORTED_TRIANGLES)
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
    if P > MAX_ROWS:
        raise ValueError(f"closest_hit kernel: {P} rows exceed the "
                         f"shared-memory bound of {MAX_ROWS}")
    te = torch.empty(R, dtype=torch.float32, device=o.device)
    tx = torch.empty_like(te)
    row = torch.empty(R, dtype=torch.int32, device=o.device)
    xrow = torch.empty_like(row)
    if R:
        KERNEL.launch(ptr(tab), P, C, *layout_ints(layout), ptr(o), ptr(d),
                      *o.stride(), R, mode, ptr(te), ptr(row), ptr(tx),
                      ptr(xrow), stream_ptr(o.device))
    return te, row, tx, xrow


def any_hit(tab, layout, o, d):
    """(R,) bool: does each ray hit any valid row?"""
    return closest_hit(tab, layout, o, d, MODE_ANY)[0] < BIG * 0.5
