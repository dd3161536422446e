"""The triangle segment on its own: the hand-written CUDA kernels of
``csrc/tri.cu``, their wrappers, their plain PyTorch versions and their
autograd functions.

The counterpart of ``micro_raytracer_tpu.ops.pallas_tri``: on the triangle
table of :func:`hit3.tri_tables` (``(Pt, 16)``: pallas_tri.pack_consts'
``AT | HT | thr`` with the group id and each row's group range),
:func:`tri_entry` returns the nearest valid triangle of each ray ``(te,
row)``, :func:`tri_entry_exit` also the farthest valid triangle of the
winner's own group ``(tx, xrow)``, and :func:`tri_group_exit` the farthest
valid triangle of a given group. Rows are triangle-local; misses give ``te
= BIG, row = 0, tx = -BIG, xrow = 0``. The test is pallas_tri._tri_block's
Woop form in its operation order (``hit3._tri_block``), the first row wins
ties.

With the segment's cull blocks ``tbb`` the entry sweeps cull per ray as
the port's other triangle sweeps do (``hit3._tri_entry``): a block the ray
misses, or enters beyond its best t so far, is skipped. The kernels walk
the blocks through superblocks of :data:`SUPER` blocks (``tsb``,
:func:`superbounds`, built with the table), which skip only blocks the
one-level walk skips, so the outputs are the one-level walk's bit for
bit. :func:`tri_entry_exit`'s group exit culls too (``hit3._tri_exit``
with ``tbb``): a block the ray misses, or leaves before its best exit t so
far, is skipped. pallas_tri sweeps every row; the two differ only on
"phantom" ``|det| >= E`` hits outside their block's AABB. The group exit
of :func:`tri_group_exit` never culls.

The per-step path (``ops/step.py``) launches :func:`tri_entry` (opaque
scenes) or :func:`tri_entry_exit` (refractive ones) before each bounce step
of a scene whose triangle segment has more than ``hit3.MAX_TRI_BLOCKS``
cull blocks, reading the rays straight from the step's carry and skipping
its dead lanes (``live``). It passes :func:`tri_entry_exit` the rows whose
material can refract (``refr``): a winner on any other row is its own exit
(``tx = te``, ``xrow = row``), as the step never reads that exit, so an
opaque mesh in a scene with glass elsewhere skips the whole-group walk.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors; there is no other path. Under autograd the
cotangent of ``te`` (and ``tx``) reaches the table's ``G[2]`` and ``h[2]``
columns, ``o`` and ``d`` through the winner row's t alone
(:func:`winner_t`), pallas_tri's custom VJPs ``_tri_entry_bwd``,
``_tri_ee_bwd`` and ``_tri_exit_bwd``.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.kernels import (CudaKernel, ptr, require_cuda_tensor,
                             stream_ptr)
from . import hit3

BIG = hit3.BIG

_c_int, _c_ptr = ctypes.c_int, ctypes.c_void_p
# cull blocks per superblock (csrc/tri.cu kSupBlocks)
SUPER = 16

# the table, its rows to sweep, its cull blocks and their count, their
# superblocks and their count
_TAB = [_c_ptr, _c_int, _c_ptr, _c_int, _c_ptr, _c_int]
# o, d, their ray and component strides, live
_RAYS = [_c_ptr, _c_ptr, _c_int, _c_int, _c_ptr]
_HEADERS = ("hit3.cuh", "tri_walk.cuh")
ENTRY_KERNEL = CudaKernel("tri_entry", "tri.cu", _HEADERS,
                          "mrt_tri_entry",
                          _TAB + _RAYS + [_c_int] + [_c_ptr] * 3)
ENTRY_EXIT_KERNEL = CudaKernel("tri_entry_exit", "tri.cu", _HEADERS,
                               "mrt_tri_entry_exit",
                               _TAB + _RAYS + [_c_ptr, _c_int]
                               + [_c_ptr] * 5)
EXIT_KERNEL = CudaKernel("tri_exit", "tri.cu", _HEADERS, "mrt_tri_exit",
                         [_c_ptr, _c_int] + _RAYS + [_c_ptr, _c_int]
                         + [_c_ptr] * 3)


def from_pallas_consts(AT, HT, thr, gid):
    """The port's ``(Pt, 16)`` triangle table from pallas_tri's constants
    (numpy ``AT (Pt, 9)``, ``HT (Pt, 3)``, ``thr (Pt, 1)`` as
    ``pack_consts`` returns them, and the group ids ``gid (Pt,)`` or ``(Pt,
    1)``), so that both packages sweep the same rows."""
    AT = torch.tensor(AT, dtype=torch.float32).reshape(-1, 9)
    HT = torch.tensor(HT, dtype=torch.float32).reshape(-1, 3)
    thr = torch.tensor(thr, dtype=torch.float32).reshape(-1, 1)
    gid = torch.tensor(gid, dtype=torch.float32).reshape(-1)
    gs, ge = hit3._group_ranges(gid)
    return torch.cat([AT, HT, thr, gid[:, None], gs.to(torch.float32)[:, None],
                      ge.to(torch.float32)[:, None]], 1)


def superbounds(tbb):
    """The superblocks' AABBs ``(ceil(n_cb / SUPER), 8)`` ``[lo (3) | hi
    (3) | 0 0]`` over the cull blocks ``tbb`` (``hit3.tri_blockbounds``):
    each the componentwise minimum and maximum of its blocks' two corners,
    no slack added and no arithmetic, so a superblock's slab interval
    holds each of its blocks' under IEEE rounding. Both corners count
    because a block of invalid rows only is inverted (``lo`` = BIG above
    ``hi`` = -BIG), and its slab test, which orders each axis' two
    distances, passes for nearly every ray. Culling data, built once per
    table without a gradient."""
    with torch.no_grad():
        tbb = tbb.detach()
        lo = torch.minimum(tbb[:, :3], tbb[:, 3:6])
        hi = torch.maximum(tbb[:, :3], tbb[:, 3:6])
        pad = (-tbb.shape[0]) % SUPER
        lo = torch.nn.functional.pad(lo, (0, 0, 0, pad), value=BIG)
        hi = torch.nn.functional.pad(hi, (0, 0, 0, pad), value=-BIG)
        lo = lo.view(-1, SUPER, 3).amin(1)
        hi = hi.view(-1, SUPER, 3).amax(1)
        return torch.cat([lo, hi, torch.zeros_like(lo[:, :2])],
                         1).contiguous()


def winner_t(tri, o, d, row):
    """Differentiable t of triangle-local rows ``row`` (R,) for rays ``o``,
    ``d`` (R, 3): pallas_tri._winner_t by a gather of the row, not a
    one-hot product (``hit3._tri_t``; the sweep's value bit for bit)."""
    return hit3._tri_t(tri, row.long(), o, d)


# --- plain versions ---------------------------------------------------------

def _rows(tri, n):
    return tri.shape[0] if n is None else n


def _dead(live):
    return None if live is None else ~(live > 0.5)


def entry_plain(tri, o, d, tbb=None, n=None, live=None):
    """Plain PyTorch :func:`tri_entry` (any device, no gradient): ``(te,
    row)`` of the nearest valid row among the first ``n`` (default all),
    culled per ray with the cull blocks ``tbb``; dead lanes of ``live`` and
    misses give ``te = BIG``, ``row = 0``."""
    ENTRY_KERNEL.plain_calls += 1
    return _entry(tri, o, d, tbb, n, live)


def _entry(tri, o, d, tbb, n, live):
    with torch.no_grad():
        o, d = o.detach(), d.detach()
        best = torch.full((o.shape[0],), BIG, dtype=o.dtype, device=o.device)
        te, row, _tested = hit3._tri_entry(tri.detach(), tbb,
                                           _rows(tri, n), o, d, best)
        miss = row < 0
        dead = _dead(live)
        if dead is not None:
            miss = miss | dead
            te = torch.where(dead, BIG, te)
        return te, torch.where(miss, 0, row).to(torch.int32)


def _exit(tri, o, d, wg, n, tbb=None):
    """(tx, xrow) of group ``wg`` (R,) over the first ``n`` rows, culled
    with the cull blocks ``tbb`` (``hit3._tri_exit``); -BIG and 0 where the
    group has no hit."""
    best = torch.full((o.shape[0],), -BIG, dtype=o.dtype, device=o.device)
    tx, xrow = hit3._tri_exit(tri, _rows(tri, n), o, d, wg, best, tbb)
    return tx, torch.where(xrow < 0, 0, xrow).to(torch.int32)


def entry_exit_plain(tri, o, d, tbb=None, n=None, live=None, refr=None):
    """Plain PyTorch :func:`tri_entry_exit` (any device, no gradient):
    :func:`entry_plain`'s ``(te, row)``, then ``(tx, xrow)`` of the
    farthest valid row of the winner's group, culled per ray with ``tbb``
    as the kernel's exit is (``tx = -BIG``, ``xrow = 0`` on a miss or a
    dead lane). ``refr`` ``(Pt,)``: where the winner's row has no 1 there,
    its exit is the winner itself (``tx = te``, ``xrow = row``), its group
    unswept."""
    ENTRY_EXIT_KERNEL.plain_calls += 1
    with torch.no_grad():
        te, row = _entry(tri, o, d, tbb, n, live)
        hit = te < BIG * 0.5
        own = None
        if refr is not None:
            own = hit & ~(refr[row.long()] > 0.5)
            hit = hit & ~own
        wg = torch.where(hit, tri[row.long(), hit3._T_GID].detach(), BIG)
        tx, xrow = _exit(tri.detach(), o.detach(), d.detach(), wg, n, tbb)
        if own is not None:
            tx, xrow = torch.where(own, te, tx), torch.where(own, row, xrow)
        return te, row, tx, xrow


def group_exit_plain(tri, o, d, wg, n=None, live=None):
    """Plain PyTorch :func:`tri_group_exit` (any device, no gradient):
    ``(tx, xrow)`` of the farthest valid row of group ``wg`` (R,) (a group
    id as the table holds it) among the first ``n`` rows, never culled."""
    EXIT_KERNEL.plain_calls += 1
    with torch.no_grad():
        tx, xrow = _exit(tri.detach(), o.detach(), d.detach(), wg.detach(),
                         n)
        dead = _dead(live)
        if dead is not None:
            tx = torch.where(dead, -BIG, tx)
            xrow = torch.where(dead, 0, xrow)
        return tx, xrow


def culled_exit_phantoms(tbb, o, d, culled, full):
    """Where a culled group exit ``culled`` ``(tx, xrow)`` (row 7's)
    differs from the unculled ``full`` (row 8's, or :func:`group_exit_plain`)
    on rays ``o``, ``d`` ``(R, 3)``: ``(differs, phantom)`` ``(R,)`` bool.
    Where the two differ the cull skipped the block of the unculled exit
    row; ``phantom`` marks the rays whose unculled exit hit point (``o + tx
    d`` in float64) lies outside that block's slacked AABB in ``tbb``, the
    only hits a cull may drop. ``differs & ~phantom`` are faults."""
    with torch.no_grad():
        differs = ~((culled[0] == full[0]) & (culled[1] == full[1]))
        b = (full[1].long() // hit3.CB).clamp(0, tbb.shape[0] - 1)
        p = o.double() + full[0].double()[:, None] * d.double()
        box = tbb[b].double()
        outside = ((p < box[:, :3]) | (p > box[:, 3:6])).any(1)
        return differs, differs & outside & (full[0] > -BIG * 0.5)


# --- kernel wrappers --------------------------------------------------------

def _launch_args(tri, o, d, tbb, n, live, what, tsb=None):
    """Validate a launch's table, cull blocks (with ``tsb``: and their
    superblocks) and rays; their C arguments."""
    Pt = tri.shape[0]
    require_cuda_tensor("tri", tri, torch.float32, (Pt, hit3.TRI_COLS))
    n = _rows(tri, n)
    # the kernels read rows and AABBs as 16-byte loads
    for name, x in (("tri", tri), ("tbb", tbb), ("tsb", tsb)):
        if x is not None and x.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")
    if not 0 <= n <= Pt:
        raise ValueError(f"{what}: {n} rows to sweep of a {Pt}-row table")
    if tbb is not None:
        n_cb = -(-Pt // hit3.CB)
        require_cuda_tensor("tbb", tbb, torch.float32, (n_cb, hit3.BB_COLS))
        if tsb is None:
            raise ValueError(f"{what}: cull blocks without their superblocks "
                             f"(tri.superbounds)")
        require_cuda_tensor("tsb", tsb, torch.float32,
                            (-(-n_cb // SUPER), hit3.BB_COLS))
    elif tsb is not None:
        raise ValueError(f"{what}: superblocks without cull blocks")
    R = o.shape[0]
    require_cuda_tensor("o", o, torch.float32, (R, 3), contiguous=False)
    require_cuda_tensor("d", d, torch.float32, (R, 3), contiguous=False)
    if o.stride() != d.stride():
        raise ValueError(f"{what}: o and d strides differ: {o.stride()} vs "
                         f"{d.stride()}")
    if live is not None:
        require_cuda_tensor("live", live, torch.float32, (R,),
                            contiguous=False)
        if live.stride(0) != o.stride(0):
            raise ValueError(f"{what}: live's stride {live.stride(0)} is not "
                             f"the rays' {o.stride(0)}")
    table = [ptr(tri), n, None if tbb is None else ptr(tbb),
             0 if tbb is None else tbb.shape[0],
             None if tsb is None else ptr(tsb),
             0 if tsb is None else tsb.shape[0]]
    rays = [ptr(o), ptr(d), *o.stride(), None if live is None else ptr(live)]
    return table, rays, R


def _entry_fwd(tri, o, d, tbb, n, live, tsb=None):
    if o.device.type == "cpu":
        return entry_plain(tri, o, d, tbb, n, live)
    table, rays, R = _launch_args(tri, o, d, tbb, n, live, "tri_entry", tsb)
    te = torch.empty(R, dtype=torch.float32, device=o.device)
    row = torch.empty(R, dtype=torch.int32, device=o.device)
    if R:
        ENTRY_KERNEL.launch(*table, *rays, R, ptr(te), ptr(row),
                            stream_ptr(o.device))
    return te, row


def _entry_exit_fwd(tri, o, d, tbb, n, live, refr, tsb=None):
    if o.device.type == "cpu":
        return entry_exit_plain(tri, o, d, tbb, n, live, refr)
    table, rays, R = _launch_args(tri, o, d, tbb, n, live, "tri_entry_exit",
                                  tsb)
    if refr is not None:
        require_cuda_tensor("refr", refr, torch.float32, (tri.shape[0],))
    te = torch.empty(R, dtype=torch.float32, device=o.device)
    tx = torch.empty_like(te)
    row = torch.empty(R, dtype=torch.int32, device=o.device)
    xrow = torch.empty_like(row)
    if R:
        ENTRY_EXIT_KERNEL.launch(*table, *rays,
                                 None if refr is None else ptr(refr), R,
                                 ptr(te), ptr(row), ptr(tx), ptr(xrow),
                                 stream_ptr(o.device))
    return te, row, tx, xrow


def _group_exit_fwd(tri, o, d, wg, n, live):
    if o.device.type == "cpu":
        return group_exit_plain(tri, o, d, wg, n, live)
    table, rays, R = _launch_args(tri, o, d, None, n, live, "tri_group_exit")
    require_cuda_tensor("wg", wg, torch.float32, (R,))
    tx = torch.empty(R, dtype=torch.float32, device=o.device)
    row = torch.empty(R, dtype=torch.int32, device=o.device)
    if R:
        EXIT_KERNEL.launch(*table[:2], *rays, ptr(wg), R, ptr(tx), ptr(row),
                           stream_ptr(o.device))
    return tx, row


# --- autograd ---------------------------------------------------------------

def _winner_grads(ctx, tri, o, d, pairs):
    """The cotangents of ``tri``, ``o``, ``d`` from ``[(row, hit, ct)]``:
    each ct reaches them through its winner row's t where it hit."""
    need = ctx.needs_input_grad[:3]
    ins = [x.detach().requires_grad_(w) for x, w in zip((tri, o, d), need)]
    with torch.enable_grad():
        ts, cts = [], []
        for row, hit, ct in pairs:
            if ct is None:
                continue
            ts.append(winner_t(ins[0], ins[1], ins[2], torch.where(hit, row,
                                                                   0)))
            cts.append(torch.where(hit, ct, 0.0))
        wanted = [x for x, w in zip(ins, need) if w]
        if not ts or not wanted:
            return (None,) * 3
        gs = iter(torch.autograd.grad(ts, wanted, cts, allow_unused=True))
    return tuple(next(gs) if w else None for w in need)


class TriEntry(torch.autograd.Function):
    """:func:`tri_entry` under autograd: ``te``'s cotangent reaches the
    table's ``G[2]``, ``h[2]``, ``o`` and ``d`` through the winner row's t
    (pallas_tri._tri_entry_bwd); ``row`` has none. ``plain``: run
    :func:`entry_plain` on any device (the plain step's sweep), else the
    wrapper's dispatch; ``tsb``: the superblocks of ``tbb``, which the
    kernel walks (:func:`superbounds`)."""

    @staticmethod
    def forward(ctx, tri, o, d, tbb, n, live, plain=False, tsb=None):
        te, row = entry_plain(tri, o, d, tbb, n, live) if plain else \
            _entry_fwd(tri, o, d, tbb, n, live, tsb)
        ctx.save_for_backward(tri, o, d, row, te)
        ctx.mark_non_differentiable(row)
        return te, row

    @staticmethod
    def backward(ctx, ct_te, _ct_row):
        tri, o, d, row, te = ctx.saved_tensors
        return (*_winner_grads(ctx, tri, o, d,
                               [(row, te < BIG * 0.5, ct_te)]),
                None, None, None, None, None)


class TriEntryExit(torch.autograd.Function):
    """:func:`tri_entry_exit` under autograd: ``te``'s and ``tx``'s
    cotangents reach the table, ``o`` and ``d`` through their rows' t
    (pallas_tri._tri_ee_bwd). ``plain`` and ``tsb`` as
    :class:`TriEntry`'s; ``refr`` as :func:`tri_entry_exit`'s."""

    @staticmethod
    def forward(ctx, tri, o, d, tbb, n, live, plain=False, refr=None,
                tsb=None):
        te, row, tx, xrow = entry_exit_plain(tri, o, d, tbb, n, live,
                                             refr) if plain else \
            _entry_exit_fwd(tri, o, d, tbb, n, live, refr, tsb)
        ctx.save_for_backward(tri, o, d, row, te, xrow, tx)
        ctx.mark_non_differentiable(row, xrow)
        return te, row, tx, xrow

    @staticmethod
    def backward(ctx, ct_te, _ct_row, ct_tx, _ct_xrow):
        tri, o, d, row, te, xrow, tx = ctx.saved_tensors
        return (*_winner_grads(ctx, tri, o, d,
                               [(row, te < BIG * 0.5, ct_te),
                                (xrow, tx > -BIG * 0.5, ct_tx)]),
                None, None, None, None, None, None)


class TriGroupExit(torch.autograd.Function):
    """:func:`tri_group_exit` under autograd: ``tx``'s cotangent reaches
    the table, ``o`` and ``d`` through its row's t; the group ids get none
    (pallas_tri._tri_exit_bwd)."""

    @staticmethod
    def forward(ctx, tri, o, d, wg, n, live):
        tx, xrow = _group_exit_fwd(tri, o, d, wg, n, live)
        ctx.save_for_backward(tri, o, d, xrow, tx)
        ctx.mark_non_differentiable(xrow)
        return tx, xrow

    @staticmethod
    def backward(ctx, ct_tx, _ct_xrow):
        tri, o, d, xrow, tx = ctx.saved_tensors
        return (*_winner_grads(ctx, tri, o, d,
                               [(xrow, tx > -BIG * 0.5, ct_tx)]),
                None, None, None)


def tri_entry(tri, o, d, tbb=None, n=None, live=None, tsb=None):
    """``(te, row)`` of the nearest valid triangle of each ray among the
    first ``n`` rows of ``tri`` ``(Pt, 16)`` (default all), culled per ray
    with the cull blocks ``tbb``, walked through their superblocks ``tsb``
    (:func:`superbounds`; the kernel needs them with ``tbb``). ``o``,
    ``d``: ``(R, 3)`` float32 views of any stride (equal strides), such as
    the carry's ``c[0:3].T``; ``live`` ``(R,)`` (the carry's live row, the
    rays' stride): a dead lane misses. CUDA tensors launch
    ``mrt_tri_entry``, CPU tensors run :func:`entry_plain`; differentiable
    in ``tri``, ``o`` and ``d``."""
    return TriEntry.apply(tri, o, d, tbb, n, live, False, tsb)


def tri_entry_exit(tri, o, d, tbb=None, n=None, live=None, refr=None,
                   tsb=None):
    """:func:`tri_entry` and ``(tx, xrow)`` of the farthest valid row of
    the winner's group, culled per ray with ``tbb``: ``(te, row, tx,
    xrow)``. ``refr`` ``(Pt,)`` float32 (default every row): the rows whose
    group exit is swept; a winner on another row is its own exit (``tx =
    te``, ``xrow = row``). CUDA tensors launch ``mrt_tri_entry_exit``, CPU
    tensors run :func:`entry_exit_plain`."""
    return TriEntryExit.apply(tri, o, d, tbb, n, live, False, refr, tsb)


def tri_group_exit(tri, o, d, wg, n=None, live=None):
    """``(tx, xrow)`` of the farthest valid row of group ``wg`` ``(R,)``
    float32 per ray. CUDA tensors launch ``mrt_tri_exit``, CPU tensors run
    :func:`group_exit_plain`."""
    return TriGroupExit.apply(tri, o, d, wg, n, live)
