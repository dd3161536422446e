"""Whole trace, forward and backward: the hand-written CUDA kernels
``csrc/trace_fwd.cu`` and ``csrc/trace_bwd.cu``, their wrappers, their
plain PyTorch versions, and the autograd function that joins them.

The counterpart of ``micro_raytracer_tpu.ops.pallas_step`` for scenes of
spheres, planes, boxes, triangles and meshes with at most 4 lights and no
textures. :func:`pack_step` builds the kernels' tables
(:class:`TraceTables`): a ``(P, 26)`` row table — the 18 sweep columns of
:func:`hit3.pack_scene`, whose ``fr, ipos, pa, pr`` are pallas_step's
attribute columns ``_C_FR.._C_PR`` (a triangle row's ``pa`` is its raw
normal), then ``_C_ALB.._C_EMI`` — the ``(L, 11)`` light table whose
directional entries hold ``-normalize(light_dir)``, and the triangle
segment's Woop table and cull-block AABBs (:func:`hit3.tri_tables`). The
row, light and triangle tables are differentiable functions of the scene
leaves, so their cotangents reach the leaves by autograd; a training step
rebuilds them from the current parameters every step.

:func:`trace_packed` runs all ``bounce + 1`` steps on lane-major primaries
``oT``/``dT`` ``(3, R)`` with uniforms ``u8s`` ``(K, NU, R)`` — ``NU = 8``
rows ``[u0..u6, u_emit]`` when the scene refracts, else 4 rows ``[u0, u1,
u2, u_emit]`` — and returns ``A, B`` ``(3, R)`` and the first-bounce hit
liveness ``(1, R)``. It dispatches on its inputs:

* CPU tensors run :func:`trace_plain`, and autograd differentiates it;
* CUDA tensors that need a gradient run :class:`TraceFunction`: the
  primary-hit kernel (:func:`hit3.closest_hit`), the train instance of the
  trace kernel (:func:`trace_fwd_train`), which saves residuals, and in
  the backward the backward kernel (:func:`trace_bwd`);
* other CUDA tensors run the primary-hit kernel and the render instance
  (:func:`trace_fwd`).

No path falls back to another.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..utils.kernels import (CudaKernel, ptr, require_cuda_tensor,
                             stream_ptr)
from . import hit3, intersect, linalg, rng
from .linalg import EPS

# attribute columns of the row table after the sweep columns
# (pallas_step._C_ALB.._C_EMI)
_C_ALB, _C_RGH, _C_MET, _C_GLS, _C_OPA, _C_EMI = 18, 21, 22, 23, 24, 25
ROW_COLS = 26
LIGHT_COLS = 11
MAX_LIGHTS = 4
# shared-memory bound of the forward kernel on the sphere, plane and box
# rows: 2048 rows * 104 B + lights + hit3.MAX_TRI_BLOCKS block AABBs; the
# triangle rows stay in global memory (any count)
MAX_ROWS = 2048
# the backward kernel also keeps a (P, 22) accumulator of those rows in
# shared memory: 1024 rows * 192 B + lights = 192 KB of the 227 KB a block
# may use; triangle rows accumulate in global memory
BWD_MAX_ROWS = 1024
_GRAD_COLS = 22           # row-table columns with a cotangent
_BWD_THREADS, _BWD_MAX_BLOCKS = 128, 1024   # csrc/trace_bwd.cu kBwdThreads

# residual rows per step (csrc/trace_step.cuh): the step's input ray o, d
# and throughput A, its entry and exit t, entry winner row, refract choice,
# one occlusion bit per light and, on a scene with triangle rows, the exit
# winner row (without triangles every group is one row: it is the entry
# row)
RES_O, RES_D, RES_A = 0, 3, 6
RES_TE, RES_TX, RES_ROW, RES_CHOOSE, RES_LOK = 9, 10, 11, 12, 13


def res_rows(n_lights: int, n_tri: int = 0) -> int:
    """Residual rows per step with ``n_lights`` lights and ``n_tri``
    triangle rows to sweep (``layout[3]``)."""
    return RES_LOK + n_lights + (1 if n_tri else 0)


def res_xrow(n_lights: int) -> int:
    """The exit winner row's residual row (scenes with triangle rows)."""
    return RES_LOK + n_lights


_c_int, _c_ptr = ctypes.c_int, ctypes.c_void_p
_TRI_ARGS = [_c_ptr, _c_int, _c_int, _c_ptr, _c_int]
_FWD_ARGS = ([_c_ptr, _c_int] + [_c_int] * 6 + _TRI_ARGS
             + [_c_ptr, _c_int, ctypes.c_float] + [_c_ptr] * 7
             + [_c_int] * 3 + [_c_ptr] * 3)
_HEADERS = ("hit3.cuh", "trace_step.cuh")
KERNEL = CudaKernel("trace_fwd", "trace_fwd.cu", _HEADERS, "mrt_trace_fwd",
                    _FWD_ARGS + [_c_ptr])
TRAIN_KERNEL = CudaKernel("trace_fwd_train", "trace_fwd.cu", _HEADERS,
                          "mrt_trace_fwd_train", _FWD_ARGS + [_c_ptr] * 3)
BWD_KERNEL = CudaKernel(
    "trace_bwd", "trace_bwd.cu", _HEADERS, "mrt_trace_bwd",
    [_c_ptr, _c_int] + [_c_int] * 6 + _TRI_ARGS
    + [_c_ptr, _c_int, ctypes.c_float] + [_c_ptr] * 3 + [_c_int] * 2
    + [_c_ptr] * 5 + [_c_int] + [_c_ptr] * 4)


class TraceTables(NamedTuple):
    """What a trace needs of a scene, built by :func:`pack_step`."""

    frames: torch.Tensor     # (P, 3, 3) instance matrices
    tab: torch.Tensor        # (P, ROW_COLS) row table
    lights: torch.Tensor     # (max(L, 1), LIGHT_COLS) light table
    layout: tuple            # hit3.seg_layout of the kind segments
    tri: torch.Tensor        # (Pt, hit3.TRI_COLS) triangle table
    tbb: torch.Tensor | None  # (n_cb, hit3.BB_COLS) cull blocks, or None


def n_uni(need_exit: bool) -> int:
    """Uniform rows per step: opaque scenes never read the exit-side draws
    u3..u6, so only [u0, u1, u2, u_emit] are packed."""
    return 8 if need_exit else 4


def check_scene(scene) -> None:
    """Reject a scene the kernels do not cover (never another path)."""
    intersect.check_scene_class(scene)
    if scene.n_lights > MAX_LIGHTS:
        raise ValueError(f"trace kernel: {scene.n_lights} lights exceed "
                         f"its bound of {MAX_LIGHTS}")


def pack_step(scene) -> TraceTables:
    """The scene's frames, row table and light table (any device;
    differentiable in the scene leaves)."""
    frames = intersect.build_frames(scene)
    m = scene.mat_id.long()
    tab = torch.cat([
        hit3.pack_scene(scene, frames), scene.mat_albedo[m],
        scene.mat_rough[m][:, None], scene.mat_metal[m][:, None],
        scene.mat_glass[m][:, None], scene.mat_opacity[m][:, None],
        scene.mat_emit[m][:, None]], dim=1)
    if scene.n_lights:
        lights = torch.cat([
            scene.light_pos, -linalg.normalize(scene.light_dir),
            scene.light_is_dir.to(torch.float32)[:, None],
            scene.light_pwr[:, None], scene.light_color], dim=1)
    else:
        lights = torch.zeros((1, LIGHT_COLS), dtype=torch.float32,
                             device=frames.device)
    tri, tbb = hit3.tri_tables(scene, frames)
    return TraceTables(frames, tab, lights,
                       hit3.seg_layout(scene.kind_counts, scene.kind_sweep),
                       tri, tbb)


def primary_mode(scene) -> int:
    """The closest-hit mode of the trace's sweeps: refractive scenes need
    the group exit, opaque ones only the entry."""
    return hit3.MODE_EXIT if scene.any_refract else hit3.MODE_ENTRY


def unpack_uniforms(u8, need_exit: bool):
    """One step's packed ``(NU, R)`` rows -> ``u (R, 7)``, ``u_emit (R,)``
    (opaque scenes get zeros in the never-read slots u3..u6)."""
    if need_exit:
        return u8[:7].T, u8[7]
    R = u8.shape[1]
    pad = torch.zeros((R, 4), dtype=u8.dtype, device=u8.device)
    return torch.cat([u8[:3].T, pad], dim=1), u8[3]


# --- plain version: the kernels' arithmetic in PyTorch ----------------------

def _dot3(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _scale(v, s):
    return v * s[:, None]


def _safe_norm(v):
    return _scale(v, 1.0 / torch.sqrt(torch.clamp(_dot3(v, v), min=1e-20)))


def _finite0(v):
    return torch.where(torch.isfinite(v), v, 0.0)


def _matvec(f, v):
    """M @ v with M the fetched rows' frame columns ``f`` (R, 9)."""
    return torch.stack([f[:, 3 * k] * v[:, 0] + f[:, 3 * k + 1] * v[:, 1]
                        + f[:, 3 * k + 2] * v[:, 2] for k in range(3)], 1)


def _row_ends(layout):
    """End rows of the sphere and plane segments (hit3.layout_ints) and the
    first triangle row."""
    ints = hit3.layout_ints(layout)
    return ints[0] + ints[1], ints[2] + ints[3], layout[1]


def _normal(at, p, row, ends):
    """World-space normal at ``p`` of the fetched rows ``at`` (trace_step.cuh
    normal_full): sphere ``M(p - ip)``, plane and triangle ``pa`` (a
    triangle row's raw normal), box face with the missing-``else`` quirk,
    then ``finite0(safe_norm(M n_obj))``."""
    f, ip, pa = at[:, 0:9], at[:, 9:12], at[:, 12:15]
    hp = ip + _matvec(f, p - ip)
    n_sph = hp - ip
    sizes = torch.where(pa == 0.0, 1.0, pa)
    q = (hp - ip) * (2.0 / sizes)
    near = [(torch.abs(q[:, c] - 1.0) < EPS, torch.abs(q[:, c] + 1.0) < EPS)
            for c in range(3)]
    (ix1, ix_1), (iy1, iy_1), (iz1, iz_1) = near
    one, zero = torch.ones_like(q[:, 0]), torch.zeros_like(q[:, 0])
    bx = torch.where(ix1, one, torch.where(ix_1, -one, zero))
    by = torch.where(ix1 | ix_1, zero,
                     torch.where(iy1, one, torch.where(iy_1, -one, zero)))
    anyz = iz1 | iz_1
    n_box = torch.stack([torch.where(anyz, zero, bx),
                         torch.where(anyz, zero, by),
                         torch.where(iz1, one,
                                     torch.where(iz_1, -one, zero))], 1)
    sph_end, pln_end, tri_start = ends
    n_box = torch.where((row >= tri_start)[:, None], pa, n_box)
    n_obj = torch.where((row < sph_end)[:, None], n_sph,
                        torch.where((row < pln_end)[:, None], pa, n_box))
    return _finite0(_safe_norm(_matvec(f, n_obj)))


def _rough_override(at, u):
    return (at[:, _C_MET] == 0.0) & (at[:, _C_OPA] != 0.0) & (u < 0.8)


def _light_vec(lt, p):
    """(R, 3) vector from ``p`` toward light row ``lt`` (its stored
    ``-normalize(dir)`` for a directional light)."""
    return torch.where(lt[6] > 0.5, lt[3:6].expand_as(p), lt[0:3] - p)


def _occlusion(tables, L, p_e, live_i, work=None):
    """(R, L) bool: light li is visible from the entry point (no
    gradient: the shadow sweep's result is a choice). ``work["shadow"]``
    gains the triangle rows the kernel's shadow sweeps test."""
    with torch.no_grad():
        tab, p_e = tables.tab.detach(), p_e.detach()
        lights, layout = tables.lights, tables.layout
        tri = tables.tri.detach()
        oks = []
        for li in range(L):
            lv = _light_vec(lights[li].detach(), p_e)
            ln = _scale(lv, 1.0 / torch.sqrt(_dot3(lv, lv)))
            so = p_e + ln * EPS
            te = hit3.sweep_plain(tab, layout, so, ln, hit3.MODE_ANY, tri,
                                  tables.tbb)[0]
            if work is not None:
                work["shadow"] += int(hit3.tri_rows_tested(
                    tab, layout, so, ln, hit3.MODE_ANY, tri,
                    tables.tbb)[live_i].sum())
            oks.append((te >= hit3.BIG * 0.5) & live_i)
        if not oks:
            return torch.zeros((p_e.shape[0], 0), dtype=torch.bool,
                               device=p_e.device)
        return torch.stack(oks, 1)


def _direct_light(lights, L, lok, p, n, d, alb, rgh, met):
    """Direct light at the chosen point with the entry point's occlusion
    (rt.rs:973-987); the light vector's normalization is guarded, so a
    light at the hit point gives no NaN cotangent."""
    l_col = torch.zeros_like(p)
    o_col = _scale(alb, 1.0 - met)
    for li in range(L):
        lt = lights[li]
        lv = _light_vec(lt, p)
        s = _dot3(lv, lv)
        ln = _scale(lv, 1.0 / torch.sqrt(torch.where(s > 0.0, s, 1.0)))
        dotln = _dot3(ln, n)
        diff = torch.clamp(dotln, min=0.0)
        lrefl = ln - _scale(n, 2.0 * dotln)
        m = torch.clamp(_dot3(d, lrefl), min=0.0)
        m2 = m * m
        m4 = m2 * m2
        m8 = m4 * m4
        m16 = m8 * m8
        spec = (m16 * m16) * (1.0 - rgh)
        contrib = (_scale(o_col, diff) * lt[8:11] + spec[:, None]) * lt[7]
        l_col = l_col + torch.where(lok[:, li:li + 1], contrib, 0.0)
    return l_col


def trace_plain(scene, tables, decay, oT, dT, u8s, want_resid=False,
                work=None):
    """Plain PyTorch whole trace: the kernels' step, operation for
    operation, on their inputs (any device). Differentiable by autograd in
    ``tables.tab``, ``tables.lights``, ``oT`` and ``dT``: hits are the
    winner row's t from the sweep (:func:`hit3.sweep_plain`), attributes a
    gather of its row, occlusion a choice. ``tables.tri`` carries the
    gradient of a triangle winner's t (its ``G`` and ``h`` columns).

    Returns ``(A (3,R), B (3,R), first_live (1,R))``; with ``want_resid``
    also the residuals ``(K, res_rows(L, n_tri), R)`` and live-step counts
    ``(R,)`` int32 that the train kernel writes (rows of steps at or after
    a ray's count are not meaningful).

    ``work`` (a dict, for the kernels' bounds): gains under ``"sweep"`` the
    triangle rows the trace kernel's closest-hit sweeps test (steps after
    the first, whose sweep is the primary-hit pass; the exit pass
    included) and under ``"shadow"`` those of its shadow sweeps, for the
    rays live at each sweep."""
    (TRAIN_KERNEL if want_resid else KERNEL).plain_calls += 1
    intersect.check_scene_class(scene)
    tab, lights, layout = tables.tab, tables.lights, tables.layout
    L, refract = scene.n_lights, scene.any_refract
    mode = primary_mode(scene)
    ends = _row_ends(layout)
    R, K = oT.shape[1], u8s.shape[0]
    o, d = oT.T, dT.T
    pwr = torch.ones((), dtype=oT.dtype, device=oT.device)
    live = torch.ones(R, dtype=torch.bool, device=oT.device)
    n_live = torch.zeros(R, dtype=torch.int32, device=oT.device)
    A = torch.ones((R, 3), dtype=oT.dtype, device=oT.device)
    B = torch.zeros((R, 3), dtype=oT.dtype, device=oT.device)
    first, resid = None, []
    for k in range(K):
        u, u_emit = unpack_uniforms(u8s[k], refract)
        te, row, tx, xrow = hit3.sweep_plain(tab, layout, o, d, mode,
                                             tables.tri, tables.tbb)
        if work is not None and k:
            work["sweep"] += int(hit3.tri_rows_tested(
                tab, layout, o, d, mode, tables.tri, tables.tbb)[live].sum())
        live_i = live & (te < hit3.BIG * 0.5)
        if k == 0:
            first = live_i
        p_e = o + _scale(d, torch.where(live_i, te, 1.0))
        at_e = tab[row.long()]
        lok = _occlusion(tables, L, p_e, live_i, work)
        n_e = _normal(at_e, p_e, row, ends)
        rough_r = torch.where(_rough_override(at_e, u[:, 0]), 1.0,
                              at_e[:, _C_RGH])
        nr = rng.sphere_rand(n_e, rough_r, u[:, 1], u[:, 2])
        refl = _safe_norm(d - _scale(nr, 2.0 * _dot3(d, nr)))
        if refract:
            at_x = tab[xrow.long()]
            p_x = o + _scale(d, torch.where(live_i, tx, 1.0))
            n_x = _normal(at_x, p_x, xrow, ends)
            rough_f = torch.where(_rough_override(at_x, u[:, 3]), 1.0,
                                  at_x[:, _C_RGH])
            nf = rng.sphere_rand(n_x, rough_f, u[:, 4], u[:, 5])
            eta = 1.0 + 0.5 * at_x[:, _C_GLS]
            cs = -_dot3(nf, d)
            kk = 1.0 - eta * eta * (1.0 - cs * cs)
            refr_ok = kk >= 0.0
            k_safe = torch.where(refr_ok, torch.clamp(kk, min=1e-12), 1.0)
            refr = _finite0(_safe_norm(
                _scale(d, eta) + _scale(nf, cs * eta + torch.sqrt(k_safe))))
            choose = ((u[:, 6] < torch.clamp(1.0 - at_e[:, _C_OPA],
                                             max=0.85)) & refr_ok)
            c = choose[:, None]
            next_dir = torch.where(c, refr, refl)
            from_p = torch.where(c, p_x, p_e)
            norm_c = torch.where(c, n_x, n_e)
            at_c = torch.where(c, at_x, at_e)
        else:
            choose = torch.zeros_like(live_i)
            next_dir, from_p, norm_c, at_c = refl, p_e, n_e, at_e
        alb_c = at_c[:, _C_ALB:_C_ALB + 3]
        l_col = _direct_light(lights, L, lok, from_p, norm_c, d, alb_c,
                              at_c[:, _C_RGH], at_c[:, _C_MET])
        b_emit = (u_emit < at_c[:, _C_EMI])[:, None]
        a_f = torch.where(b_emit, 0.0, pwr * (0.5 + alb_c))
        b_f = torch.where(b_emit, alb_c, l_col * pwr)
        lv = live_i[:, None]
        a_f = torch.where(lv, a_f, 1.0)
        b_f = torch.where(lv, b_f, 0.0)
        if want_resid:
            resid.append(torch.cat([
                o.T, d.T, A.T, te[None], tx[None], row.to(te.dtype)[None],
                choose.to(te.dtype)[None], lok.to(te.dtype).T]
                + ([xrow.to(te.dtype)[None]] if layout[3] else [])).detach())
        B = B + A * b_f
        A = A * a_f
        o = from_p + next_dir * EPS                          # Ray::cast
        d = next_dir
        pwr = pwr * decay
        n_live += live_i.to(torch.int32)
        live = live_i & ~b_emit[:, 0]                        # emit kill
    out = (A.T.contiguous(), B.T.contiguous(), first.to(oT.dtype)[None])
    if want_resid:
        return out + (torch.stack(resid), n_live)
    return out


def trace_bwd_plain(scene, tables, decay, oT, dT, u8s, ctA, ctB):
    """Plain version of :func:`trace_bwd`: autograd through
    :func:`trace_plain`. Returns ``(d_tab, d_lights, d_oT, d_dT, d_tri)``."""
    BWD_KERNEL.plain_calls += 1
    ins = [t.detach().requires_grad_(True)
           for t in (tables.tab, tables.lights, oT, dT, tables.tri)]
    with torch.enable_grad():
        A, B, _fl = trace_plain(
            scene, tables._replace(tab=ins[0], lights=ins[1], tri=ins[4]),
            decay, ins[2], ins[3], u8s)
        grads = torch.autograd.grad((A, B), ins, (ctA, ctB),
                                    allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, ins))


# --- kernel wrappers --------------------------------------------------------

def _table_args(scene, tables, max_dense, what):
    """Validate the row, light and triangle tables of a launch; their
    leading C arguments (the dense rows the kernel stages, the dense and
    triangle layouts)."""
    tab, lights, layout = tables.tab, tables.lights, tables.layout
    P = tab.shape[0]
    require_cuda_tensor("table", tab, torch.float32, (P, ROW_COLS))
    require_cuda_tensor("lights", lights, torch.float32,
                        (max(scene.n_lights, 1), LIGHT_COLS))
    n_dense = layout[1]
    if n_dense > max_dense:
        raise ValueError(f"{what} kernel: {n_dense} sphere, plane and box "
                         f"rows exceed the shared-memory bound of "
                         f"{max_dense}")
    hit3.check_tri_tables(layout, tables.tri, tables.tbb)
    return [ptr(tab), n_dense,
            *hit3.table_args(layout, tables.tri, tables.tbb), ptr(lights)]


def _fwd_args(scene, tables, decay, oT, dT, u8s, hit0):
    """Validate a forward launch's inputs; its leading C arguments."""
    check_scene(scene)
    R = oT.shape[1]
    K = u8s.shape[0]
    require_cuda_tensor("oT", oT, torch.float32, (3, R))
    require_cuda_tensor("dT", dT, torch.float32, (3, R))
    require_cuda_tensor("u8s", u8s, torch.float32,
                        (K, n_uni(scene.any_refract), R))
    for name, t, dtype in zip(("te0", "row0", "tx0", "xrow0"), hit0,
                              (torch.float32, torch.int32) * 2):
        require_cuda_tensor(name, t, dtype, (R,))
    return (_table_args(scene, tables, MAX_ROWS, "trace")
            + [scene.n_lights, float(decay), ptr(oT), ptr(dT),
               *(ptr(t) for t in hit0), ptr(u8s), K, R,
               int(scene.any_refract)])


def primary_hits(scene, tables, oT, dT):
    """The primary-hit pass (:func:`hit3.closest_hit`) of lane-major
    primaries, in :func:`primary_mode`: the trace kernels' ``hit0``."""
    return hit3.closest_hit(tables.tab, tables.layout, oT.T, dT.T,
                            primary_mode(scene), tables.tri, tables.tbb)


def trace_fwd(scene, tables, decay, oT, dT, u8s, hit0):
    """Launch ``mrt_trace_fwd`` (the render instance) on CUDA tensors.
    ``hit0`` is the primaries' ``(te, row, tx, xrow)`` from
    :func:`primary_hits`."""
    args = _fwd_args(scene, tables, decay, oT, dT, u8s, hit0)
    R = oT.shape[1]
    A = torch.empty((3, R), dtype=torch.float32, device=oT.device)
    B = torch.empty_like(A)
    fl = torch.empty((1, R), dtype=torch.float32, device=oT.device)
    if R:
        KERNEL.launch(*args, ptr(A), ptr(B), ptr(fl), stream_ptr(oT.device))
    return A, B, fl


def trace_fwd_train(scene, tables, decay, oT, dT, u8s, hit0):
    """Launch ``mrt_trace_fwd_train`` (the train instance) on CUDA tensors:
    :func:`trace_fwd`'s ``(A, B, first_live)`` bit for bit, plus the
    residuals ``(K, res_rows(L, n_tri), R)`` and live-step counts ``(R,)``
    int32 that :func:`trace_bwd` reads."""
    args = _fwd_args(scene, tables, decay, oT, dT, u8s, hit0)
    R, K = oT.shape[1], u8s.shape[0]
    A = torch.empty((3, R), dtype=torch.float32, device=oT.device)
    B = torch.empty_like(A)
    fl = torch.empty((1, R), dtype=torch.float32, device=oT.device)
    resid = torch.empty((K, res_rows(scene.n_lights, tables.layout[3]), R),
                        dtype=torch.float32, device=oT.device)
    n_live = torch.empty(R, dtype=torch.int32, device=oT.device)
    if R:
        TRAIN_KERNEL.launch(*args, ptr(A), ptr(B), ptr(fl), ptr(resid),
                            ptr(n_live), stream_ptr(oT.device))
    return A, B, fl, resid, n_live


def trace_bwd(scene, tables, decay, u8s, resid, n_live, ctA, ctB):
    """Launch ``mrt_trace_bwd`` on CUDA tensors: the cotangents of the row
    table ``(P, 26)``, the light table, the primaries ``oT``, ``dT`` ``(3,
    R)`` and the triangle table ``(Pt, 16)`` (its ``G[2]`` and ``h[2]``
    columns), for output cotangents ``ctA``, ``ctB`` ``(3, R)`` of a trace
    whose residuals :func:`trace_fwd_train` (or :func:`trace_plain` with
    ``want_resid``) wrote. The table cotangents vary from run to run at
    float32 rounding level (csrc/trace_bwd.cu)."""
    check_scene(scene)
    L = scene.n_lights
    K, _nu, R = u8s.shape
    require_cuda_tensor("u8s", u8s, torch.float32,
                        (K, n_uni(scene.any_refract), R))
    require_cuda_tensor("resid", resid, torch.float32,
                        (K, res_rows(L, tables.layout[3]), R))
    require_cuda_tensor("n_live", n_live, torch.int32, (R,))
    require_cuda_tensor("ctA", ctA, torch.float32, (3, R))
    require_cuda_tensor("ctB", ctB, torch.float32, (3, R))
    args = _table_args(scene, tables, BWD_MAX_ROWS, "trace_bwd")
    tab, lights, layout = tables.tab, tables.lights, tables.layout
    dev = tab.device
    d_tab = torch.zeros((tab.shape[0], ROW_COLS), dtype=torch.float32,
                        device=dev)
    d_lights = torch.zeros_like(lights)
    d_oT = torch.zeros((3, R), dtype=torch.float32, device=dev)
    d_dT = torch.zeros_like(d_oT)
    d_tri4 = torch.zeros((layout[2], 4), dtype=torch.float32, device=dev)
    if R:
        blocks = min(-(-R // _BWD_THREADS), _BWD_MAX_BLOCKS)
        partials = torch.empty(
            (blocks, layout[1] * _GRAD_COLS + L * LIGHT_COLS),
            dtype=torch.float32, device=dev)
        BWD_KERNEL.launch(
            *args, L, float(decay), ptr(resid), ptr(n_live), ptr(u8s), R,
            int(scene.any_refract), ptr(ctA), ptr(ctB), ptr(d_oT),
            ptr(d_dT), ptr(partials), blocks, ptr(d_tab), ptr(d_lights),
            ptr(d_tri4) if layout[2] else None, stream_ptr(dev))
    d_tri = torch.zeros((layout[2], hit3.TRI_COLS), dtype=torch.float32,
                        device=dev)
    d_tri[:, 6:9] = d_tri4[:, :3]
    d_tri[:, hit3._T_H + 2] = d_tri4[:, 3]
    return d_tab, d_lights, d_oT, d_dT, d_tri


class TraceFunction(torch.autograd.Function):
    """The whole trace on CUDA tensors under autograd: forward through the
    primary-hit kernel and the train instance of the trace kernel, backward
    through the backward kernel. Differentiable inputs: the row table, the
    light table, the triangle table, ``oT`` and ``dT``; ``first_live`` has
    no gradient."""

    @staticmethod
    def forward(ctx, tab, lights, tri, oT, dT, scene, tables, decay, u8s):
        tables = tables._replace(tab=tab, lights=lights, tri=tri)
        hit0 = primary_hits(scene, tables, oT, dT)
        A, B, fl, resid, n_live = trace_fwd_train(scene, tables, decay, oT,
                                                  dT, u8s, hit0)
        ctx.save_for_backward(tab, lights, tri, u8s, resid, n_live)
        ctx.scene, ctx.decay = scene, decay
        ctx.layout, ctx.tbb = tables.layout, tables.tbb
        ctx.mark_non_differentiable(fl)
        return A, B, fl

    @staticmethod
    def backward(ctx, ctA, ctB, _ct_fl):
        tab, lights, tri, u8s, resid, n_live = ctx.saved_tensors
        R = u8s.shape[2]
        zero = torch.zeros((3, R), dtype=torch.float32, device=tab.device)
        ctA = zero if ctA is None else ctA.contiguous()
        ctB = zero if ctB is None else ctB.contiguous()
        tables = TraceTables(None, tab, lights, ctx.layout, tri, ctx.tbb)
        d_tab, d_lights, d_oT, d_dT, d_tri = trace_bwd(
            ctx.scene, tables, ctx.decay, u8s, resid, n_live, ctA, ctB)
        return d_tab, d_lights, d_tri, d_oT, d_dT, None, None, None, None


def trace_packed(scene, tables, decay, oT, dT, u8s):
    """Whole trace on lane-major primaries (see the module docstring for
    which path each input takes)."""
    if oT.device.type == "cpu":
        return trace_plain(scene, tables, decay, oT, dT, u8s)
    diff_in = (tables.tab, tables.lights, tables.tri, oT, dT)
    if torch.is_grad_enabled() and any(t.requires_grad for t in diff_in):
        return TraceFunction.apply(tables.tab, tables.lights, tables.tri,
                                   oT, dT, scene, tables, decay, u8s)
    hit0 = primary_hits(scene, tables, oT, dT)
    return trace_fwd(scene, tables, decay, oT, dT, u8s, hit0)
