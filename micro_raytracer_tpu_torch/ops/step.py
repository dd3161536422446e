"""The trace, forward and backward: the whole-trace CUDA kernels
``csrc/trace_fwd.cu`` and ``csrc/trace_bwd.cu``, the per-step kernels
``csrc/step_fwd.cu`` and ``csrc/step_bwd.cu``, their wrappers, their plain
PyTorch versions, and the autograd functions that join them.

The counterpart of ``micro_raytracer_tpu.ops.pallas_step`` for scenes of
spheres, planes, boxes, triangles and meshes, with or without texture
maps. :func:`pack_step` builds the kernels' tables
(:class:`TraceTables`): a ``(P, 26)`` row table — the 18 sweep columns of
:func:`hit3.pack_scene`, whose ``fr, ipos, pa, pr`` are pallas_step's
attribute columns ``_C_FR.._C_PR`` (a triangle row's ``pa`` is its raw
normal), then ``_C_ALB.._C_EMI`` — the ``(L, 11)`` light table whose
directional entries hold ``-normalize(light_dir)``, the triangle
segment's Woop table and cull-block AABBs (:func:`hit3.tri_tables`), and
on a textured scene the ``(P, 6)`` int32 map ids of each row
(``mat_maps[mat_id]``, -1: no map) with the flat ``(N, 3)`` atlas and its
``(T, 3)`` (offset, width, height) table. The row, light and triangle
tables are differentiable functions of the scene leaves, so their
cotangents reach the leaves by autograd; a training step rebuilds them
from the current parameters every step. Textures are constants.

Textures (rt.rs:811-863, pallas_step's ``_apply_maps_rows``): at each hit
side the trace takes the point's uv (:func:`intersect.uv_from_attrs`), the
nearest texel of each mapped slot (:func:`intersect.sample_texture`), and
applies it: slot 0 multiplies the albedo by the texel's rgb, slots 1-5
replace rough, metal, glass, opacity and emit by its red channel. The
dielectric test ``(metal == 0) & (opacity != 0)`` reads the raw metal and
the mapped opacity; the entry side's mapped opacity sets the refract
choice, the exit side's mapped glass the index; the chosen side's mapped
albedo, rough, metal and emit shade the step.

:func:`trace_packed` runs all ``bounce + 1`` steps on lane-major primaries
``oT``/``dT`` ``(3, R)`` with uniforms ``u8s`` ``(K, NU, R)`` — ``NU = 8``
rows ``[u0..u6, u_emit]`` when the scene refracts, else 4 rows ``[u0, u1,
u2, u_emit]`` — and returns ``A, B`` ``(3, R)`` and the first-bounce hit
liveness ``(1, R)``. :func:`route` picks its path from the scene and
whether a gradient is wanted, the same way on every device: the whole
trace for at most :data:`MAX_LIGHTS` lights and at most :data:`MAX_ROWS`
sphere, plane and box rows (:data:`BWD_MAX_ROWS` in training), which the
whole-trace kernels hold in registers and shared memory; past either, the
per-step path (:func:`trace_steps`: one bounce step per launch, the
``(CARRY_ROWS, R)`` carry in device memory between launches, the JAX
package's per-step scan with pallas_step's ``_step_kernel`` and
``_bwd_kernel``), whose kernels take any number of lights and rows. On
the whole-trace route it dispatches on its inputs:

* CPU tensors run :func:`trace_plain`, and autograd differentiates it;
* CUDA tensors that need a gradient run :class:`TraceFunction`: the
  primary-hit kernel (:func:`hit3.closest_hit`), the train instance of the
  trace kernel (:func:`trace_fwd_train`), which saves residuals, and in
  the backward the backward kernel (:func:`trace_bwd`);
* other CUDA tensors run the primary-hit kernel and the render instance
  (:func:`trace_fwd`).

:func:`trace_segment` runs the steps ``[k0, k1)`` of a render from a
carry (live-first compaction between segments, ``models/tracer.py``): the
render instance on the card, :func:`trace_plain` on the CPU.

The per-step path: :func:`step_plain` is one step of :func:`trace_plain`
from a carry, with its residuals (a ray that is dead or misses passes its
carry through; pwr decays on every lane); on the card :func:`step_fwd`
(the render instance), or under a gradient :class:`StepFunction`
(:func:`step_fwd_train`, then :func:`step_bwd`). Composed over the K
steps it is the whole trace bit for bit. A triangle segment of more than
``hit3.MAX_TRI_BLOCKS`` cull blocks (a mesh of more than 16,384 triangles,
more block AABBs than the kernels stage) takes the per-step path, where
each step first sweeps the triangle segment alone (:func:`tri_hits`:
``tri.tri_entry``, or ``tri.tri_entry_exit`` on a refractive scene, on
the carry's rays) and the step then merges that hit with the dense rows
(the kernels' kTriIn instances; :func:`merge_tri_hits` in the plain step),
the JAX package's ``closest_hit_tri_pallas``. No path falls back to
another.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..models import schema
from ..utils.kernels import (CudaKernel, ptr, ptxas_table,
                             require_cuda_tensor, stream_ptr)
from . import hit3, intersect, linalg, rng, tri as tri_ops
from .linalg import EPS

# attribute columns of the row table after the sweep columns
# (pallas_step._C_ALB.._C_EMI)
_C_ALB, _C_RGH, _C_MET, _C_GLS, _C_OPA, _C_EMI = 18, 21, 22, 23, 24, 25
_OMAP = schema.MaterialConfig.MAP_KEYS.index("omap")   # a slot of ``maps``
ROW_COLS = 26
LIGHT_COLS = 11
MAX_LIGHTS = 4
# shared-memory bound of the forward kernel on the sphere, plane and box
# rows: 2048 rows * 104 B + lights + hit3.MAX_TRI_BLOCKS block AABBs; the
# triangle rows stay in global memory (any count)
MAX_ROWS = 2048
# the training bound on those rows (the backward kernel reads them from
# global memory and sums their cotangents in shared memory while they fit,
# past that with global atomics; csrc/trace_bwd.cu)
BWD_MAX_ROWS = 1024
# the per-step kernels (csrc/step_fwd.cu, csrc/step_bwd.cu) read the rows
# from global memory (no row bound) and stage the first STEP_MAX_LIGHTS
# lights in shared memory, 2048 * 44 B = 88 KB (the backward's float64 sums
# beside them take at most _STEP_SHARED_BYTES), the rest read from global
# memory (trace_step.cuh LightTab): no light bound
STEP_MAX_LIGHTS = 2048
# the per-step backward sums the dense rows' cotangents in float64 per
# block in shared memory while they and its warps' light slots fit this
# budget (csrc/step_bwd.cu kSharedBytes), else straight into the global
# float64 sums (chip_smoke.py --step-diagnosis times both on lights8)
_STEP_SHARED_BYTES = 100 * 1024
# warps per block of csrc/step_bwd.cu (kThreads / 32), each with its own
# float64 slots of the lights' cotangents
_STEP_BWD_WARPS = 8

# residual rows per step (csrc/trace_step.cuh): the step's input ray o, d
# and throughput A, its entry and exit t, entry winner row, refract choice,
# one occlusion bit per light, on a scene with triangle rows the exit
# winner row (without triangles every group is one row: it is the entry
# row) and on a textured scene the texels of the present map slots (3 rows
# for slot 0, 1 for each other slot), entry side then exit side
RES_O, RES_D, RES_A = 0, 3, 6
RES_TE, RES_TX, RES_ROW, RES_CHOOSE, RES_LOK = 9, 10, 11, 12, 13


def res_rows(n_lights: int, n_tri: int = 0) -> int:
    """Residual rows per step with ``n_lights`` lights and ``n_tri``
    triangle rows to sweep (``layout[3]``), without textures: on a
    textured scene the first texel row."""
    return RES_LOK + n_lights + (1 if n_tri else 0)


def tex_side_rows(slots) -> int:
    """Texel residual rows of one hit side for the present map slots."""
    return sum(3 if s == 0 else 1 for s in range(6) if slots[s])


def tex_rows(scene) -> int:
    """Texel residual rows per step: one side's, twice on a refractive
    scene (entry and exit side), none without textures."""
    if not scene.has_maps:
        return 0
    return tex_side_rows(scene.map_slots) * (2 if scene.any_refract else 1)


def scene_res_rows(scene, layout) -> int:
    """Residual rows per step of a scene and its tables' layout, the
    texel rows included."""
    return res_rows(scene.n_lights, layout[3]) + tex_rows(scene)


def res_xrow(n_lights: int) -> int:
    """The exit winner row's residual row (scenes with triangle rows)."""
    return RES_LOK + n_lights


# carry rows of a segmented render (csrc/trace_fwd.cu CarryRow; the JAX
# package's c0 / cout): o (3), d (3), pwr, live, A (3), B (3)
C_LIVE, CARRY_ROWS = 7, 14

_c_int, _c_ptr = ctypes.c_int, ctypes.c_void_p
_TRI_ARGS = [_c_ptr, _c_int, _c_int, _c_ptr, _c_int, _c_ptr, _c_int]
_TEX_ARGS = [_c_ptr] * 3 + [_c_int]
_FWD_ARGS = ([_c_ptr, _c_int] + [_c_int] * 6 + _TRI_ARGS
             + [_c_ptr, _c_int, ctypes.c_float] + _TEX_ARGS + [_c_ptr] * 7
             + [_c_int] * 3)
_HEADERS = ("hit3.cuh", "trace_step.cuh")
_TRACE_HEADERS = _HEADERS + ("grid.cuh", "tri_walk.cuh",
                             "sph_walk.cuh", "box_walk.cuh")
# ... k0, k1, c0, rid, A, B, first_live, cout, the refill counters, the
# sphere walk tables (srows, ssb), the box walk (its tables and boxes),
# stream
_BOX_ARGS = [_c_ptr, _c_int, _c_ptr]
KERNEL = CudaKernel("trace_fwd", "trace_fwd.cu", _TRACE_HEADERS,
                    "mrt_trace_fwd",
                    _FWD_ARGS + [_c_int, _c_int] + [_c_ptr] * 9 + _BOX_ARGS)
TRAIN_KERNEL = CudaKernel("trace_fwd_train", "trace_fwd.cu", _TRACE_HEADERS,
                          "mrt_trace_fwd_train",
                          _FWD_ARGS + [_c_ptr] * 8 + _BOX_ARGS)
# resident warps per SM of a whole-trace instance (not launches)
FWD_OCCUPANCY = CudaKernel("trace_fwd_occupancy", "trace_fwd.cu",
                           _TRACE_HEADERS, "mrt_trace_fwd_occupancy",
                           [_c_int] * 17 + [_c_ptr])
_BWD_HEADERS = _HEADERS + ("trace_bwd.cuh",)
BWD_KERNEL = CudaKernel(
    "trace_bwd", "trace_bwd.cu", _BWD_HEADERS + ("grid.cuh",),
    "mrt_trace_bwd",
    [_c_ptr, _c_int] + [_c_int] * 6 + _TRI_ARGS
    + [_c_ptr, _c_int, ctypes.c_float] + _TEX_ARGS + [_c_ptr] * 3
    + [_c_int] * 2 + [_c_ptr] * 9)
BWD_OCCUPANCY = CudaKernel("trace_bwd_occupancy", "trace_bwd.cu",
                           _BWD_HEADERS + ("grid.cuh",),
                           "mrt_trace_bwd_occupancy",
                           [_c_int] * 5 + [_c_ptr])
# the per-step path: tables as the trace kernels', then c0, u8, R, refract
_STEP_ARGS = ([_c_ptr, _c_int] + [_c_int] * 6 + _TRI_ARGS
              + [_c_ptr, _c_int, ctypes.c_float] + _TEX_ARGS
              + [_c_ptr, _c_ptr, _c_int, _c_int])
# ... c1, hit (train: resid), the triangle segment's te, row, tx, xrow
# and its cull blocks' superblocks and their count (kTriIn; null and 0
# otherwise), the sphere walk tables (sbb's; null otherwise), the refill
# counters (_counters), stream
_STEP_HEADERS = _HEADERS + ("tri_walk.cuh", "sph_walk.cuh", "grid.cuh")
STEP_KERNEL = CudaKernel("step_fwd", "step_fwd.cu", _STEP_HEADERS,
                         "mrt_step_fwd",
                         _STEP_ARGS + [_c_ptr] * 7 + [_c_int] + [_c_ptr] * 4)
STEP_TRAIN_KERNEL = CudaKernel("step_fwd_train", "step_fwd.cu",
                               _STEP_HEADERS, "mrt_step_fwd_train",
                               _STEP_ARGS + [_c_ptr] * 8 + [_c_int]
                               + [_c_ptr] * 4)
# resident warps per SM of a per-step forward instance (not launches)
STEP_OCCUPANCY = CudaKernel("step_fwd_occupancy", "step_fwd.cu",
                            _STEP_HEADERS, "mrt_step_fwd_occupancy",
                            [_c_int] * 11 + [_c_ptr])
# the same entry points for scenes of more than STEP_MAX_LIGHTS lights
# (csrc/step_fwd_many.cu: their instances, in a library of their own)
_MANY_HEADERS = _STEP_HEADERS + ("step_fwd.cu",)
STEP_MANY_KERNEL = CudaKernel("step_fwd_many", "step_fwd_many.cu",
                              _MANY_HEADERS, "mrt_step_fwd",
                              STEP_KERNEL.argtypes)
STEP_MANY_TRAIN_KERNEL = CudaKernel("step_fwd_many_train",
                                    "step_fwd_many.cu", _MANY_HEADERS,
                                    "mrt_step_fwd_train",
                                    STEP_TRAIN_KERNEL.argtypes)
STEP_MANY_OCCUPANCY = CudaKernel("step_fwd_many_occupancy",
                                 "step_fwd_many.cu", _MANY_HEADERS,
                                 "mrt_step_fwd_occupancy",
                                 STEP_OCCUPANCY.argtypes)
STEP_BWD_KERNEL = CudaKernel(
    "step_bwd", "step_bwd.cu", _BWD_HEADERS + ("grid.cuh",), "mrt_step_bwd",
    [_c_ptr, _c_int] + [_c_int] * 6 + _TRI_ARGS
    + [_c_ptr, _c_int, ctypes.c_float] + _TEX_ARGS + [_c_ptr] * 4
    + [_c_int] * 2 + [_c_ptr] * 2 + [_c_int] + [_c_ptr] * 5)
STEP_BWD_OCCUPANCY = CudaKernel("step_bwd_occupancy", "step_bwd.cu",
                                _BWD_HEADERS + ("grid.cuh",),
                                "mrt_step_bwd_occupancy",
                                [_c_int] * 6 + [_c_ptr])


class Segment(NamedTuple):
    """The steps ``[k0, k1)`` of a segmented render, the ``(CARRY_ROWS,
    R)`` carry it resumes from (None: the primaries, ``k0 = 0``) and the
    ray each lane holds (None: lane i holds ray i), whose uniform column it
    reads."""

    k0: int
    k1: int
    c0: torch.Tensor | None = None
    rid: torch.Tensor | None = None


class TraceTables(NamedTuple):
    """What a trace needs of a scene, built by :func:`pack_step`."""

    frames: torch.Tensor     # (P, 3, 3) instance matrices
    tab: torch.Tensor        # (P, ROW_COLS) row table
    lights: torch.Tensor     # (max(L, 1), LIGHT_COLS) light table
    layout: tuple            # hit3.seg_layout of the kind segments
    tri: torch.Tensor        # (Pt, hit3.TRI_COLS) triangle table
    tbb: torch.Tensor | None  # (n_cb, hit3.BB_COLS) cull blocks, or None
    # textured scenes only (else None): (P, 6) int32 map ids, the (N, 3)
    # atlas, the (T, 3) int32 (offset, width, height) of each texture
    maps: torch.Tensor | None = None
    atlas: torch.Tensor | None = None
    tmeta: torch.Tensor | None = None
    # (n_sb, hit3.BB_COLS) cull blocks of a long sphere segment, or None
    sbb: torch.Tensor | None = None
    # the triangle cull blocks' superblocks (tri_ops.superbounds) where the
    # segment is swept on its own (tri_split), else None
    tsb: torch.Tensor | None = None
    # with sbb, the per-step forward's sphere walk tables
    # (hit3.sph_walk_tables): the packed sphere rows (n, 16) and the
    # sub-blocks' AABBs (n_sub, hit3.BB_COLS), else None
    srows: torch.Tensor | None = None
    ssb: torch.Tensor | None = None
    # a textured scene's walked box segment (hit3.box_walk_tables), or None
    box: hit3.BoxWalk | None = None
    # on the card, the closest hit's launch arguments of these tables
    # (hit3.HitArgs: checked and packed once, read through hit_args), or
    # None
    hit: hit3.HitArgs | None = None


def n_uni(need_exit: bool) -> int:
    """Uniform rows per step: opaque scenes never read the exit-side draws
    u3..u6, so only [u0, u1, u2, u_emit] are packed."""
    return 8 if need_exit else 4


def check_scene(scene) -> None:
    """Reject a scene the whole-trace kernels do not cover (:func:`route`
    sends it to the per-step path)."""
    if scene.n_lights > MAX_LIGHTS:
        raise ValueError(f"trace kernel: {scene.n_lights} lights exceed "
                         f"its bound of {MAX_LIGHTS}")


def route(scene, train: bool) -> str:
    """The path of a trace of ``scene`` (``train``: a gradient is
    wanted): ``"trace"``, the whole-trace kernels, for at most
    :data:`MAX_LIGHTS` lights, at most :data:`MAX_ROWS` sphere, plane and
    box rows (:data:`BWD_MAX_ROWS` in training) and at most
    ``hit3.MAX_TRI_BLOCKS`` triangle cull blocks (16,384 triangles);
    ``"steps"``, the per-step path (:func:`trace_steps`), past any of them
    — exactly where the whole-trace wrappers raise. The rule is the same
    on every device."""
    n_dense = hit3.seg_layout(scene.kind_counts)[1]
    if scene.n_lights > MAX_LIGHTS or \
            n_dense > (BWD_MAX_ROWS if train else MAX_ROWS) or \
            tri_split(scene.kind_counts[schema.KIND_TRIANGLE]):
        return "steps"
    return "trace"


def tri_split(n_tri: int) -> bool:
    """Whether a triangle segment of ``n_tri`` rows has more cull blocks
    than the kernels stage (``hit3.MAX_TRI_BLOCKS``): the per-step path
    then sweeps it on its own before each step (:func:`tri_hits`)."""
    return hit3.tri_blocks(n_tri) > hit3.MAX_TRI_BLOCKS


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
    tex = ()
    if scene.has_maps:
        tex = (scene.mat_maps[m].to(torch.int32).contiguous(),
               *intersect.tex_tables(scene))
    layout = hit3.seg_layout(scene.kind_counts, scene.kind_sweep)
    tsb = tri_ops.superbounds(tbb) if tri_split(layout[2]) else None
    srows, ssb = hit3.sph_walk_tables(scene, layout, tab)
    tables = TraceTables(frames, tab, lights, layout, tri, tbb, *tex,
                         sbb=hit3.sph_table(scene, layout), tsb=tsb,
                         srows=srows, ssb=ssb,
                         box=hit3.box_walk_tables(scene, layout, tab))
    return tables._replace(hit=hit_args(tables))


def table_hit_args(tables):
    """The closest hit's :class:`hit3.HitArgs` of ``tables`` (its row,
    triangle and cull tables and walks, as :func:`primary_hits` passes
    them)."""
    return hit3.hit_args(tables.tab, tables.layout, tables.tri, tables.tbb,
                         tables.sbb, _walk(tables), tables.box)


def hit_args(tables):
    """``tables.hit`` where it was built from these very tables, else
    :func:`table_hit_args` (tables replaced in part, such as a float64 or
    an unwalked copy); None for tables off the card."""
    h = tables.hit
    now = (tables.tab, tables.layout, tables.tri, tables.tbb, tables.sbb,
           *(_walk(tables) or (None, None)), tables.box)
    if h is not None and all(a is b for a, b in zip(h.key, now)):
        return h
    return table_hit_args(tables) if tables.tab.is_cuda else None


def hits(tables, o, d, mode):
    """``hit3.closest_hit`` of rays ``o``, ``d`` (R, 3) against the
    tables' sweep (walks included): on the card through their launch
    arguments (:func:`hit_args`, so a call checks only the rays), on the
    CPU the plain version."""
    if o.device.type == "cpu":
        return hit3.closest_hit(tables.tab, tables.layout, o, d, mode,
                                tables.tri, tables.tbb, tables.sbb,
                                _walk(tables), tables.box)
    return hit3.launch_hit(hit_args(tables), o, d, mode)


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


def _rough_override(at, mat, u):
    """The dielectric re-roll (rt.rs:559-572): the raw metal column, the
    mapped opacity."""
    return (at[:, _C_MET] == 0.0) & (mat["opacity"] != 0.0) & (u < 0.8)


def _row_kind(row, ends):
    """Schema kind of each winner row (segments: spheres, planes, boxes,
    triangles)."""
    sph_end, pln_end, tri_start = ends
    return torch.where(
        row < sph_end, schema.KIND_SPHERE,
        torch.where(row < pln_end, schema.KIND_PLANE,
                    torch.where(row >= tri_start, schema.KIND_TRIANGLE,
                                schema.KIND_BOX)))


TEX_EDGE = 1e-4   # a texel coordinate this close to an integer may flip


def _side_material(scene, tables, at, p, row, ends, live_i, work):
    """The material of one hit side: the row's columns with the texels at
    ``p`` applied (:func:`intersect.apply_texels`), and the texels
    (``[(slot, value)]``, empty without textures). ``work`` gains under
    ``"tex_fetch"`` the texel fetches of live rays and under
    ``"tex_edge"`` the rays with a texel coordinate within
    :data:`TEX_EDGE` of an integer."""
    mat = {"color": at[:, _C_ALB:_C_ALB + 3], "rough": at[:, _C_RGH],
           "metal": at[:, _C_MET], "glass": at[:, _C_GLS],
           "opacity": at[:, _C_OPA], "emit": at[:, _C_EMI]}
    if tables.maps is None:
        return mat, []
    ids = tables.maps[row.long()]
    with torch.no_grad():
        kind = _row_kind(row, ends)
        u, v = intersect.uv_from_attrs(at.detach(), p.detach(), kind)
        tv = intersect.texel_values(tables.atlas, tables.tmeta,
                                    scene.map_slots, ids, u, v)
        if work is not None:
            for s, _val in tv:
                fetch = live_i & (ids[:, s] >= 0)
                work["tex_fetch"] = (work.get("tex_fetch", 0)
                                     + int(fetch.sum()))
                # a triangle's uv is 0 on every path: its texel never flips
                edge = intersect.texel_edge(tables.tmeta, ids[:, s], u, v,
                                            TEX_EDGE)
                edge &= fetch & (kind != schema.KIND_TRIANGLE)
                work["tex_edge"] = work.get(
                    "tex_edge", torch.zeros_like(fetch)) | edge
    return intersect.apply_texels(mat, ids, tv), tv


def _tex_resid(tv):
    """Residual rows of one side's texels: 3 for slot 0, 1 per scalar."""
    return [val.T if s == 0 else val[None] for s, val in tv]


def _light_vec(lt, p):
    """(R, 3) vector from ``p`` toward light row ``lt`` (its stored
    ``-normalize(dir)`` for a directional light)."""
    return torch.where(lt[6] > 0.5, lt[3:6].expand_as(p), lt[0:3] - p)


def _occlusion(tables, L, p_e, live_i, work=None):
    """(R, L) bool: light li is visible from the entry point (no
    gradient: the shadow sweep's result is a choice). ``work["shadow"]``
    gains the triangle rows the kernel's shadow sweeps test, with sphere
    cull blocks ``work["sph_shadow"]`` the sphere rows, and with the box
    walk ``work["box_shadow"]`` and ``work["box_slabs"]`` the box rows and
    the walk's slab tests."""
    with torch.no_grad():
        tab, p_e = tables.tab.detach(), p_e.detach()
        lights, layout = tables.lights, tables.layout
        tri = tables.tri.detach()
        oks = []
        for li in range(L):
            lv = _light_vec(lights[li].detach(), p_e)
            ln = _scale(lv, 1.0 / torch.sqrt(_dot3(lv, lv)))
            so = p_e + ln * EPS
            bw = {} if work is not None else None
            te = hit3.sweep_plain(tab, layout, so, ln, hit3.MODE_ANY, tri,
                                  tables.tbb, tables.sbb, tables.box, bw)[0]
            if work is not None:
                work["shadow"] += int(hit3.tri_rows_tested(
                    tab, layout, so, ln, hit3.MODE_ANY, tri,
                    tables.tbb)[live_i].sum())
                if tables.sbb is not None:
                    work["sph_shadow"] = work.get("sph_shadow", 0) + int(
                        hit3.sph_rows_tested(tab, layout, so, ln,
                                             hit3.MODE_ANY,
                                             tables.sbb)[live_i].sum())
                _box_work(work, "box_shadow", bw, live_i)
            oks.append((te >= hit3.BIG * 0.5) & live_i)
        if not oks:
            return torch.zeros((p_e.shape[0], 0), dtype=torch.bool,
                               device=p_e.device)
        return torch.stack(oks, 1)


def _box_work(work, key, box_work, live):
    """Add the box walk's rows (under ``key``) and slab tests (under
    ``"box_slabs"``) for the ``live`` rays, from a sweep's ``box_work``
    (:func:`hit3.sweep_plain`; empty without the walk), to ``work``."""
    if box_work:
        work[key] = work.get(key, 0) + int(box_work["rows"][live].sum())
        work["box_slabs"] = (work.get("box_slabs", 0)
                             + int(box_work["slabs"][live].sum()))


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


def pick_side(scene, tables, o, d, tx, xrow, live_i, p_e, n_e, at_e, mat_e,
              u, ends, work=None):
    """The step's reflect / refract pick (rt.rs:559-589, 1054-1058) from
    the entry side (point ``p_e``, normal ``n_e``, row attributes ``at_e``,
    material ``mat_e``) and, on a refractive scene, the exit side at
    ``tx``, ``xrow`` (its row gathered whole here), with the uniforms ``u``
    (R, 7): ``(choose, next_dir, from_p, norm, mat, exit texels)``; the
    chosen side's point, normal and material shade the step. Shared by the
    plain trace and the record path (``models/tracer.py``)."""
    rough_r = torch.where(_rough_override(at_e, mat_e, u[:, 0]), 1.0,
                          mat_e["rough"])
    nr = rng.sphere_rand(n_e, rough_r, u[:, 1], u[:, 2])
    refl = _safe_norm(d - _scale(nr, 2.0 * _dot3(d, nr)))
    if not scene.any_refract:
        return torch.zeros_like(live_i), refl, p_e, n_e, mat_e, []
    at_x = tables.tab[xrow.long()]
    p_x = o + _scale(d, torch.where(live_i, tx, 1.0))
    n_x = _normal(at_x, p_x, xrow, ends)
    mat_x, tv_x = _side_material(scene, tables, at_x, p_x, xrow, ends,
                                 live_i, work)
    rough_f = torch.where(_rough_override(at_x, mat_x, u[:, 3]), 1.0,
                          mat_x["rough"])
    nf = rng.sphere_rand(n_x, rough_f, u[:, 4], u[:, 5])
    eta = 1.0 + 0.5 * mat_x["glass"]
    cs = -_dot3(nf, d)
    kk = 1.0 - eta * eta * (1.0 - cs * cs)
    refr_ok = kk >= 0.0
    k_safe = torch.where(refr_ok, torch.clamp(kk, min=1e-12), 1.0)
    refr = _finite0(_safe_norm(
        _scale(d, eta) + _scale(nf, cs * eta + torch.sqrt(k_safe))))
    choose = ((u[:, 6] < torch.clamp(1.0 - mat_e["opacity"], max=0.85))
              & refr_ok)
    c = choose[:, None]
    mat = {k: torch.where(c if k == "color" else choose, mat_x[k], mat_e[k])
           for k in mat_e}
    return (choose, torch.where(c, refr, refl), torch.where(c, p_x, p_e),
            torch.where(c, n_x, n_e), mat, tv_x)


def trace_plain(scene, tables, decay, oT, dT, u8s, want_resid=False,
                work=None, seg=None):
    """Plain PyTorch whole trace: the kernels' step, operation for
    operation, on their inputs (any device). Differentiable by autograd in
    ``tables.tab``, ``tables.lights``, ``oT`` and ``dT``: hits are the
    winner row's t from the sweep (:func:`hit3.sweep_plain`), attributes a
    gather of its row, occlusion a choice. ``tables.tri`` carries the
    gradient of a triangle winner's t (its ``G`` and ``h`` columns).

    Returns ``(A (3,R), B (3,R), first_live (1,R))``; with ``want_resid``
    also the residuals ``(K, scene_res_rows(scene, layout), R)`` and
    live-step counts ``(R,)`` int32 that the train kernel writes (rows of
    steps at or after a ray's count are not meaningful).

    ``work`` (a dict, for the kernels' bounds and checks): gains under
    ``"sweep"`` the triangle rows the trace kernel's closest-hit sweeps
    test (steps after the first, whose sweep is the primary-hit pass; the
    exit pass included) and under ``"shadow"`` those of its shadow sweeps,
    for the rays live at each sweep; with sphere cull blocks the sphere
    rows under ``"sph_sweep"`` and ``"sph_shadow"``; with the box walk the
    box rows under ``"box_sweep"`` and ``"box_shadow"`` and its slab tests
    under ``"box_slabs"``; on a textured scene also ``"tex_fetch"`` and
    ``"tex_edge"`` (:func:`_side_material`).

    ``seg`` (a :class:`Segment`) runs its steps from its carry, lane i
    reading the uniform column of ray ``rid[i]``, and returns ``(A, B,
    first_live, carry)`` like :func:`trace_segment` (``first_live`` is 0
    unless the segment starts at step 0), then with ``want_resid`` the
    segment's residuals and live-step counts."""
    (TRAIN_KERNEL if want_resid else KERNEL).plain_calls += 1
    return _trace_plain(scene, tables, decay, oT, dT, u8s, want_resid, work,
                        seg)


def _trace_plain(scene, tables, decay, oT, dT, u8s, want_resid, work, seg,
                 thit=None):
    """:func:`trace_plain` without its call count (the plain step runs
    it too). ``thit``: the triangle segment's hits of a one-step segment
    (:func:`tri_hits`), merged with the dense rows' sweep
    (:func:`merge_tri_hits`) in place of the sweep over every row."""
    tab, lights, layout = tables.tab, tables.lights, tables.layout
    L, refract = scene.n_lights, scene.any_refract
    mode = primary_mode(scene)
    ends = hit3.row_ends(layout)
    R, K = oT.shape[1], u8s.shape[0]
    segmented = seg is not None
    seg = Segment(0, K) if seg is None else seg
    n_live = torch.zeros(R, dtype=torch.int32, device=oT.device)
    if seg.c0 is None:
        o, d = oT.T, dT.T
        pwr = torch.ones((), dtype=oT.dtype, device=oT.device)
        live = torch.ones(R, dtype=torch.bool, device=oT.device)
        A = torch.ones((R, 3), dtype=oT.dtype, device=oT.device)
        B = torch.zeros((R, 3), dtype=oT.dtype, device=oT.device)
    else:
        c = seg.c0
        o, d, pwr = c[0:3].T, c[3:6].T, c[6:7].T
        live, A, B = c[C_LIVE] > 0.5, c[8:11].T, c[11:14].T
    first = torch.zeros(R, dtype=torch.bool, device=oT.device)
    resid = []
    for k in range(seg.k0, seg.k1):
        u8 = u8s[k] if seg.rid is None else u8s[k][:, seg.rid]
        u, u_emit = unpack_uniforms(u8, refract)
        bw = {} if work is not None and k else None
        if thit is None:
            te, row, tx, xrow = hit3.sweep_plain(tab, layout, o, d, mode,
                                                 tables.tri, tables.tbb,
                                                 tables.sbb, tables.box, bw)
        else:
            dense = hit3.sweep_plain(tab, (layout[0], layout[1], 0, 0), o,
                                     d, mode, sbb=tables.sbb)
            te, row, tx, xrow = merge_tri_hits(dense, layout[1], mode, thit)
        if work is not None and k and thit is None:
            work["sweep"] += int(hit3.tri_rows_tested(
                tab, layout, o, d, mode, tables.tri, tables.tbb)[live].sum())
            if tables.sbb is not None:
                work["sph_sweep"] = work.get("sph_sweep", 0) + int(
                    hit3.sph_rows_tested(tab, layout, o, d, mode,
                                         tables.sbb)[live].sum())
            _box_work(work, "box_sweep", bw, live)
        live_i = live & (te < hit3.BIG * 0.5)
        if k == 0:
            first = live_i
        p_e = o + _scale(d, torch.where(live_i, te, 1.0))
        at_e = tab[row.long()]
        lok = _occlusion(tables, L, p_e, live_i, work)
        n_e = _normal(at_e, p_e, row, ends)
        mat_e, tv_e = _side_material(scene, tables, at_e, p_e, row, ends,
                                     live_i, work)
        choose, next_dir, from_p, norm_c, mat_c, tv_x = pick_side(
            scene, tables, o, d, tx, xrow, live_i, p_e, n_e, at_e, mat_e, u,
            ends, work)
        alb_c = mat_c["color"]
        l_col = _direct_light(lights, L, lok, from_p, norm_c, d, alb_c,
                              mat_c["rough"], mat_c["metal"])
        b_emit = (u_emit < mat_c["emit"])[:, None]
        a_f = torch.where(b_emit, 0.0, pwr * (0.5 + alb_c))
        b_f = torch.where(b_emit, alb_c, l_col * pwr)
        lv = live_i[:, None]
        a_f = torch.where(lv, a_f, 1.0)
        b_f = torch.where(lv, b_f, 0.0)
        if want_resid:
            resid.append(torch.cat([
                o.T, d.T, A.T, te[None], tx[None], row.to(te.dtype)[None],
                choose.to(te.dtype)[None], lok.to(te.dtype).T]
                + ([xrow.to(te.dtype)[None]] if layout[3] else [])
                + _tex_resid(tv_e) + _tex_resid(tv_x)).detach())
        B = B + A * b_f
        A = A * a_f
        o = from_p + next_dir * EPS                          # Ray::cast
        d = next_dir
        pwr = pwr * decay
        n_live += live_i.to(torch.int32)
        live = live_i & ~b_emit[:, 0]                        # emit kill
    out = (A.T.contiguous(), B.T.contiguous(), first.to(oT.dtype)[None])
    if segmented:
        pwr = torch.broadcast_to(pwr, (R, 1))
        out += (torch.cat([o, d, pwr, live.to(oT.dtype)[:, None], A, B],
                          1).T.contiguous(),)
    if want_resid:
        out += (torch.stack(resid), n_live)
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


# --- the per-step path: plain version ---------------------------------------

def primary_carry(oT, dT):
    """The carry ``(CARRY_ROWS, R)`` of lane-major primaries: o, d, pwr = 1,
    live = 1, A = 1, B = 0 (differentiable in ``oT`` and ``dT``)."""
    R = oT.shape[1]
    one = torch.ones((1, R), dtype=oT.dtype, device=oT.device)
    return torch.cat([oT, dT, one, one, one.expand(3, R),
                      torch.zeros((3, R), dtype=oT.dtype, device=oT.device)])


def tri_hits(scene, tables, c0, plain=False):
    """The triangle segment's hits of the carry ``c0``'s live rays where
    the step kernels do not sweep it (:func:`tri_split`), else None:
    ``tri.tri_entry``'s ``(te, row)``, or on a refractive scene
    ``tri.tri_entry_exit``'s ``(te, row, tx, xrow)`` with the group exit
    swept only for winners on :func:`tri_refracts`' rows, triangle-local
    rows, culled per ray with the segment's cull blocks (a dead lane
    misses). ``plain``: the plain versions on any device, differentiable in
    the triangle table and the carry (the plain step's); else the wrappers,
    which launch the kernel on the card (no gradient: the step's backward
    kernel transposes the winner's t) and walk the cull blocks through
    their superblocks (``tables.tsb``)."""
    if not tri_split(tables.layout[2]):
        return None
    args = (tables.tri, c0[0:3].T, c0[3:6].T)
    if not plain:
        args = tuple(t.detach() for t in args)
    return tri_segment_hits(scene, tables, *args, c0[C_LIVE], plain)


def tri_segment_hits(scene, tables, tri, o, d, live=None, plain=False):
    """The triangle segment's hits of rays ``o``, ``d`` (R, 3) on its
    triangle table ``tri``: ``tri.TriEntry``, or on a refractive scene
    ``tri.TriEntryExit`` (see :func:`tri_hits`), differentiable in ``tri``,
    ``o`` and ``d`` through their winner-t VJPs."""
    args = (tri, o, d, tables.tbb, tables.layout[3], live, plain)
    if not scene.any_refract:
        return tri_ops.TriEntry.apply(*args, tables.tsb)
    return tri_ops.TriEntryExit.apply(*args, tri_refracts(tables),
                                      tables.tsb)


def tri_refracts(tables):
    """``(Pt,)`` float32, 1 on the triangle rows whose material can
    refract: opacity below 1 or an opacity map. A step reads the group exit
    only where the entry side refracts, which takes ``u < 1 - opacity``, so
    a winner on any other row needs no exit."""
    start, n = tables.layout[1], tables.layout[2]
    with torch.no_grad():
        can = tables.tab[start:start + n, _C_OPA] < 1.0
        if tables.maps is not None:
            can = can | (tables.maps[start:start + n, _OMAP] >= 0)
        return can.to(torch.float32)


def merge_tri_hits(dense, n_dense, mode, thit):
    """``(te, row, tx, xrow)`` of the closest hit from the dense rows' hits
    ``dense`` (their ``(te, row, tx, xrow)``; ``n_dense`` rows) and the
    triangle segment's hits ``thit`` (:func:`tri_hits`), by the rule of the
    JAX package's ``closest_hit_tri_pallas`` (intersect.py:488-524): the
    triangles are the last segment, so they win only with a t strictly
    below the dense rows' best, and then the exit is theirs."""
    te, row, tx, xrow = dense
    won = thit[0] < te
    te = torch.where(won, thit[0], te)
    row = torch.where(won, n_dense + thit[1], row)
    if mode != hit3.MODE_EXIT:
        return te, row, te, row
    tx = torch.where(won, thit[2], tx)
    xrow = torch.where(won, n_dense + thit[3], xrow)
    return te, row, tx, xrow


def _step_plain(scene, tables, decay, c0, u8, want_resid):
    """:func:`step_plain` without its call count (the box rows dense, as
    the per-step kernels sweep them)."""
    tables = tables._replace(box=None)
    out = _trace_plain(scene, tables, decay, c0[0:3], c0[3:6], u8[None],
                       want_resid, None, Segment(0, 1, c0),
                       tri_hits(scene, tables, c0, plain=True))
    hit, c1 = out[2], out[3]
    # a ray that is dead or misses keeps its ray (the plain step moves it)
    c1 = torch.cat([torch.where(hit > 0.5, c1[:6], c0[:6]), c1[6:]])
    return (c1, hit) + ((out[4][0],) if want_resid else ())


def step_plain(scene, tables, decay, c0, u8, want_resid=False):
    """Plain PyTorch bounce step, the per-step kernels' arithmetic (any
    device): the step of :func:`trace_plain` from the carry ``c0``
    ``(CARRY_ROWS, R)`` with the step's uniforms ``u8`` ``(NU, R)``.
    Returns the next carry and the step's hit liveness ``(1, R)`` (before
    the emit kill; pallas_step.step's ``live2``); with ``want_resid`` also
    the step's residuals ``(scene_res_rows, R)``, meaningful on the rays
    that hit. A ray that is dead or misses passes its carry through (live
    0); pwr decays on every lane. Differentiable by autograd in the
    tables and ``c0``."""
    (STEP_TRAIN_KERNEL if want_resid else STEP_KERNEL).plain_calls += 1
    return _step_plain(scene, tables, decay, c0, u8, want_resid)


def step_bwd_plain(scene, tables, decay, c0, u8, ct1):
    """Plain version of :func:`step_bwd`: autograd through the plain step
    for the output carry's cotangent ``ct1``. Returns ``(d_tab, d_lights,
    d_c0, d_tri)``."""
    STEP_BWD_KERNEL.plain_calls += 1
    ins = [t.detach().requires_grad_(True)
           for t in (tables.tab, tables.lights, c0, tables.tri)]
    with torch.enable_grad():
        c1, _hit = _step_plain(
            scene, tables._replace(tab=ins[0], lights=ins[1], tri=ins[3]),
            decay, ins[2], u8, False)
        grads = torch.autograd.grad(c1, ins, ct1, allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, ins))


# --- kernel wrappers --------------------------------------------------------

def _table_args(scene, tables, max_dense, what,
                max_tri_blocks=hit3.MAX_TRI_BLOCKS):
    """Validate the row, light and triangle tables of a launch (``max_dense``:
    the kernel's bound on the dense rows, None for none; ``max_tri_blocks``:
    its bound on the triangle cull blocks, hit3.check_cull_tables); their
    leading C arguments (the dense rows, the dense and triangle
    layouts)."""
    tab, lights, layout = tables.tab, tables.lights, tables.layout
    P = tab.shape[0]
    require_cuda_tensor("table", tab, torch.float32, (P, ROW_COLS))
    require_cuda_tensor("lights", lights, torch.float32,
                        (max(scene.n_lights, 1), LIGHT_COLS))
    n_dense = layout[1]
    if max_dense is not None and n_dense > max_dense:
        raise ValueError(f"{what} kernel: {n_dense} sphere, plane and box "
                         f"rows exceed the shared-memory bound of "
                         f"{max_dense}")
    if scene.has_maps and tables.sbb is not None:
        raise ValueError("sphere cull blocks for a textured scene "
                         "(hit3.sph_table)")
    if tables.box is not None and not scene.has_maps:
        raise ValueError("box walk tables for a scene without textures "
                         "(hit3.box_culled)")
    hit3.check_cull_tables(layout, tables.tri, tables.tbb, tables.sbb,
                           max_tri_blocks)
    return [ptr(tab), n_dense,
            *hit3.table_args(layout, tables.tri, tables.tbb, tables.sbb),
            ptr(lights)]


def _tex_args(scene, tables):
    """Validate the texture tables of a launch; their C arguments (null
    pointers and an empty slot mask without textures: the kernels'
    untextured instances)."""
    if not scene.has_maps:
        return [None, None, None, 0]
    require_cuda_tensor("maps", tables.maps, torch.int32,
                        (tables.tab.shape[0], 6))
    require_cuda_tensor("atlas", tables.atlas, torch.float32,
                        (tables.atlas.shape[0], 3))
    require_cuda_tensor("tmeta", tables.tmeta, torch.int32,
                        (tables.tmeta.shape[0], 3))
    slots = sum(1 << s for s in range(6) if scene.map_slots[s])
    return [ptr(tables.maps), ptr(tables.atlas), ptr(tables.tmeta), slots]


def _fwd_args(scene, tables, decay, oT, dT, u8s, hit0):
    """Validate a forward launch's inputs; its leading C arguments
    (``hit0`` None: null pointers, for a segment that starts after step
    0)."""
    check_scene(scene)
    R = oT.shape[1]
    K = u8s.shape[0]
    require_cuda_tensor("oT", oT, torch.float32, (3, R))
    require_cuda_tensor("dT", dT, torch.float32, (3, R))
    require_cuda_tensor("u8s", u8s, torch.float32,
                        (K, n_uni(scene.any_refract), R))
    if hit0 is None:
        hit_ptrs = [None] * 4
    else:
        for name, t, dtype in zip(("te0", "row0", "tx0", "xrow0"), hit0,
                                  (torch.float32, torch.int32) * 2):
            require_cuda_tensor(name, t, dtype, (R,))
        hit_ptrs = [ptr(t) for t in hit0]
    return (_table_args(scene, tables, MAX_ROWS, "trace")
            + [scene.n_lights, float(decay), *_tex_args(scene, tables),
               ptr(oT), ptr(dT), *hit_ptrs, ptr(u8s), K, R,
               int(scene.any_refract)])


def primary_hits(scene, tables, oT, dT):
    """The primary-hit pass (:func:`hit3.closest_hit`, through
    :func:`hits`) of lane-major primaries, in :func:`primary_mode`: the
    trace kernels' ``hit0``."""
    return hits(tables, oT.T, dT.T, primary_mode(scene))


def _walk(tables):
    """The sphere walk tables ``(srows, ssb)`` of a culled sphere segment,
    or None."""
    return None if tables.sbb is None else (tables.srows, tables.ssb)


def _walk_args(tables):
    """The sphere and box walk tables' C arguments of a whole-trace launch
    (srows, ssb; the box walk's tables and boxes: nulls and 0 without)."""
    box = hit3.check_box_walk(tables.box, tables.layout)
    if tables.sbb is None:
        return [None, None, *box]
    return hit3.check_walk_tables(tables.srows, tables.ssb,
                                  tables.layout) + box


def _variant(tables):
    """The counted variant of a whole-trace launch (``CudaKernel.variants``):
    ``"box_walk"`` for the box walk's instances, else None."""
    return None if tables.box is None else "box_walk"


def _seg_args(seg, K, R, dev):
    """Validate a segment of the render instance; its C arguments (the
    step range, the carry in, the lanes' rays) and the carry out."""
    if seg is None:
        return [0, K, None, None], None
    if not 0 <= seg.k0 < seg.k1 <= K or (seg.c0 is None) != (seg.k0 == 0):
        raise ValueError(f"segment [{seg.k0}, {seg.k1}) of {K} steps with "
                         f"{'no ' if seg.c0 is None else ''}carry")
    c0 = rid = None
    if seg.c0 is not None:
        require_cuda_tensor("c0", seg.c0, torch.float32, (CARRY_ROWS, R))
        c0 = ptr(seg.c0)
    if seg.rid is not None:
        require_cuda_tensor("rid", seg.rid, torch.int32, (R,))
        rid = ptr(seg.rid)
    cout = torch.empty((CARRY_ROWS, R), dtype=torch.float32, device=dev)
    return [seg.k0, seg.k1, c0, rid], cout


def trace_fwd(scene, tables, decay, oT, dT, u8s, hit0, seg=None):
    """Launch ``mrt_trace_fwd`` (the render instance) on CUDA tensors.
    ``hit0`` is the primaries' ``(te, row, tx, xrow)`` from
    :func:`primary_hits` (None for a segment that starts after step 0).
    With a :class:`Segment` it runs its steps from its carry and returns
    its carry out too: ``(A, B, first_live, carry)``."""
    args = _fwd_args(scene, tables, decay, oT, dT, u8s, hit0)
    R = oT.shape[1]
    seg_args, cout = _seg_args(seg, u8s.shape[0], R, oT.device)
    A = torch.empty((3, R), dtype=torch.float32, device=oT.device)
    B = torch.empty_like(A)
    fl = torch.empty((1, R), dtype=torch.float32, device=oT.device)
    if R:
        nxt = None if seg is not None else _refill_counter(
            scene, tables, False, oT.device)
        KERNEL.launch(*args, *seg_args, ptr(A), ptr(B), ptr(fl),
                      None if cout is None else ptr(cout),
                      None if nxt is None else ptr(nxt),
                      *_walk_args(tables), stream_ptr(oT.device),
                      variant=_variant(tables))
    return (A, B, fl) if seg is None else (A, B, fl, cout)


def trace_fwd_train(scene, tables, decay, oT, dT, u8s, hit0):
    """Launch ``mrt_trace_fwd_train`` (the train instance) on CUDA tensors:
    :func:`trace_fwd`'s ``(A, B, first_live)`` bit for bit, plus the
    residuals ``(K, scene_res_rows(scene, layout), R)`` and live-step
    counts ``(R,)`` int32 that :func:`trace_bwd` reads."""
    args = _fwd_args(scene, tables, decay, oT, dT, u8s, hit0)
    R, K = oT.shape[1], u8s.shape[0]
    A = torch.empty((3, R), dtype=torch.float32, device=oT.device)
    B = torch.empty_like(A)
    fl = torch.empty((1, R), dtype=torch.float32, device=oT.device)
    resid = torch.empty((K, scene_res_rows(scene, tables.layout), R),
                        dtype=torch.float32, device=oT.device)
    n_live = torch.empty(R, dtype=torch.int32, device=oT.device)
    if R:
        nxt = _refill_counter(scene, tables, True, oT.device)
        TRAIN_KERNEL.launch(*args, ptr(A), ptr(B), ptr(fl), ptr(resid),
                            ptr(n_live), None if nxt is None else ptr(nxt),
                            *_walk_args(tables), stream_ptr(oT.device),
                            variant=_variant(tables))
    return A, B, fl, resid, n_live


def refills(scene, tables, train: bool) -> bool:
    """Whether a whole (unsegmented) trace launch refills its lanes
    (csrc/trace_fwd.cu): on dense-row scenes (no triangles, no textures)
    the render always, and training where the sphere segment has cull
    blocks (the Instance class: 37% faster on its frame; in the room,
    where rays live long, the refilled lanes' scattered residual stores
    made it 29% slower; tools/torch_compare_trees.py ablate); on a
    textured scene whose box segment is walked the render (its train
    instance saves both sides' texels at every hit, trace_ray's
    schedule)."""
    if tables.box is not None:
        return not train
    if tables.layout[2] or scene.has_maps:
        return False
    return not train or tables.sbb is not None


# the refill counters of each (device, stream): two int32, zeroed once;
# the kernel leaves them zeroed, and launches on one stream run in order
_COUNTERS = {}


def _counters(dev):
    """The two int32 counters of a refilling launch on the current stream
    of ``dev`` (the kernel leaves them zeroed for the next one)."""
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    nxt = _COUNTERS.get(key)
    if nxt is None:
        nxt = _COUNTERS[key] = torch.zeros(2, dtype=torch.int32, device=dev)
    return nxt


def _refill_counter(scene, tables, train, dev):
    """The counters from which a refilling launch's lanes take their next
    rays, or None (:func:`refills`)."""
    return _counters(dev) if refills(scene, tables, train) else None


def instance_resources(scene, tables, which: str) -> dict:
    """What the card gives the instance that a launch of ``which``
    (``"trace_fwd"``, ``"trace_fwd_train"``, ``"trace_bwd"``,
    ``"step_fwd"``, ``"step_fwd_train"`` or ``"step_bwd"``) on these
    tables runs: registers and spilled bytes (stores + loads) per thread
    from ``nvcc``'s log, and resident warps per SM
    (:func:`resident_warps`). Builds the kernel if needed."""
    t = hit3.table_args(tables.layout, tables.tri, tables.tbb, tables.sbb)
    tri, tex = t[8] > 0, bool(scene.has_maps)
    refract = scene.any_refract
    if which == "trace_bwd":
        kernel, name, flags = BWD_KERNEL, "trace_bwd", (refract, tri, tex)
    elif which == "step_bwd":
        kernel, name, flags = STEP_BWD_KERNEL, "step_bwd", (
            refract, tri, tex, scene.n_lights > STEP_MAX_LIGHTS)
    elif which.startswith("step_fwd"):
        train = which == "step_fwd_train"
        many = scene.n_lights > STEP_MAX_LIGHTS
        kernel = _step_kernels(scene)[1 if train else 0]
        if tri_split(tables.layout[2]):
            name, flags = "step_fwd_in", (refract, train, tex, many)
        else:
            # kCull: a culled sphere segment (its walk tables)
            name, flags = "step_fwd", (refract, train, tri, tex,
                                       not tri and not tex and t[12] > 0,
                                       many)
    else:
        train = which == "trace_fwd_train"
        refill = refills(scene, tables, train)
        kernel = KERNEL if which == "trace_fwd" else TRAIN_KERNEL
        # the walk of a culled sphere segment, of a box segment (their own
        # instances)
        walk = not tri and not tex and t[12] > 0
        name, flags = "trace_fwd", (refract, train, False, tri, tex, refill,
                                    walk, tables.box is not None)
    kernel.fn()
    key = (f"{name}_kernelI"
           + "".join(f"Lb{int(bool(f))}E" for f in flags) + "E")
    found = [v for k, v in ptxas_table(kernel.build_log).items() if key in k]
    regs, st, ld = found[0] if found else (None, None, None)
    return {"registers": regs,
            "spill_bytes": None if st is None else st + ld,
            "warps_per_sm": resident_warps(scene, tables, which)}


def resident_warps(scene, tables, which: str) -> int:
    """Warps per SM that the card keeps resident of the instance a launch
    of ``which`` (as :func:`instance_resources`) on these tables takes
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    t = hit3.table_args(tables.layout, tables.tri, tables.tbb, tables.sbb)
    slots = _tex_args(scene, tables)[3]
    refract = int(scene.any_refract)
    L = scene.n_lights
    warps = ctypes.c_int(0)
    if which == "trace_bwd":
        rc = BWD_OCCUPANCY.fn()(t[7], L, refract, int(t[8] > 0),
                                int(slots > 0), ctypes.byref(warps))
    elif which == "step_bwd":
        n_dense = tables.layout[1]
        rc = STEP_BWD_OCCUPANCY.fn()(
            n_dense, L, int(_step_shared_rows(n_dense, L)), refract,
            int(t[8] > 0), int(slots > 0), ctypes.byref(warps))
    elif which.startswith("step_fwd"):
        # sph_n, pln_n, box_n, tri_n, n_cb, n_sb
        rc = _step_kernels(scene)[2].fn()(t[1], t[3], t[5], t[8], t[10], t[12], L,
                                 slots, refract,
                                 int(which == "step_fwd_train"),
                                 int(tri_split(tables.layout[2])),
                                 ctypes.byref(warps))
    else:
        # P, the six dense ints, tri_start, tri_n, n_cb, n_sb
        train = which == "trace_fwd_train"
        rc = FWD_OCCUPANCY.fn()(t[7], *t[:6], t[7], t[8], t[10], t[12],
                                L, slots, refract, int(train),
                                int(refills(scene, tables, train)),
                                0 if tables.box is None else tables.box.n,
                                ctypes.byref(warps))
    if rc:
        raise RuntimeError(f"occupancy of {which}: CUDA error {rc}")
    return warps.value


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
                        (K, scene_res_rows(scene, tables.layout), R))
    require_cuda_tensor("n_live", n_live, torch.int32, (R,))
    require_cuda_tensor("ctA", ctA, torch.float32, (3, R))
    require_cuda_tensor("ctB", ctB, torch.float32, (3, R))
    args = _table_args(scene, tables, BWD_MAX_ROWS, "trace_bwd")
    tab, lights, layout = tables.tab, tables.lights, tables.layout
    dev = tab.device
    d_tab = torch.zeros((tab.shape[0], ROW_COLS), dtype=torch.float32,
                        device=dev)
    d_lights = torch.zeros_like(lights)
    # every ray's d_o and d_d are written
    d_oT = torch.empty((3, R), dtype=torch.float32, device=dev)
    d_dT = torch.empty_like(d_oT)
    d_tri4 = torch.zeros((layout[2], 4), dtype=torch.float32, device=dev)
    if R:
        # the float64 sums of the dense rows and the lights
        acc = torch.zeros(layout[1] * ROW_COLS + L * LIGHT_COLS,
                          dtype=torch.float64, device=dev)
        BWD_KERNEL.launch(
            *args, L, float(decay), *_tex_args(scene, tables), ptr(resid),
            ptr(n_live), ptr(u8s), R, int(scene.any_refract), ptr(ctA),
            ptr(ctB), ptr(d_oT), ptr(d_dT), ptr(acc), ptr(d_tab),
            ptr(d_lights), ptr(d_tri4) if layout[2] else None,
            stream_ptr(dev))
    d_tri = torch.zeros((layout[2], hit3.TRI_COLS), dtype=torch.float32,
                        device=dev)
    d_tri[:, 6:9] = d_tri4[:, :3]
    d_tri[:, hit3._T_H + 2] = d_tri4[:, 3]
    return d_tab, d_lights, d_oT, d_dT, d_tri


# --- the per-step path: kernel wrappers -------------------------------------

def _sph_walk_args(tables):
    """The sphere walk tables' C arguments of a forward step launch (two
    nulls without sphere cull blocks)."""
    if tables.sbb is None:
        return [None, None]
    for name in ("srows", "ssb"):
        t = getattr(tables, name)
        require_cuda_tensor(name, t, torch.float32, (t.shape[0], 16 if name
                                                     == "srows" else 8))
        if t.data_ptr() % 16:
            raise ValueError(f"step kernel: {name} is not 16-byte aligned")
    return [ptr(tables.srows), ptr(tables.ssb)]


def _step_args(scene, tables, decay, c0, u8):
    """Validate a per-step launch's inputs; its leading C arguments (the
    tables, then the carry ``c0``, the uniforms ``u8``, R and refract for
    the forward; the backward takes the tables' and adds its own)."""
    L = scene.n_lights
    R = c0.shape[1]
    require_cuda_tensor("c0", c0, torch.float32, (CARRY_ROWS, R))
    require_cuda_tensor("u8", u8, torch.float32,
                        (n_uni(scene.any_refract), R))
    tab_args = (_table_args(scene, tables, None, "step", None)
                + [L, float(decay), *_tex_args(scene, tables)])
    return tab_args, [ptr(c0), ptr(u8), R, int(scene.any_refract)]


def _tri_in_args(scene, tables, c0):
    """The kTriIn arguments of a step launch: on a scene past the staged
    cull blocks the triangle segment's hits, launched here
    (:func:`tri_hits`; te, row, tx, xrow, the last two null on an opaque
    scene), and its superblocks ``tables.tsb`` and their count, else four
    nulls, a null and 0; and the tensors that must outlive the launch."""
    with torch.no_grad():
        thit = tri_hits(scene, tables, c0) if c0.shape[1] else None
    if thit is None:
        return [None] * 5 + [0], ()
    tsb = tables.tsb
    require_cuda_tensor("tsb", tsb, torch.float32, (tsb.shape[0], 8))
    if tsb.data_ptr() % 16:
        raise ValueError("step kernel: tsb is not 16-byte aligned")
    return ([ptr(t) for t in thit] + [None] * (4 - len(thit))
            + [ptr(tsb), tsb.shape[0]], thit)


def _step_kernels(scene):
    """The step forward's render, train and occupancy entry points for
    the scene: those of ``csrc/step_fwd_many.cu`` past STEP_MAX_LIGHTS
    lights, else ``csrc/step_fwd.cu``'s."""
    if scene.n_lights > STEP_MAX_LIGHTS:
        return STEP_MANY_KERNEL, STEP_MANY_TRAIN_KERNEL, STEP_MANY_OCCUPANCY
    return STEP_KERNEL, STEP_TRAIN_KERNEL, STEP_OCCUPANCY


def step_fwd(scene, tables, decay, c0, u8):
    """Launch ``mrt_step_fwd`` (the render instance) on CUDA tensors: one
    bounce step from the carry ``c0``; returns :func:`step_plain`'s
    ``(c1, hit)``. On a scene past the staged cull blocks the triangle
    segment's hits (:func:`tri_hits` of ``c0``) are launched first."""
    tab_args, ray_args = _step_args(scene, tables, decay, c0, u8)
    R = c0.shape[1]
    c1 = torch.empty_like(c0)
    hit = torch.empty((1, R), dtype=torch.float32, device=c0.device)
    tin, _keep = _tri_in_args(scene, tables, c0)
    if R:
        _step_kernels(scene)[0].launch(
            *tab_args, *ray_args, ptr(c1), ptr(hit), *tin,
            *_sph_walk_args(tables), ptr(_counters(c0.device)),
            stream_ptr(c0.device))
    return c1, hit


def step_fwd_train(scene, tables, decay, c0, u8):
    """Launch ``mrt_step_fwd_train`` (the train instance) on CUDA tensors:
    :func:`step_fwd`'s ``(c1, hit)`` bit for bit, plus the step's residuals
    ``(scene_res_rows, R)`` of the rays that hit (the rest unwritten)."""
    tab_args, ray_args = _step_args(scene, tables, decay, c0, u8)
    R = c0.shape[1]
    c1 = torch.empty_like(c0)
    hit = torch.empty((1, R), dtype=torch.float32, device=c0.device)
    resid = torch.empty((scene_res_rows(scene, tables.layout), R),
                        dtype=torch.float32, device=c0.device)
    tin, _keep = _tri_in_args(scene, tables, c0)
    if R:
        _step_kernels(scene)[1].launch(
            *tab_args, *ray_args, ptr(c1), ptr(hit), ptr(resid), *tin,
            *_sph_walk_args(tables), ptr(_counters(c0.device)),
            stream_ptr(c0.device))
    return c1, hit, resid


def _step_shared_rows(n_dense: int, L: int) -> bool:
    """Whether the per-step backward sums the dense rows per block in
    shared memory (float64, beside its warps' light slots)."""
    return (n_dense * ROW_COLS + _STEP_BWD_WARPS * L * LIGHT_COLS) * 8 \
        <= _STEP_SHARED_BYTES


def step_bwd(scene, tables, decay, c0, u8, resid, hit, ct1):
    """Launch ``mrt_step_bwd`` on CUDA tensors: for the cotangent ``ct1``
    ``(CARRY_ROWS, R)`` of a step's output carry, whose train instance
    (:func:`step_fwd_train`) wrote ``resid`` and ``hit`` from the carry
    ``c0``, the cotangents of the row table ``(P, 26)``, the light table,
    the input carry ``(CARRY_ROWS, R)`` (o, d, pwr, A, B; the live row 0)
    and the triangle table ``(Pt, 16)`` (its ``G[2]`` and ``h[2]``
    columns). The table cotangents vary from run to run at float32
    rounding level (float64 sums rounded once; csrc/step_bwd.cu)."""
    L = scene.n_lights
    R = c0.shape[1]
    for name, t, shape in (
            ("resid", resid, (scene_res_rows(scene, tables.layout), R)),
            ("hit", hit, (1, R)), ("ct1", ct1, (CARRY_ROWS, R))):
        require_cuda_tensor(name, t, torch.float32, shape)
    tab_args, _ray_args = _step_args(scene, tables, decay, c0, u8)
    tab, lights, layout = tables.tab, tables.lights, tables.layout
    dev = tab.device
    n_dense = layout[1]
    shared = _step_shared_rows(n_dense, L)
    d_tab = torch.zeros((tab.shape[0], ROW_COLS), dtype=torch.float32,
                        device=dev)
    d_lights = torch.zeros_like(lights)
    ct0 = torch.empty_like(c0)
    d_tri4 = torch.zeros((layout[2], 4), dtype=torch.float32, device=dev)
    if R:
        # the float64 sums of the dense rows and the lights
        acc = torch.zeros(n_dense * ROW_COLS + L * LIGHT_COLS,
                          dtype=torch.float64, device=dev)
        STEP_BWD_KERNEL.launch(
            *tab_args, ptr(resid), ptr(hit), ptr(c0), ptr(u8), R,
            int(scene.any_refract), ptr(ct1), ptr(ct0), int(shared),
            ptr(acc), ptr(d_tab), ptr(d_lights),
            ptr(d_tri4) if layout[2] else None, stream_ptr(dev))
    d_tri = torch.zeros((layout[2], hit3.TRI_COLS), dtype=torch.float32,
                        device=dev)
    d_tri[:, 6:9] = d_tri4[:, :3]
    d_tri[:, hit3._T_H + 2] = d_tri4[:, 3]
    return d_tab, d_lights, ct0, d_tri


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
        ctx.tables = tables._replace(frames=None, tab=None, lights=None,
                                     tri=None, hit=None)
        ctx.mark_non_differentiable(fl)
        return A, B, fl

    @staticmethod
    def backward(ctx, ctA, ctB, _ct_fl):
        tab, lights, tri, u8s, resid, n_live = ctx.saved_tensors
        R = u8s.shape[2]
        zero = torch.zeros((3, R), dtype=torch.float32, device=tab.device)
        ctA = zero if ctA is None else ctA.contiguous()
        ctB = zero if ctB is None else ctB.contiguous()
        tables = ctx.tables._replace(tab=tab, lights=lights, tri=tri)
        d_tab, d_lights, d_oT, d_dT, d_tri = trace_bwd(
            ctx.scene, tables, ctx.decay, u8s, resid, n_live, ctA, ctB)
        return d_tab, d_lights, d_tri, d_oT, d_dT, None, None, None, None


class StepFunction(torch.autograd.Function):
    """One bounce step on CUDA tensors under autograd: forward through the
    train instance of the step kernel, backward through the step's
    backward kernel. Differentiable inputs: the row table, the light
    table, the triangle table and the carry ``c0``; ``hit`` has no
    gradient, and ``decay`` is a constant."""

    @staticmethod
    def forward(ctx, tab, lights, tri, c0, scene, tables, decay, u8):
        tables = tables._replace(tab=tab, lights=lights, tri=tri)
        c1, hit, resid = step_fwd_train(scene, tables, decay, c0, u8)
        ctx.save_for_backward(tab, lights, tri, c0, u8, resid, hit)
        ctx.scene, ctx.decay = scene, decay
        ctx.tables = tables._replace(frames=None, tab=None, lights=None,
                                     tri=None, hit=None)
        ctx.mark_non_differentiable(hit)
        return c1, hit

    @staticmethod
    def backward(ctx, ct1, _ct_hit):
        tab, lights, tri, c0, u8, resid, hit = ctx.saved_tensors
        ct1 = torch.zeros_like(c0) if ct1 is None else ct1.contiguous()
        tables = ctx.tables._replace(tab=tab, lights=lights, tri=tri)
        d_tab, d_lights, d_c0, d_tri = step_bwd(
            ctx.scene, tables, ctx.decay, c0, u8, resid, hit, ct1)
        return d_tab, d_lights, d_tri, d_c0, None, None, None, None


def _steps(scene, tables, decay, c, u8s, k0, k1, rid=None, grad=False):
    """Steps ``[k0, k1)`` of the per-step path from the carry ``c``, lane i
    reading the uniform column of ray ``rid[i]`` (None: ray i): the plain
    step on the CPU, on the card the step kernel's render instance, or
    with ``grad`` :class:`StepFunction`. Returns the carry and step 0's hit
    liveness (zeros unless ``k0`` is 0)."""
    fl = torch.zeros((1, c.shape[1]), dtype=c.dtype, device=c.device)
    for k in range(k0, k1):
        u8 = u8s[k] if rid is None else u8s[k][:, rid.long()].contiguous()
        if c.device.type == "cpu":
            c, hit = step_plain(scene, tables, decay, c, u8)
        elif grad:
            c, hit = StepFunction.apply(tables.tab, tables.lights, tables.tri,
                                        c, scene, tables, decay, u8)
        else:
            c, hit = step_fwd(scene, tables, decay, c, u8)
        if k == 0:
            fl = hit
    return c, fl


def trace_steps(scene, tables, decay, oT, dT, u8s):
    """The per-step path: the whole trace of :func:`trace_packed` as one
    bounce step per launch, the carry ``(CARRY_ROWS, R)`` in device memory
    between them (the JAX package's ``stepk`` scan, models/tracer.py:564-
    597): from :func:`primary_carry`, step k reads row k of ``u8s``, so a
    ray's uniforms are the whole trace's. Returns ``(A, B, first_live)``,
    first_live from step 0. CPU tensors run :func:`step_plain` (autograd
    differentiates it), CUDA tensors the step kernel, or under a gradient
    :class:`StepFunction`. Its radiance is the whole trace's bit for
    bit."""
    diff_in = (tables.tab, tables.lights, tables.tri, oT, dT)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in diff_in)
    c, fl = _steps(scene, tables, decay, primary_carry(oT, dT), u8s, 0,
                   u8s.shape[0], grad=grad)
    return c[8:11], c[11:14], fl


def trace_segment(scene, tables, decay, oT, dT, u8s, seg):
    """The steps of :class:`Segment` ``seg`` of a render (no gradient):
    ``(A, B, first_live, carry)`` in lane order. CUDA tensors run the
    primary-hit kernel (a segment from step 0) and the render instance of
    the trace kernel, CPU tensors :func:`trace_plain`; a scene that
    :func:`route` sends to the per-step path runs its steps there."""
    if route(scene, False) == "steps":
        c = primary_carry(oT, dT) if seg.c0 is None else seg.c0
        c, fl = _steps(scene, tables, decay, c, u8s, seg.k0, seg.k1,
                       seg.rid)
        return c[8:11], c[11:14], fl, c
    if oT.device.type == "cpu":
        return trace_plain(scene, tables, decay, oT, dT, u8s, seg=seg)
    hit0 = primary_hits(scene, tables, oT, dT) if seg.k0 == 0 else None
    return trace_fwd(scene, tables, decay, oT, dT, u8s, hit0, seg)


def trace_packed(scene, tables, decay, oT, dT, u8s):
    """Whole trace on lane-major primaries (see the module docstring for
    which path each input takes)."""
    diff_in = (tables.tab, tables.lights, tables.tri, oT, dT)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in diff_in)
    if route(scene, grad) == "steps":
        return trace_steps(scene, tables, decay, oT, dT, u8s)
    if oT.device.type == "cpu":
        return trace_plain(scene, tables, decay, oT, dT, u8s)
    if grad:
        return TraceFunction.apply(tables.tab, tables.lights, tables.tri,
                                   oT, dT, scene, tables, decay, u8s)
    hit0 = primary_hits(scene, tables, oT, dT)
    return trace_fwd(scene, tables, decay, oT, dT, u8s, hit0)
