"""Whole-trace forward: the hand-written CUDA kernel ``csrc/trace_fwd.cu``,
its wrapper, and its plain PyTorch version.

The counterpart of ``micro_raytracer_tpu.ops.pallas_step`` for rendering
(no residuals, no backward) scenes of spheres, planes and boxes with at
most 4 lights and no textures. :func:`pack_step` builds the kernel's
tables once per scene (:class:`TraceTables`): a ``(P, 26)`` row table —
the 18 sweep columns of :func:`hit3.pack_scene`, whose ``fr, ipos, pa,
pr`` are pallas_step's attribute columns ``_C_FR.._C_PR``, then
``_C_ALB.._C_EMI`` — and the ``(L, 11)`` light table whose directional
entries hold ``-normalize(light_dir)``.

:func:`trace_packed` runs all ``bounce + 1`` steps on lane-major primaries
``oT``/``dT`` ``(3, R)`` with uniforms ``u8s`` ``(K, NU, R)`` — ``NU = 8``
rows ``[u0..u6, u_emit]`` when the scene refracts, else 4 rows ``[u0, u1,
u2, u_emit]`` — and returns ``A, B`` ``(3, R)`` and the first-bounce hit
liveness ``(1, R)``. CUDA tensors launch the primary-hit kernel
(:func:`hit3.closest_hit`) and then the trace kernel, which starts from
those hits; CPU tensors run :func:`trace_plain`, a loop of the port's
``fused_step_reference``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..utils.kernels import (CudaKernel, ptr, require_cuda_tensor,
                             stream_ptr)
from . import hit3, intersect, linalg

# attribute columns of the row table after the sweep columns
# (pallas_step._C_ALB.._C_EMI)
_C_ALB, _C_RGH, _C_MET, _C_GLS, _C_OPA, _C_EMI = 18, 21, 22, 23, 24, 25
ROW_COLS = 26
LIGHT_COLS = 11
MAX_LIGHTS = 4
# shared-memory bound of the kernel: 2048 rows * 104 B + lights = 208 KB
MAX_ROWS = 2048

_c_int, _c_ptr = ctypes.c_int, ctypes.c_void_p
KERNEL = CudaKernel(
    "trace_fwd", "trace_fwd.cu", ("hit3.cuh",), "mrt_trace_fwd",
    [_c_ptr, _c_int] + [_c_int] * 6
    + [_c_ptr, _c_int, ctypes.c_float] + [_c_ptr] * 7 + [_c_int] * 3
    + [_c_ptr] * 4)


class TraceTables(NamedTuple):
    """What a trace needs of a scene, built once by :func:`pack_step`."""

    frames: torch.Tensor     # (P, 3, 3) instance matrices
    tab: torch.Tensor        # (P, ROW_COLS) row table
    lights: torch.Tensor     # (max(L, 1), LIGHT_COLS) light table
    layout: tuple            # hit3.seg_layout of the kind segments


def n_uni(need_exit: bool) -> int:
    """Uniform rows per step: opaque scenes never read the exit-side draws
    u3..u6, so only [u0, u1, u2, u_emit] are packed."""
    return 8 if need_exit else 4


def check_scene(scene) -> None:
    """Reject a scene the kernel does not cover (never another path)."""
    intersect.check_scene_class(scene)
    if scene.n_lights > MAX_LIGHTS:
        raise ValueError(f"trace kernel: {scene.n_lights} lights exceed "
                         f"its bound of {MAX_LIGHTS}")


def pack_step(scene) -> TraceTables:
    """The scene's frames, row table and light table (any device)."""
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
    return TraceTables(frames, tab, lights,
                       hit3.seg_layout(scene.kind_counts))


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


def trace_plain(scene, tables, decay, oT, dT, u8s):
    """Plain PyTorch whole trace: ``bounce + 1`` steps of
    :func:`micro_raytracer_tpu_torch.models.tracer.fused_step_reference`
    (any device). Returns ``(A (3,R), B (3,R), first_live (1,R))``."""
    from ..models import tracer

    KERNEL.plain_calls += 1
    frames = tables.frames
    attrs = intersect.prim_attributes(scene, frames)
    R = oT.shape[1]
    ray = (oT.T, dT.T, torch.ones(R, dtype=oT.dtype, device=oT.device),
           torch.ones(R, dtype=torch.bool, device=oT.device))
    A = torch.ones((R, 3), dtype=oT.dtype, device=oT.device)
    B = torch.zeros((R, 3), dtype=oT.dtype, device=oT.device)
    first = None
    for k in range(u8s.shape[0]):
        u, u_emit = unpack_uniforms(u8s[k], scene.any_refract)
        ray, A, B, live = tracer.fused_step_reference(
            scene, frames, attrs, decay, ray, A, B, u, u_emit)
        if k == 0:
            first = live
    return (A.T.contiguous(), B.T.contiguous(),
            first.to(oT.dtype)[None])


def trace_fwd(scene, tables, decay, oT, dT, u8s, hit0):
    """Launch ``mrt_trace_fwd`` on CUDA tensors (the kernel wrapper).
    ``hit0`` is the primaries' ``(te, row, tx, xrow)`` from
    :func:`hit3.closest_hit` in :func:`primary_mode`."""
    check_scene(scene)
    R = oT.shape[1]
    K = u8s.shape[0]
    NU = n_uni(scene.any_refract)
    require_cuda_tensor("oT", oT, torch.float32, (3, R))
    require_cuda_tensor("dT", dT, torch.float32, (3, R))
    require_cuda_tensor("u8s", u8s, torch.float32, (K, NU, R))
    for name, t, dtype in zip(("te0", "row0", "tx0", "xrow0"), hit0,
                              (torch.float32, torch.int32) * 2):
        require_cuda_tensor(name, t, dtype, (R,))
    tab, lights = tables.tab, tables.lights
    P = tab.shape[0]
    require_cuda_tensor("table", tab, torch.float32, (P, ROW_COLS))
    require_cuda_tensor("lights", lights, torch.float32,
                        (max(scene.n_lights, 1), LIGHT_COLS))
    if P > MAX_ROWS:
        raise ValueError(f"trace kernel: {P} rows exceed the shared-memory "
                         f"bound of {MAX_ROWS}")
    A = torch.empty((3, R), dtype=torch.float32, device=oT.device)
    B = torch.empty_like(A)
    fl = torch.empty((1, R), dtype=torch.float32, device=oT.device)
    if R:
        KERNEL.launch(ptr(tab), P, *hit3.layout_ints(tables.layout),
                      ptr(lights), scene.n_lights, float(decay), ptr(oT),
                      ptr(dT), *(ptr(t) for t in hit0), ptr(u8s), K, R,
                      int(scene.any_refract), ptr(A), ptr(B), ptr(fl),
                      stream_ptr(oT.device))
    return A, B, fl


def trace_packed(scene, tables, decay, oT, dT, u8s):
    """Whole trace on lane-major primaries: the primary-hit kernel and the
    trace kernel for CUDA tensors, :func:`trace_plain` for CPU tensors."""
    if oT.device.type == "cpu":
        return trace_plain(scene, tables, decay, oT, dT, u8s)
    hit0 = hit3.closest_hit(tables.tab, tables.layout, oT.T, dT.T,
                            primary_mode(scene))
    return trace_fwd(scene, tables, decay, oT, dT, u8s, hit0)
