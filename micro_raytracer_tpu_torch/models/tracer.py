"""Path tracer: the bounce loop with the shading fold composed forward.

The counterpart of ``micro_raytracer_tpu.models.tracer`` for rendering.
``reduce_light`` (rt.rs:956-994) is an affine recurrence in the radiance,
``col_i = a_i * col_{i+1} + b_i`` with

  a_i = [live] * [not emit] * pwr_i * (0.5 + color_i)
  b_i = [live] * where(emit, color_i, pwr_i * l_col_i)

(dead rays pass through: a = 1, b = 0), so the trace carries ``(A, B)``
with ``col = A * col_tail + B`` and updates ``B += A*b; A *= a`` per
bounce. :func:`trace_fused` runs the whole trace through
:func:`step.trace_packed`: the CUDA kernels for CUDA tensors, the plain
trace (the kernels' arithmetic in PyTorch, which the tests hold against
the JAX package) for CPU tensors.

A render (no gradient) of a scene with a long sphere segment or a
refractive one with triangles runs in segments with live-first compaction
between them (:func:`compact_cuts`, :func:`compact_perm`), the JAX
package's ``trace_segment`` path; its radiance is the unsegmented trace's
bit for bit.

Every random draw is an input: :func:`trace_radiance_u` takes the aperture
uniforms and the packed per-step uniforms, and :func:`trace_radiance` draws
them from a ``torch.Generator`` and calls it.

The radiance is differentiable in the scene leaves: through the tables
:func:`step.pack_step` builds (rebuilt on every call unless the caller
passes them, as the renderer does once per frame), the whole trace
(:func:`step.trace_packed` — autograd through the plain trace on the CPU,
the backward kernel on the card), and the sky fold ``B + A*sky`` with the
``first_live`` select, as in the JAX package's ``trace_fused``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import hit3, rng, step
from . import camera as camera_mod
from . import schema
from .compiler import CameraArrays, SceneArrays


def decay_of(loss) -> float:
    """Per-bounce power decay ``1 - min(loss, 1)`` in float32 arithmetic."""
    loss = np.float32(loss)
    return float(np.float32(1.0) - np.minimum(loss, np.float32(1.0)))


def jax_cuts(scene: SceneArrays, steps: int):
    """The steps at which the JAX package's render packs its live lanes
    first (tracer._compact_cuts): ``[3, 6]`` on a scene with a triangle
    segment, ``[2, 4, 6]`` on one whose sphere segment gets cull blocks
    and has no triangles, none otherwise; cuts inside ``(0, steps)``.
    Sweeps are the expensive part there, and the scenes are open: lanes
    die to the sky, and a warp whose lanes are mostly dead costs as much
    as a full one. The sphere rule needs the port's cull too
    (:func:`hit3.sph_culled`): a textured sphere grid, which the JAX
    package culls and the port sweeps dense, stays whole."""
    layout = hit3.seg_layout(scene.kind_counts, scene.kind_sweep)
    if layout[2]:
        cuts = [3, 6]
    elif hit3.sph_culled(scene, layout):
        cuts = [2, 4, 6]
    else:
        return []
    return [c for c in cuts if 0 < c < steps]


def compact_cuts(scene: SceneArrays, steps: int, inference: bool):
    """The cuts of a render: :func:`jax_cuts`, except on an opaque scene
    with triangles, and none for a trace that needs a gradient. On the
    H100 the CLI renders the sphere-grid class 39% faster compacted and a
    refractive mesh (its exit passes sweep every triangle row) 4% faster,
    but an opaque mesh, whose culled sweeps are short and whose room keeps
    its lanes alive, 7% slower (PERF.md, ``chip_smoke.py
    --compaction``)."""
    if not inference or (scene.kind_counts[schema.KIND_TRIANGLE]
                         and not scene.any_refract):
        return []
    return jax_cuts(scene, steps)


def compact_perm(live):
    """Stable live-first partition of the ``(R,)`` bool ``live``: ``perm``
    (int64) with ``perm[slot] = lane``, live lanes first in their order,
    then the dead ones. A prefix sum and one scatter (no sort, and no
    host sync)."""
    R = live.shape[0]
    li = live.to(torch.int64)
    rank = torch.cumsum(li, 0) - li           # live lanes before each lane
    lanes = torch.arange(R, device=live.device)
    n_live = rank[-1:] + li[-1:]
    pos = torch.where(live, rank, n_live + lanes - rank)
    return torch.empty_like(lanes).scatter_(0, pos, lanes)


def _trace_compacted(scene, tables, decay, oT, dT, u8s, cuts):
    """The whole trace in segments split at ``cuts``, live lanes packed
    first between segments: the carry and the lanes' ray ids ride one
    permutation, and each lane reads its ray's uniform column, so every
    ray's trace is the unsegmented one. Returns ``(A, B, first_live)`` in
    ray order."""
    steps = u8s.shape[0]
    bounds = [0] + list(cuts) + [steps]
    carry = rid = fl = None
    for k0, k1 in zip(bounds[:-1], bounds[1:]):
        A_T, B_T, fl_s, carry = step.trace_segment(
            scene, tables, decay, oT, dT, u8s,
            step.Segment(k0, k1, carry, rid))
        if k0 == 0:
            fl = fl_s             # the first segment runs in ray order
        if k1 < steps:
            perm = compact_perm(carry[step.C_LIVE] > 0.5)
            carry = carry[:, perm]
            rid = (perm if rid is None else rid[perm]).to(torch.int32)
    if rid is None:
        return A_T, B_T, fl
    ray = rid.long()
    return (torch.empty_like(A_T).index_copy_(1, ray, A_T),
            torch.empty_like(B_T).index_copy_(1, ray, B_T), fl)


def trace_fused(scene: SceneArrays, tables, bounce: int, orig, dirs, loss,
                u8s, cuts=None):
    """Radiance ``(R, 3)`` of primaries ``orig``/``dirs`` ``(R, 3)`` through
    ``bounce + 1`` steps with packed uniforms ``u8s`` ``(bounce+1, NU, R)``,
    given the scene's :class:`step.TraceTables`. CUDA tensors run the
    kernels; CPU tensors the plain loop. ``cuts``: the steps at which a
    render compacts its live lanes (None: :func:`compact_cuts`; a trace
    that needs a gradient takes none)."""
    if u8s.shape[0] != bounce + 1:
        raise ValueError(f"u8s holds {u8s.shape[0]} steps, bounce {bounce} "
                         f"needs {bounce + 1}")
    diff_in = (tables.tab, tables.lights, tables.tri, orig, dirs)
    inference = not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in diff_in))
    if cuts is None:
        cuts = compact_cuts(scene, bounce + 1, inference)
    elif cuts and not inference:
        raise ValueError("a trace that needs a gradient does not compact")
    elif list(cuts) != sorted(set(cuts)) or not all(
            0 < c <= bounce for c in cuts):
        raise ValueError(f"cuts {cuts}: ascending steps inside (0, "
                         f"{bounce + 1})")
    oT, dT = orig.T.contiguous(), dirs.T.contiguous()
    if cuts:
        with torch.no_grad():
            A_T, B_T, flT = _trace_compacted(scene, tables, decay_of(loss),
                                             oT, dT, u8s, cuts)
    else:
        A_T, B_T, flT = step.trace_packed(scene, tables, decay_of(loss), oT,
                                          dT, u8s)
    A, B = A_T.T, B_T.T
    first_live = flT[0] > 0.5
    col = B + A * (scene.sky_color * scene.sky_pwr)
    # empty path -> bare sky color, *without* pwr (rt.rs:957-959)
    return torch.where(first_live[:, None], col,
                       torch.broadcast_to(scene.sky_color, col.shape))


def trace_radiance_u(scene: SceneArrays, cam: CameraArrays, render_wh,
                     bounce: int, loss, coords, u_aprt, u8s, tables=None):
    """Per-pixel radiance from explicit uniforms: camera rays (``u_aprt``
    (R,2)) -> whole trace (``u8s`` (bounce+1, NU, R)). ``tables`` is the
    scene's :func:`step.pack_step`, built here when not given."""
    orig, dirs = camera_mod.gen_rays(cam, render_wh, coords, u_aprt)
    if tables is None:
        tables = step.pack_step(scene)
    return trace_fused(scene, tables, bounce, orig, dirs, loss, u8s)


def draw_uniforms(gen, n_rays: int, bounce: int, any_refract: bool, device):
    """``(u_aprt (R,2), u8s (bounce+1, NU, R))`` from ``gen``."""
    u_aprt = rng.uniform(gen, (n_rays, 2), device)
    u8s = rng.uniform(gen, (bounce + 1, step.n_uni(any_refract), n_rays),
                      device)
    return u_aprt, u8s


def trace_radiance(scene: SceneArrays, cam: CameraArrays, render_wh,
                   bounce: int, loss, coords, gen, tables=None):
    """Per-pixel radiance, one path per coordinate, uniforms from ``gen``
    (``tables`` as in :func:`trace_radiance_u`)."""
    u_aprt, u8s = draw_uniforms(gen, coords.shape[0], bounce,
                                scene.any_refract, coords.device)
    return trace_radiance_u(scene, cam, render_wh, bounce, loss, coords,
                            u_aprt, u8s, tables)
