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
the JAX package) for CPU tensors; a scene past the whole-trace kernels'
bounds (more than 4 lights, or more dense rows than they stage) takes
the per-step path there (``step.route``, ``step.trace_steps``).

A render (no gradient) of a refractive scene with a long sphere segment
or with triangles runs in segments with live-first compaction between
them (:func:`compact_cuts`, :func:`compact_perm`), the JAX
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

import os

import numpy as np
import torch
import torch.utils.checkpoint

from ..ops import hit3, rng, step
from ..ops.linalg import EPS
from . import camera as camera_mod
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
    """The cuts of a render: :func:`jax_cuts` on a refractive scene, and
    none on an opaque one, for a trace that needs a gradient or for one
    that takes the per-step path (``step.route``; the JAX package's
    per-step scan does not compact either). On the H100 the CLI renders
    the refractive classes 3% faster compacted (``inst_glass``,
    ``mesh_glass``), and the opaque ones 7-10% faster whole
    (``mesh_opaque``, and ``inst_grid``, whose whole render refills its
    lanes; PERF.md, ``chip_smoke.py --compaction``)."""
    if not inference or not scene.any_refract \
            or step.route(scene, False) == "steps":
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


# --- the record path: trace_records, then shade_records ---------------------

# the shadow rays one occlusion query takes at most: past it the query runs
# by groups of lights (2,051 lights on a frame would be 2.4e9 rays)
ANY_HIT_RAYS = 1 << 24


def _light_dirs_to(tables, lights, point):
    """Un-normalized vectors ``(R, n, 3)`` toward the lights ``lights`` (a
    range of light rows) from ``point`` ``(R, 3)`` (rt.rs:975-978; a
    directional light's is its stored ``-normalize(dir)``)."""
    return torch.stack([step._light_vec(tables.lights[li], point)
                        for li in lights], 1)


def _shadows(scene, tables, entry_p, live_i):
    """``(R, L)`` bool: light li is visible from the entry point (no
    gradient). The shadow rays go to the closest hit's any-hit mode on the
    fused path's tables, walks included (``step.hits``), by groups of
    lights of at most :data:`ANY_HIT_RAYS` rays."""
    R, L = entry_p.shape[0], scene.n_lights
    if L == 0:
        return torch.zeros((R, 0), dtype=torch.bool, device=entry_p.device)
    with torch.no_grad():
        p = entry_p.detach()
        per = max(1, ANY_HIT_RAYS // max(R, 1))
        occ = []
        for l0 in range(0, L, per):
            lv = _light_dirs_to(tables, range(l0, min(L, l0 + per)), p)
            s = lv[..., 0] * lv[..., 0] + lv[..., 1] * lv[..., 1] \
                + lv[..., 2] * lv[..., 2]
            ln = lv * (1.0 / torch.sqrt(s))[..., None]
            so = p[:, None, :] + ln * EPS                  # Ray::cast_default
            n = lv.shape[1]
            te = step.hits(tables, so.reshape(R * n, 3),
                           ln.reshape(R * n, 3), hit3.MODE_ANY)[0]
            occ.append((te < hit3.BIG * 0.5).reshape(R, n))
        return ~torch.cat(occ, 1) & live_i[:, None]


def _hits(scene, tables, o, d):
    """``(te, row, tx, xrow)`` of the rays ``o``, ``d`` (R, 3) through the
    differentiable closest hit (pallas_hit3.make_closest_hit's role,
    models/tracer.py:35-53 of the JAX package): :class:`hit3.ClosestHit` on
    the fused path's tables, or for a triangle segment past
    ``hit3.MAX_TRI_BLOCKS`` (``step.tri_split``) the triangle segment's
    ``tri.TriEntry`` / ``tri.TriEntryExit`` (``step.tri_segment_hits``,
    their winner-t VJPs) merged with the dense rows' :class:`hit3.ClosestHit`
    by ``step.merge_tri_hits`` (intersect.closest_hit_tri_pallas)."""
    layout = tables.layout
    mode = step.primary_mode(scene)
    if not step.tri_split(layout[2]):
        return hit3.ClosestHit.apply(
            tables.tab, tables.tri if layout[2] else None, o, d, layout,
            mode, tables.tbb, tables.sbb, step._walk(tables), tables.box,
            step.hit_args(tables))
    thit = step.tri_segment_hits(scene, tables, tables.tri, o, d)
    dense = hit3.ClosestHit.apply(
        tables.tab, None, o, d, (layout[0], layout[1], 0, 0), mode, None,
        tables.sbb, step._walk(tables), None)
    return step.merge_tri_hits(dense, layout[1], mode, thit)


def _bounce_step(scene, tables, decay, o, d, pwr, live, u):
    """One bounce of the record path (the JAX package's ``_bounce_step``,
    rt.rs:1014-1066): the closest hit (:func:`_hits`), the winner rows'
    attributes (one gather of each side's whole row), normals and
    materials (``step._normal``, ``step._side_material``), the shadow
    rays from the entry point, and the reflect / refract pick from the
    step's uniforms ``u`` (R, 7) (``step.pick_side``, the plain trace's).
    Returns the next ray ``(o, d, pwr, live)`` and the bounce's record."""
    layout = tables.layout
    ends = hit3.row_ends(layout)
    te, row, tx, xrow = _hits(scene, tables, o, d)
    live_i = live & (te < hit3.BIG * 0.5)
    # dead lanes stay finite, so no NaN reaches a gradient
    p_e = o + d * torch.where(live_i, te, 1.0)[:, None]
    at_e = tables.tab[row.long()]
    n_e = step._normal(at_e, p_e, row, ends)
    mat_e, _tv = step._side_material(scene, tables, at_e, p_e, row, ends,
                                     live_i, None)
    lok = _shadows(scene, tables, p_e, live_i)
    _choose, next_dir, from_p, norm, mat, _tv = step.pick_side(
        scene, tables, o, d, tx, xrow, live_i, p_e, n_e, at_e, mat_e, u,
        ends)
    rec = {"live": live_i, "p": from_p, "norm": norm, "dir": d, "pwr": pwr,
           "color": mat["color"], "rough": mat["rough"],
           "metal": mat["metal"], "emit": mat["emit"], "light_ok": lok}
    return (from_p + next_dir * EPS, next_dir, pwr * decay, live_i), rec


def trace_records(scene, tables, bounce: int, orig, dirs, loss, u8s,
                  remat: bool = False):
    """The forward bounce loop of the record path (the JAX package's
    ``trace_records``): ``bounce + 1`` records, one per bounce, of
    primaries ``orig``/``dirs`` (R, 3) with step i's uniforms ``u8s[i]``
    (the fused path's; ``u8s`` (bounce+1, NU, R)). Each record holds the
    bounce's live mask, chosen point and normal, direction, throughput
    ``pwr``, chosen material and per-light visibility. ``remat``: each
    bounce under ``torch.utils.checkpoint`` (non-reentrant), its
    activations recomputed in the backward (memory-lean gradients, the same
    values)."""
    if u8s.shape[0] != bounce + 1:
        raise ValueError(f"u8s holds {u8s.shape[0]} steps, bounce {bounce} "
                         f"needs {bounce + 1}")
    decay = decay_of(loss)
    R = orig.shape[0]
    o, d = orig, dirs
    pwr = torch.ones((), dtype=orig.dtype, device=orig.device)
    live = torch.ones(R, dtype=torch.bool, device=orig.device)
    records = []
    for i in range(bounce + 1):
        u = step.unpack_uniforms(u8s[i], scene.any_refract)[0]
        if remat and torch.is_grad_enabled():
            (o, d, pwr, live), rec = torch.utils.checkpoint.checkpoint(
                _bounce_step, scene, tables, decay, o, d, pwr, live, u,
                use_reentrant=False)
        else:
            (o, d, pwr, live), rec = _bounce_step(scene, tables, decay, o, d,
                                                  pwr, live, u)
        records.append(rec)
    return records


def shade_records(scene, tables, records, u8s):
    """The reverse fold of ``reduce_light`` (rt.rs:956-994) over the
    records, the JAX package's ``shade_records``: from the sky, each live
    bounce from the last to the first gives ``color`` where its emit draw
    (``u8s[i]``'s last row) is below its ``emit``, else ``(0.5 col + color
    col + l_col) pwr`` with ``l_col`` the direct light at its chosen point
    (``step._direct_light``). A ray that hit nothing gets the bare sky
    colour. Returns (R, 3) radiance."""
    R = records[0]["live"].shape[0]
    col = torch.broadcast_to(scene.sky_color * scene.sky_pwr, (R, 3))
    for i in reversed(range(len(records))):
        rec = records[i]
        u_emit = step.unpack_uniforms(u8s[i], scene.any_refract)[1]
        b_emit = (u_emit < rec["emit"])[:, None]                # rt.rs:966
        l_col = step._direct_light(tables.lights, scene.n_lights,
                                   rec["light_ok"], rec["p"], rec["norm"],
                                   rec["dir"], rec["color"], rec["rough"],
                                   rec["metal"])               # rt.rs:973-987
        d_col = 0.5 * col + rec["color"] * col                  # rt.rs:990
        new = torch.where(b_emit, rec["color"],
                          (d_col + l_col) * rec["pwr"])         # rt.rs:992
        col = torch.where(rec["live"][:, None], new, col)
    # empty path -> bare sky color, *without* pwr (rt.rs:957-959)
    return torch.where(records[0]["live"][:, None], col,
                       torch.broadcast_to(scene.sky_color, (R, 3)))


def use_fused(fused=None) -> bool:
    """The route of a trace: ``fused`` as given, else the fused path unless
    ``MRT_NO_FUSE=1`` (read at each call, as the JAX package's
    ``trace_radiance`` does)."""
    if fused is None:
        return os.environ.get("MRT_NO_FUSE", "0") != "1"
    return bool(fused)


def trace_radiance_u(scene: SceneArrays, cam: CameraArrays, render_wh,
                     bounce: int, loss, coords, u_aprt, u8s, tables=None,
                     fused=None, remat: bool = False):
    """Per-pixel radiance from explicit uniforms: camera rays (``u_aprt``
    (R,2)) -> whole trace (``u8s`` (bounce+1, NU, R)). ``tables`` is the
    scene's :func:`step.pack_step`, built here when not given.

    ``fused`` (None: :func:`use_fused`, ``MRT_NO_FUSE=1`` for False) picks
    the fused path (:func:`trace_fused`) or the record path
    (:func:`trace_records`, then :func:`shade_records`), which takes the
    same uniforms and agrees up to float reassociation. ``remat``
    checkpoints each bounce of the record path; the fused path's kernels
    save only their residuals, so there it changes nothing, values or
    memory."""
    orig, dirs = camera_mod.gen_rays(cam, render_wh, coords, u_aprt)
    if tables is None:
        tables = step.pack_step(scene)
    if use_fused(fused):
        return trace_fused(scene, tables, bounce, orig, dirs, loss, u8s)
    records = trace_records(scene, tables, bounce, orig, dirs, loss, u8s,
                            remat)
    return shade_records(scene, tables, records, u8s)


def draw_uniforms(gen, n_rays: int, bounce: int, any_refract: bool, device):
    """``(u_aprt (R,2), u8s (bounce+1, NU, R))`` from ``gen``."""
    u_aprt = rng.uniform(gen, (n_rays, 2), device)
    u8s = rng.uniform(gen, (bounce + 1, step.n_uni(any_refract), n_rays),
                      device)
    return u_aprt, u8s


def trace_radiance(scene: SceneArrays, cam: CameraArrays, render_wh,
                   bounce: int, loss, coords, gen, tables=None, fused=None,
                   remat: bool = False):
    """Per-pixel radiance, one path per coordinate, uniforms from ``gen``
    (``tables``, ``fused`` and ``remat`` as in :func:`trace_radiance_u`)."""
    u_aprt, u8s = draw_uniforms(gen, coords.shape[0], bounce,
                                scene.any_refract, coords.device)
    return trace_radiance_u(scene, cam, render_wh, bounce, loss, coords,
                            u_aprt, u8s, tables, fused, remat)
