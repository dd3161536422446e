"""Path tracer: the bounce loop with the shading fold composed forward.

The counterpart of ``micro_raytracer_tpu.models.tracer`` for rendering.
``reduce_light`` (rt.rs:956-994) is an affine recurrence in the radiance,
``col_i = a_i * col_{i+1} + b_i`` with

  a_i = [live] * [not emit] * pwr_i * (0.5 + color_i)
  b_i = [live] * where(emit, color_i, pwr_i * l_col_i)

(dead rays pass through: a = 1, b = 0), so the trace carries ``(A, B)``
with ``col = A * col_tail + B`` and updates ``B += A*b; A *= a`` per
bounce. :func:`fused_step_reference` is one such bounce on dense tensors
from explicit uniforms — the semantic reference of the trace kernel — and
:func:`trace_fused` runs the whole trace: the CUDA kernels for CUDA
tensors, a loop of :func:`fused_step_reference` for CPU tensors.

Every random draw is an input: :func:`trace_radiance_u` takes the aperture
uniforms and the packed per-step uniforms, and :func:`trace_radiance` draws
them from a ``torch.Generator`` and calls it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import intersect, linalg, rng, step
from ..ops.linalg import EPS
from . import camera as camera_mod
from .compiler import CameraArrays, SceneArrays


def _pow32(x):
    x2 = x * x
    x4 = x2 * x2
    x8 = x4 * x4
    x16 = x8 * x8
    return x16 * x16


def _light_dirs_to(scene: SceneArrays, point):
    """(R,3) -> (R,L,3) un-normalized vectors toward each light
    (rt.rs:975-978); directional lights give ``-normalize(dir)``."""
    lp = scene.light_pos[None] - point[:, None, :]
    ld = -linalg.normalize(scene.light_dir)[None]
    return torch.where(scene.light_is_dir[None, :, None], ld, lp)


def _bounce_step(scene: SceneArrays, frames, attrs, decay, carry, u):
    """One bounce (rt.rs:1014-1066): closest hit, shadow rays, the
    reflect/refract pick. Returns ``(new_carry, rec)``."""
    o, d, pwr, live = carry
    R = o.shape[0]
    L = scene.n_lights
    hit = intersect.closest_hit(scene, frames, o, d,
                                need_exit=scene.any_refract)
    live_i = live & hit.hit
    one = torch.ones((), dtype=o.dtype, device=o.device)

    at_e = intersect.fetch_attrs(attrs, hit.idx_entry)
    te = torch.where(live_i, hit.t_entry, one)
    entry_p = o + d * te[:, None]
    n_entry = intersect.normal_from_attrs(at_e, entry_p)
    n_entry = torch.where(torch.isfinite(n_entry), n_entry, 0.0)
    mat_e = intersect.material_from_attrs(scene, at_e, entry_p)

    if scene.any_refract:
        at_x = intersect.fetch_attrs(attrs, hit.idx_exit)
        tx = torch.where(live_i, hit.t_exit, one)
        exit_p = o + d * tx[:, None]
        n_exit = intersect.normal_from_attrs(at_x, exit_p)
        n_exit = torch.where(torch.isfinite(n_exit), n_exit, 0.0)
        mat_x = intersect.material_from_attrs(scene, at_x, exit_p)

    # per-light shadow rays from the entry hit (rt.rs:1027-1046)
    if L > 0:
        lvec = _light_dirs_to(scene, entry_p)
        ldir = linalg.normalize(lvec)
        sorig = entry_p[:, None, :] + ldir * EPS
        occ = intersect.any_hit(scene, frames, sorig.reshape(R * L, 3),
                                ldir.reshape(R * L, 3)).reshape(R, L)
        light_ok = (~occ) & live_i[:, None]
    else:
        light_ok = torch.zeros((R, 0), dtype=torch.bool, device=o.device)

    # reflect from the entry hit (rt.rs:559-572)
    diel_e = (mat_e["metal_scalar"] == 0.0) & (mat_e["opacity"] != 0.0)
    rough_r = torch.where(diel_e & (u[:, 0] < 0.8), one, mat_e["rough"])
    nr = rng.sphere_rand(n_entry, rough_r, u[:, 1], u[:, 2])
    refl = linalg.safe_normalize(linalg.reflect(d, nr))

    if scene.any_refract:
        # refract from the exit hit (rt.rs:574-589, 1054-1058)
        diel_x = (mat_x["metal_scalar"] == 0.0) & (mat_x["opacity"] != 0.0)
        rough_f = torch.where(diel_x & (u[:, 3] < 0.8), one, mat_x["rough"])
        nf = rng.sphere_rand(n_exit, rough_f, u[:, 4], u[:, 5])
        eta = 1.0 + 0.5 * mat_x["glass"]
        refr, refr_ok = linalg.refract(d, eta, nf)
        refr = linalg.safe_normalize(refr)
        refr = torch.where(torch.isfinite(refr), refr, 0.0)
        choose = ((u[:, 6] < torch.clamp(1.0 - mat_e["opacity"], max=0.85))
                  & refr_ok)

        def pick(a, b):
            return torch.where(choose[:, None] if a.ndim == 2 else choose,
                               a, b)

        next_dir = pick(refr, refl)
        from_p = pick(exit_p, entry_p)
        norm = pick(n_exit, n_entry)
        color = pick(mat_x["color"], mat_e["color"])
        rough = pick(mat_x["rough"], mat_e["rough"])
        metal = pick(mat_x["metal"], mat_e["metal"])
        emit = pick(mat_x["emit"], mat_e["emit"])
    else:
        # opaque scene: the refract probability min(1-1, 0.85) is 0
        next_dir, from_p, norm = refl, entry_p, n_entry
        color, rough = mat_e["color"], mat_e["rough"]
        metal, emit = mat_e["metal"], mat_e["emit"]

    rec = {"live": live_i, "p": from_p, "norm": norm, "dir": d, "pwr": pwr,
           "color": color, "rough": rough, "metal": metal, "emit": emit,
           "light_ok": light_ok}
    return (from_p + next_dir * EPS, next_dir, pwr * decay, live_i), rec


def _direct_light(scene: SceneArrays, rec):
    """Direct light of ``reduce_light`` (rt.rs:973-987), (R,3): shaded at
    the chosen point with the entry point's shadow mask (the reference
    quirk)."""
    R = rec["p"].shape[0]
    if scene.n_lights == 0:
        return torch.zeros((R, 3), dtype=rec["p"].dtype,
                           device=rec["p"].device)
    ln = linalg.normalize(_light_dirs_to(scene, rec["p"]))        # (R,L,3)
    norm = rec["norm"][:, None, :]
    diff = torch.clamp(linalg.dot(ln, norm), min=0.0)
    spec = _pow32(torch.clamp(
        linalg.dot(rec["dir"][:, None, :], linalg.reflect(ln, norm)),
        min=0.0)) * (1.0 - rec["rough"][:, None])
    o_col = (rec["color"] * (1.0 - rec["metal"])[:, None])[:, None, :]
    contrib = (o_col * diff[..., None] * scene.light_color[None]
               + spec[..., None]) * scene.light_pwr[None, :, None]
    return torch.sum(torch.where(rec["light_ok"][..., None], contrib, 0.0),
                     dim=1)


def _fold_update(scene: SceneArrays, rec, A, B, u_emit):
    """One forward composition step of the fold: ``(A*a, B + A*b)``."""
    live = rec["live"][:, None]
    b_emit = (u_emit < rec["emit"])[:, None]                  # rt.rs:966-970
    l_col = _direct_light(scene, rec)
    pwr_c = rec["pwr"][:, None]
    a = torch.where(b_emit, 0.0, pwr_c * (0.5 + rec["color"]))
    b = torch.where(b_emit, rec["color"], pwr_c * l_col)
    a = torch.where(live, a, 1.0)
    b = torch.where(live, b, 0.0)
    return A * a, B + A * b


def fused_step_reference(scene: SceneArrays, frames, attrs, decay, ray, A, B,
                         u, u_emit):
    """One full bounce from explicit uniforms ``u`` (R,7), ``u_emit`` (R,).
    ``ray = (o, d, pwr, live)``; returns ``(ray2, A2, B2, live2)``."""
    ray2, rec = _bounce_step(scene, frames, attrs, decay, ray, u)
    A2, B2 = _fold_update(scene, rec, A, B, u_emit)
    return ray2, A2, B2, rec["live"]


def decay_of(loss) -> float:
    """Per-bounce power decay ``1 - min(loss, 1)`` in float32 arithmetic."""
    loss = np.float32(loss)
    return float(np.float32(1.0) - np.minimum(loss, np.float32(1.0)))


def trace_fused(scene: SceneArrays, tables, bounce: int, orig, dirs, loss,
                u8s):
    """Radiance ``(R, 3)`` of primaries ``orig``/``dirs`` ``(R, 3)`` through
    ``bounce + 1`` steps with packed uniforms ``u8s`` ``(bounce+1, NU, R)``,
    given the scene's :class:`step.TraceTables`. CUDA tensors run the
    kernels; CPU tensors the plain loop."""
    if u8s.shape[0] != bounce + 1:
        raise ValueError(f"u8s holds {u8s.shape[0]} steps, bounce {bounce} "
                         f"needs {bounce + 1}")
    A_T, B_T, flT = step.trace_packed(
        scene, tables, decay_of(loss), orig.T.contiguous(),
        dirs.T.contiguous(), u8s)
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
