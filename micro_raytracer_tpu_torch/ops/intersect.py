"""What every plain path shares: the instance frames, the triangles' Woop
transforms, the first-index tie rule, and the texture lookups.

The counterpart of the parts of ``micro_raytracer_tpu.ops.intersect`` that
the port's sweeps (:mod:`.hit3`) and whole trace (:mod:`.step`) use:
spheres, planes, boxes, triangles and meshes, with or without texture
maps. The texture functions (:func:`uv_from_attrs`, :func:`sample_texture`,
:func:`material_from_attrs`) are the plain versions of the texture code of
``csrc/trace_step.cuh``.
"""

from __future__ import annotations

import math

import torch

from ..models import schema
from ..models.compiler import SceneArrays
from . import linalg

# texture slots of ``mat_maps`` (schema.MaterialConfig.MAP_KEYS): slot 0
# multiplies the albedo by the texel's rgb, slots 1-5 replace rough, metal,
# glass, opacity and emit by its red channel
MAT_KEYS = ("rough", "metal", "glass", "opacity", "emit")


def build_frames(scene: SceneArrays):
    """Per-primitive instance matrices ``M = rot_y(-dir) @ lookat(-dir)``."""
    return linalg.instance_mat(scene.inst_dir)  # (P,3,3)


def triangle_pack(scene: SceneArrays, frames):
    """Per-triangle unit-space ("Woop") transforms of the triangle segment,
    as ``micro_raytracer_tpu.ops.intersect.triangle_pack`` builds them.

    With edges ``e0 = v1 - v0``, ``e1 = v2 - v0`` and the raw normal ``n =
    e0 x e1``, ``W = [(e1 x n), (n x e0), n] / (n . n)`` maps a point to
    barycentric coordinates; composed with the instance frame ``M`` it gives
    ``G = W @ M`` and ``h = -G @ ipos - W @ v0``, so that ``o' = G o + h``,
    ``d' = G d`` and the hit is ``t = -o'_z / d'_z`` with ``u = o'_x + t
    d'_x``, ``v = o'_y + t d'_y`` (Moller-Trumbore, rt.rs:361-398, in exact
    arithmetic). The ``|det| >= E`` window becomes ``|d'_z| >= thr`` with
    ``thr = EPS / (n . n)``. Returns ``(G (Pt,3,3), h (Pt,3), thr (Pt,),
    nondegenerate (Pt,))``, differentiable in the vertices, ``inst_pos``
    and (through ``frames``) ``inst_dir``."""
    s = scene.seg(schema.KIND_TRIANGLE)
    a, b, c = scene.prim_a[s], scene.prim_b[s], scene.prim_c[s]
    e0, e1 = b - a, c - a
    n = linalg.cross(e0, e1)
    nn = linalg.dot(n, n)
    ok = nn > 0.0                       # degenerate or padding rows
    nn_s = torch.where(ok, nn, 1.0)[..., None]
    W = torch.stack([linalg.cross(e1, n) / nn_s, linalg.cross(n, e0) / nn_s,
                     n / nn_s], dim=-2)
    G = linalg.matmul3(W, frames[s])
    h = -linalg.matvec(G, scene.inst_pos[s]) - linalg.matvec(W, a)
    return G, h, linalg.EPS / nn_s[..., 0], ok


def triangle_normals(scene: SceneArrays):
    """The raw cross-product normal ``(v1 - v0) x (v2 - v0)`` of each row of
    the triangle segment (pallas_step.pack_step's normal source), ``(Pt,
    3)``, differentiable in the vertices."""
    s = scene.seg(schema.KIND_TRIANGLE)
    e0 = scene.prim_b[s] - scene.prim_a[s]
    e1 = scene.prim_c[s] - scene.prim_a[s]
    return torch.stack([e0[:, 1] * e1[:, 2] - e0[:, 2] * e1[:, 1],
                        e0[:, 2] * e1[:, 0] - e0[:, 0] * e1[:, 2],
                        e0[:, 0] * e1[:, 1] - e0[:, 1] * e1[:, 0]], -1)


def first_index(mask):
    """int32 index of the first True along the last axis (0 if none), the
    tie rule of jnp.argmin / jnp.argmax."""
    cols = torch.arange(mask.shape[-1], device=mask.device)
    idx = torch.where(mask, cols, mask.shape[-1]).amin(dim=-1)
    return torch.where(idx == mask.shape[-1], 0, idx).to(torch.int32)


def _dot(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def uv_from_attrs(at, point, kind):
    """Texture coordinates ``(u, v)``, each ``(R,)``, of world points
    ``point`` ``(R, 3)`` on rows whose attributes ``at`` ``(R, >= 15)``
    hold the frame (columns 0-8, row-major), the instance position (9-11)
    and the plane normal / box sizes (12-14), of schema kinds ``kind``
    ``(R,)`` (rt.rs:468-548; ``micro_raytracer_tpu.ops.intersect.
    uv_from_attrs``).

    Sphere: the spherical map of the unguarded ``normalize(hp - ip)`` (a
    degenerate point gives NaN, whose texel is the first, see
    :func:`texel_index`); plane: ``fract(x + 0.5)`` as ``x - trunc(x)``
    wrapped below 0; box: the 4x3 cross atlas, the first face test that
    holds in rt.rs order (x+, x-, y+, y-, z+, z-) choosing the face;
    triangle: 0 (the reference's ``todo!()``)."""
    f, ip, pa = at[:, 0:9], at[:, 9:12], at[:, 12:15]
    rel_w = point - ip
    hp = ip + torch.stack([f[:, 3 * k] * rel_w[:, 0]
                           + f[:, 3 * k + 1] * rel_w[:, 1]
                           + f[:, 3 * k + 2] * rel_w[:, 2]
                           for k in range(3)], 1)
    rel = hp - ip
    inv = 1.0 / torch.sqrt(_dot(rel, rel))
    n = rel * inv[:, None]
    u_sph = 0.5 + 0.5 * torch.atan2(n[:, 0], -n[:, 1]) / math.pi
    v_sph = 0.5 - 0.5 * n[:, 2]
    fx = (hp[:, 0] + 0.5) - torch.trunc(hp[:, 0] + 0.5)
    fy = (hp[:, 1] + 0.5) - torch.trunc(hp[:, 1] + 0.5)
    u_pln = torch.where(fx < 0.0, 1.0 + fx, fx)
    v_pln = torch.where(fy < 0.0, 1.0 + fy, fy)
    q = rel * (2.0 / torch.where(pa == 0.0, 1.0, pa))
    qx, qy, qz = q[:, 0], q[:, 1], q[:, 2]
    side = (0.5 - 0.5 * qz) / 3.0 + 1.0 / 3.0
    top_u = (0.5 + 0.5 * qx) / 4.0 + 1.0 / 4.0
    faces = [  # (axis, target, u, v) in rt.rs test order
        (qx, 1.0, (0.5 + 0.5 * qy) / 4.0 + 2.0 / 4.0, side),
        (qx, -1.0, (0.5 - 0.5 * qy) / 4.0, side),
        (qy, 1.0, (0.5 - 0.5 * qx) / 4.0 + 3.0 / 4.0, side),
        (qy, -1.0, top_u, side),
        (qz, 1.0, top_u, (0.5 - 0.5 * qy) / 3.0),
        (qz, -1.0, top_u, (0.5 + 0.5 * qy) / 3.0 + 2.0 / 3.0),
    ]
    u_box = v_box = torch.zeros_like(qx)
    for axis, target, uu, vv in reversed(faces):
        c = torch.abs(axis - target) < linalg.EPS
        u_box = torch.where(c, uu, u_box)
        v_box = torch.where(c, vv, v_box)
    zero = torch.zeros_like(qx)
    by_kind = ((schema.KIND_SPHERE, u_sph, v_sph),
               (schema.KIND_PLANE, u_pln, v_pln),
               (schema.KIND_BOX, u_box, v_box))
    u, v = zero, zero
    for k, uk, vk in by_kind:
        u = torch.where(kind == k, uk, u)
        v = torch.where(kind == k, vk, v)
    return u, v


def texel_index(f, n):
    """``clip(int(f), 0, n - 1)`` as an int64 index, with NaN at 0: the
    JAX package's saturating float-to-int conversion, and the kernel's
    ``(int)fminf(fmaxf(f, 0), n - 1)`` (a float-to-int cast of NaN is 0 in
    CUDA and XLA, but not in PyTorch)."""
    f = torch.where(f >= 0.0, f, 0.0)
    return torch.minimum(f, (n - 1).to(f.dtype)).long()


def sample_texture(atlas, tmeta, tex_id, u, v):
    """Nearest texel (rt.rs:618-628; ``micro_raytracer_tpu.ops.intersect.
    sample_texture``): ``atlas`` ``(N, 3)`` holds the textures one after
    another, ``tmeta`` ``(T, 3)`` each texture's (offset, width, height);
    the texel of texture ``max(tex_id, 0)`` at ``x = clip(int(u w), 0,
    w - 1)``, ``y`` likewise, ``off + x + y w``. Returns ``(R, 3)``."""
    meta = tmeta[tex_id.clamp(min=0).long()].long()
    off, w, h = meta[:, 0], meta[:, 1], meta[:, 2]
    x = texel_index(u * w.to(u.dtype), w)
    y = texel_index(v * h.to(v.dtype), h)
    return atlas[off + x + y * w]


def texel_edge(tmeta, tex_id, u, v, tol):
    """(R,) bool: is a texel coordinate ``u w`` or ``v h`` of
    :func:`sample_texture` within ``tol`` of an integer (where a one-ulp
    difference of ``u`` or ``v`` moves the lookup to the next texel)?"""
    meta = tmeta[tex_id.clamp(min=0).long()]
    edge = torch.zeros(u.shape, dtype=torch.bool, device=u.device)
    for f in (u * meta[:, 1].to(u.dtype), v * meta[:, 2].to(v.dtype)):
        edge |= torch.abs(f - torch.round(f)) < tol
    return edge


def texel_values(atlas, tmeta, slots, ids, u, v):
    """The texels of the present ``slots`` (``scene.map_slots``) at ``(u,
    v)`` for map ids ``ids`` ``(R, 6)``: ``[(slot, value)]`` with an ``(R,
    3)`` rgb value for slot 0 and an ``(R,)`` red channel for slots 1-5, 0
    where the id is -1 (no map)."""
    out = []
    for s in range(6):
        if not slots[s]:
            continue
        val = sample_texture(atlas, tmeta, ids[:, s], u, v)
        val = val if s == 0 else val[:, 0]
        mapped = ids[:, s] >= 0
        out.append((s, torch.where(mapped[:, None] if s == 0 else mapped,
                                   val, 0.0)))
    return out


def apply_texels(mat, ids, texvals):
    """The material ``mat`` (a dict with ``color`` and :data:`MAT_KEYS`)
    with the texels of :func:`texel_values` applied where the map id is not
    -1 (rt.rs:811-863): slot 0 multiplies ``color``, slots 1-5 replace the
    scalar. The texels are constants: the cotangent of the base color is
    multiplied by the texel, that of a replaced scalar is 0."""
    out = dict(mat)
    for s, val in texvals:
        mapped = ids[:, s] >= 0
        if s == 0:
            out["color"] = torch.where(mapped[:, None], mat["color"] * val,
                                       mat["color"])
        else:
            key = MAT_KEYS[s - 1]
            out[key] = torch.where(mapped, val, mat[key])
    return out


def material_from_attrs(scene: SceneArrays, mat, ids, point, at, kind,
                        atlas=None, tmeta=None):
    """The material at ``point`` (rt.rs:811-863; ``micro_raytracer_tpu.
    ops.intersect.material_from_attrs``): ``mat`` holds the rows' base
    ``color`` ``(R, 3)`` and :data:`MAT_KEYS` ``(R,)``, ``ids`` their map
    ids ``(R, 6)``, ``at`` and ``kind`` locate the point for
    :func:`uv_from_attrs`. Adds ``metal_scalar``, the unmapped metal that
    the dielectric test reads (rt.rs:564). ``atlas`` / ``tmeta`` default
    to the scene's."""
    out = dict(mat, metal_scalar=mat["metal"])
    if not scene.has_maps:
        return out
    if atlas is None:
        atlas, tmeta = tex_tables(scene)
    u, v = uv_from_attrs(at, point, kind)
    out.update(apply_texels(mat, ids, texel_values(
        atlas, tmeta, scene.map_slots, ids, u, v)))
    return out


def tex_tables(scene: SceneArrays):
    """The flat atlas ``(N, 3)`` float32 and the ``(T, 3)`` int32
    (offset, width, height) of each texture."""
    tmeta = torch.stack([scene.tex_offset, scene.tex_w, scene.tex_h],
                        1).to(torch.int32).contiguous()
    return scene.tex_data.to(torch.float32).contiguous(), tmeta
