"""What every plain path shares: the scene-class check, the instance frames,
the triangles' Woop transforms and the first-index tie rule.

The counterpart of the parts of ``micro_raytracer_tpu.ops.intersect`` that
the port's sweeps (:mod:`.hit3`) and whole trace (:mod:`.step`) use, for
the scene class this port covers so far: spheres, planes, boxes, triangles
and meshes, no textures.
"""

from __future__ import annotations

import torch

from ..models import schema
from ..models.compiler import SceneArrays
from . import linalg

UNPORTED_TEXTURES = ("textured materials are not ported yet "
                     "(ROADMAP.md, queue 1 item 7: textures)")


def check_scene_class(scene: SceneArrays) -> None:
    """Raise NotImplementedError for a scene outside the ported class."""
    if scene.has_maps:
        raise NotImplementedError(UNPORTED_TEXTURES)


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
