"""Dense ray-primitive intersection, winner attributes, normals, materials.

The plain PyTorch counterpart of ``micro_raytracer_tpu.ops.intersect`` for
the scene class this port covers so far: spheres, planes and boxes, no
triangles and no textures. Every ray is tested against every primitive row
as one ``(R, P)`` computation per kind segment (rt.rs:299-412), the closest
hit is a masked argmin (ties to the lowest row) and the exit hit a max over
the winner's group (rt.rs:740-772). These functions are the CPU path of the
port and the reference the hit kernel is held against.

Validity per kind, as in the reference:
  sphere  quadratic, ``t0 >= 0`` (inside counts as a miss)  rt.rs:335-358
  plane   double-sided, ``t > 0``                          rt.rs:400-412
  box     slab test with 1/0 -> 1e4, ``t0<=t1 && t1>=0``    rt.rs:299-332
Non-finite ``t`` is a miss. Every division and sqrt is guarded before the op.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models import schema
from ..models.compiler import SceneArrays
from . import linalg
from .linalg import EPS

_BIG = 3.0e38

UNPORTED_TRIANGLES = ("triangle and mesh segments are not ported yet "
                      "(ROADMAP.md, queue 1 item 6: triangles and meshes)")
UNPORTED_TEXTURES = ("textured materials are not ported yet "
                     "(ROADMAP.md, queue 1 item 7: textures)")


def check_scene_class(scene: SceneArrays) -> None:
    """Raise NotImplementedError for a scene outside the ported class."""
    if scene.kind_counts[schema.KIND_TRIANGLE]:
        raise NotImplementedError(UNPORTED_TRIANGLES)
    if scene.has_maps:
        raise NotImplementedError(UNPORTED_TEXTURES)


def build_frames(scene: SceneArrays):
    """Per-primitive instance matrices ``M = rot_y(-dir) @ lookat(-dir)``."""
    return linalg.instance_mat(scene.inst_dir)  # (P,3,3)


def _kind_array(scene: SceneArrays):
    """(P,) int64 kind codes derived from the segment counts."""
    return torch.repeat_interleave(
        torch.arange(4, device=scene.device),
        torch.tensor(scene.kind_counts, device=scene.device))


def intersect_all(scene: SceneArrays, frames, orig, dirs):
    """``(t_entry, t_exit, valid)``, each ``(R, P)``, of a ray batch
    ``orig``/``dirs`` ``(R, 3)`` against every primitive row."""
    check_scene_class(scene)
    t0_parts, t1_parts, ok_parts = [], [], []
    for kind, count in enumerate(scene.kind_counts):
        if count == 0:
            continue
        s = scene.seg(kind)
        pos = scene.inst_pos[s][None]
        fr_s = frames[s][None]
        o_rel = orig[:, None, :] - pos                            # (R,Pk,3)
        o_s = linalg.matvec(fr_s, o_rel) + pos
        d_s = linalg.matvec(fr_s, dirs[:, None, :])
        if kind == schema.KIND_SPHERE:
            o = o_s - pos
            a = linalg.dot(d_s, d_s)
            b = 2.0 * linalg.dot(o, d_s)
            c = linalg.dot(o, o) - scene.prim_r[s][None] ** 2
            disc = b * b - 4.0 * a * c
            sq = torch.sqrt(torch.where(disc >= 0.0,
                                        torch.clamp(disc, min=1e-12),
                                        torch.ones_like(disc)))
            a2 = torch.where(a == 0.0, torch.ones_like(a), 2.0 * a)
            t0 = (-b - sq) / a2
            t1 = (-b + sq) / a2
            ok = (disc >= 0.0) & (t0 >= 0.0)
        elif kind == schema.KIND_PLANE:
            n = linalg.safe_normalize(scene.prim_a[s])[None]      # (1,Pk,3)
            dd = -linalg.dot(n, pos)
            dn = linalg.dot(d_s, n)
            t0 = -(linalg.dot(o_s, n) + dd) / torch.where(
                dn == 0.0, torch.ones_like(dn), dn)
            t1 = t0
            ok = (t0 > 0.0) & (dn != 0.0)
        else:  # KIND_BOX: 1/0 -> 1/E (sign dropped), rt.rs:306-316
            zero = d_s == 0.0
            m = 1.0 / torch.where(zero, torch.ones_like(d_s), d_s)
            m = torch.where(zero, torch.full_like(m, 1.0 / EPS), m)
            nb = (o_s - pos) * m
            k = (0.5 * scene.prim_a[s][None]) * torch.abs(m)
            t0 = torch.amax(-nb - k, dim=-1)
            t1 = torch.amin(-nb + k, dim=-1)
            ok = ~((t0 > t1) | (t1 < 0.0))
        ok = (ok & scene.prim_valid[s][None] & torch.isfinite(t0)
              & torch.isfinite(t1))
        t0_parts.append(t0)
        t1_parts.append(t1)
        ok_parts.append(ok)
    return (torch.cat(t0_parts, dim=1), torch.cat(t1_parts, dim=1),
            torch.cat(ok_parts, dim=1))


def any_hit(scene: SceneArrays, frames, orig, dirs):
    """Occlusion query: does the ray hit anything at all? (rt.rs:1036-1038)"""
    _, _, valid = intersect_all(scene, frames, orig, dirs)
    return torch.any(valid, dim=-1)


@dataclass
class HitInfo:
    hit: torch.Tensor        # (R,) bool
    t_entry: torch.Tensor    # (R,)
    t_exit: torch.Tensor     # (R,)
    idx_entry: torch.Tensor  # (R,) int32 winning row
    idx_exit: torch.Tensor   # (R,) int32 farthest-exit row of its group


def closest_hit(scene: SceneArrays, frames, orig, dirs,
                need_exit: bool = True) -> HitInfo:
    """Masked argmin over entry t (first row on ties, rt.rs:867-872) plus
    the group max of exit t for the exit hit (rt.rs:758-771)."""
    t_entry, t_exit, valid = intersect_all(scene, frames, orig, dirs)
    hit = torch.any(valid, dim=-1)
    big = torch.full_like(t_entry, _BIG)
    masked_entry = torch.where(valid, t_entry, big)
    te = torch.amin(masked_entry, dim=-1)
    win = first_index(masked_entry == te[:, None])
    if not need_exit:
        return HitInfo(hit=hit, t_entry=te, t_exit=te, idx_entry=win,
                       idx_exit=win)
    win_group = scene.group_id[win.long()]
    same = valid & (scene.group_id[None, :] == win_group[:, None])
    masked_exit = torch.where(same, t_exit, -big)
    tx = torch.amax(masked_exit, dim=-1)
    return HitInfo(hit=hit, t_entry=te, t_exit=tx, idx_entry=win,
                   idx_exit=first_index(masked_exit == tx[:, None]))


def first_index(mask):
    """int32 index of the first True along the last axis (0 if none), the
    tie rule of jnp.argmin / jnp.argmax."""
    cols = torch.arange(mask.shape[-1], device=mask.device)
    idx = torch.where(mask, cols, mask.shape[-1]).amin(dim=-1)
    return torch.where(idx == mask.shape[-1], 0, idx).to(torch.int32)


class AttrView:
    """Column view over fetched ``(..., 34)`` attribute rows."""

    _F, _IPOS, _A, _KIND = 0, 9, 12, 22
    _ALBEDO, _ROUGH, _METAL, _GLASS, _OPACITY, _EMIT = 26, 29, 30, 31, 32, 33
    K = 34

    def __init__(self, fetched):
        self.v = fetched

    @property
    def frames(self):
        return self.v[..., self._F:self._F + 9].reshape(
            self.v.shape[:-1] + (3, 3))

    @property
    def inst_pos(self):
        return self.v[..., self._IPOS:self._IPOS + 3]

    @property
    def prim_a(self):
        return self.v[..., self._A:self._A + 3]

    def kind_is(self, kind: int):
        return self.v[..., self._KIND + kind] > 0.5

    @property
    def albedo(self):
        return self.v[..., self._ALBEDO:self._ALBEDO + 3]

    @property
    def rough(self):
        return self.v[..., self._ROUGH]

    @property
    def metal(self):
        return self.v[..., self._METAL]

    @property
    def glass(self):
        return self.v[..., self._GLASS]

    @property
    def opacity(self):
        return self.v[..., self._OPACITY]

    @property
    def emit(self):
        return self.v[..., self._EMIT]


def prim_attributes(scene: SceneArrays, frames):
    """All per-primitive attributes as one dense ``(P, 34)`` matrix, in the
    JAX package's column layout (:class:`AttrView`)."""
    check_scene_class(scene)
    P = scene.n_prims
    kind_oh = torch.nn.functional.one_hot(_kind_array(scene), 4).to(
        frames.dtype)
    m = scene.mat_id.long()
    return torch.cat([
        frames.reshape(P, 9), scene.inst_pos,
        scene.prim_a, scene.prim_b, scene.prim_c, scene.prim_r[:, None],
        kind_oh, scene.mat_albedo[m], scene.mat_rough[m][:, None],
        scene.mat_metal[m][:, None], scene.mat_glass[m][:, None],
        scene.mat_opacity[m][:, None], scene.mat_emit[m][:, None],
    ], dim=1)


def fetch_attrs(attrs, idx) -> AttrView:
    """Rows of ``attrs`` at ``idx`` (an exact gather)."""
    return AttrView(attrs[idx.long()])


def normal_from_attrs(at: AttrView, point):
    """World-space normal from fetched winner attributes (rt.rs:776-793),
    including the box face quirk: the z test is not chained to the x/y
    chain (missing ``else``, rt.rs:435)."""
    M = at.frames
    ipos = at.inst_pos
    hp = ipos + linalg.matvec(M, point - ipos)

    n_sph = hp - ipos
    n_pln = at.prim_a
    sizes = torch.where(at.prim_a == 0, torch.ones_like(at.prim_a), at.prim_a)
    p = (hp - ipos) * (2.0 / sizes)

    def _in(v, target):
        return (torch.abs(v - target) < EPS)[..., None]

    e = torch.eye(3, dtype=point.dtype, device=point.device)
    ex, ey, ez = e[0], e[1], e[2]
    zero3 = torch.zeros_like(point)
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    base = torch.where(_in(px, 1.0), ex,
           torch.where(_in(px, -1.0), -ex,
           torch.where(_in(py, 1.0), ey,
           torch.where(_in(py, -1.0), -ey, zero3))))
    n_box = torch.where(_in(pz, 1.0), ez, torch.where(_in(pz, -1.0), -ez,
                                                       base))
    n_obj = torch.where(at.kind_is(schema.KIND_SPHERE)[..., None], n_sph,
            torch.where(at.kind_is(schema.KIND_PLANE)[..., None], n_pln,
                        n_box))
    return linalg.safe_normalize(linalg.matvec(M, n_obj))


def material_from_attrs(scene: SceneArrays, at: AttrView, point):
    """Material dict from fetched attributes (rt.rs:811-863, untextured)."""
    check_scene_class(scene)
    return {"color": at.albedo, "rough": at.rough, "metal": at.metal,
            "glass": at.glass, "opacity": at.opacity, "emit": at.emit,
            "metal_scalar": at.metal}
