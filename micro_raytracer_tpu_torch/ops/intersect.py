"""What every plain path shares: the scene-class check, the instance frames
and the first-index tie rule.

The counterpart of the parts of ``micro_raytracer_tpu.ops.intersect`` that
the port's sweeps (:mod:`.hit3`) and whole trace (:mod:`.step`) use, for
the scene class this port covers so far: spheres, planes and boxes, no
triangles and no textures.
"""

from __future__ import annotations

import torch

from ..models import schema
from ..models.compiler import SceneArrays
from . import linalg

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


def first_index(mask):
    """int32 index of the first True along the last axis (0 if none), the
    tie rule of jnp.argmin / jnp.argmax."""
    cols = torch.arange(mask.shape[-1], device=mask.device)
    idx = torch.where(mask, cols, mask.shape[-1]).amin(dim=-1)
    return torch.where(idx == mask.shape[-1], 0, idx).to(torch.int32)
