"""Primary-ray generation: pinhole camera with depth of field.

The counterpart of ``micro_raytracer_tpu.models.camera`` (``RayTracer::cast``
+ ``RayTracer::iter``, rt.rs:900-954): pixel -> uv with aspect, fov ->
direction, the focus point, per-sample aperture jitter on x/z, and the
``rot_y(cam.dir) @ lookat(cam.dir)`` orientation.
"""

from __future__ import annotations

import math

import torch

from ..ops import linalg
from ..ops.linalg import EPS
from .compiler import CameraArrays


def gen_rays(cam: CameraArrays, render_wh, coords, u_aprt):
    """Primary rays for float pixel coords ``(R, 2)`` (x, y) at the render
    resolution ``render_wh``; ``u_aprt`` ``(R, 2)`` drives the aperture
    jitter. Returns ``(orig, dirs)``, each ``(R, 3)``, origins E-offset
    (``Ray::cast_default``, rt.rs:555-557)."""
    w = float(render_wh[0])
    h = float(render_wh[1])
    aspect = w / h

    # pixel -> uv (rt.rs:938-945)
    uvx = aspect * (coords[:, 0] - 0.5 * w) / w
    uvy = (coords[:, 1] - 0.5 * h) / h

    # fov -> direction (rt.rs:902-908)
    tan_fov = torch.tan(0.5 * cam.fov * (math.pi / 180.0))
    d = linalg.normalize(torch.stack(
        [uvx, torch.broadcast_to(1.0 / (2.0 * tan_fov), uvx.shape), -uvy],
        dim=-1))

    # depth of field (rt.rs:910-922): focus point from the E-offset ray,
    # aperture jitter on world x/z only
    p = (cam.pos[None] + d * EPS) + d * cam.foc
    jitter = (u_aprt - 0.5) * cam.aprt
    pos = cam.pos[None] + torch.stack(
        [jitter[:, 0], torch.zeros_like(jitter[:, 0]), jitter[:, 1]], dim=-1)
    new_dir = linalg.normalize(p - pos)

    # orientation (rt.rs:924-930)
    M = linalg.matmul3(linalg.rotate_y_mat(cam.dir),
                       linalg.lookat_mat(cam.dir))
    dirs = linalg.matvec(M[None], new_dir)

    orig = pos + dirs * EPS
    return orig, dirs
