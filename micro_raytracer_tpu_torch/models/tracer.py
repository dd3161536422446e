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

from ..ops import rng, step
from . import camera as camera_mod
from .compiler import CameraArrays, SceneArrays


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
