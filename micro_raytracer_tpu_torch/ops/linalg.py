"""Batched 3-vector / rotation math on torch tensors.

The counterpart of ``micro_raytracer_tpu.ops.linalg`` (itself a re-derivation
of the reference's ``lin.rs``): every function broadcasts over leading axes
of ``(..., 3)`` stacks. Arithmetic is written in the JAX package's operation
order, so the two agree to float32 rounding.

Coordinate convention (lin.rs:40-50): +y forward, +x right, +z up.
Direction 4-vectors are ``[w, x, y, z]``; ``w`` is the roll parameter read
by :func:`rotate_y_mat`.
"""

from __future__ import annotations

import torch

EPS = 1e-4  # the reference's global intersection epsilon (rt.rs:7)


def dot(a, b):
    """Dot product over the trailing axis. (lin.rs:259-264)"""
    return torch.sum(a * b, dim=-1)


def cross(a, b):
    """Cross product over the trailing axis. (lin.rs:52-58)"""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def mag(a):
    """Euclidean norm of the trailing axis. (lin.rs:60-62)"""
    return torch.sqrt(torch.sum(a * a, dim=-1))


def normalize(a):
    """a / |a| like the reference's ``norm`` (zero vectors give non-finite
    output, as in Rust)."""
    return a * (1.0 / mag(a))[..., None]


def safe_normalize(a, eps=1e-20):
    """Normalize with zero vectors mapped to zero instead of NaN. The
    reciprocal square root is ``1 / sqrt`` (exact on every device; CUDA's
    rsqrt is approximate), as in the kernels."""
    m2 = torch.sum(a * a, dim=-1)
    return a * (1.0 / torch.sqrt(torch.clamp(m2, min=eps)))[..., None]


def reflect(v, n):
    """Mirror ``v`` about normal ``n``: ``v - 2 (v.n) n``. (lin.rs:68-70)"""
    return v - n * (2.0 * dot(v, n))[..., None]


def refract(v, eta, n):
    """Snell refraction (lin.rs:96-105): ``(dir, ok)``, ``ok`` False on
    total internal reflection; ``dir`` unnormalized like the reference."""
    cos = -dot(n, v)
    k = 1.0 - eta * eta * (1.0 - cos * cos)
    ok = k >= 0.0
    # TIR lanes take k := 1 so the sqrt stays finite (guard before the op)
    k_safe = torch.where(ok, torch.clamp(k, min=1e-12), torch.ones_like(k))
    out = v * eta[..., None] + n * (cos * eta + torch.sqrt(k_safe))[..., None]
    return out, ok


def rotate_y_mat(dir4):
    """Roll rotation from a ``[w,x,y,z]`` direction (``Mat3f::rotate_y``,
    lin.rs:175-183): ``w`` is the sine of the roll, ``cw = sqrt(1 - w^2)``."""
    w = dir4[..., 0]
    cw = torch.sqrt(1.0 - w * w)
    zero = torch.zeros_like(w)
    one = torch.ones_like(w)
    rows = [torch.stack([cw, zero, w], dim=-1),
            torch.stack([zero, one, zero], dim=-1),
            torch.stack([-w, zero, cw], dim=-1)]
    return torch.stack(rows, dim=-2)


def lookat_mat(dir4, up=None):
    """Orientation matrix from a ``[w,x,y,z]`` direction (lin.rs:197-208),
    with ``Mat4f::lookat``'s negated-column quirks and the 3x3 read of
    ``Mat4f * Vec3f`` (lin.rs:356-365)."""
    if up is None:
        up = torch.tensor([0.0, 0.0, 1.0], dtype=dir4.dtype,
                          device=dir4.device)
    fwd = normalize(dir4[..., 1:4])
    right = normalize(cross(fwd, torch.broadcast_to(up, fwd.shape)))
    n_up = cross(right, fwd)
    rows = [
        torch.stack([right[..., 0], -right[..., 1], right[..., 2]], dim=-1),
        torch.stack([-fwd[..., 0], fwd[..., 1], -fwd[..., 2]], dim=-1),
        torch.stack([n_up[..., 0], -n_up[..., 1], n_up[..., 2]], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def matvec(m, v):
    """``(..., 3, 3) @ (..., 3)`` with broadcasting, as explicit component
    arithmetic (no matmul: keeps full float32 and the JAX operation order)."""
    return torch.stack(
        [m[..., i, 0] * v[..., 0] + m[..., i, 1] * v[..., 1]
         + m[..., i, 2] * v[..., 2] for i in range(3)], dim=-1)


def matmul3(a, b):
    """``(..., 3, 3) @ (..., 3, 3)`` with broadcasting, componentwise."""
    rows = [[a[..., i, 0] * b[..., 0, j] + a[..., i, 1] * b[..., 1, j]
             + a[..., i, 2] * b[..., 2, j] for j in range(3)]
            for i in range(3)]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def instance_mat(dir4):
    """Object-space transform ``M = rot_y(-dir) @ lookat(-dir)``; the same
    matrix maps rays world->object and normals object->world (rt.rs:726-733,
    776-793)."""
    neg = -dir4
    return matmul3(rotate_y_mat(neg), lookat_mat(neg))
