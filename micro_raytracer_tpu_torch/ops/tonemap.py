"""Framebuffer -> displayable image: gamma, Reinhard tonemap, SSAA resize.

The counterpart of ``micro_raytracer_tpu.ops.tonemap`` (``Sampler::img``,
sampler.rs:80-99), in the reference's order: mean over samples,
``v^gamma``, the Reinhard variant ``v * (1 + v / (1-exp)^2) / (1 + v)``,
quantize to u8 with a saturating cast, then a Lanczos3 resize with
antialiasing from the supersampled resolution to the output resolution —
written to match ``jax.image.resize(method="lanczos3", antialias=True)``.
"""

from __future__ import annotations

import math

import torch


def tonemap(mean_rgb, gamma, exp):
    """Gamma + Reinhard tone mapping on linear radiance (sampler.rs:87-91)."""
    g = torch.pow(torch.clamp(mean_rgb, min=0.0), gamma)
    return g * (1.0 + g / (1.0 - exp) ** 2) / (1.0 + g)


def to_u8(img):
    """``(255 * v) as u8`` with Rust saturating-cast semantics."""
    v = torch.nan_to_num(img * 255.0, nan=0.0, posinf=255.0, neginf=0.0)
    return torch.clamp(v, 0.0, 255.0).to(torch.uint8)


def _lanczos3(x):
    radius = 3.0
    y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
    safe = torch.where(x != 0, math.pi ** 2 * x ** 2, torch.ones_like(x))
    out = torch.where(x > 1e-3, y / safe, torch.ones_like(x))
    return torch.where(x > radius, torch.zeros_like(x), out)


def _weight_mat(in_size: int, out_size: int, device):
    """(in, out) resampling weights of one axis, as jax.image's
    ``compute_weight_mat`` for scale ``out/in`` and no translation."""
    f32 = torch.float32
    # 1/scale in double, then float32 — jax's rounding of the same value
    inv_scale = torch.tensor(1.0 / (out_size / in_size), dtype=f32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)      # antialias
    sample_f = ((torch.arange(out_size, dtype=f32) + 0.5) * inv_scale
                - 0.5)
    x = torch.abs(sample_f[None, :]
                  - torch.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = _lanczos3(x)
    total = torch.sum(w, dim=0, keepdim=True)
    eps = float(torch.finfo(torch.float32).eps)
    w = torch.where(torch.abs(total) > 1000.0 * eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = torch.where(inside[None, :], w, torch.zeros_like(w))
    return w.to(device)


def lanczos3_resize(img, out_hw):
    """(H, W, C) float32 -> (h, w, C), Lanczos3 with antialiasing."""
    H, W = img.shape[:2]
    h, w = out_hw
    out = img
    if h != H:
        out = torch.einsum("hwc,hk->kwc", out, _weight_mat(H, h, img.device))
    if w != W:
        out = torch.einsum("hwc,wk->hkc", out, _weight_mat(W, w, img.device))
    return out


def finalize(accum, count, gamma, exp, out_wh):
    """Accumulated (H, W, 3) sums + count -> tonemapped, resized u8 image:
    tonemap and quantize at the supersampled resolution, then resize the
    8-bit image (sampler.rs:85-98)."""
    mapped = to_u8(tonemap(accum / count, gamma, exp))
    w, h = out_wh
    if tuple(mapped.shape[:2]) != (h, w):
        res = lanczos3_resize(mapped.to(torch.float32), (h, w))
        mapped = torch.clamp(torch.round(res), 0.0, 255.0).to(torch.uint8)
    return mapped
