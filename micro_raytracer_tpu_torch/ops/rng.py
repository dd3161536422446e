"""Randomness for path tracing, from an explicit ``torch.Generator``.

The JAX package derives every draw from a counter-based key; here every
draw comes from a generator the caller owns and passes in, so a render is
reproducible for a fixed seed and call sequence. The bits differ from
JAX's: tests hand both sides the same uniforms instead.
"""

from __future__ import annotations

import math

import torch


def make_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g


def uniform(gen: torch.Generator, shape, device) -> torch.Tensor:
    """float32 uniforms in [0, 1) drawn from ``gen`` on ``device``."""
    return torch.rand(shape, generator=gen, device=device,
                      dtype=torch.float32)


def sphere_rand(n, rough, u1, u2):
    """Jittered normal ``normalize(n + rough * uniform_sphere)``
    (``RayTracer::rand``, rt.rs:996-1007) with ``cos th = 1 - 2u`` in place
    of the arccos/cos pair, in the trace kernels' operation order
    (csrc/trace_step.cuh ``sphere_rand``)."""
    ct = torch.clamp(1.0 - 2.0 * u1, -1.0, 1.0)
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    phi = u2 * (2.0 * math.pi)
    v = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)
    w = n + v * rough[..., None]
    m2 = w[..., 0] * w[..., 0] + w[..., 1] * w[..., 1] + w[..., 2] * w[..., 2]
    return w * (1.0 / torch.sqrt(torch.clamp(m2, min=1e-20)))[..., None]
