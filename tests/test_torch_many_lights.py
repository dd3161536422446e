"""Scenes past the per-step kernels' staged lights (``step.STEP_MAX_LIGHTS``
= 2,048 rows of the light table in shared memory, the rest read from
global memory; ``csrc/trace_step.cuh`` LightTab): the per-step route
renders a 2,051-light scene (``chip_smoke.lights_many``: ``lights8``'s
geometry) on an 8 x 8 frame, bounce 2, as the JAX package's jnp path does
(K composed ``tracer.fused_step_reference`` steps, ``MRT_HIT3=0``), within
``test_torch_steps.py``'s rule (rtol 1e-3 / atol 1e-4 on all but 0.5% of
the rays: here every ray), and its launch wrapper no longer refuses the
scene on the card (the launch itself is a card test,
``test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import torch

from chip_smoke import LIGHTS8_CAMERA, lights_many
from micro_raytracer_tpu.models import camera as jcam_mod
from micro_raytracer_tpu.models import compiler as jcomp
from micro_raytracer_tpu.models import schema
from micro_raytracer_tpu.models import tracer as jtr
from micro_raytracer_tpu.ops import intersect as ji
from micro_raytracer_tpu_torch.ops import step
from test_torch_steps import DECAY, _outliers, _unpack
from torch_mesh_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import port_scene


def test_many_lights_match_jax_jnp_path(monkeypatch):
    monkeypatch.setenv("MRT_HIT3", "0")        # the JAX side stays dense
    monkeypatch.setenv("MRT_TRI_PALLAS", "0")
    js = jcomp.compile_scene(schema.SceneConfig.from_json(lights_many()))
    ps = port_scene(js)
    assert ps.n_lights == 2051 > step.STEP_MAX_LIGHTS
    assert step.route(ps, False) == "steps"
    jcam = jcomp.compile_camera(schema.CameraConfig.from_json(
        LIGHTS8_CAMERA))
    xs, ys = np.meshgrid(np.arange(8), np.arange(8))
    coords = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)
    rng = np.random.default_rng(3)
    R, bounce = len(coords), 2
    u_aprt = rng.random((R, 2)).astype(np.float32)
    o, d = (np.asarray(x) for x in jcam_mod.gen_rays(
        jcam, (8, 8), jnp.asarray(coords), jnp.asarray(u_aprt)))
    u8s = rng.random((bounce + 1, step.n_uni(ps.any_refract), R)).astype(
        np.float32)
    fr = ji.build_frames(js)
    at = ji.prim_attributes(js, fr)
    ray = (jnp.asarray(o), jnp.asarray(d), jnp.ones((R,), jnp.float32),
           jnp.ones((R,), bool))
    A, B = jnp.ones((R, 3), jnp.float32), jnp.zeros((R, 3), jnp.float32)
    for k in range(bounce + 1):
        u, ue = _unpack(js, u8s[k])
        ray, A, B, _live = jtr.fused_step_reference(
            js, fr, at, jnp.float32(DECAY), ray, A, B, u, ue)
    tables = step.pack_step(ps)
    before = step.STEP_KERNEL.plain_calls
    A_t, B_t, _fl = step.trace_packed(ps, tables, DECAY,
                                      torch.from_numpy(o.T.copy()),
                                      torch.from_numpy(d.T.copy()),
                                      torch.from_numpy(u8s))
    assert step.STEP_KERNEL.plain_calls == before + bounce + 1
    assert float(np.abs(np.asarray(B)).max()) > 0.05
    bad = _outliers([(A_t.T.numpy(), np.asarray(A)),
                     (B_t.T.numpy(), np.asarray(B))])
    assert not bad.any(), np.nonzero(bad)[0]
