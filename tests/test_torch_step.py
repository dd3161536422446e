"""The port's whole trace (plain version of the trace kernel) and its
bounce step against the JAX package: the Pallas whole-trace kernel in
interpret mode and the jnp ``fused_step_reference``, on the same uniforms.

Tolerance: rtol 1e-3 / atol 1e-4 (as test_step_kernel_full_trace_matches),
on all but at most 0.5% of rays: a float32 rounding difference can flip a
sampling branch (``u < 0.8``, ``k >= 0``, a grazing hit), and that ray's
path then differs. The outliers are printed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micro_raytracer_tpu.models import compiler as jcomp
from micro_raytracer_tpu.models import schema
from micro_raytracer_tpu.models import tracer as jtr
from micro_raytracer_tpu.ops import intersect as ji
from micro_raytracer_tpu.ops import pallas_step as jps
from micro_raytracer_tpu_torch.models import tracer as ttr
from micro_raytracer_tpu_torch.ops import intersect as ti
from micro_raytracer_tpu_torch.ops import hit3, step
from test_pallas_step import scenes, state
from torch_port_helpers import outlier_rows, port_scene, rays

RTOL, ATOL, SHARE = 1e-3, 1e-4, 0.005


def _scene(name):
    js = jcomp.compile_scene(schema.SceneConfig.from_json(scenes()[name]))
    return js, port_scene(js)


def _assert_close_share(name, got, want, n_rays):
    bad = outlier_rows(got, want, RTOL, ATOL)
    if len(bad):
        print(f"{name}: {len(bad)} of {n_rays} rays outside tolerance:",
              bad[:20])
    assert len(bad) <= SHARE * n_rays, (name, len(bad))


@pytest.mark.parametrize("name", ["opaque", "glass_flat"])
def test_trace_plain_matches_pallas_trace(name, monkeypatch):
    monkeypatch.setenv("MRT_STEP", "1")
    js, ps = _scene(name)
    R, K = 256, 4
    o, d = rays(R, seed=3)
    nu = step.n_uni(ps.any_refract)
    assert nu == jps.n_uni(js.any_refract)
    u8s = np.random.default_rng(4).random((K, nu, R)).astype(np.float32)
    jfr = ji.build_frames(js)
    consts, attr, gattr, attr2, lights, tex = jps.pack_step(js, jfr, None)
    A_j, B_j, fl_j = jps.trace_packed(
        js, consts, attr, lights, jnp.float32(0.85), jnp.asarray(o.T),
        jnp.asarray(d.T), jnp.asarray(u8s), tex=tex, inference=True,
        gattr=gattr, attr2=attr2)
    A, B, fl = step.trace_packed(
        ps, step.pack_step(ps), ttr.decay_of(0.15),
        torch.from_numpy(o.T.copy()), torch.from_numpy(d.T.copy()),
        torch.from_numpy(u8s))
    assert np.asarray(fl_j).sum() > 0.3 * R
    np.testing.assert_array_equal(fl.numpy(), np.asarray(fl_j))
    _assert_close_share("A", A.numpy().T, np.asarray(A_j).T, R)
    _assert_close_share("B", B.numpy().T, np.asarray(B_j).T, R)


@pytest.mark.parametrize("name", ["opaque", "glass_flat"])
def test_pack_step_matches_jax(name):
    """The row table holds pallas_step's (P, 24) attribute table: its
    columns _C_FR.._C_PR are the sweep columns 0-15, _C_ALB.._C_EMI follow
    valid and gid."""
    js, ps = _scene(name)
    consts, attr, _g, _a2, lights, _tex = jps.pack_step(
        js, ji.build_frames(js), None)
    tables = step.pack_step(ps)
    tab = tables.tab
    assert step._C_ALB == hit3.SWEEP_COLS and tab.shape[1] == step.ROW_COLS
    t_attr = torch.cat([tab[:, :16], tab[:, step._C_ALB:]], dim=1)
    np.testing.assert_allclose(t_attr.numpy(), np.asarray(attr), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tables.lights.numpy(), np.asarray(lights),
                               rtol=1e-6, atol=1e-7)
    for got, want in zip(hit3.split_sweep(tab), consts[:6]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("name", ["opaque", "glass_flat"])
def test_fused_step_matches_jax_reference(name, monkeypatch):
    monkeypatch.setenv("MRT_HIT3", "0")     # the JAX side stays dense
    js, ps = _scene(name)
    ray, A, B, u, u_emit = state(js)
    decay = 0.85
    jfr = ji.build_frames(js)
    ray_j, A_j, B_j, live_j = jtr.fused_step_reference(
        js, jfr, ji.prim_attributes(js, jfr), jnp.float32(decay), ray, A, B,
        u, u_emit)
    tt = [torch.tensor(np.asarray(x)) for x in ray]
    pfr = ti.build_frames(ps)
    ray_t, A_t, B_t, live_t = ttr.fused_step_reference(
        ps, pfr, ti.prim_attributes(ps, pfr), decay, tuple(tt),
        *(torch.tensor(np.asarray(x)) for x in (A, B, u, u_emit)))
    live = np.asarray(live_j)
    np.testing.assert_array_equal(live_t.numpy(), live)
    R = len(live)
    _assert_close_share("o2", ray_t[0].numpy()[live],
                        np.asarray(ray_j[0])[live], R)
    _assert_close_share("d2", ray_t[1].numpy()[live],
                        np.asarray(ray_j[1])[live], R)
    np.testing.assert_allclose(ray_t[2].numpy(), np.asarray(ray_j[2]),
                               rtol=1e-6)
    _assert_close_share("A2", A_t.numpy(), np.asarray(A_j), R)
    _assert_close_share("B2", B_t.numpy(), np.asarray(B_j), R)


def test_all_dead_input_passes_through():
    """Dead rays: A/B unchanged, pwr decays, live stays false; a trace of
    rays that miss everything returns A = 1, B = 0, first_live = 0."""
    js, ps = _scene("opaque")
    ray, A, B, u, u_emit = state(js, n=128, seed=5)
    to_t = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    ray_t = (to_t(ray[0]), to_t(ray[1]), to_t(ray[2]),
             torch.zeros(128, dtype=torch.bool))
    pfr = ti.build_frames(ps)
    ray2, A2, B2, live2 = ttr.fused_step_reference(
        ps, pfr, ti.prim_attributes(ps, pfr), 0.85, ray_t, to_t(A), to_t(B),
        to_t(u), to_t(u_emit))
    assert not live2.any() and not ray2[3].any()
    assert torch.equal(A2, to_t(A)) and torch.equal(B2, to_t(B))
    torch.testing.assert_close(ray2[2], to_t(ray[2]) * 0.85)

    o = np.tile(np.asarray([[0.0, 0.0, 5.0]], np.float32), (64, 1))
    d = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (64, 1))
    u8s = torch.rand((3, step.n_uni(ps.any_refract), 64),
                     generator=torch.Generator().manual_seed(0))
    A3, B3, fl = step.trace_packed(ps, step.pack_step(ps), 0.85,
                                   torch.from_numpy(o.T.copy()),
                                   torch.from_numpy(d.T.copy()), u8s)
    assert torch.equal(A3, torch.ones_like(A3))
    assert torch.equal(B3, torch.zeros_like(B3))
    assert not fl.any()


@pytest.mark.parametrize("refract", [False, True])
def test_unpack_uniforms_layout(refract):
    """Opaque scenes pack [u0 u1 u2 u_emit], refractive ones [u0..u6 u_emit]
    (pallas_step.n_uni): u_emit is never read from slot 7 when NU = 4."""
    nu = step.n_uni(refract)
    u8 = torch.arange(nu * 5, dtype=torch.float32).reshape(nu, 5)
    u, ue = step.unpack_uniforms(u8, refract)
    assert u.shape == (5, 7)
    assert torch.equal(ue, u8[nu - 1])
    assert torch.equal(u[:, :3], u8[:3].T)
    if not refract:
        assert torch.equal(u[:, 3:], torch.zeros(5, 4))


def _cpu_hit0(n):
    return (torch.zeros(n), torch.zeros(n, dtype=torch.int32),
            torch.zeros(n), torch.zeros(n, dtype=torch.int32))


def test_kernel_wrapper_takes_only_cuda_tensors():
    _js, ps = _scene("opaque")
    o, d = rays(8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        step.trace_fwd(ps, step.pack_step(ps), 0.85,
                       torch.from_numpy(o.T.copy()),
                       torch.from_numpy(d.T.copy()),
                       torch.zeros((2, 4, 8)), _cpu_hit0(8))


def test_more_than_four_lights_rejected():
    """The kernel's bound of 4 lights is checked before anything crosses
    into C; the plain path has no such bound."""
    cfg = dict(scenes()["opaque"])
    cfg["light"] = [{"type": "point", "pos": [0, -1, i]} for i in range(5)]
    ps = port_scene(jcomp.compile_scene(schema.SceneConfig.from_json(cfg)))
    tables = step.pack_step(ps)
    o, d = (torch.from_numpy(a.T.copy()) for a in rays(8))
    u8s = torch.zeros((2, 4, 8))
    with pytest.raises(ValueError, match="lights"):
        step.trace_fwd(ps, tables, 0.85, o, d, u8s, _cpu_hit0(8))
    A, _B, _fl = step.trace_packed(ps, tables, 0.85, o, d, u8s)
    assert A.shape == (3, 8)
