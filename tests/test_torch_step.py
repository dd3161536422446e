"""The port's whole trace (plain version of the trace kernel) against the
JAX package: the Pallas whole-trace kernel in interpret mode, and one
bounce against the jnp ``fused_step_reference``, on the same uniforms.

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
from micro_raytracer_tpu_torch.ops import hit3, step
from test_pallas_step import scenes, state
from test_torch_grad import _jax_pack
from torch_port_helpers import outlier_rows, port_scene, rays
from torch_mesh_helpers import one_torch_thread  # noqa: F401

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


@pytest.mark.parametrize("name", ["opaque", "glass_flat", "glass"])
def test_trace_plain_matches_pallas_trace(name, monkeypatch):
    monkeypatch.setenv("MRT_STEP", "1")
    js, ps = _scene(name)
    R, K = 256, 4
    o, d = rays(R, seed=3)
    nu = step.n_uni(ps.any_refract)
    assert nu == jps.n_uni(js.any_refract)
    u8s = np.random.default_rng(4).random((K, nu, R)).astype(np.float32)
    consts, attr, gattr, attr2, lights, tex = _jax_pack(js)
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


@pytest.mark.parametrize("name", ["opaque", "glass_flat", "glass"])
def test_pack_step_matches_jax(name):
    """The row table holds pallas_step's (P, 24) attribute table: its
    columns _C_FR.._C_PR are the sweep columns 0-15, _C_ALB.._C_EMI follow
    valid and gid. A triangle row's normal columns hold its raw normal
    (the attribute table's; the JAX sweep table keeps a vertex there, which
    its triangle sweep never reads), and the triangle table holds
    pallas_tri.pack_consts' AT, HT and thr."""
    js, ps = _scene(name)
    consts, attr, _g, _a2, lights, _tex = _jax_pack(js)
    tables = step.pack_step(ps)
    tab = tables.tab
    assert step._C_ALB == hit3.SWEEP_COLS and tab.shape[1] == step.ROW_COLS
    t_attr = torch.cat([tab[:, :16], tab[:, step._C_ALB:]], dim=1)
    # the JAX tables pad the triangle segment to its kernel's block size
    P = tab.shape[0]
    np.testing.assert_allclose(t_attr.numpy(), np.asarray(attr)[:P],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tables.lights.numpy(), np.asarray(lights),
                               rtol=1e-6, atol=1e-7)
    n_dense = tables.layout[1]
    for k, (got, want) in enumerate(zip(hit3.split_sweep(tab), consts[:6])):
        rows = n_dense if k == 2 else P
        np.testing.assert_allclose(got[:rows].numpy(),
                                   np.asarray(want)[:rows], rtol=1e-6,
                                   atol=1e-7)
    tri = tables.tri.detach().numpy()
    assert tri.shape == (ps.kind_counts[3], hit3.TRI_COLS)
    if tri.shape[0]:
        for got, want in ((tri[:, :9], consts[6]), (tri[:, 9:12], consts[7]),
                          (tri[:, 12:13], consts[8])):
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                       atol=1e-7)


@pytest.mark.parametrize("name", ["opaque", "glass_flat", "glass"])
def test_fused_step_matches_jax_reference(name, monkeypatch):
    """One bounce of the plain trace against the JAX package's jnp bounce
    step, from live rays at unit power with A = 1, B = 0: A/B and
    first_live of a one-step trace, and the next step's input ray from the
    residuals of a two-step trace."""
    monkeypatch.setenv("MRT_HIT3", "0")     # the JAX side stays dense
    js, ps = _scene(name)
    (o, d, _pwr, _live), _A, _B, u, u_emit = state(js)
    R = o.shape[0]
    decay = 0.85
    jfr = ji.build_frames(js)
    ray_j, A_j, B_j, live_j = jtr.fused_step_reference(
        js, jfr, ji.prim_attributes(js, jfr), jnp.float32(decay),
        (o, d, jnp.ones((R,), jnp.float32), jnp.ones((R,), bool)),
        jnp.ones((R, 3), jnp.float32), jnp.zeros((R, 3), jnp.float32), u,
        u_emit)
    u, u_emit = np.asarray(u), np.asarray(u_emit)
    rows = u.T if ps.any_refract else u[:, :3].T
    u8 = np.concatenate([rows, u_emit[None]])[None]
    u8s = torch.from_numpy(np.concatenate([u8, u8]))      # (2, NU, R)
    oT, dT = (torch.from_numpy(np.asarray(x).T.copy()) for x in (o, d))
    tables = step.pack_step(ps)
    A_t, B_t, fl = step.trace_plain(ps, tables, decay, oT, dT, u8s[:1])
    res = step.trace_plain(ps, tables, decay, oT, dT, u8s,
                           want_resid=True)[3]
    live = np.asarray(live_j)
    np.testing.assert_array_equal(fl[0].numpy() > 0.5, live)
    o2 = res[1, step.RES_O:step.RES_O + 3].T.numpy()
    d2 = res[1, step.RES_D:step.RES_D + 3].T.numpy()
    _assert_close_share("o2", o2[live], np.asarray(ray_j[0])[live], R)
    _assert_close_share("d2", d2[live], np.asarray(ray_j[1])[live], R)
    _assert_close_share("A2", A_t.numpy().T, np.asarray(A_j), R)
    _assert_close_share("B2", B_t.numpy().T, np.asarray(B_j), R)


def test_all_dead_input_passes_through():
    """Dead rays pass through: A/B stop changing after a ray's last live
    step (a miss or an emit kill), and a trace of rays that miss everything
    returns A = 1, B = 0, first_live = 0."""
    _js, ps = _scene("opaque")
    tables = step.pack_step(ps)
    oT, dT = (torch.from_numpy(a.T.copy()) for a in rays(128, seed=5))
    u8s = torch.rand((4, step.n_uni(ps.any_refract), 128),
                     generator=torch.Generator().manual_seed(1))
    A4, B4, _fl, _res, n_live = step.trace_plain(ps, tables, 0.85, oT, dT,
                                                 u8s, want_resid=True)
    A2, B2, _fl2 = step.trace_plain(ps, tables, 0.85, oT, dT, u8s[:2])
    dead = n_live <= 2
    assert ((n_live > 0) & dead).any()
    assert torch.equal(A2[:, dead], A4[:, dead])
    assert torch.equal(B2[:, dead], B4[:, dead])

    o = np.tile(np.asarray([[0.0, 0.0, 5.0]], np.float32), (64, 1))
    d = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (64, 1))
    u8s = torch.rand((3, step.n_uni(ps.any_refract), 64),
                     generator=torch.Generator().manual_seed(0))
    A3, B3, fl = step.trace_packed(ps, tables, 0.85,
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
