"""The port's gradients against the JAX package's whole-trace custom VJP
(one trace; the whole slice by scene leaf is in ``test_torch_grad_slice.py``).

The JAX side runs ``pallas_step.trace_packed`` (its train-mode forward
kernel and the whole-trace backward kernel, in interpret mode on the CPU);
the port side is torch autograd through the plain trace
(``step.trace_plain``), which is what a CPU tensor takes. Inputs and
cotangents come from numpy seeds and are handed to both sides.

Tolerances:

* paths: a ray whose discrete path differs between the two sides — a
  winner row, an occlusion bit, a refract choice or its count of live
  steps, read from both sides' training residuals — took another branch
  through a float32 rounding flip (``u < 0.8``, ``k >= 0``, a shadow ray
  grazing an edge). Its value may still agree (an occluded light at a
  grazing hit contributes ~1e-6) while its derivative does not (a hit 3e5
  away on a nearly parallel plane scales it by t/dn ~ 1e11). Such rays get
  a zero cotangent on both sides, or in the slice tests are replaced by a
  copy of another ray, so summed gradients compare like with like; at most
  0.5% of rays may flip. The forward is also held to rtol 1e-3 / atol 1e-4
  (as ``test_torch_step.py``) on the other rays;
* gradients: rtol 2e-3 and an absolute floor of 1e-5 of the largest
  magnitude of the compared array. The JAX package's own gate between its
  kernel and its jnp gradients is rtol 1e-3 / atol 1e-6 on leaf sums; here
  the two sides' forwards also differ (sin/cos and sums round differently:
  up to 3e-5 in the refractive scene's radiance), and one refracted
  instance-position entry measured 1.1e-3. The floor covers entries that
  are sums of terms of opposite sign;
* residuals: rtol 1e-4 / atol 1e-5 on the rows both layouts hold, on the
  live steps of rays inside the forward tolerance; rows, choices and
  occlusion bits equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micro_raytracer_tpu.models import compiler as jcomp
from micro_raytracer_tpu.models import schema
from micro_raytracer_tpu.ops import intersect as ji
from micro_raytracer_tpu.ops import pallas_step as jps
from micro_raytracer_tpu_torch.models import tracer as ttr
from micro_raytracer_tpu_torch.ops import hit3, step
from micro_raytracer_tpu_torch.parallel import shard
from test_pallas_step import scenes
from torch_port_helpers import outlier_rows, port_scene, rays
from torch_mesh_helpers import one_torch_thread  # noqa: F401

FWD_RTOL, FWD_ATOL = 1e-3, 1e-4
G_RTOL, G_FLOOR = 2e-3, 1e-5
R, K = 256, 4
DECAY = ttr.decay_of(0.15)
SCENES = ["opaque", "glass_flat"]


@functools.lru_cache(maxsize=None)
def _scene(name):
    js = jcomp.compile_scene(schema.SceneConfig.from_json(scenes()[name]))
    return js, port_scene(js)


def _assert_grad_close(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.all(np.isfinite(got)), f"{name}: non-finite"
    atol = G_FLOOR * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=G_RTOL, atol=atol,
                               err_msg=name)


def _uniforms(js, n, k, seed):
    return np.random.default_rng(seed).random(
        (k, jps.n_uni(js.any_refract), n)).astype(np.float32)


def _bad_rays(pairs):
    """(R,) bool: rays outside the forward tolerance in any (C, R) pair."""
    bad = np.zeros(pairs[0][0].shape[-1], bool)
    for got, want in pairs:
        bad[outlier_rows(np.asarray(got).T, np.asarray(want).T, FWD_RTOL,
                         FWD_ATOL)] = True
    return bad


def _jax_pack(js):
    """pallas_step.pack_step of a JAX scene, with its triangles' Woop
    transforms when it has any."""
    fr = ji.build_frames(js)
    return jps.pack_step(js, fr, ji.triangle_pack(js, fr)
                         if js.kind_counts[schema.KIND_TRIANGLE] else None)


def _same_row(ps):
    """Refractive scenes without triangles keep the refract choice in the
    JAX residuals' xrow row (every group is one row)."""
    return ps.any_refract and not ps.kind_counts[schema.KIND_TRIANGLE]


def _resid_j(js, oT, dT, u8s):
    """The JAX train-mode forward: (A, B, first_live, residuals)."""
    consts, attr, gattr, attr2, lights, _tex = _jax_pack(js)
    out = jps._call_trace(
        jps._seg_layout(js.kind_counts), js.any_refract, js.n_lights,
        u8s.shape[0], consts, attr, lights, jnp.float32(DECAY),
        jnp.asarray(oT), jnp.asarray(dT), jnp.asarray(u8s), train=True,
        gattr=gattr, attr2=attr2)
    return tuple(np.asarray(x) for x in out)


def _path_flips(ps, res, n_live, res_j):
    """(R,) bool: rays whose discrete path differs between the port's
    residuals (res, n_live) and the JAX package's (res_j)."""
    k_ax = np.arange(res.shape[0])[:, None]
    hit_j = (res_j[:, 7] > 0.5) & (res_j[:, jps._R_TE] < 1e38)
    flip = hit_j.sum(0) != n_live
    live = k_ax < n_live[None]
    cols = [(step.RES_ROW, jps._R_ROW)]
    cols += [(step.RES_LOK + li, jps._R_LOK + li)
             for li in range(ps.n_lights)]
    if _same_row(ps):
        cols.append((step.RES_CHOOSE, jps._R_XROW))
    elif ps.any_refract:
        cols.append((step.res_xrow(ps.n_lights), jps._R_XROW))
    for mine, theirs in cols:
        flip |= (live & (res[:, mine] != res_j[:, theirs])).any(0)
    return flip


@functools.lru_cache(maxsize=None)
def _module_fwd(name):
    """Both sides' training forwards on R random rays: (inputs, JAX
    (A, B, first_live, residuals), port (A, B, first_live, residuals,
    n_live))."""
    js, ps = _scene(name)
    o, d = rays(R, seed=3)
    u8s = _uniforms(js, R, K, seed=4)
    port = step.trace_plain(
        ps, step.pack_step(ps), DECAY, torch.from_numpy(o.T.copy()),
        torch.from_numpy(d.T.copy()), torch.from_numpy(u8s),
        want_resid=True)
    return (o, d, u8s), _resid_j(js, o.T, d.T, u8s), port


@functools.lru_cache(maxsize=None)
def _module_case(name):
    """Both sides' trace gradients for random ctA/ctB (outliers zeroed):
    JAX's for (attr, lights, oT, dT, AT, HT), the port's for (tab, lights,
    oT, dT, tri)."""
    js, ps = _scene(name)
    (o, d, u8s), (_A, _B, _f, res_j), (A_t, B_t, _fl, res, n_live) = \
        _module_fwd(name)
    consts, attr, gattr, attr2, lights, tex = _jax_pack(js)

    def f(attr, lights, oT, dT, AT, HT):
        c = consts[:6] + (AT, HT) + consts[8:]
        A, B, _fl = jps.trace_packed(
            js, c, attr, lights, jnp.float32(DECAY), oT, dT,
            jnp.asarray(u8s), tex=tex, inference=False, gattr=gattr,
            attr2=attr2)
        return A, B

    (A_j, B_j), vjp = jax.vjp(f, attr, lights, jnp.asarray(o.T),
                              jnp.asarray(d.T), consts[6], consts[7])
    tables = step.pack_step(ps)
    oT, dT = (torch.from_numpy(a.T.copy()) for a in (o, d))
    bad = _path_flips(ps, res.numpy(), n_live.numpy(), res_j)
    assert bad.sum() <= 0.005 * R
    assert not _bad_rays([(A_t[:, ~bad], A_j[:, ~bad]),
                          (B_t[:, ~bad], B_j[:, ~bad])]).any()
    rng = np.random.default_rng(5)
    ct = [rng.normal(size=(3, R)).astype(np.float32) for _ in range(2)]
    for c in ct:
        c[:, bad] = 0.0
    g_j = vjp((jnp.asarray(ct[0]), jnp.asarray(ct[1])))
    g_t = step.trace_bwd_plain(ps, tables, DECAY, oT, dT,
                               torch.from_numpy(u8s),
                               *(torch.from_numpy(c) for c in ct))
    return bad, g_j, g_t


@pytest.mark.parametrize("name", SCENES)
def test_trace_grad_matches_pallas_vjp(name):
    """d_attr (on the port's columns), d_lights, d_oT and d_dT of one trace
    for the same cotangents."""
    check_trace_grad(name)


def check_trace_grad(name):
    bad, (d_attr, d_lights, d_oT, d_dT, _dAT, _dHT), g_t = _module_case(name)
    print(f"{name}: {int(bad.sum())} of {R} rays took another path")
    d_tab, d_lt, d_oT_t, d_dT_t = (g.numpy() for g in g_t[:4])
    port_attr = np.concatenate([d_tab[:, :16], d_tab[:, step._C_ALB:]], 1)
    # the JAX table pads the triangle segment to its kernel's block size
    d_attr = np.asarray(d_attr)
    assert not d_attr[len(d_tab):].any()
    d_attr = d_attr[:len(d_tab)]
    assert np.abs(d_attr).max() > 0
    _assert_grad_close("d_attr", port_attr, d_attr)
    np.testing.assert_array_equal(d_tab[:, 16:18], 0.0)  # valid, gid
    _assert_grad_close("d_lights", d_lt, d_lights)
    _assert_grad_close("d_oT", d_oT_t, d_oT)
    _assert_grad_close("d_dT", d_dT_t, d_dT)


@pytest.mark.parametrize("name", SCENES)
def test_resid_matches_pallas_train_mode(name):
    """trace_plain(want_resid=True) against the JAX train-mode residual
    block (_call_trace with train=True) on the rows both layouts hold."""
    check_resid(name)


def check_resid(name):
    _js, ps = _scene(name)
    _ins, (A_j, B_j, _f, res_j), (A, B, _fl, res, n_live) = \
        _module_fwd(name)
    res, n_live = res.numpy(), n_live.numpy()
    assert res.shape == (K, step.res_rows(ps.n_lights, ps.kind_sweep[3]), R)
    flips = _path_flips(ps, res, n_live, res_j)
    assert flips.sum() <= 0.005 * R
    good = ~flips & ~_bad_rays([(A, A_j), (B, B_j)])
    live = (np.arange(K)[:, None] < n_live[None]) & good[None]
    assert live.sum() > R // 4
    # every live step was live in the JAX carry
    assert np.all(res_j[:, 7][live] > 0.5)
    pairs = [(step.RES_O + c, c) for c in range(3)]          # o
    pairs += [(step.RES_D + c, 3 + c) for c in range(3)]     # d
    pairs += [(step.RES_A + c, 8 + c) for c in range(3)]     # A
    pairs += [(step.RES_TE, jps._R_TE), (step.RES_TX, jps._R_TX)]
    for mine, theirs in pairs:
        np.testing.assert_allclose(res[:, mine][live], res_j[:, theirs][live],
                                   rtol=1e-4, atol=1e-5, err_msg=str(mine))
    exact = [(step.RES_ROW, jps._R_ROW)]
    exact += [(step.RES_LOK + li, jps._R_LOK + li)
              for li in range(ps.n_lights)]
    if _same_row(ps):
        exact.append((step.RES_CHOOSE, jps._R_XROW))
    elif ps.any_refract:
        exact.append((step.res_xrow(ps.n_lights), jps._R_XROW))
    for mine, theirs in exact:
        np.testing.assert_array_equal(res[:, mine][live],
                                      res_j[:, theirs][live], err_msg=str(mine))


def test_train_step_one_device_only():
    with pytest.raises(ValueError, match="multi-device not yet ported"):
        shard.make_train_step((8, 8), 1, device="cpu", n_devices=2)


def test_params_from_numpy_leaves():
    js, ps = _scene("opaque")
    p = shard.params_from_numpy(
        {k: np.asarray(getattr(js, k)) for k in shard.TRAINABLE_FIELDS},
        "cpu")
    assert set(p) == set(shard.TRAINABLE_FIELDS)
    for k, v in p.items():
        assert v.is_leaf and v.requires_grad and v.dtype == torch.float32
        np.testing.assert_array_equal(v.detach().numpy(),
                                      getattr(ps, k).numpy())


# --- dispatch -----------------------------------------------------------------

def _cpu_hit0(n):
    return (torch.zeros(n), torch.zeros(n, dtype=torch.int32),
            torch.zeros(n), torch.zeros(n, dtype=torch.int32))


def test_train_kernel_wrappers_take_only_cuda_tensors():
    _js, ps = _scene("glass_flat")
    tables = step.pack_step(ps)
    o, d = (torch.from_numpy(a.T.copy()) for a in rays(8))
    u8s = torch.zeros((2, 8, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        step.trace_fwd_train(ps, tables, DECAY, o, d, u8s, _cpu_hit0(8))
    resid = torch.zeros((2, step.res_rows(ps.n_lights), 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        step.trace_bwd(ps, tables, DECAY, u8s, resid,
                       torch.zeros(8, dtype=torch.int32), torch.zeros(3, 8),
                       torch.zeros(3, 8))


def test_cpu_grad_trace_never_launches_a_kernel():
    """A CPU trace under autograd runs the plain version, and autograd
    differentiates it: no kernel counter moves."""
    _js, ps = _scene("glass_flat")
    kernels = (hit3.KERNEL, step.KERNEL, step.TRAIN_KERNEL, step.BWD_KERNEL)
    before = [k.launches for k in kernels]
    plain = step.KERNEL.plain_calls
    params = {"mat_albedo": ps.mat_albedo.clone().requires_grad_(True)}
    s = shard.merge_params(ps, params)
    o, d = (torch.from_numpy(a.T.copy()) for a in rays(64))
    u8s = torch.rand((3, 8, 64), generator=torch.Generator().manual_seed(1))
    A, B, _fl = step.trace_packed(s, step.pack_step(s), DECAY, o, d, u8s)
    (A.sum() + B.sum()).backward()
    assert [k.launches for k in kernels] == before
    assert step.KERNEL.plain_calls == plain + 1
    assert float(params["mat_albedo"].grad.abs().sum()) > 0


def test_train_entry_point_runs_on_cpu(capsys):
    """``python -m micro_raytracer_tpu_torch.parallel.shard --device cpu``:
    one JSON line per step with a finite loss, then the fitted leaves."""
    import json

    assert shard.main(["--device", "cpu", "--res", "8", "--bounce", "2",
                       "--steps", "2", "--target-spp", "2"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["step"] for x in lines[:2]] == [0, 1]
    assert all(np.isfinite(x["loss"]) for x in lines[:2])
    assert set(lines[2]) == {"mat_albedo", "light_pwr"}
