"""The port's record path (``tracer.trace_records`` / ``shade_records``
through ``hit3.ClosestHit``) against the JAX package's
``trace_radiance(fused=False)``, and against the port's own fused path.

The JAX side runs its record path with ``MRT_HIT3=1`` (pallas_hit3's
kernel and its custom VJP in interpret mode, as
``tests/test_pallas_hit3.py`` runs it), or for a mesh past 256 cull blocks
with ``MRT_HIT3=0 MRT_TRI_PALLAS=1 MRT_TRI_PALLAS_MIN=1`` (pallas_tri's
kernels, as ``tests/test_torch_tri.py``). The port side gets the exact
uniforms the JAX side draws for one key (``test_torch_render``).

Tolerances (those of ``test_torch_grad.py``):

* radiance rtol 1e-3 / atol 1e-4 on all but at most 0.5% of pixels;
* gradients of every trainable leaf rtol 2e-3 with an absolute floor of
  1e-5 of the largest magnitude. A ray whose path differs between the two
  sides (a float32 rounding flip of a branch: its live mask, occlusion
  bits or chosen point differ at some bounce, read from both sides'
  records, or its radiance is outside tolerance) gets a zero cotangent on
  both sides; at most 0.5% of rays may.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import box_grid
from micro_raytracer_tpu.models import camera as jcam_mod
from micro_raytracer_tpu.models import compiler as jcomp
from micro_raytracer_tpu.models import schema
from micro_raytracer_tpu.models import tracer as jtr
from micro_raytracer_tpu.ops import intersect as ji
from micro_raytracer_tpu_torch.frontends import cli as tcli
from micro_raytracer_tpu_torch.models import camera as tcam_mod
from micro_raytracer_tpu_torch.models import tracer as ttr
from micro_raytracer_tpu_torch.ops import hit3, step
from micro_raytracer_tpu_torch.parallel import shard
from test_pallas_step import scenes
from test_torch_grad import _assert_grad_close
from test_torch_render import _jax_uniforms
from torch_mesh_helpers import big_mesh, one_torch_thread  # noqa: F401
from torch_port_helpers import outlier_rows, port_camera, port_scene

RTOL, ATOL = 1e-3, 1e-4
FLIP_SHARE = 0.005
LOSS = 0.15
CAM = {"pos": [0, -2, 0], "aprt": 0.05, "foc": 2.0}
# the JAX package's routes: its record path's closest hit through
# pallas_hit3 (interpret mode), or a big mesh's through pallas_tri
HIT3_ENV = {"MRT_HIT3": "1"}
TRI_ENV = {"MRT_HIT3": "0", "MRT_TRI_PALLAS": "1", "MRT_TRI_PALLAS_MIN": "1"}


def _source(name):
    if name == "big_glass":
        return big_mesh(glass=True)
    if name == "box_grid":
        return box_grid((46, 46))
    return scenes()[name]


CASES = {
    # name: (side of the square frame, bounce, the JAX route)
    "opaque": (16, 3, HIT3_ENV), "glass": (16, 3, HIT3_ENV),
    "glass_flat": (16, 3, HIT3_ENV), "textured": (16, 3, HIT3_ENV),
    "textured_flat": (16, 3, HIT3_ENV),
    # past 2,048 dense rows: 2,116 boxes and a plane
    "box_grid": (8, 2, HIT3_ENV),
    # a refractive mesh past 256 cull blocks (16,448 triangles)
    "big_glass": (8, 2, TRI_ENV),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    side, bounce, env = CASES[name]
    js = jcomp.compile_scene(schema.SceneConfig.from_json(_source(name)))
    jc = jcomp.compile_camera(schema.CameraConfig.from_json(CAM))
    ys, xs = np.divmod(np.arange(side * side), side)
    coords = np.stack([xs * (64 // side) + 1, ys * (64 // side) + 1],
                      -1).astype(np.float32)
    key = jax.random.PRNGKey(5)
    u_aprt, u8s = _jax_uniforms(key, coords.shape[0], bounce, js.any_refract)
    return js, port_scene(js), jc, coords, key, u_aprt, u8s, bounce, env


def _with_env(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def _jax_fn(name):
    """The JAX record path's radiance as a function of the trainable
    leaves, and its records (for the path flips)."""
    js, _ps, jc, coords, key, _ua, _u8, bounce, _env = _case(name)
    params = {k: getattr(js, k) for k in shard.TRAINABLE_FIELDS}

    def rad_fn(p):
        return jtr.trace_radiance(dataclasses.replace(js, **p), jc, (64, 64),
                                  bounce, jnp.float32(LOSS),
                                  jnp.asarray(coords), key, fused=False)

    _kc, k_trace, _ks = jax.random.split(key, 3)
    orig, dirs = jcam_mod.gen_rays(jc, (64, 64), jnp.asarray(coords),
                                   jnp.asarray(_case(name)[5]))
    fr = ji.build_frames(js)
    tp = ji.triangle_pack(js, fr) if ji._use_tri_mxu(
        js.kind_counts[schema.KIND_TRIANGLE]) else None
    recs = jtr.trace_records(js, fr, ji.prim_attributes(js, fr), bounce,
                             orig, dirs, jnp.float32(LOSS), k_trace,
                             tri_pack=tp)
    return params, rad_fn, {k: np.asarray(v) for k, v in recs.items()}


def _port_records(ps, cam, coords, u_aprt, u8s, bounce):
    with torch.no_grad():
        orig, dirs = tcam_mod.gen_rays(cam, (64, 64), coords, u_aprt)
        return ttr.trace_records(ps, step.pack_step(ps), bounce, orig, dirs,
                                 LOSS, u8s)


def _flips(recs_t, recs_j, rad, rad_j):
    """(R,) bool: rays whose path differs between the two sides."""
    bad = np.zeros(rad.shape[0], bool)
    bad[outlier_rows(rad, rad_j, RTOL, ATOL)] = True
    for i, rec in enumerate(recs_t):
        live, live_j = rec["live"].numpy(), recs_j["live"][i]
        bad |= live != live_j
        bad |= (rec["light_ok"].numpy() != recs_j["light_ok"][i]).any(1)
        both = live & live_j
        p = np.where(both[:, None], rec["p"].numpy(), 0.0)
        p_j = np.where(both[:, None], recs_j["p"][i], 0.0)
        bad[outlier_rows(p, p_j, RTOL, ATOL)] = True
    return bad


def _port_inputs(name):
    js, ps, jc, coords, _key, u_aprt, u8s, bounce, _env = _case(name)
    params = shard.params_from_numpy(
        {k: np.asarray(getattr(js, k)) for k in shard.TRAINABLE_FIELDS},
        "cpu")
    return (ps, params, port_camera(jc), torch.from_numpy(coords),
            torch.from_numpy(u_aprt), torch.from_numpy(u8s), bounce)


@pytest.mark.parametrize("name", sorted(CASES))
def test_record_path_matches_jax(name, monkeypatch):
    """Radiance and every trainable leaf's gradient of the port's record
    path against the JAX package's, on the same uniforms."""
    _with_env(monkeypatch, _case(name)[-1])
    params_j, rad_fn, recs_j = _jax_fn(name)
    rad_j, vjp = jax.vjp(rad_fn, params_j)
    rad_j = np.asarray(rad_j)
    ps, params, cam, coords, u_aprt, u8s, bounce = _port_inputs(name)
    rad = ttr.trace_radiance_u(shard.merge_params(ps, params), cam,
                               (64, 64), bounce, LOSS, coords, u_aprt, u8s,
                               fused=False)
    R = rad.shape[0]
    assert rad_j.max() > 0 and torch.isfinite(rad).all()
    recs = _port_records(ps, cam, coords, u_aprt, u8s, bounce)
    flips = _flips(recs, recs_j, rad.detach().numpy(), rad_j)
    if flips.any():
        print(f"{name}: {int(flips.sum())} of {R} rays flip:",
              np.nonzero(flips)[0][:20])
    assert flips.sum() <= FLIP_SHARE * R
    w = np.random.default_rng(3).standard_normal((R, 3)).astype(np.float32)
    w[flips] = 0.0
    (rad * torch.from_numpy(w)).sum().backward()
    (g_j,) = vjp(jnp.asarray(w))
    assert float(np.abs(np.asarray(g_j["mat_albedo"])).max()) > 0
    for k in shard.TRAINABLE_FIELDS:
        g = params[k].grad
        assert g is not None, k
        _assert_grad_close(k, g.numpy(), g_j[k])


@pytest.mark.parametrize("name", ["opaque", "glass", "textured",
                                  "glass_flat"])
def test_record_path_matches_the_fused_path(name):
    """The record path and the fused path on the same uniforms: radiance
    within tolerance (float reassociation of the fold), the same rays hit
    at the first bounce, and the same gradients."""
    ps, params, cam, coords, u_aprt, u8s, bounce = _port_inputs(name)
    s = shard.merge_params(ps, params)
    out = {}
    for fused in (True, False):
        rad = ttr.trace_radiance_u(s, cam, (64, 64), bounce, LOSS, coords,
                                   u_aprt, u8s, fused=fused)
        g = torch.autograd.grad(rad.sum(), list(params.values()),
                                allow_unused=True)
        out[fused] = (rad.detach().numpy(), g)
    R = coords.shape[0]
    bad = outlier_rows(out[False][0], out[True][0], RTOL, ATOL)
    assert len(bad) <= FLIP_SHARE * R
    for k, a, b in zip(params, out[False][1], out[True][1]):
        if b is None:
            assert a is None or not a.any(), k
            continue
        _assert_grad_close(k, a.numpy(), b.numpy())


def test_no_fuse_reaches_the_record_path(monkeypatch, tmp_path):
    """MRT_NO_FUSE=1 sends the CLI's render and make_train_step through the
    record path (hit3's plain closest hit per bounce and its plain VJP, no
    plain whole trace); remat gives the same loss and gradients."""
    monkeypatch.setenv("MRT_NO_FUSE", "1")
    ps, params, cam, coords, u_aprt, u8s, bounce = _port_inputs("glass")
    counts = (hit3.KERNEL, hit3.BWD_KERNEL, step.KERNEL, step.TRAIN_KERNEL)
    before = [k.plain_calls for k in counts]
    out = tmp_path / "o.png"
    argv = ["--obj", "sphere", "r:", "0.4", "--light", "point:", "-0.5",
            "-1", "0.5", "--res", "8", "8", "--sample", "1", "--bounce",
            "2", "--device", "cpu", "-o", str(out)]
    assert tcli.main(argv) == 0 and out.exists()
    got = [k.plain_calls - b for k, b in zip(counts, before)]
    # three bounces, each a closest hit and a shadow query
    assert got[0] >= 6 and got[2:] == [0, 0], got
    target = torch.rand((coords.shape[0], 3),
                        generator=torch.Generator().manual_seed(2))
    res = {}
    for remat in (False, True):
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
        ts = shard.make_train_step((64, 64), bounce, device="cpu",
                                   remat=remat)
        before = [k.plain_calls for k in counts]
        loss, _new = ts.step_u(p, ps, cam, LOSS, coords, target, u_aprt, u8s)
        got = [k.plain_calls - b for k, b in zip(counts, before)]
        assert got[1] > 0 and got[2:] == [0, 0], got
        res[remat] = (float(loss), {k: v.grad.clone() for k, v in p.items()
                                    if v.grad is not None})
    assert res[False][0] == res[True][0]
    assert res[False][1].keys() == res[True][1].keys()
    for k in res[False][1]:
        assert torch.equal(res[False][1][k], res[True][1][k]), k
    monkeypatch.delenv("MRT_NO_FUSE")
    rad = ttr.trace_radiance_u(shard.merge_params(ps, params), cam, (64, 64),
                               bounce, LOSS, coords, u_aprt, u8s)
    loss_f = float(torch.mean((rad.detach() - target) ** 2))
    np.testing.assert_allclose(res[False][0], loss_f, rtol=1e-4)


def test_http_renders_on_the_record_path(monkeypatch):
    """The HTTP service's render (``http.render_jpeg``) reaches the record
    path under MRT_NO_FUSE=1 (its trace_radiance reads the variable at each
    call): a JPEG, hit3's plain closest hit, no plain whole trace."""
    from micro_raytracer_tpu_torch.frontends import http

    monkeypatch.setenv("MRT_NO_FUSE", "1")
    body = json.dumps({
        "rt": {"sample": 1, "bounce": 2}, "frame": {"res": [8, 8]},
        "scene": {"renderer": [{"type": "sphere", "r": 0.5}],
                  "light": [{"type": "point", "pos": [-0.5, -1, 0.5]}]},
    }).encode()
    before = (hit3.KERNEL.plain_calls, step.KERNEL.plain_calls)
    jpg = http.render_jpeg(body, device="cpu")
    assert jpg[:2] == b"\xff\xd8"
    assert hit3.KERNEL.plain_calls > before[0]
    assert step.KERNEL.plain_calls == before[1]


def test_entry_points_take_the_flags(monkeypatch):
    """``fused`` / ``remat`` reach the record path; None reads
    MRT_NO_FUSE."""
    assert ttr.use_fused(None) is True
    assert ttr.use_fused(False) is False
    monkeypatch.setenv("MRT_NO_FUSE", "1")
    assert ttr.use_fused(None) is False
    assert ttr.use_fused(True) is True
    assert shard.make_train_step((8, 8), 2, device="cpu", remat=True).remat
