"""The port's gradients of the whole slice against the JAX package's:
camera rays, the differentiable table build, the whole trace and the sky
fold, by trainable scene leaf, and one SGD step of ``make_train_step``.

The JAX side composes ``camera.gen_rays``, ``pallas_step.pack_step``,
``pallas_step.trace_packed`` (its kernels in interpret mode) and the sky
fold as a function of the trainable leaves; the port side is
``tracer.trace_radiance_u`` under autograd on the CPU. Both take the same
numpy pixel coordinates and uniforms. Tolerances and the rule for rays
whose path flips are those of ``test_torch_grad.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micro_raytracer_tpu.models import camera as jcam_mod
from micro_raytracer_tpu.models import compiler as jcomp
from micro_raytracer_tpu.models import schema
from micro_raytracer_tpu.ops import pallas_step as jps
from micro_raytracer_tpu_torch.models import camera as tcam_mod
from micro_raytracer_tpu_torch.models import tracer as ttr
from micro_raytracer_tpu_torch.ops import step
from micro_raytracer_tpu_torch.parallel import shard
from test_torch_grad import (DECAY, SCENES, _assert_grad_close, _bad_rays,
                             _jax_pack, _path_flips, _resid_j, _scene,
                             _uniforms, drop_flips)
from torch_port_helpers import port_camera
from torch_mesh_helpers import one_torch_thread  # noqa: F401

# --- the slice: camera -> tables -> trace -> sky fold, by scene leaf --------

W = H = 16
BOUNCE = 3
# the glass scene adds a refractive mesh (16 triangles, a multi-row group)
SLICE_SCENES = SCENES + ["glass"]


def _jcam():
    return jcomp.compile_camera(schema.CameraConfig.from_json(
        {"pos": [0, -2, 0]}))


@functools.lru_cache(maxsize=None)
def _slice_inputs(name):
    """Pixel coords of the 16x16 frame, uniforms and a target; a ray whose
    path flips between the two sides (see the module docstring) is
    replaced by a copy of the first ray that does not."""
    js, ps = _scene(name)
    ys, xs = np.divmod(np.arange(W * H), W)
    coords = np.stack([xs, ys], -1).astype(np.float32)
    rng = np.random.default_rng(7)
    u_aprt = rng.random((W * H, 2)).astype(np.float32)
    u8s = _uniforms(js, W * H, BOUNCE + 1, seed=8)
    target = rng.random((W * H, 3)).astype(np.float32)
    o_j, d_j = jcam_mod.gen_rays(_jcam(), (W, H), jnp.asarray(coords),
                                 jnp.asarray(u_aprt))
    A_j, B_j, _fl_j, res_j = _resid_j(js, np.asarray(o_j).T,
                                      np.asarray(d_j).T, u8s)
    o_t, d_t = tcam_mod.gen_rays(port_camera(_jcam()), (W, H),
                                 torch.from_numpy(coords),
                                 torch.from_numpy(u_aprt))
    work = {"sweep": 0, "shadow": 0,
            "tex_edge": torch.zeros(W * H, dtype=torch.bool)}
    A, B, _fl, res, n_live = step.trace_plain(
        ps, step.pack_step(ps), DECAY, o_t.T.contiguous(),
        d_t.T.contiguous(), torch.from_numpy(u8s), want_resid=True,
        work=work)
    flips = drop_flips(_path_flips(ps, res.numpy(), n_live.numpy(), res_j),
                       work["tex_edge"].numpy(), [(A, A_j), (B, B_j)])
    src = int(np.argmin(flips))
    coords[flips], u_aprt[flips] = coords[src], u_aprt[src]
    u8s[:, :, flips] = u8s[:, :, src:src + 1]
    return coords, u_aprt, u8s, target


@functools.lru_cache(maxsize=None)
def _jax_slice(name):
    """JAX radiance of the slice and its VJP, as a function of the
    trainable leaves."""
    js, _ps = _scene(name)
    jc = _jcam()
    coords, u_aprt, u8s, _t = _slice_inputs(name)

    def rad_fn(params):
        s = dataclasses.replace(js, **params)
        orig, dirs = jcam_mod.gen_rays(jc, (W, H), jnp.asarray(coords),
                                       jnp.asarray(u_aprt))
        consts, attr, gattr, attr2, lights, tex = _jax_pack(s)
        A_T, B_T, flT = jps.trace_packed(
            s, consts, attr, lights, jnp.float32(DECAY), orig.T, dirs.T,
            jnp.asarray(u8s), tex=tex, inference=False, gattr=gattr,
            attr2=attr2)
        col = B_T.T + A_T.T * (s.sky_color * s.sky_pwr)
        return jnp.where((flT[0] > 0.5)[:, None], col,
                         jnp.broadcast_to(s.sky_color, col.shape))

    params = {k: getattr(js, k) for k in shard.TRAINABLE_FIELDS}
    rad, vjp = jax.vjp(rad_fn, params)
    return params, np.asarray(rad), vjp


def _port_slice(name):
    js, ps = _scene(name)
    coords, u_aprt, u8s, target = _slice_inputs(name)
    params = shard.params_from_numpy(
        {k: np.asarray(getattr(js, k)) for k in shard.TRAINABLE_FIELDS},
        "cpu")
    cam = port_camera(_jcam())
    return (js, ps, params, cam,
            *(torch.from_numpy(a) for a in (coords, u_aprt, u8s, target)))


@pytest.mark.parametrize("name", SLICE_SCENES)
def test_slice_grad_mean_sq_matches_jax(name):
    """d mean(rad**2) / d leaf for every trainable leaf."""
    js, ps, params, cam, coords, u_aprt, u8s, _t = _port_slice(name)
    rad = ttr.trace_radiance_u(shard.merge_params(ps, params), cam, (W, H),
                               BOUNCE, 0.15, coords, u_aprt, u8s)
    _p, rad_j, vjp = _jax_slice(name)
    assert not _bad_rays([(rad.detach().T, rad_j.T)]).any()
    torch.mean(rad ** 2).backward()
    (g_j,) = vjp(jnp.asarray(2.0 * rad_j / rad_j.size, jnp.float32))
    assert float(np.abs(np.asarray(g_j["mat_albedo"])).max()) > 0
    for k in shard.TRAINABLE_FIELDS:
        g = params[k].grad
        assert g is not None, k
        _assert_grad_close(k, g.numpy(), g_j[k])


@pytest.mark.parametrize("name", SLICE_SCENES)
def test_train_step_matches_jax_sgd(name):
    """One make_train_step SGD step: the L2 loss, every leaf's gradient
    and the new leaves against JAX's arithmetic (p - lr * grad) on the
    same inputs."""
    js, ps, params, cam, coords, u_aprt, u8s, target = _port_slice(name)
    lr = 1e-2
    ts = shard.make_train_step((W, H), BOUNCE, lr=lr, device="cpu")
    loss, new = ts.step_u(params, ps, cam, 0.15, coords, target, u_aprt,
                          u8s)
    p_j, rad_j, vjp = _jax_slice(name)
    t = target.numpy()
    loss_j = float(np.mean((rad_j - t) ** 2))
    np.testing.assert_allclose(float(loss), loss_j, rtol=1e-4)
    (g_j,) = vjp(jnp.asarray(2.0 * (rad_j - t) / rad_j.size, jnp.float32))
    for k in shard.TRAINABLE_FIELDS:
        _assert_grad_close(k, params[k].grad.numpy(), g_j[k])
        new_j = np.asarray(p_j[k]) - lr * np.asarray(g_j[k])
        np.testing.assert_allclose(new[k].detach().numpy(), new_j,
                                   rtol=1e-5, atol=1e-7, err_msg=k)
        assert new[k].requires_grad and new[k].is_leaf
