"""The per-step path (``step.trace_steps``: one bounce step per launch, the
carry in memory between them) against the JAX package, and its route.

* Row 4: the plain step (``step.step_plain``) against ``pallas_step.step``,
  the bounce-step kernel in interpret mode (``MRT_STEP=1``, as
  ``test_pallas_step.py`` runs it), on the same carry and uniforms.
* Row 5: autograd of the plain step against ``jax.vjp`` of
  ``pallas_step.step``, whose backward is ``_call_step_bwd`` in interpret
  mode: every scene leaf a step reaches and the carry's o, d, pwr, A, B.
* More than 4 lights (``lights8``, chip_smoke.py's stand-in) and more than
  2,048 rows (a 13 x 13 x 13 sphere grid over a plane, 2,205 rows, 2
  lights): ``step.trace_packed``, which routes them to the per-step path,
  against K composed ``tracer.fused_step_reference`` steps (the JAX jnp
  path, ``MRT_HIT3=0``), radiance and leaf gradients.
* The route (``step.route``): the whole trace for every scene it takes,
  the per-step path only past its bounds; the per-step path equals the
  whole trace bit for bit on the CPU.

Tolerances, as ``test_torch_step.py`` and ``test_torch_grad.py``: values
within rtol 1e-3 / atol 1e-4 on all but 0.5% of rays (a float32 rounding
difference can flip a sampling branch or a grazing hit, and that ray's
path then differs); gradients within rtol 2e-3 and an absolute floor of
1e-5 of the compared array's largest magnitude, for cotangents that are
zero on the rays whose values left the tolerance (at most 0.5%).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (LIGHTS8_CAMERA, inst_scene, lights8, slice_config,
                        tex_blocks)
from micro_raytracer_tpu.models import compiler as jcomp
from micro_raytracer_tpu.models import schema
from micro_raytracer_tpu.models import tracer as jtr
from micro_raytracer_tpu.models import camera as jcam_mod
from micro_raytracer_tpu.ops import intersect as ji
from micro_raytracer_tpu.ops import pallas_step as jps
from micro_raytracer_tpu_torch.frontends import cli
from micro_raytracer_tpu_torch.models import tracer as ttr
from micro_raytracer_tpu_torch.models.compiler import compile_scene
from micro_raytracer_tpu_torch.models import schema as tschema
from micro_raytracer_tpu_torch.ops import hit3, step
from micro_raytracer_tpu_torch.parallel import shard
from test_pallas_step import scenes, state
from torch_inst_helpers import CAMERA as INST_CAMERA
from torch_mesh_helpers import mesh_scene
from torch_mesh_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import MIXED, outlier_rows, port_scene, rays

RTOL, ATOL, SHARE = 1e-3, 1e-4, 0.005
G_RTOL, G_FLOOR = 2e-3, 1e-5
DECAY = 0.85
# the leaves a bounce step reaches (the sky only in the fold after the
# trace; opacity and emission only through comparisons)
STEP_LEAVES = ("mat_albedo", "mat_rough", "mat_metal", "mat_glass",
               "light_pos", "light_dir", "light_pwr", "light_color",
               "inst_pos", "inst_dir", "prim_r")
GRID13 = inst_scene("inst_grid", dims=(13, 13, 13))


@functools.lru_cache(maxsize=None)
def _scene(name):
    src = {"lights8": lights8(), "grid13": GRID13}.get(name) \
        or scenes()[name]
    js = jcomp.compile_scene(schema.SceneConfig.from_json(src))
    return js, port_scene(js)


def _u8(js, u, u_emit):
    """The packed (NU, R) uniform rows of one step."""
    u, u_emit = np.asarray(u), np.asarray(u_emit)
    rows = u.T if js.any_refract else u[:, :3].T
    return np.concatenate([rows, u_emit[None]]).astype(np.float32)


def _unpack(js, u8):
    """One step's (u (R, 7), u_emit (R,)) for the JAX functions."""
    R = u8.shape[1]
    if js.any_refract:
        return jnp.asarray(u8[:7].T), jnp.asarray(u8[7])
    return (jnp.asarray(np.concatenate([u8[:3].T, np.zeros((R, 4),
                                                           np.float32)], 1)),
            jnp.asarray(u8[3]))


def _carry(o, d, pwr, live, A, B):
    """The port's (14, R) carry from row-major numpy state."""
    R = o.shape[0]
    return torch.from_numpy(np.concatenate([
        np.asarray(o).T, np.asarray(d).T, np.asarray(pwr)[None],
        np.asarray(live, np.float32)[None], np.asarray(A).T,
        np.asarray(B).T]).astype(np.float32).reshape(step.CARRY_ROWS, R))


def _outliers(pairs):
    """(R,) bool: rays outside RTOL / ATOL in any ((R, C) got, want)
    pair; at most SHARE of them."""
    bad = np.zeros(len(pairs[0][0]), bool)
    for got, want in pairs:
        bad[outlier_rows(got, want, RTOL, ATOL)] = True
    assert bad.sum() <= SHARE * len(bad), np.nonzero(bad)[0]
    return bad


def _on(mask, x):
    """(R, C) ``x`` with its rows outside ``mask`` zeroed."""
    return np.where(mask[:, None], np.asarray(x), 0.0)


def _assert_grad_close(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.all(np.isfinite(got)), f"{name}: non-finite"
    atol = G_FLOOR * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=G_RTOL, atol=atol,
                               err_msg=name)


# --- row 4 and row 5: one step against pallas_step.step ----------------------

def _jax_step(monkeypatch):
    monkeypatch.setenv("MRT_STEP", "1")
    monkeypatch.setenv("MRT_HIT3", "0")
    monkeypatch.setenv("MRT_TRI_PALLAS", "0")


@pytest.mark.parametrize("name", ["opaque", "glass_flat", "glass"])
def test_plain_step_matches_pallas_step(name, monkeypatch):
    """The next carry and the hit liveness of one step: o and d on the
    rays that hit (a dead ray's are garbage in the JAX step and passed
    through here), pwr, A and B on every ray."""
    _jax_step(monkeypatch)
    js, ps = _scene(name)
    ray, A, B, u, u_emit = state(js)
    ray_k, A_k, B_k, live_k = jps.step(js, ji.build_frames(js),
                                       jnp.float32(DECAY), ray, A, B, u,
                                       u_emit)
    c1, hit = step.step_plain(ps, step.pack_step(ps), DECAY,
                              _carry(*ray, A, B),
                              torch.from_numpy(_u8(js, u, u_emit)))
    live = np.asarray(live_k)
    assert 0.3 * len(live) < live.sum() < len(live)
    np.testing.assert_array_equal(hit[0].numpy() > 0.5, live)
    np.testing.assert_array_equal(c1[step.C_LIVE].numpy() > 0.5,
                                  live & (c1[step.C_LIVE].numpy() > 0.5))
    c = c1.numpy()
    _outliers([(_on(live, c[0:3].T), _on(live, ray_k[0])),
               (_on(live, c[3:6].T), _on(live, ray_k[1])),
               (c[6:7].T, np.asarray(ray_k[2])[:, None]),
               (c[8:11].T, np.asarray(A_k)), (c[11:14].T, np.asarray(B_k))])


@pytest.mark.parametrize("name", ["opaque", "glass_flat", "glass"])
def test_plain_step_vjp_matches_pallas_step(name, monkeypatch):
    """d leaf for STEP_LEAVES and the carry's d o, d d, d pwr, d A, d B of
    one step for random output cotangents, those of o and d zero on the
    rays that do not hit (their JAX values are garbage)."""
    _jax_step(monkeypatch)
    js, ps = _scene(name)
    ray, A, B, u, u_emit = state(js, n=128, seed=2)
    live_in = ray[3]

    def f(params, o, d, pwr, A, B):
        s = dataclasses.replace(js, **params)
        (o2, d2, pwr2, _l), A2, B2, _live = jps.step(
            s, ji.build_frames(s), jnp.float32(DECAY), (o, d, pwr, live_in),
            A, B, u, u_emit)
        return o2, d2, pwr2, A2, B2

    params = {k: getattr(js, k) for k in STEP_LEAVES}
    outs, vjp = jax.vjp(f, params, *ray[:3], A, B)
    tp = {k: torch.tensor(np.asarray(v)).requires_grad_(True)
          for k, v in params.items()}
    c0 = _carry(*ray, A, B).requires_grad_(True)
    c1, hit = step.step_plain(
        ps, step.pack_step(dataclasses.replace(ps, **tp)), DECAY, c0,
        torch.from_numpy(_u8(js, u, u_emit)))
    live = hit[0].numpy() > 0.5
    c = c1.detach().numpy()
    bad = _outliers([(_on(live, c[0:3].T), _on(live, outs[0])),
                     (_on(live, c[3:6].T), _on(live, outs[1])),
                     (c[8:11].T, np.asarray(outs[3])),
                     (c[11:14].T, np.asarray(outs[4]))])
    rng = np.random.default_rng(3)
    ct = rng.normal(size=(step.CARRY_ROWS, len(live))).astype(np.float32)
    ct[:, bad] = 0.0
    ct[0:6, ~live] = 0.0
    ct[step.C_LIVE] = 0.0
    g_j = vjp((jnp.asarray(ct[0:3].T), jnp.asarray(ct[3:6].T),
               jnp.asarray(ct[6]), jnp.asarray(ct[8:11].T),
               jnp.asarray(ct[11:14].T)))
    c1.backward(torch.from_numpy(ct))
    assert float(np.abs(np.asarray(g_j[0]["mat_albedo"])).max()) > 0
    for k in STEP_LEAVES:
        _assert_grad_close(k, tp[k].grad.numpy(), g_j[0][k])
    g = c0.grad.numpy()
    for gname, mine, theirs in (("d_o", g[0:3].T, g_j[1]),
                                ("d_d", g[3:6].T, g_j[2]),
                                ("d_pwr", g[6], g_j[3]),
                                ("d_A", g[8:11].T, g_j[4]),
                                ("d_B", g[11:14].T, g_j[5])):
        _assert_grad_close(gname, mine, theirs)
    assert not g[step.C_LIVE].any()


# --- past the whole-trace bounds: the per-step route against the jnp path --

@functools.lru_cache(maxsize=None)
def _route_case(name, R, bounce):
    """Camera rays of a 64x64 frame at random pixels, uniforms, output
    cotangents; the JAX radiance and its VJP in the leaves through
    ``bounce + 1`` composed ``tracer.fused_step_reference`` steps."""
    js, ps = _scene(name)
    cam_json = LIGHTS8_CAMERA if name == "lights8" else INST_CAMERA
    jcam = jcomp.compile_camera(schema.CameraConfig.from_json(cam_json))
    rng = np.random.default_rng(21)
    coords = np.floor(rng.random((R, 2)) * 64).astype(np.float32)
    u_aprt = rng.random((R, 2)).astype(np.float32)
    o, d = (np.asarray(x) for x in jcam_mod.gen_rays(
        jcam, (64, 64), jnp.asarray(coords), jnp.asarray(u_aprt)))
    u8s = rng.random((bounce + 1, step.n_uni(ps.any_refract), R)).astype(
        np.float32)

    def rad_fn(params):
        s = dataclasses.replace(js, **params)
        fr = ji.build_frames(s)
        at = ji.prim_attributes(s, fr)
        ray = (jnp.asarray(o), jnp.asarray(d), jnp.ones((R,), jnp.float32),
               jnp.ones((R,), bool))
        A, B = jnp.ones((R, 3), jnp.float32), jnp.zeros((R, 3), jnp.float32)
        first = None
        for k in range(bounce + 1):
            u, ue = _unpack(js, u8s[k])
            ray, A, B, live = jtr.fused_step_reference(
                s, fr, at, jnp.float32(DECAY), ray, A, B, u, ue)
            first = live if k == 0 else first
        col = B + A * (s.sky_color * s.sky_pwr)
        return jnp.where(first[:, None], col,
                         jnp.broadcast_to(s.sky_color, col.shape))

    params = {k: getattr(js, k) for k in STEP_LEAVES}
    rad, vjp = jax.vjp(rad_fn, params)
    return o, d, u8s, np.asarray(rad), vjp


def _port_rad(ps, o, d, u8s, params):
    s = dataclasses.replace(ps, **params)
    A, B, fl = step.trace_packed(s, step.pack_step(s), DECAY,
                                 torch.from_numpy(o.T.copy()),
                                 torch.from_numpy(d.T.copy()),
                                 torch.from_numpy(u8s))
    col = B.T + A.T * (s.sky_color * s.sky_pwr)
    return torch.where(fl[0, :, None] > 0.5, col,
                       torch.broadcast_to(s.sky_color, col.shape))


@pytest.mark.parametrize("name,R,bounce", [
    ("lights8", 192, 3), ("grid13", 96, 2)])
def test_route_past_the_bounds_matches_jax_steps(name, R, bounce,
                                                 monkeypatch):
    """Radiance and the leaf gradients of ``lights8`` (8 lights) and the
    13^3 grid (2,205 rows, past MAX_ROWS and BWD_MAX_ROWS) through
    ``step.trace_packed`` — the per-step path — against the JAX jnp
    steps."""
    monkeypatch.setenv("MRT_HIT3", "0")        # the JAX side stays dense
    monkeypatch.setenv("MRT_TRI_PALLAS", "0")
    js, ps = _scene(name)
    assert step.route(ps, False) == step.route(ps, True) == "steps"
    o, d, u8s, rad_j, vjp = _route_case(name, R, bounce)
    params = {k: torch.tensor(np.asarray(getattr(js, k)))
              .requires_grad_(True) for k in STEP_LEAVES}
    before = (step.STEP_KERNEL.plain_calls, step.KERNEL.plain_calls)
    rad = _port_rad(ps, o, d, u8s, params)
    assert (step.STEP_KERNEL.plain_calls, step.KERNEL.plain_calls) \
        == (before[0] + bounce + 1, before[1])
    bad = _outliers([(rad.detach().numpy(), rad_j)])
    assert rad_j.std() > 0.01
    ct = np.random.default_rng(22).normal(size=rad_j.shape).astype(
        np.float32)
    ct[bad] = 0.0
    (g_j,) = vjp(jnp.asarray(ct))
    rad.backward(torch.from_numpy(ct))
    for k in ("mat_albedo", "light_pos", "light_pwr", "light_color",
              "prim_r"):
        assert float(np.abs(np.asarray(g_j[k])).max()) > 0, k
        _assert_grad_close(k, params[k].grad.numpy(), g_j[k])


# --- the route --------------------------------------------------------------

def _port(js_json):
    return compile_scene(tschema.SceneConfig.from_json(js_json), "cpu")


def _five_lights(js_json):
    return dict(js_json, light=[{"type": "point", "pos": [0, -1, 0.2 * i]}
                                for i in range(5)])


def test_route_rule():
    """The whole trace for every scene it takes (at most 4 lights, at most
    2,048 dense rows, 1,024 in training), the per-step path only past
    those bounds; a render on the per-step path takes no compaction cuts
    (the JAX package's per-step scan compacts neither)."""
    whole = [MIXED, mesh_scene("mesh_glass"), tex_blocks(small=True),
             inst_scene("inst_grid"), slice_config().scene.to_json()]
    for js_json in whole:
        s = _port(js_json)
        assert step.route(s, False) == step.route(s, True) == "trace"
    s = _port(_five_lights(MIXED))
    assert step.route(s, False) == step.route(s, True) == "steps"
    # 1,100 spheres and the plane: 1,112 rows
    s = _port(inst_scene("inst_grid", dims=(10, 10, 11)))
    assert hit3.seg_layout(s.kind_counts)[1] == 1112
    assert (step.route(s, False), step.route(s, True)) == ("trace", "steps")
    s = _port(GRID13)
    assert step.route(s, False) == "steps"
    assert ttr.jax_cuts(s, 9) == [2, 4, 6]
    assert ttr.compact_cuts(s, 9, True) == []
    assert step.pack_step(s).sbb.shape[0] == 35


@pytest.mark.parametrize("name", ["slice_room", "inst_grid", "mesh_glass",
                                  "tex_blocks"])
def test_steps_equal_whole_trace_on_cpu(name):
    """The per-step path on the tables of a scene the whole trace takes:
    A, B and first_live of ``trace_steps`` equal ``trace_plain``'s bit for
    bit (the kernels are held so on the card)."""
    js_json = {"slice_room": lambda: slice_config().scene.to_json(),
               "inst_grid": lambda: inst_scene("inst_grid", small=True),
               "mesh_glass": lambda: mesh_scene("mesh_glass"),
               "tex_blocks": lambda: tex_blocks(small=True)}[name]()
    s = _port(js_json)
    tables = step.pack_step(s)
    o, d = rays(256, seed=4)
    if name in ("slice_room", "mesh_glass"):
        o = (o * 0.22).astype(np.float32)
    oT, dT = torch.from_numpy(o.T.copy()), torch.from_numpy(d.T.copy())
    u8s = torch.rand((5, step.n_uni(s.any_refract), 256),
                     generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        whole = step.trace_plain(s, tables, DECAY, oT, dT, u8s)
        steps = step.trace_steps(s, tables, DECAY, oT, dT, u8s)
    assert float(whole[2].sum()) > 64
    for a, b in zip(whole, steps):
        assert torch.equal(a, b)


def test_segments_on_the_steps_route():
    """A render of ``lights8`` split at explicit cuts (``trace_segment``
    on the per-step route, each lane reading its ray's uniforms) equals
    the uncut render bit for bit."""
    _js, ps = _scene("lights8")
    tables = step.pack_step(ps)
    o, d = rays(128, seed=6)
    orig, dirs = torch.from_numpy(o), torch.from_numpy(d)
    u8s = torch.rand((5, step.n_uni(ps.any_refract), 128),
                     generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        flat = ttr.trace_fused(ps, tables, 4, orig, dirs, 0.15, u8s)
        split = ttr.trace_fused(ps, tables, 4, orig, dirs, 0.15, u8s,
                                cuts=[2, 3])
    assert torch.equal(flat, split)


def test_step_wrappers_take_only_cuda_tensors():
    _js, ps = _scene("lights8")
    tables = step.pack_step(ps)
    o, d = (torch.from_numpy(a.T.copy()) for a in rays(8))
    c0 = step.primary_carry(o, d)
    u8 = torch.zeros((step.n_uni(ps.any_refract), 8))
    for fn in (step.step_fwd, step.step_fwd_train):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(ps, tables, DECAY, c0, u8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        step.step_bwd(ps, tables, DECAY, c0, u8,
                      torch.zeros((step.scene_res_rows(ps, tables.layout),
                                   8)), torch.zeros((1, 8)),
                      torch.zeros_like(c0))


def test_cli_renders_five_lights_on_cpu(tmp_path):
    """The CLI with five ``--light`` entries (``--device cpu``) renders
    through the plain per-step path."""
    from PIL import Image

    out = tmp_path / "five.png"
    before = step.STEP_KERNEL.plain_calls
    args = ["--obj", "sphere", "r:", "0.5", "--obj", "plane", "pos:", "0",
            "0", "-0.5"]
    for i in range(5):
        args += ["--light", "point:", str(0.4 * i - 0.8), "-1", "1",
                 "pwr:", "0.3"]
    assert cli.main(args + ["--res", "16", "16", "--sample", "1",
                            "--bounce", "2", "--device", "cpu", "-o",
                            str(out)]) == 0
    assert step.STEP_KERNEL.plain_calls == before + 3
    assert np.asarray(Image.open(out)).std() > 1.0


def test_train_step_past_1024_rows_on_cpu():
    """make_train_step on a 1,112-row grid, which renders through the whole
    trace and trains through the per-step path: finite gradients."""
    s = _port(inst_scene("inst_grid", dims=(10, 10, 11)))
    from micro_raytracer_tpu_torch.models.compiler import compile_camera

    cam = compile_camera(tschema.CameraConfig.from_json(INST_CAMERA), "cpu")
    params = shard.params_from_numpy(
        {k: getattr(s, k).numpy() for k in shard.TRAINABLE_FIELDS}, "cpu")
    ys, xs = np.divmod(np.arange(64), 8)
    coords = torch.from_numpy(np.stack([xs, ys], -1).astype(np.float32))
    ts = shard.make_train_step((8, 8), 1, device="cpu")
    before = step.STEP_KERNEL.plain_calls
    loss, _new = ts.step(params, s, cam, 0.15, coords,
                         torch.full((64, 3), 0.5),
                         torch.Generator().manual_seed(0))
    assert step.STEP_KERNEL.plain_calls == before + 2
    assert bool(torch.isfinite(loss))
    assert float(params["mat_albedo"].grad.abs().max()) > 0
