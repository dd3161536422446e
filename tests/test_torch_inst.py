"""The port's Instance class against the JAX package: the sphere cull
blocks, the culled sweeps, the whole trace, live-first compaction of the
render, the gradients, and the CLI on an instanced scene (on the CPU, where
every wrapper runs its plain version).

The JAX side runs its Pallas kernels in interpret mode (``MRT_HIT3=1``,
``MRT_STEP=1``), as its own tests do. Scenes: the 360-sphere 9 x 8 x 5
grid of ``test_pallas_hit3.py::test_sphere_cull_blocks_match_dense`` and
the small ``inst_grid`` / ``inst_glass`` (``torch_inst_helpers``, 294
spheres), both with a partial last cull block. Tolerances:

* the block AABBs: rtol 1e-6 (the same float32 formula);
* the sweeps with the port's cull on and off: rows and t equal (a sphere's
  hit point lies inside its block's AABB); against the JAX sweep: rows
  equal, t within rtol 1e-5 / atol 1e-6;
* the whole trace (camera rays and uniforms drawn as the JAX package's
  ``trace_radiance`` draws them, which compacts this class at step 2),
  ray by ray: ``test_torch_step.py``'s rule, rtol 1e-3 / atol 1e-4 on all
  but 0.5% of rays, at bounce 1; at bounce 3 at most 3% of rays may leave
  it, each explained by float32 rounding: traced from JAX's own primaries
  the port meets the rule, or its own float32 radiance is off its float64
  radiance at least a tenth as far as off JAX's;
* the compacted render against the unsegmented one: bit for bit;
* gradients: ``test_torch_grad.py``'s rules, and a ray whose gradient
  leaves them must be shown ill-conditioned by float64.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from micro_raytracer_tpu.models import camera as jcam_mod
from micro_raytracer_tpu.models import compiler as jcomp
from micro_raytracer_tpu.models import schema
from micro_raytracer_tpu.models import tracer as jtr
from micro_raytracer_tpu.ops import intersect as ji
from micro_raytracer_tpu.ops import pallas_hit3 as jh
from micro_raytracer_tpu.ops import rng as jrng
from micro_raytracer_tpu_torch.frontends import cli as tcli
from micro_raytracer_tpu_torch.models import tracer as ttr
from micro_raytracer_tpu_torch.ops import hit3, step
from test_torch_grad import check_trace_grad
from torch_inst_helpers import CAMERA, inst_scene, render_json
from torch_tex_helpers import _buf, checker
from torch_mesh_helpers import mesh_scene, small_torus
from torch_mesh_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import outlier_rows, port_camera, port_scene, rays

# bounce 3 of the whole trace: at most this share of the frame's rays may
# leave test_torch_step.py's rule, each off JAX at most ILL_RATIO times as
# far as the port's own float32 radiance is off its float64 radiance
ILL_SHARE, ILL_RATIO = 0.03, 10.0


def grid360():
    """test_pallas_hit3's 9 x 8 x 5 sphere grid (360 rows: the last cull
    block holds 40)."""
    rng = np.random.default_rng(5)
    objs = []
    for x in range(9):
        for y in range(8):
            for z in range(5):
                objs.append({
                    "type": "sphere", "r": 0.18,
                    "pos": [x * 0.5 - 2.0, y * 0.5 + 1.0, z * 0.5 - 1.0],
                    "mat": {"rough": float(rng.uniform(0.2, 1.0)),
                            "albedo": [float(v) for v in
                                       rng.uniform(0.2, 1.0, 3)]}})
    return {"renderer": objs,
            "light": [{"type": "point", "pos": [0, -1, 1.5], "pwr": 0.7}],
            "sky": {"color": [0.25, 0.3, 0.35], "pwr": 0.5}}


def tex_grid360():
    """grid360 with one sphere textured: the JAX package culls its spheres
    and compacts its render, the port sweeps them dense and renders it
    whole (hit3.sph_culled)."""
    src = grid360()
    src["renderer"][0]["mat"]["tex"] = _buf(checker(4, 2))
    return src


SCENES = {"grid360": grid360(), "inst_grid": inst_scene("inst_grid", True),
          "inst_glass": inst_scene("inst_glass", True)}


@functools.lru_cache(maxsize=None)
def _scene(name):
    js = jcomp.compile_scene(schema.SceneConfig.from_json(SCENES[name]))
    return js, port_scene(js)


def _rays(n, seed):
    """Rays from inside and around the grids, random directions."""
    o, d = rays(n, seed=seed)
    o = o * np.float32(1.2) + np.float32([0.0, 2.5, 0.5])
    return torch.from_numpy(o), torch.from_numpy(d)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_sph_blockbounds_match_jax(name):
    """The gate and the block AABBs of the sphere segment against
    pallas_hit3's ``_sph_cull_rows`` and ``_sphere_blockbounds``."""
    js, ps = _scene(name)
    tables = step.pack_step(ps)
    sph = hit3.sph_cull_rows(tables.layout)
    assert sph == jh._sph_cull_rows(jh._seg_layout(js.kind_counts))
    n_sb = -(-sph[1] // hit3.CB)
    assert tables.sbb.shape == (n_sb, hit3.BB_COLS)
    assert sph[1] % hit3.CB                      # a partial last block
    want = np.asarray(jh._sphere_blockbounds(js))
    np.testing.assert_allclose(tables.sbb.numpy(), want[:n_sb], rtol=1e-6)


def test_sph_cull_gate():
    """Only a sphere segment of at least 256 rows gets cull blocks: not
    the room scenes, not a mesh's triangles, not a 248-sphere grid; and
    the kernels cull it only in a scene without triangles or textures."""
    for src in (mesh_scene("mesh_opaque", small_torus()),
                {"renderer": grid360()["renderer"][:248]}):
        ps = port_scene(jcomp.compile_scene(schema.SceneConfig.from_json(
            src)))
        assert step.pack_step(ps).sbb is None
        assert hit3.sph_cull_rows(step.pack_step(ps).layout) is None
    ps = port_scene(jcomp.compile_scene(schema.SceneConfig.from_json(
        tex_grid360())))
    tables = step.pack_step(ps)
    assert hit3.sph_cull_rows(tables.layout) is not None
    assert not hit3.sph_culled(ps, tables.layout) and tables.sbb is None
    assert hit3.sph_culled(_scene("grid360")[1],
                           step.pack_step(_scene("grid360")[1]).layout)


@pytest.mark.parametrize("mode", [hit3.MODE_ENTRY, hit3.MODE_EXIT,
                                  hit3.MODE_ANY])
@pytest.mark.parametrize("name", ["grid360", "inst_grid"])
def test_culled_sweep_equals_dense(name, mode):
    """The culled sweep gives the dense sweep's rows and t bit for bit,
    and in every mode tests fewer sphere rows (an exit-mode sweep culls
    its entry too; its exit is the winner row's own)."""
    _js, ps = _scene(name)
    tables = step.pack_step(ps)
    o, d = _rays(2048, 7)
    args = (tables.tab, tables.layout, o, d, mode, tables.tri, tables.tbb)
    culled = hit3.closest_hit(*args, tables.sbb)
    dense = hit3.closest_hit(*args, None)
    for c, f in zip(culled, dense):
        assert torch.equal(c, f)
    assert int((culled[0] < hit3.BIG * 0.5).sum()) > 300
    n = tables.layout[0][0][3]
    tested = hit3.sph_rows_tested(tables.tab, tables.layout, o, d, mode,
                                  tables.sbb).float().mean()
    assert float(tested) < 0.5 * n


@functools.lru_cache(maxsize=None)
def _jax_hits(name, need_exit):
    js, _ps = _scene(name)
    o, d = (t.numpy() for t in _rays(512, 3))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MRT_HIT3", "1")
        jfr = ji.build_frames(js)
        h = jh.closest_hit(js, jfr, jnp.asarray(o), jnp.asarray(d),
                           need_exit=need_exit)
        anyh = jh.any_hit(js, jfr, jnp.asarray(o), jnp.asarray(d))
    return (o, d), tuple(np.asarray(x) for x in (
        h.hit, h.t_entry, h.idx_entry, h.t_exit, h.idx_exit)), \
        np.asarray(anyh)


@pytest.mark.parametrize("mode", ["entry", "exit", "any"])
@pytest.mark.parametrize("name", ["grid360", "inst_grid"])
def test_sweep_matches_pallas(name, mode):
    _js, ps = _scene(name)
    tables = step.pack_step(ps)
    (o, d), (hit, te, row, tx, xrow), anyh = _jax_hits(name, mode == "exit")
    m = {"entry": hit3.MODE_ENTRY, "exit": hit3.MODE_EXIT,
         "any": hit3.MODE_ANY}[mode]
    got = [t.numpy() for t in hit3.closest_hit(
        tables.tab, tables.layout, torch.from_numpy(o), torch.from_numpy(d),
        m, tables.tri, tables.tbb, tables.sbb)]
    if mode == "any":
        assert anyh.sum() > 100
        np.testing.assert_array_equal(got[0] < 0.0, anyh)
        return
    assert hit.sum() > 100
    np.testing.assert_array_equal(got[0] < hit3.BIG * 0.5, hit)
    np.testing.assert_array_equal(got[1], row)
    np.testing.assert_allclose(got[0][hit], te[hit], rtol=1e-5, atol=1e-6)
    if mode == "exit":
        np.testing.assert_array_equal(got[3], xrow)
        np.testing.assert_allclose(got[2][hit], tx[hit], rtol=1e-5,
                                   atol=1e-6)


def _jax_draws(key, n, bounce, refract):
    """The camera and path uniforms the JAX package's trace_radiance draws
    from ``key``: ``u_aprt (n, 2)`` and the packed ``u8s``."""
    k_cam, k_trace, k_shade = jax.random.split(key, 3)
    u_aprt = jrng.uniform(k_cam, (n, 2))
    us = []
    for i in range(bounce + 1):
        u = jrng.uniform(jax.random.fold_in(k_trace, i), (n, 7))
        ue = jrng.uniform(jax.random.fold_in(k_shade, i), (n,))
        us.append(jnp.concatenate([u.T if refract else u[:, :3].T,
                                   ue[None]], 0))
    return np.array(u_aprt), np.array(jnp.stack(us))


def _shown_ill(ps, prim, jprim, u8s, bounce, got, want, idx):
    """Hold each ray of ``idx`` (outside the rule) to a witness that
    float32 rounding alone moves it that far (a path that the grid's
    convex mirrors amplify, or one that a last-bit change of the primary
    turns onto another sphere):

    * the camera: traced from JAX's own primaries ``jprim`` (which differ
      from the port's ``prim`` in the last bits), the port meets the rule;
    * the trace: the port's radiance differs from JAX's at most ILL_RATIO
      times as much as it differs from the port's plain trace of the same
      primaries and uniforms run in float64.

    A ray that neither explains fails."""
    f64 = torch.float64
    tables = step.pack_step(ps)
    t64 = tables._replace(tab=tables.tab.to(f64),
                          lights=tables.lights.to(f64),
                          tri=tables.tri.to(f64))
    sub = torch.from_numpy(idx)
    u = u8s[..., sub]
    with torch.no_grad():
        from_jax = ttr.trace_fused(ps, tables, bounce, *(
            torch.from_numpy(a[idx]) for a in jprim), 0.15, u, cuts=[])
        got64 = ttr.trace_fused(ps, t64, bounce, *(
            a[sub].to(f64) for a in prim), 0.15, u.to(f64), cuts=[])
    cam = np.isclose(from_jax.numpy(), want[idx], rtol=1e-3,
                     atol=1e-4).all(1)
    gap = np.abs(got[idx] - want[idx]).max(1)
    own = np.abs(got[idx].astype(np.float64) - got64.numpy()).max(1)
    print(f"rays {idx}: the camera explains {idx[cam]}; off JAX "
          f"{gap / own} times as far as off float64")
    assert np.all(cam | (gap <= ILL_RATIO * own)), (idx, cam, gap, own)


@pytest.mark.parametrize("name", ["inst_grid", "inst_glass"])
def test_trace_radiance_matches_jax(name, monkeypatch):
    """A 32 x 32 frame of the small stand-in through the JAX package's
    trace_radiance (its whole-trace kernel) and the port's
    trace_radiance_u from the same draws, ray by ray. At bounce 1 every
    ray is held to the rule (all but 0.5% of rays). At bounce 3 (the JAX
    package compacting at step 2, and the port on the glass grid) the
    grid's convex mirrors amplify a
    first-hit t that differs in its last bits (JAX's XLA contracts
    products into fused multiply-adds, the port rounds each), and a
    camera direction that differs in its last bit can turn a path onto
    another sphere: at most ILL_SHARE of the rays may leave the rule, each
    explained by float32 rounding (:func:`_shown_ill`)."""
    monkeypatch.setenv("MRT_STEP", "1")
    monkeypatch.setenv("MRT_HIT3", "1")
    js, ps = _scene(name)
    jcam = jcomp.compile_camera(schema.CameraConfig.from_json(CAMERA))
    xs, ys = np.meshgrid(np.arange(32), np.arange(32))
    coords = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)
    key = jax.random.PRNGKey(4)
    for bounce, cuts in ((1, []), (3, [2] if ps.any_refract else [])):
        want = np.asarray(jtr.trace_radiance(
            js, jcam, (32, 32), bounce, jnp.float32(0.15),
            jnp.asarray(coords), key, inference=True))
        u_aprt, u8s = (torch.from_numpy(a) for a in _jax_draws(
            key, len(coords), bounce, ps.any_refract))
        assert ttr.compact_cuts(ps, bounce + 1, True) == cuts
        got = ttr.trace_radiance_u(
            ps, port_camera(jcam), (32, 32), bounce, 0.15,
            torch.from_numpy(coords), u_aprt, u8s).numpy()
        assert np.abs(want).max() > 0
        bad = outlier_rows(got, want, 1e-3, 1e-4)
        print(f"{name} bounce {bounce}: {len(bad)} of {len(coords)} rays "
              f"outside rtol 1e-3")
        if bounce == 1:
            assert len(bad) <= 0.005 * len(coords), bad
        else:
            assert len(bad) <= ILL_SHARE * len(coords), bad
            prim = ttr.camera_mod.gen_rays(port_camera(jcam), (32, 32),
                                           torch.from_numpy(coords), u_aprt)
            jprim = jcam_mod.gen_rays(jcam, (32, 32), jnp.asarray(coords),
                                      jnp.asarray(u_aprt.numpy()))
            _shown_ill(ps, prim, [np.asarray(a) for a in jprim], u8s,
                       bounce, got, want, bad)


def test_compact_perm_is_a_stable_live_first_partition():
    live = torch.from_numpy(np.random.default_rng(2).random(1000) < 0.3)
    perm = ttr.compact_perm(live)
    n = int(live.sum())
    assert sorted(perm.tolist()) == list(range(1000))
    assert bool(live[perm[:n]].all()) and not bool(live[perm[n:]].any())
    assert bool((perm[:n].diff() > 0).all())
    assert bool((perm[n:].diff() > 0).all())


def test_compact_cuts_rule():
    """The JAX package's rule (jax_cuts): a sphere-cull class without
    triangles compacts at 2, 4 and 6, a triangle class at 3 and 6, a room
    never; a sphere grid whose spheres the port sweeps dense (textured)
    neither. The default (compact_cuts) follows it on refractive scenes
    and leaves opaque ones whole, and a trace that needs a gradient never
    compacts."""
    inst = _scene("inst_grid")[1]
    glass = _scene("inst_glass")[1]
    mesh = {name: port_scene(jcomp.compile_scene(schema.SceneConfig
                                                 .from_json(mesh_scene(
                                                     name, small_torus()))))
            for name in ("mesh_opaque", "mesh_glass")}
    room = port_scene(jcomp.compile_scene(schema.SceneConfig.from_json(
        {"renderer": grid360()["renderer"][:248]})))
    assert ttr.jax_cuts(inst, 9) == [2, 4, 6]
    assert ttr.jax_cuts(inst, 4) == [2]
    assert ttr.jax_cuts(mesh["mesh_opaque"], 9) == [3, 6]
    assert ttr.jax_cuts(room, 9) == []
    tex = port_scene(jcomp.compile_scene(schema.SceneConfig.from_json(
        tex_grid360())))
    assert ttr.jax_cuts(tex, 9) == [] and ttr.compact_cuts(tex, 9, True) == []
    assert ttr.compact_cuts(inst, 9, True) == []
    assert ttr.jax_cuts(glass, 9) == ttr.compact_cuts(glass, 9, True) \
        == [2, 4, 6]
    assert ttr.compact_cuts(mesh["mesh_glass"], 9, True) == [3, 6]
    assert ttr.compact_cuts(mesh["mesh_opaque"], 9, True) == []
    assert ttr.compact_cuts(room, 9, True) == []
    assert ttr.compact_cuts(inst, 9, False) == []


@pytest.mark.parametrize("name", ["inst_grid", "inst_glass", "mesh_glass"])
def test_compacted_render_equals_unsegmented(name):
    """Bounce 8 from the stand-in's camera: the render split at 2, 4 and 6
    with live lanes packed first between segments gives the unsegmented
    trace's radiance bit for bit, with the JAX rule's cuts too."""
    if name == "mesh_glass":
        ps = port_scene(jcomp.compile_scene(schema.SceneConfig.from_json(
            mesh_scene(name, small_torus()))))
    else:
        ps = _scene(name)[1]
    tables = step.pack_step(ps)
    cam = port_camera(jcomp.compile_camera(schema.CameraConfig.from_json(
        CAMERA if name != "mesh_glass" else {"pos": [0, -1.25, 0],
                                             "fov": 60})))
    gen = torch.Generator().manual_seed(8)
    coords = torch.floor(torch.rand((1024, 2), generator=gen) * 32)
    u_aprt, u8s = ttr.draw_uniforms(gen, 1024, 8, ps.any_refract, "cpu")
    with torch.no_grad():
        base = ttr.trace_radiance_u(ps, cam, (32, 32), 8, 0.1, coords,
                                    u_aprt, u8s, tables)   # default cuts
        orig, dirs = ttr.camera_mod.gen_rays(cam, (32, 32), coords, u_aprt)
        flat = ttr.trace_fused(ps, tables, 8, orig, dirs, 0.1, u8s, cuts=[])
        split = ttr.trace_fused(ps, tables, 8, orig, dirs, 0.1, u8s,
                                cuts=[2, 4, 6])
        live = step.trace_segment(ps, tables, ttr.decay_of(0.1),
                                  orig.T.contiguous(), dirs.T.contiguous(),
                                  u8s, step.Segment(0, 4))[3][step.C_LIVE]
    assert 0.05 < float(live.float().mean()) < 0.95   # compaction moves
    assert torch.equal(split, flat)
    assert torch.equal(base, flat)
    assert float(flat.std()) > 0.01


def test_segments_need_a_carry_and_no_gradient():
    ps = _scene("inst_grid")[1]
    tables = step.pack_step(ps)
    o, d = _rays(16, 1)
    with pytest.raises(ValueError, match="gradient"):
        ttr.trace_fused(ps, tables, 2, o.requires_grad_(True), d, 0.1,
                        torch.rand((3, 4, 16)), cuts=[1])
    with pytest.raises(ValueError, match="carry"):
        step._seg_args(step.Segment(1, 3), 3, 16, "cpu")
    for cuts in ([2, 1], [3], [0]):
        with pytest.raises(ValueError, match="ascending"):
            ttr.trace_fused(ps, tables, 2, o.detach(), d, 0.1,
                            torch.rand((3, 4, 16)), cuts=cuts)


@pytest.mark.parametrize("name", ["inst_grid"])
def test_trace_grad_matches_pallas_vjp(name):
    """d_attr, d_lights, d_oT and d_dT of one trace through the small
    grid against the JAX whole-trace VJP (test_torch_grad.py's rules).
    Rays from inside the grid graze spheres, where d t / d o grows as 1 /
    sqrt(disc): a ray whose gradient leaves the tolerance must be shown
    ill-conditioned by the plain trace in float64 (at most 1%; measured 2
    of 256) and is then dropped on both sides like a path flip."""
    check_trace_grad(name, ill_ok=True)


def test_cli_renders_an_instanced_scene(tmp_path):
    """The CLI renders the small stand-ins from JSON files through the
    plain trace, one trace call per segment of each sample: the opaque
    grid whole, the glass one in two segments (bounce 2: one cut, at step
    2)."""
    for name, segments in (("inst_grid", 1), ("inst_glass", 2)):
        cfg = tmp_path / f"{name}.json"
        cfg.write_text(json.dumps(render_json(name, small=True)))
        out = tmp_path / f"{name}.png"
        before = step.KERNEL.plain_calls
        assert tcli.main([str(cfg), "--device", "cpu", "-o", str(out)]) == 0
        assert step.KERNEL.plain_calls == before + 2 * segments
        img = np.asarray(Image.open(out))
        assert img.shape == (32, 32, 3) and img.std() > 5.0
