"""Textures in the port against the JAX package, on the CPU: per-kind uv,
the texel fetch and the material maps, the textured whole trace and its
training residuals, and the CLI and HTTP service on textured scenes. The
gradients are in ``test_torch_tex_grad.py``.

Scenes: the JAX package's ``textured`` (a textured sphere, plane, rotated
refractive box and 4-triangle mesh) and ``textured_flat`` (the same
without the mesh: every group is one row), and small versions of the
stand-ins ``tex_dof`` and ``tex_blocks`` (``torch_tex_helpers``). The JAX
side runs its Pallas whole-trace kernel in interpret mode (``MRT_STEP=1``),
as its own tests do.

Tolerances:

* uv: rtol 1e-6 / atol 1e-6 (the same float32 formulas; ``atan2`` is
  PyTorch's here and XLA's there), NaN where JAX gives NaN; texels and
  materials equal exactly (the JAX function gathers the float32 atlas as
  the port does), except where a texel coordinate ``u w`` or ``v h`` of
  the port lies within ``step.TEX_EDGE`` (1e-4) of an integer;
* the trace: ``test_torch_step.py``'s rule, rtol 1e-3 / atol 1e-4 on all
  but 0.5% of rays, and beside it at most a quarter of the rays at a
  texel edge, rounded up (``max_flips``), dropped as shown texel flips:
  rays outside the tolerance that have a texel coordinate within 1e-4 of
  an integer at some live step (the texel index is ``trunc(u w)``, and a
  one-ulp difference of ``u`` moves the lookup to the next texel and the
  path with it). The JAX kernel's texels are its bf16 hi/lo split of the
  atlas, within ~2^-17 of the float32 texel;
* the texel residual rows: rtol 1e-5 (the bf16 split) on the live steps
  of rays inside the trace tolerance, where the side's map id is not -1.
"""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from micro_raytracer_tpu.models import camera as jcam_mod
from micro_raytracer_tpu.models import compiler as jcomp
from micro_raytracer_tpu.models import schema
from micro_raytracer_tpu.ops import intersect as ji
from micro_raytracer_tpu.ops import pallas_step as jps
from micro_raytracer_tpu_torch.frontends import cli as tcli
from micro_raytracer_tpu_torch.models import tracer as ttr
from micro_raytracer_tpu_torch.ops import intersect as ti
from micro_raytracer_tpu_torch.ops import step
from micro_raytracer_tpu_torch.utils import assets
from test_pallas_step import scenes
from test_torch_cli import _req, server  # noqa: F401  (fixture)
from test_torch_grad import _jax_pack
from torch_mesh_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import outlier_rows, port_scene, rays
from torch_tex_helpers import (CAMERAS, TEX_NAMES, max_flips, render_json,
                               tex_scene)

RTOL, ATOL, SHARE = 1e-3, 1e-4, 0.005
JAX_NAMES = ("textured", "textured_flat")
R, K = 256, 4
DECAY = ttr.decay_of(0.15)


@functools.lru_cache(maxsize=None)
def _scene(name):
    cfg = scenes()[name] if name in JAX_NAMES else tex_scene(name, True)
    js = jcomp.compile_scene(schema.SceneConfig.from_json(cfg))
    return js, port_scene(js)


def _kinds(ps, rows):
    tables = step.pack_step(ps)
    return step._row_kind(rows, step.hit3.row_ends(tables.layout)), tables


# --- uv, texel fetch, materials ---------------------------------------------

def _object_points(js, rows, q):
    """World points whose object-space offsets ``hp - ip`` are ``q``."""
    M = np.asarray(ji.build_frames(js))[rows]
    ip = np.asarray(js.inst_pos)[rows]
    return (ip + np.einsum("rij,rj->ri", np.linalg.inv(M), q)).astype(
        np.float32)


def _surface_points(js, n, seed):
    """Rows and world points of ``textured``: on the sphere and one
    degenerate point at its centre; on the plane, many at negative
    coordinates; on all six faces of the rotated box, on an edge and at a
    corner; on the mesh."""
    rng = np.random.default_rng(seed)
    start = {k: sum(js.kind_counts[:k]) for k in range(4)}
    rows, q = [], []
    d = rng.normal(size=(n, 3))
    q += list(0.5 * d / np.linalg.norm(d, axis=1, keepdims=True))
    q.append(np.zeros(3))                             # degenerate lane
    rows += [start[schema.KIND_SPHERE]] * (n + 1)
    q += list(rng.uniform(-3.7, 2.2, (n, 3)))
    rows += [start[schema.KIND_PLANE]] * n
    sizes = np.asarray(js.prim_a)[start[schema.KIND_BOX]]
    for axis in range(3):
        for sgn in (1.0, -1.0):
            f = rng.uniform(-0.95, 0.95, (n // 6, 3))
            f[:, axis] = sgn
            q += list(f * sizes / 2)
    q += [np.asarray([1.0, 1.0, 0.3]) * sizes / 2,      # an edge
          np.asarray([-1.0, 1.0, -1.0]) * sizes / 2]    # a corner
    rows += [start[schema.KIND_BOX]] * (6 * (n // 6) + 2)
    q += list(rng.uniform(-1, 1, (8, 3)))
    rows += [start[schema.KIND_TRIANGLE]] * 8
    rows = np.asarray(rows)
    return rows, _object_points(js, rows, np.asarray(q))


def test_uv_matches_jax():
    js, ps = _scene("textured")
    rows, pts = _surface_points(js, 120, 0)
    attrs = ji.prim_attributes(js, ji.build_frames(js))
    uv_j = np.asarray(ji.uv_from_attrs(ji.AttrView(attrs[rows]),
                                       jnp.asarray(pts)))
    kind, tables = _kinds(ps, torch.from_numpy(rows))
    u, v = ti.uv_from_attrs(tables.tab.detach()[rows], torch.from_numpy(pts),
                            kind)
    got = torch.stack([u, v], 1).numpy()
    assert np.isnan(got[120]).all() and np.isnan(uv_j[120]).all()
    np.testing.assert_allclose(got, uv_j, rtol=1e-6, atol=1e-6)
    tri = kind.numpy() == schema.KIND_TRIANGLE
    assert (got[tri] == 0).all() and (got[~tri & ~np.isnan(got[:, 0])]
                                      > 0).any()
    # the box's six faces reach the six cells of the cross atlas (the edge
    # and the corner, last, lie on cell borders)
    box = kind.numpy() == schema.KIND_BOX
    cells = {(int(a * 4), int(b * 3)) for a, b in got[box][:-2]}
    assert cells == {(1, 0), (0, 1), (1, 1), (2, 1), (3, 1), (1, 2)}


def test_sample_texture_matches_jax():
    """Every texture, map id -1 included, at uv inside, outside and on the
    edges of [0, 1], and at NaN and infinities (the texel of a degenerate
    sphere lane): the same texel, exactly."""
    js, ps = _scene("textured")
    rng = np.random.default_rng(1)
    n = 400
    T = len(np.asarray(js.tex_w))
    tid = rng.integers(-1, T, n).astype(np.int32)
    uv = rng.uniform(-0.3, 1.3, (n, 2)).astype(np.float32)
    uv[:8] = [[0, 0], [1, 1], [np.nan, 0.5], [0.5, np.nan],
              [np.nan, np.nan], [np.inf, -np.inf], [-np.inf, 2.0],
              [0.999999, 0.0]]
    want = np.asarray(ji.sample_texture(js, jnp.asarray(tid),
                                        jnp.asarray(uv)))
    atlas, tmeta = ti.tex_tables(ps)
    got = ti.sample_texture(atlas, tmeta, torch.from_numpy(tid),
                            torch.from_numpy(uv[:, 0]),
                            torch.from_numpy(uv[:, 1]))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["textured", "tex_blocks"])
def test_material_from_attrs_matches_jax(name):
    """Every map slot (the small ``tex_blocks`` maps all six), map ids -1
    included: the mapped color, rough, metal, glass, opacity and emit and
    the raw ``metal_scalar``."""
    js, ps = _scene(name)
    rng = np.random.default_rng(2)
    valid = np.nonzero(np.asarray(js.prim_valid))[0]
    rows = rng.choice(valid, 300)
    kind_j = np.asarray(ji._kind_array(js))[rows]
    sizes = np.asarray(js.prim_a)[rows]
    q = rng.uniform(-0.95, 0.95, (300, 3))
    face = rng.integers(0, 3, 300)
    q[np.arange(300), face] = rng.choice([-1.0, 1.0], 300)
    q = np.where((kind_j == schema.KIND_BOX)[:, None], q * sizes / 2,
                 rng.uniform(-2, 2, (300, 3)))
    pts = _object_points(js, rows, q)
    attrs = ji.prim_attributes(js, ji.build_frames(js))
    want = ji.material_from_attrs(js, ji.AttrView(attrs[rows]),
                                  jnp.asarray(pts))
    kind, tables = _kinds(ps, torch.from_numpy(rows))
    at = tables.tab.detach()[rows]
    mat = {"color": at[:, step._C_ALB:step._C_ALB + 3],
           "rough": at[:, step._C_RGH], "metal": at[:, step._C_MET],
           "glass": at[:, step._C_GLS], "opacity": at[:, step._C_OPA],
           "emit": at[:, step._C_EMI]}
    ids = tables.maps[rows]
    got = ti.material_from_attrs(ps, mat, ids, torch.from_numpy(pts), at,
                                 kind)
    u, v = ti.uv_from_attrs(at, torch.from_numpy(pts), kind)
    edge = torch.zeros(300, dtype=torch.bool)
    for s in range(6):
        edge |= ti.texel_edge(tables.tmeta, ids[:, s], u, v,
                              step.TEX_EDGE) & (ids[:, s] >= 0)
    edge &= kind != schema.KIND_TRIANGLE     # uv 0: the texel never flips
    assert int(edge.sum()) <= 3
    keep = ~edge.numpy()
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy()[keep],
                                      np.asarray(want[key])[keep],
                                      err_msg=key)
    if name == "tex_blocks":
        assert all(ps.map_slots) and (ids < 0).any()
        assert not torch.equal(got["metal"], got["metal_scalar"])


# --- the textured whole trace -----------------------------------------------

def _inputs(name):
    """R rays (random ones for the JAX scenes, 16x16 camera rays of the
    stand-ins) and K steps of uniforms, as numpy."""
    js, ps = _scene(name)
    if name in JAX_NAMES:
        o, d = rays(R, seed=3)
    else:
        cam = jcomp.compile_camera(schema.CameraConfig.from_json(
            CAMERAS[name]))
        ys, xs = np.divmod(np.arange(R), 16)
        coords = np.stack([xs, ys], -1).astype(np.float32)
        u_aprt = np.random.default_rng(6).random((R, 2)).astype(np.float32)
        o, d = (np.asarray(x) for x in jcam_mod.gen_rays(
            cam, (16, 16), jnp.asarray(coords), jnp.asarray(u_aprt)))
    u8s = np.random.default_rng(4).random(
        (K, step.n_uni(ps.any_refract), R)).astype(np.float32)
    return o, d, u8s


def _maps(js, tex):
    return (tuple(js.map_slots), int(tex[1].shape[0]),
            tuple(js.mapped_kinds))


@functools.lru_cache(maxsize=None)
def _both(name):
    """The JAX inference trace, the JAX train-mode residuals and the port's
    plain trace (with residuals and ``work``) on the same inputs."""
    js, ps = _scene(name)
    o, d, u8s = _inputs(name)
    consts, attr, gattr, attr2, lights, tex = _jax_pack(js)
    args = (jps._seg_layout(js.kind_counts), js.any_refract, js.n_lights, K,
            consts, attr, lights, jnp.float32(DECAY), jnp.asarray(o.T),
            jnp.asarray(d.T), jnp.asarray(u8s))
    kw = dict(tex=tex, maps=_maps(js, tex), gattr=gattr, attr2=attr2)
    A_j, B_j, fl_j = (np.asarray(x) for x in jps._call_trace(*args, **kw))
    res_j = np.asarray(jps._call_trace(*args, train=True, **kw)[3])
    work = {"sweep": 0, "shadow": 0}
    port = step.trace_plain(ps, step.pack_step(ps), DECAY,
                            torch.from_numpy(o.T.copy()),
                            torch.from_numpy(d.T.copy()),
                            torch.from_numpy(u8s), want_resid=True,
                            work=work)
    return (A_j, B_j, fl_j, res_j), port, work


def _split_outliers(name, port, jax_out, work):
    """(bad, texel flips): rays outside the trace tolerance, and those of
    them shown to be texel flips; both capped."""
    A, B = port[:2]
    bad = np.zeros(R, bool)
    for g, w in ((A, jax_out[0]), (B, jax_out[1])):
        bad[outlier_rows(g.numpy().T, w.T, RTOL, ATOL)] = True
    flip = bad & work["tex_edge"].numpy()
    print(f"{name}: {int(bad.sum())} of {R} rays outside tolerance, "
          f"{int(flip.sum())} of them texel flips; "
          f"{int(work['tex_edge'].sum())} rays near a texel edge")
    assert (bad & ~flip).sum() <= SHARE * R, name
    assert flip.sum() <= max_flips(int(work["tex_edge"].sum())), name
    return bad, flip


@pytest.mark.parametrize("name", JAX_NAMES + TEX_NAMES)
def test_trace_plain_matches_pallas_trace(name):
    (A_j, B_j, fl_j, _res), port, work = _both(name)
    A, B, fl = port[:3]
    assert fl_j.sum() > 0.3 * R
    np.testing.assert_array_equal(fl.numpy(), fl_j)
    assert work["tex_fetch"] > R
    _split_outliers(name, port, (A_j, B_j), work)


@pytest.mark.parametrize("name", JAX_NAMES)
def test_resid_texel_rows_match_pallas_train_mode(name):
    """The texel rows (present slots, entry side then exit side) against
    the JAX train-mode residuals, on the live steps of rays inside the
    tolerance where the side's map id is not -1; the port's rows hold 0
    where the id is -1."""
    js, ps = _scene(name)
    (A_j, B_j, _f, res_j), port, work = _both(name)
    res, n_live = port[3].numpy(), port[4].numpy()
    L = ps.n_lights
    tables = step.pack_step(ps)
    n_tri = tables.layout[3]
    assert res.shape[1] == step.scene_res_rows(ps, tables.layout)
    bad, _flip = _split_outliers(name, port, (A_j, B_j), work)
    live = (np.arange(K)[:, None] < n_live[None]) & ~bad[None]
    assert live.sum() > R // 2
    maps = tables.maps.numpy()
    row = res[:, step.RES_ROW].astype(int)
    xrow = res[:, step.res_xrow(L)].astype(int) if n_tri else row
    mine, theirs = step.res_rows(L, n_tri), jps._R_LOK + L
    checked = 0
    for side_row in (row, xrow):
        for s in range(6):
            if not ps.map_slots[s]:
                continue
            mapped = maps[side_row, s] >= 0
            for c in range(3 if s == 0 else 1):
                got, want = res[:, mine], res_j[:, theirs]
                sel = live & mapped
                np.testing.assert_allclose(got[sel], want[sel], rtol=1e-5,
                                           err_msg=f"slot {s}")
                assert (got[live & ~mapped] == 0).all()
                checked += int(sel.sum())
                mine, theirs = mine + 1, theirs + 1
    assert mine == res.shape[1] and checked > R // 2


def test_texels_are_saved_only_on_textured_scenes():
    """Room and mesh scenes keep their residual rows; a textured scene adds
    one side's texel rows, twice when it refracts."""
    js, ps = _scene("textured_flat")
    # tex, rmap, omap, emap
    assert step.tex_rows(ps) == 2 * (3 + 1 + 1 + 1)
    js_o = jcomp.compile_scene(schema.SceneConfig.from_json(
        scenes()["glass"]))
    po = port_scene(js_o)
    assert step.tex_rows(po) == 0 and step.pack_step(po).maps is None
    assert step.scene_res_rows(po, step.pack_step(po).layout) == \
        step.res_rows(po.n_lights, po.kind_sweep[3])


# --- front ends -------------------------------------------------------------

def _tex_json(tmp_path, fmt):
    """A small ``tex_dof`` whose checker is a raw buffer, an inline
    base64(gzip(JSON)) string or a PNG file."""
    cfg = render_json("tex_dof", small=True, res=24, bounce=2, sample=2)
    plane = cfg["scene"]["renderer"][0]["mat"]
    if fmt == "inline":
        plane["tex"] = assets.encode_inline(plane["tex"])
    elif fmt == "png":
        img = np.asarray(plane["tex"]["dat"], np.float32).reshape(
            plane["tex"]["h"], plane["tex"]["w"], 3)
        path = tmp_path / "checker.png"
        Image.fromarray(np.round(img * 255).astype(np.uint8)).save(path)
        plane["tex"] = str(path)
    return cfg


def test_cli_renders_all_three_texture_formats(tmp_path):
    """The CLI renders a textured JSON with the texture as a raw buffer,
    inline and a PNG file: rc 0, one plain trace per sample, the same
    image."""
    imgs = []
    for fmt in ("buffer", "inline", "png"):
        cfg = tmp_path / f"{fmt}.json"
        cfg.write_text(json.dumps(_tex_json(tmp_path, fmt)))
        out = tmp_path / f"{fmt}.png"
        before = step.KERNEL.plain_calls
        assert tcli.main([str(cfg), "--device", "cpu", "-o", str(out)]) == 0
        assert step.KERNEL.plain_calls == before + 2
        imgs.append(np.asarray(Image.open(out)))
    assert imgs[0].shape == (24, 24, 3) and imgs[0].std() > 5.0
    for img in imgs[1:]:
        np.testing.assert_array_equal(img, imgs[0])


def test_http_renders_a_textured_scene(server):  # noqa: F811
    body = json.dumps(render_json("tex_blocks", small=True, res=24,
                                  bounce=2, sample=2)).encode()
    res = _req(server, b"POST /render HTTP/1.1\r\nContent-Type: "
               b"application/json\r\n"
               + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    assert res.startswith(b"HTTP/1.1 200 OK")
    assert res.split(b"\r\n\r\n", 1)[1][:2] == b"\xff\xd8"
