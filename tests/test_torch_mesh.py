"""The port's Mesh class against the JAX package: the Woop table, the cull
blocks, the triangle sweeps with the per-ray block cull, the whole trace,
its residuals and its gradients, and the CLI and HTTP service on mesh
scenes (on the CPU, where every wrapper runs its plain version).

The JAX side runs its Pallas kernels in interpret mode (``MRT_HIT3=1``,
``MRT_STEP=1``), as its own tests do. Tolerances:

* ``triangle_pack`` and the block AABBs: rtol 1e-5 / atol 1e-6 (the same
  float32 formulas; sums may associate differently);
* sweeps on the clustered 210-triangle scene, where the cull is active and
  no phantom hit lies outside its block: rows equal and t within rtol 1e-5
  / atol 1e-6, with the port's cull on and off;
* the whole trace: ``test_torch_step.py``'s rule (rtol 1e-3 / atol 1e-4 on
  all but 0.5% of rays), against the JAX trace run without its cull
  (``MRT_TRI_NOCULL=1``): the JAX block bounds omit a mesh's instance
  translation (see ``hit3.tri_blockbounds``), so its tile cull drops real
  hits of the translated torus;
* residuals and gradients (the ``glass`` scene: a glass sphere, a plane and
  a 16-triangle mesh, one group of many rows): ``test_torch_grad.py``'s
  rules — rays whose discrete path flips are dropped (at most 0.5%), then
  rtol 2e-3 with an absolute floor of 1e-5 of the largest magnitude; the
  JAX package's own gate is rtol 1e-3 / atol 1e-6 on leaf sums, and the two
  forwards already differ at float32 rounding. The triangle cotangents are
  those of ``G[2]`` (the port's ``tri[:, 6:9]``, JAX's ``AT[:, 6:9]``) and
  ``h[2]`` (``tri[:, 11]``, ``HT[:, 2]``).
"""

import dataclasses
import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from micro_raytracer_tpu.models import compiler as jcomp
from micro_raytracer_tpu.models import schema
from micro_raytracer_tpu.ops import intersect as ji
from micro_raytracer_tpu.ops import pallas_hit3 as jh
from micro_raytracer_tpu.ops import pallas_step as jps
from micro_raytracer_tpu_torch.frontends import cli as tcli
from micro_raytracer_tpu_torch.models import tracer as ttr
from micro_raytracer_tpu_torch.ops import hit3, intersect as ti, step
from test_torch_cli import _req, server  # noqa: F401  (fixture)
from test_torch_grad import (R, _assert_grad_close, _jax_pack, _module_case,
                             check_resid, check_trace_grad)
from torch_mesh_helpers import (CLUSTERED, aimed_rays, mesh_scene,
                                small_torus, torus)
from torch_mesh_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import outlier_rows, port_scene, rays

SCENES = {"clustered": CLUSTERED,
          "mesh_opaque": mesh_scene("mesh_opaque", small_torus()),
          "mesh_glass": mesh_scene("mesh_glass", small_torus())}


@functools.lru_cache(maxsize=None)
def _scene(name):
    js = jcomp.compile_scene(schema.SceneConfig.from_json(SCENES[name]))
    return js, port_scene(js)


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("name", ["clustered", "mesh_glass"])
def test_triangle_pack_matches_jax(name):
    js, ps = _scene(name)
    want = ji.triangle_pack(js, ji.build_frames(js))
    got = ti.triangle_pack(ps, ti.build_frames(ps))
    for g, w in zip(got[:3], want[:3]):
        _close(g.numpy(), w)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    tri, _tbb = hit3.tri_tables(ps, ti.build_frames(ps))
    AT, HT, thr = jh.pallas_tri.pack_consts(want, js.prim_valid[
        js.seg(schema.KIND_TRIANGLE)])
    _close(tri[:, :9].detach(), AT)
    _close(tri[:, 9:12].detach(), HT)
    _close(tri[:, 12:13], thr)


def test_tri_blockbounds_match_jax():
    """The port's block AABBs are _tri_superbounds of the vertices placed
    where the Woop test puts them (``v + ip`` before the frame's inverse):
    equal to it for an untranslated mesh, and equal to it on moved
    vertices for the clustered mesh (translated and rotated)."""
    for src, pos in ((CLUSTERED, None), (CLUSTERED, [0.0, 0.0, 0.0])):
        if pos is not None:
            src = {"renderer": [dict(src["renderer"][0], pos=pos),
                                src["renderer"][1]]}
        js = jcomp.compile_scene(schema.SceneConfig.from_json(src))
        ps = port_scene(js)
        got = hit3.tri_blockbounds(ps, ti.build_frames(ps)).numpy()
        s = js.seg(schema.KIND_TRIANGLE)
        ip = js.inst_pos
        moved = dataclasses.replace(js, **{
            k: getattr(js, k).at[s].add(ip[s])
            for k in ("prim_a", "prim_b", "prim_c")})
        want = np.asarray(jh._tri_superbounds(moved, ji.build_frames(js)))
        assert got.shape == (-(-ps.kind_counts[3] // hit3.CB), 8)
        _close(got, want[:got.shape[0]])
        if pos is not None:      # no translation: JAX's own table
            _close(got, np.asarray(jh._tri_superbounds(
                js, ji.build_frames(js)))[:got.shape[0]])


def test_cull_keeps_every_hit_on_the_torus():
    """Conservative: on the 960-triangle torus the culled entry and any-hit
    sweeps give the unculled sweep's hits, and they skip most rows."""
    ps = port_scene(jcomp.compile_scene(schema.SceneConfig.from_json(
        mesh_scene("mesh_opaque"))))
    tables = step.pack_step(ps)
    o, d = (torch.from_numpy(a) for a in rays(2048, seed=9))
    o = o * 0.22
    args = (tables.tab, tables.layout, o, d)
    for mode in (hit3.MODE_ENTRY, hit3.MODE_ANY):
        culled = hit3.closest_hit(*args, mode, tables.tri, tables.tbb)
        full = hit3.closest_hit(*args, mode, tables.tri, None)
        for c, f in zip(culled, full):
            assert torch.equal(c, f)
        tested = hit3.tri_rows_tested(*args, mode, tables.tri, tables.tbb)
        assert float(tested.float().mean()) < 0.5 * ps.kind_sweep[3]
    assert int((culled[0] < 0).sum()) > 100


@functools.lru_cache(maxsize=None)
def _jax_hits(need_exit):
    js, ps = _scene("clustered")
    o, d = aimed_rays(ps, 512, 3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MRT_HIT3", "1")
        jfr = ji.build_frames(js)
        h = jh.closest_hit(js, jfr, jnp.asarray(o), jnp.asarray(d),
                           need_exit=need_exit)
        anyh = jh.any_hit(js, jfr, jnp.asarray(o), jnp.asarray(d))
    return (o, d), tuple(np.asarray(x) for x in (
        h.hit, h.t_entry, h.idx_entry, h.t_exit, h.idx_exit)), \
        np.asarray(anyh)


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("mode", ["entry", "exit", "any"])
def test_sweep_matches_pallas_on_clustered_mesh(mode, cull):
    _js, ps = _scene("clustered")
    tables = step.pack_step(ps)
    assert tables.tbb is not None and tables.tbb.shape[0] > 1
    (o, d), (hit, te, row, tx, xrow), anyh = _jax_hits(mode == "exit")
    m = {"entry": hit3.MODE_ENTRY, "exit": hit3.MODE_EXIT,
         "any": hit3.MODE_ANY}[mode]
    got = [t.numpy() for t in hit3.closest_hit(
        tables.tab, tables.layout, torch.from_numpy(o), torch.from_numpy(d),
        m, tables.tri, tables.tbb if cull else None)]
    if mode == "any":
        assert anyh.sum() > 50
        np.testing.assert_array_equal(got[0] < 0.0, anyh)
        return
    assert (got[1] >= tables.layout[1]).sum() > 50
    np.testing.assert_array_equal(got[0] < hit3.BIG * 0.5, hit)
    np.testing.assert_array_equal(got[1], row)
    _close(got[0][hit], te[hit])
    if mode == "exit":
        np.testing.assert_array_equal(got[3], xrow)
        _close(got[2][hit], tx[hit])


@pytest.mark.parametrize("name", ["mesh_opaque", "mesh_glass"])
def test_trace_plain_matches_pallas_trace(name, monkeypatch):
    """A 16x16 frame's worth of rays from inside the room, bounce 3."""
    monkeypatch.setenv("MRT_STEP", "1")
    monkeypatch.setenv("MRT_TRI_NOCULL", "1")
    js, ps = _scene(name)
    n, K = 256, 4
    o, d = rays(n, seed=3)
    o = (o * 0.22).astype(np.float32)
    u8s = np.random.default_rng(4).random(
        (K, step.n_uni(ps.any_refract), n)).astype(np.float32)
    consts, attr, gattr, attr2, lights, tex = _jax_pack(js)
    A_j, B_j, fl_j = jps.trace_packed(
        js, consts, attr, lights, jnp.float32(0.85), jnp.asarray(o.T),
        jnp.asarray(d.T), jnp.asarray(u8s), tex=tex, inference=True,
        gattr=gattr, attr2=attr2)
    A, B, fl = step.trace_packed(
        ps, step.pack_step(ps), ttr.decay_of(0.15),
        torch.from_numpy(o.T.copy()), torch.from_numpy(d.T.copy()),
        torch.from_numpy(u8s))
    assert np.asarray(fl_j).sum() > 0.5 * n
    np.testing.assert_array_equal(fl.numpy(), np.asarray(fl_j))
    for g, w in ((A, A_j), (B, B_j)):
        bad = outlier_rows(g.numpy().T, np.asarray(w).T, 1e-3, 1e-4)
        assert len(bad) <= 0.005 * n, bad


def test_resid_matches_pallas_train_mode_glass():
    """The residuals of the glass scene (the exit row xrow of a multi-row
    group included) against the JAX train-mode residual block."""
    check_resid("glass")


def test_trace_grad_matches_pallas_vjp_glass():
    """d_attr, d_lights, d_oT, d_dT of one trace through a refractive mesh,
    and the triangle cotangents against JAX's dAT[:, 6:9] and dHT[:, 2]."""
    check_trace_grad("glass")
    _bad, g_j, g_t = _module_case("glass")
    dAT, dHT = np.asarray(g_j[4]), np.asarray(g_j[5])
    d_tri = g_t[4].numpy()
    Pt = d_tri.shape[0]
    assert Pt == 16 and np.abs(dHT).max() > 0
    _assert_grad_close("dG2", d_tri[:, 6:9], dAT[:Pt, 6:9])
    _assert_grad_close("dh2", d_tri[:, 11], dHT[:Pt, 2])
    # only G[2] and h[2] carry a cotangent (the winner's t)
    np.testing.assert_array_equal(d_tri[:, :6], 0.0)
    np.testing.assert_array_equal(d_tri[:, 12:], 0.0)
    assert R == g_t[2].shape[1]


# --- the front ends on a mesh scene ----------------------------------------

def _mesh_json(tmp_path, obj_file):
    """A small mesh scene: the coarse torus inline, or from an OBJ file."""
    tris = small_torus()
    scene = mesh_scene("mesh_opaque", tris)
    if obj_file:
        path = tmp_path / "torus.obj"
        lines = [f"v {x} {y} {z}" for x, y, z in tris.reshape(-1, 3)]
        lines += [f"f {3 * i + 1} {3 * i + 2} {3 * i + 3}"
                  for i in range(len(tris))]
        path.write_text("\n".join(lines) + "\n")
        scene["renderer"][-1]["mesh"] = str(path)
    return {"scene": scene, "frame": {"res": [24, 24], "cam": {
        "pos": [0, -1.25, 0], "fov": 60}}, "rt": {"bounce": 2, "sample": 2}}


def test_cli_renders_inline_and_obj_meshes(tmp_path):
    """The CLI renders a JSON scene with an inline mesh, and the same scene
    with the mesh in an OBJ file, through the plain trace; the images are
    equal and show the torus."""
    imgs = []
    for obj_file in (False, True):
        cfg = tmp_path / f"scene{int(obj_file)}.json"
        cfg.write_text(json.dumps(_mesh_json(tmp_path, obj_file)))
        out = tmp_path / f"o{int(obj_file)}.png"
        before = step.KERNEL.plain_calls
        assert tcli.main([str(cfg), "--device", "cpu", "-o", str(out)]) == 0
        assert step.KERNEL.plain_calls == before + 2      # one per sample
        imgs.append(np.asarray(Image.open(out)))
    np.testing.assert_array_equal(imgs[0], imgs[1])
    assert imgs[0].shape == (24, 24, 3) and imgs[0].std() > 5.0


def test_http_renders_a_mesh_scene(server, tmp_path):  # noqa: F811
    body = json.dumps(_mesh_json(tmp_path, False)).encode()
    res = _req(server, b"POST /render HTTP/1.1\r\nContent-Type: "
               b"application/json\r\n"
               + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    assert res.startswith(b"HTTP/1.1 200 OK")
    assert res.split(b"\r\n\r\n", 1)[1][:2] == b"\xff\xd8"


def test_torus_is_closed_and_outward():
    t = torus()
    assert t.shape == (960, 3, 3)
    edges = {}
    for tri in t.round(6):
        for a, b in ((0, 1), (1, 2), (2, 0)):
            key = tuple(sorted((tuple(tri[a]), tuple(tri[b]))))
            edges[key] = edges.get(key, 0) + 1
    assert set(edges.values()) == {2}           # every edge shared by two
