"""The triangle segment on its own (``ops/tri.py``, ``csrc/tri.cu``) and the
per-step route of meshes past ``hit3.MAX_TRI_BLOCKS`` cull blocks, against
the JAX package (on the CPU, where every wrapper runs its plain version).

Scenes: ``small``, test_pallas_tri.py's fixture (40 random triangles in a
rotated, translated mesh, a glass tetrahedron, a sphere and a plane), and
``big``, 8,224 small random triangles instanced twice (two groups, 16,448
rows: 257 cull blocks, one past the staged bound) beside a sphere over a
plane, under one light (``big_glass``: the mesh is glass; ``big_mixed``:
the mesh is opaque and the sphere glass, so the scene refracts but a
winner on the mesh needs no group exit).

* ``tri_entry``, ``tri_entry_exit``, ``tri_group_exit`` and the any-hit
  use of ``tri_entry`` on the constants of ``tri.from_pallas_consts``
  against ``pallas_tri``'s kernels in interpret mode, as
  ``test_pallas_tri.py`` runs them: rows equal, t within rtol 1e-5 / atol
  1e-6; the port's own tables with the per-ray cull give the same rows
  and t on these rays (no phantom hit lies outside its block).
* Their gradients (autograd of ``TriEntry``, ``TriEntryExit``,
  ``TriGroupExit``) against ``jax.vjp`` of pallas_tri's custom VJPs: rtol
  2e-4 / atol 1e-5, the JAX test's own bar (``test_pallas_tri.py``).
* ``step.route`` sends a mesh past the bound to the per-step path with 1
  light and with 5, with and without a gradient.
* One plain step of the big scenes against the JAX package's bounce step
  (``tracer.fused_step_reference``, ``_bounce_step`` with its explicit
  uniforms) on the ``pallas_tri`` path (``MRT_TRI_PALLAS=1``,
  ``MRT_TRI_PALLAS_MIN=1``), under ``test_torch_steps.py``'s rule (values
  within rtol 1e-3 / atol 1e-4 on all but 0.5% of rays: pallas_tri sweeps
  every row and decides occlusion by its entry test, the port culls and
  uses the division-free any-hit test).
* The plain per-step route on the big scenes equals the plain whole trace
  bit for bit (on these rays the cull against the triangles' own best and
  against the dense rows' best skip no hit), also where it sweeps the
  group exit of refracting rows only (``big_mixed``).
* The host C++ build of ``csrc/tri.cu``'s per-ray functions equals the
  plain versions bit for bit (rays read from a carry with dead lanes);
  its two-level walk equals the one-level walk of ``hit3.cuh`` and the
  plain entry bit for bit, its culled group exit ``entry_exit_plain`` (and
  the unculled exit but on phantom exits, ``tri.culled_exit_phantoms``,
  whose gate fails on a mutant cull), on random, camera, axis-parallel
  (and NaN) rays and rays from inside blocks, on ``big_glass`` and on
  ``odd_glass`` (10,006 triangles: a partial last block and superblock, a
  group boundary inside a block), over all rows and a row count inside
  the last block, with the superblocks staged or read from global memory;
  ``tri.superbounds`` and the chunk bounds are exact min / max (an
  inverted block of invalid rows included); the culled plain exit
  (``hit3._tri_exit`` with the cull blocks) matches ``pallas_tri``'s group
  exit;
  the host build of ``step_fwd.cu``'s kTriIn instance equals its kTri
  instance bit for bit on the torus scenes, whose segments it can sweep
  itself, and matches the plain step on the big scenes by
  ``test_torch_kernel_host.py``'s rule (0.3% of rays).
"""

import ctypes
import functools
import json
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micro_raytracer_tpu.models import compiler as jcomp
from micro_raytracer_tpu.models import schema as jschema
from micro_raytracer_tpu.models import tracer as jtr
from micro_raytracer_tpu.ops import intersect as ji
from micro_raytracer_tpu.ops import pallas_tri as jpt
from micro_raytracer_tpu_torch.frontends import cli
from micro_raytracer_tpu_torch.models import schema
from micro_raytracer_tpu_torch.models.compiler import compile_scene
from micro_raytracer_tpu_torch.ops import hit3, intersect, step, tri
from micro_raytracer_tpu_torch.utils.kernels import CSRC
from test_torch_kernel_host import _SHIM
from test_torch_steps import DECAY, _carry, _on, _outliers, _u8, _unpack
from torch_mesh_helpers import (aimed_rays, big_tris, mesh_scene,
                                stack_table)
from torch_mesh_helpers import big_mesh as big
from torch_mesh_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import port_scene, rays

RTOL, ATOL = 1e-5, 1e-6
G_RTOL, G_ATOL = 2e-4, 1e-5
R = 512


def _small():
    rng = np.random.default_rng(1)
    tris = rng.uniform(-1, 1, (40, 3, 3)).astype(np.float32)
    tetra = [
        [[0.0, 0.0, 0.35], [-0.3, -0.2, -0.25], [0.3, -0.2, -0.25]],
        [[0.0, 0.0, 0.35], [0.3, -0.2, -0.25], [0.0, 0.3, -0.25]],
        [[0.0, 0.0, 0.35], [0.0, 0.3, -0.25], [-0.3, -0.2, -0.25]],
        [[-0.3, -0.2, -0.25], [0.3, -0.2, -0.25], [0.0, 0.3, -0.25]],
    ]
    return {"renderer": [
        {"type": "mesh", "mesh": tris.tolist(), "dir": [0, 0.4, 0.6, 0.2],
         "pos": [0.2, -0.1, 0.3]},
        {"type": "mesh", "mesh": tetra, "pos": [-0.5, 0.5, 0],
         "mat": {"opacity": 0.0, "glass": 0.1}},
        {"type": "sphere", "r": 0.3},
        {"type": "plane", "n": [0, 0, 1], "pos": [0, 0, -0.9]},
    ]}


def _odd():
    """10,006 glass triangles, :func:`big_tris` (5,003) instanced twice: a
    multiple of neither 64 nor a superblock's 1,024 rows (157 cull blocks
    in 10 superblocks, the last of 13 blocks), and the second group starts
    inside block 78."""
    js = big(True)
    js["renderer"][0]["mesh"] = big_tris(5003, seed=6).tolist()
    return js


SCENES = {"small": _small, "big": big, "big_glass": lambda: big(True),
          "big_mixed": lambda: big(glass_sphere=True), "odd_glass": _odd}


@functools.lru_cache(maxsize=None)
def _scene(name):
    """(JAX scene, port scene) compiled from one JSON."""
    js = jcomp.compile_scene(jschema.SceneConfig.from_json(SCENES[name]()))
    return js, port_scene(js)


@functools.lru_cache(maxsize=None)
def _consts(name):
    """pallas_tri's constants of the scene's triangle segment (numpy) and
    the port's table from them."""
    js, _ps = _scene(name)
    s = js.seg(jschema.KIND_TRIANGLE)
    AT, HT, thr = jpt.pack_consts(ji.triangle_pack(js, ji.build_frames(js)),
                                  js.prim_valid[s])
    gid = np.asarray(js.group_id[s], np.float32)
    AT, HT, thr = (np.asarray(x) for x in (AT, HT, thr))
    return AT, HT, thr, gid, tri.from_pallas_consts(AT, HT, thr, gid)


@functools.lru_cache(maxsize=None)
def _rays(name):
    """float32 numpy rays: test_pallas_tri's random rays for ``small``,
    rays aimed at the mesh's cull blocks for the big scenes."""
    if name == "small":
        return rays(R, seed=0)
    return aimed_rays(_scene(name)[1], R, 3)


def _jax_entry(name, o, d):
    AT, HT, thr, _gid, _t = _consts(name)
    return [np.asarray(x) for x in jpt.tri_entry(AT, HT, thr, jnp.asarray(o),
                                                 jnp.asarray(d))]


def _close_t(got, want, mask):
    np.testing.assert_allclose(np.asarray(got)[mask], np.asarray(want)[mask],
                               rtol=RTOL, atol=ATOL)


def _culled(name):
    """The port's own triangle table and cull blocks of the scene."""
    _js, ps = _scene(name)
    return hit3.tri_tables(ps, intersect.build_frames(ps))


@pytest.mark.parametrize("name", ["small", "big"])
def test_tri_entry_matches_pallas_tri(name):
    o, d = _rays(name)
    te_j, row_j = _jax_entry(name, o, d)
    t = _consts(name)[4]
    te, row = tri.tri_entry(t, torch.from_numpy(o), torch.from_numpy(d))
    hit = te_j < jpt._BIG * 0.5
    assert 0.1 * R < hit.sum() < R
    np.testing.assert_array_equal(te.numpy() < tri.BIG * 0.5, hit)
    np.testing.assert_array_equal(row.numpy(), row_j)
    _close_t(te, te_j, hit)
    # the port's tables, culled per ray: the same rows and t
    t2, tbb = _culled(name)
    assert (tbb is None) == (name == "small")
    te2, row2 = tri.tri_entry(t2.detach(), torch.from_numpy(o),
                              torch.from_numpy(d), tbb)
    assert torch.equal(row2, row)
    _close_t(te2, te_j, hit)


@pytest.mark.parametrize("name", ["small", "big_glass"])
def test_tri_entry_exit_matches_pallas_tri(name):
    AT, HT, thr, gid, t = _consts(name)
    o, d = _rays(name)
    te_j, row_j, tx_j, xrow_j = (np.asarray(x) for x in jpt.tri_entry_exit(
        AT, HT, thr, gid[:, None], jnp.asarray(o), jnp.asarray(d)))
    te, row, tx, xrow = tri.tri_entry_exit(t, torch.from_numpy(o),
                                           torch.from_numpy(d))
    hit = te_j < jpt._BIG * 0.5
    assert 0.1 * R < hit.sum() < R
    np.testing.assert_array_equal(row.numpy(), row_j)
    np.testing.assert_array_equal(xrow.numpy(), xrow_j)
    np.testing.assert_array_equal(tx.numpy() > -tri.BIG * 0.5,
                                  tx_j > -jpt._BIG * 0.5)
    _close_t(te, te_j, hit)
    _close_t(tx, tx_j, hit)
    # an exit differs from its entry where the group is closed
    assert (np.asarray(xrow)[hit] != np.asarray(row)[hit]).mean() > 0.3
    t2, tbb = _culled(name)
    got = tri.tri_entry_exit(t2.detach(), torch.from_numpy(o),
                             torch.from_numpy(d), tbb)
    assert torch.equal(got[1], row) and torch.equal(got[3], xrow)


@pytest.mark.parametrize("name", ["small", "big_glass"])
def test_tri_group_exit_matches_pallas_tri(name):
    """Fed the entry winners' groups (no group on a miss): the JAX exit,
    and tri_entry_exit's exit wherever a triangle wins."""
    AT, HT, thr, gid, t = _consts(name)
    o, d = _rays(name)
    te_j, row_j = _jax_entry(name, o, d)
    hit = te_j < jpt._BIG * 0.5
    wg = np.where(hit, gid[row_j], -5.0).astype(np.float32)
    tx_j, xrow_j = (np.asarray(x) for x in jpt.tri_group_exit(
        AT, HT, thr, gid[:, None], jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(wg)))
    tx, xrow = tri.tri_group_exit(t, torch.from_numpy(o), torch.from_numpy(d),
                                  torch.from_numpy(wg))
    np.testing.assert_array_equal(xrow.numpy()[hit], xrow_j[hit])
    np.testing.assert_array_equal(tx.numpy() < -tri.BIG * 0.5, ~hit)
    _close_t(tx, tx_j, hit)
    ee = tri.tri_entry_exit(t, torch.from_numpy(o), torch.from_numpy(d))
    assert torch.equal(ee[2], tx) and torch.equal(ee[3], xrow)


def test_tri_entry_exit_sweeps_the_refracting_winners_only():
    """With ``refr`` a winner on a row marked 1 gets the group exit of
    ``refr=None``, any other winner is its own exit (tx = te, xrow = row);
    the step's rows: every mesh row refracts in ``big_glass``, none in
    ``big_mixed``, whose glass is a sphere."""
    t, tbb = _culled("big_glass")
    t = t.detach()
    o, d = (torch.from_numpy(x) for x in _rays("big_glass"))
    refr = (torch.rand(t.shape[0], generator=torch.Generator().manual_seed(
        3)) < 0.5).to(torch.float32)
    full = tri.tri_entry_exit(t, o, d, tbb)
    te, row, tx, xrow = tri.tri_entry_exit(t, o, d, tbb, refr=refr)
    assert torch.equal(te, full[0]) and torch.equal(row, full[1])
    hit = te < tri.BIG * 0.5
    swept = hit & (refr[row.long()] > 0.5)
    own = hit & ~swept
    assert int(swept.sum()) > R // 8 and int(own.sum()) > R // 8
    assert torch.equal(tx[swept], full[2][swept])
    assert torch.equal(xrow[swept], full[3][swept])
    assert torch.equal(tx[own], te[own]) and torch.equal(xrow[own], row[own])
    assert torch.equal(tx[~hit], full[2][~hit])
    for name, want in (("big_glass", 1.0), ("big_mixed", 0.0)):
        ps = _scene(name)[1]
        r = step.tri_refracts(step.pack_step(ps))
        assert ps.any_refract and r.shape == (16448,)
        assert bool((r == want).all())


@pytest.mark.parametrize("name", ["small", "big"])
def test_tri_entry_as_any_hit_matches_pallas_tri(name):
    """Shadow rays from the rays' nearest hits toward a light: occlusion
    by ``te < BIG`` as the JAX package's ``intersect.any_hit`` reads it
    from ``pallas_tri.tri_entry``, and the division-free any-hit sweep of
    the port's step kernels (hit3._tri_any) agrees."""
    o, d = _rays(name)
    te, _row = _jax_entry(name, o, d)
    hit = te < jpt._BIG * 0.5
    p = o[hit] + d[hit] * te[hit][:, None]
    lv = np.asarray([0.3, -1.0, 1.5], np.float32) - p
    ln = (lv / np.linalg.norm(lv, axis=1, keepdims=True)).astype(np.float32)
    so = (p + ln * 1e-4).astype(np.float32)
    te_j, _ = _jax_entry(name, so, ln)
    occ_j = te_j < jpt._BIG * 0.5
    t = _consts(name)[4]
    te_s, _ = tri.tri_entry(t, torch.from_numpy(so), torch.from_numpy(ln))
    occ = te_s.numpy() < tri.BIG * 0.5
    np.testing.assert_array_equal(occ, occ_j)
    assert 0 < occ.sum() < len(occ)
    t2, tbb = _culled(name)
    none = torch.zeros(len(occ), dtype=torch.bool)
    any_ = hit3._tri_any(t2.detach(), tbb, t2.shape[0], torch.from_numpy(so),
                         torch.from_numpy(ln), none)[0]
    np.testing.assert_array_equal(any_.numpy(), occ_j)


# --- gradients against the custom VJPs --------------------------------------

def _port_grads(fn, t, o, d, cts, *extra):
    ins = [torch.from_numpy(np.asarray(x)).clone().requires_grad_(True)
           for x in (t.numpy(), o, d)]
    outs = fn(ins[0], ins[1], ins[2], *extra)
    ts = [outs[0]] if len(cts) == 1 else [outs[0], outs[2]]
    torch.autograd.backward(ts, [torch.from_numpy(c) for c in cts])
    return [x.grad.numpy() for x in ins]


@pytest.mark.parametrize("name,which", [
    ("small", "entry"), ("big", "entry"), ("small", "entry_exit"),
    ("big_glass", "entry_exit"), ("small", "group_exit"),
    ("big_glass", "group_exit")])
def test_tri_gradients_match_pallas_tri_vjp(name, which):
    """d AT (the table's G), d HT (h), d o and d d for random cotangents of
    te (and tx) against jax.vjp of pallas_tri's custom VJPs; thr and the
    group ids get none on either side."""
    AT, HT, thr, gid, t = _consts(name)
    o, d = _rays(name)
    rng = np.random.default_rng(9)
    ct = [rng.normal(size=R).astype(np.float32)
          for _ in range(2 if which == "entry_exit" else 1)]
    if which == "entry":
        def f(A, H, o_, d_):
            return jpt.tri_entry(A, H, thr, o_, d_)[0]
        port = _port_grads(tri.tri_entry, t, o, d, ct)
    elif which == "entry_exit":
        def f(A, H, o_, d_):
            out = jpt.tri_entry_exit(A, H, thr, gid[:, None], o_, d_)
            return out[0], out[2]
        port = _port_grads(tri.tri_entry_exit, t, o, d, ct)
    else:
        te_j, row_j = _jax_entry(name, o, d)
        wg = np.where(te_j < jpt._BIG * 0.5, gid[row_j], -5.0).astype(
            np.float32)

        def f(A, H, o_, d_):
            return jpt.tri_group_exit(A, H, thr, gid[:, None], o_, d_,
                                      jnp.asarray(wg))[0]
        port = _port_grads(tri.tri_group_exit, t, o, d, ct,
                           torch.from_numpy(wg))
    _out, vjp = jax.vjp(f, jnp.asarray(AT), jnp.asarray(HT), jnp.asarray(o),
                        jnp.asarray(d))
    g_j = [np.asarray(g) for g in vjp(ct[0] if len(ct) == 1 else tuple(ct))]
    assert float(np.abs(g_j[0][:, 6:9]).max()) > 0
    assert not port[0][:, 12:].any()
    for gname, got, want in (("d_AT", port[0][:, 0:9], g_j[0]),
                             ("d_HT", port[0][:, 9:12], g_j[1]),
                             ("d_o", port[1], g_j[2]),
                             ("d_d", port[2], g_j[3])):
        np.testing.assert_allclose(got, want, rtol=G_RTOL, atol=G_ATOL,
                                   err_msg=gname)


# --- the route and the per-step path ----------------------------------------

@pytest.mark.parametrize("n_lights", [1, 5])
def test_route_sends_meshes_past_the_staged_blocks_to_steps(n_lights):
    """257 cull blocks take the per-step path, with or without a gradient;
    256 (16,384 triangles) stay on the whole trace with one light."""
    s = compile_scene(schema.SceneConfig.from_json(big(n_lights=n_lights)),
                      "cpu")
    assert hit3.tri_blocks(s.kind_counts[schema.KIND_TRIANGLE]) == 257
    assert step.route(s, False) == step.route(s, True) == "steps"
    js = big(n_lights=n_lights)
    js["renderer"][0] = dict(js["renderer"][0], mesh=big_tris(8192).tolist())
    s = compile_scene(schema.SceneConfig.from_json(js), "cpu")
    assert step.pack_step(s).tbb.shape[0] == hit3.MAX_TRI_BLOCKS
    want = "trace" if n_lights == 1 else "steps"
    assert step.route(s, False) == step.route(s, True) == want


def _state(name, seed=2):
    """Step inputs of ``R`` rays aimed at the mesh: o, d, pwr, live (a
    tenth dead), A, B and the uniforms, numpy."""
    js, _ps = _scene(name)
    o, d = _rays(name)
    rng = np.random.default_rng(seed)
    pwr = np.full(R, 0.85, np.float32)
    live = rng.random(R) > 0.1
    A = rng.uniform(0.2, 1.0, (R, 3)).astype(np.float32)
    B = rng.uniform(0.0, 0.3, (R, 3)).astype(np.float32)
    u = rng.random((R, 7)).astype(np.float32)
    u_emit = rng.random(R).astype(np.float32)
    return (o, d, pwr, live), A, B, u, u_emit


@pytest.mark.parametrize("name", ["big", "big_glass", "big_mixed"])
def test_plain_step_matches_jax_bounce_step(name, monkeypatch):
    """The next carry and the hit liveness of one step through
    ``step.step_plain`` (tri_entry or tri_entry_exit, then the merge)
    against ``tracer.fused_step_reference`` on the pallas_tri path."""
    monkeypatch.setenv("MRT_HIT3", "0")
    monkeypatch.setenv("MRT_TRI_PALLAS", "1")
    monkeypatch.setenv("MRT_TRI_PALLAS_MIN", "1")
    js, ps = _scene(name)
    assert jpt.enabled_for(js) and not jpt.fused_exit_ok(js)
    ray, A, B, u, u_emit = _state(name)
    u8 = _u8(js, u, u_emit)
    uj, uej = _unpack(js, u8)
    fr = ji.build_frames(js)
    (o2, d2, pwr2, live_j), A2, B2, _l = jtr.fused_step_reference(
        js, fr, ji.prim_attributes(js, fr), jnp.float32(DECAY),
        tuple(jnp.asarray(x) for x in ray), jnp.asarray(A), jnp.asarray(B),
        uj, uej)
    kern = tri.ENTRY_EXIT_KERNEL if js.any_refract else tri.ENTRY_KERNEL
    before = (kern.plain_calls, step.STEP_KERNEL.plain_calls)
    c1, hit = step.step_plain(ps, step.pack_step(ps), DECAY,
                              _carry(*ray, A, B), torch.from_numpy(u8))
    assert (kern.plain_calls, step.STEP_KERNEL.plain_calls) \
        == (before[0] + 1, before[1] + 1)
    live = np.asarray(live_j)
    assert 0.3 * R < live.sum() < R
    got = hit[0].numpy() > 0.5
    c = c1.numpy()
    _outliers([(got[:, None].astype(np.float32),
                live[:, None].astype(np.float32)),
               (_on(live & got, c[0:3].T), _on(live & got, o2)),
               (_on(live & got, c[3:6].T), _on(live & got, d2)),
               (c[6:7].T, np.asarray(pwr2)[:, None]),
               (c[8:11].T, np.asarray(A2)), (c[11:14].T, np.asarray(B2))])


@pytest.mark.parametrize("name", ["big", "big_glass", "big_mixed"])
def test_steps_equal_whole_trace_past_the_staged_blocks(name):
    """The plain per-step route (the triangle segment swept on its own
    each step) against the plain whole trace (one sweep over every row),
    A, B and first_live bit for bit, and under a gradient the tables' and
    primaries' cotangents within rtol 1e-5 / 1e-6 of the largest."""
    _js, ps = _scene(name)
    tables = step.pack_step(ps)
    assert step.route(ps, False) == "steps"
    o, d = _rays(name)
    oT, dT = torch.from_numpy(o.T.copy()), torch.from_numpy(d.T.copy())
    u8s = torch.rand((4, step.n_uni(ps.any_refract), R),
                     generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        whole = step.trace_plain(ps, tables, DECAY, oT, dT, u8s)
        steps = step.trace_steps(ps, tables, DECAY, oT, dT, u8s)
    assert float(whole[2].sum()) > R / 4
    for a, b in zip(whole, steps):
        assert torch.equal(a, b)
    rng = np.random.default_rng(6)
    ctA, ctB = (torch.from_numpy(rng.normal(size=(3, R)).astype(np.float32))
                for _ in "ab")

    def grads(fn):
        ins = [x.detach().clone().requires_grad_(True)
               for x in (tables.tab, tables.lights, tables.tri, oT, dT)]
        t = tables._replace(tab=ins[0], lights=ins[1], tri=ins[2])
        A, B, _fl = fn(ps, t, DECAY, ins[3], ins[4], u8s)
        torch.autograd.backward((A, B), (ctA, ctB))
        return [x.grad for x in ins]

    gw = grads(step.trace_plain)
    gs = grads(step.trace_steps)
    assert float(gw[2].abs().max()) > 0
    for a, b in zip(gs, gw):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-6 * float(b.abs().max()))


def test_wrappers_run_the_plain_versions_on_cpu():
    """Each wrapper counts a plain call on CPU tensors and launches
    nothing."""
    t = _consts("small")[4]
    o, d = (torch.from_numpy(x) for x in _rays("small"))
    kernels = (tri.ENTRY_KERNEL, tri.ENTRY_EXIT_KERNEL, tri.EXIT_KERNEL)
    before = [(k.launches, k.plain_calls) for k in kernels]
    tri.tri_entry(t, o, d)
    tri.tri_entry_exit(t, o, d)
    tri.tri_group_exit(t, o, d, torch.zeros(R))
    assert [(k.launches, k.plain_calls) for k in kernels] \
        == [(a, b + 1) for a, b in before]


def test_cli_renders_a_mesh_past_the_staged_blocks_on_cpu(tmp_path):
    """A scene JSON whose mesh is an OBJ file of 16,448 triangles renders
    through the CLI on the plain per-step path: one tri_entry and one step
    per bounce and sample."""
    from PIL import Image

    tris = big_tris(16448)
    obj = tmp_path / "big.obj"
    lines = [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in tris.reshape(-1, 3)]
    lines += [f"f {3 * i + 1} {3 * i + 2} {3 * i + 3}"
              for i in range(len(tris))]
    obj.write_text("\n".join(lines) + "\n")
    js = big()
    js["renderer"][0] = {"type": "mesh", "mesh": str(obj),
                         "pos": [0, 0.8, 0], "mat": {"rough": 0.5}}
    path = tmp_path / "big.json"
    path.write_text(json.dumps({
        "scene": js, "frame": {"res": [12, 12],
                               "cam": {"pos": [0, -1.2, 0.1], "fov": 60}},
        "rt": {"bounce": 1, "sample": 1}}))
    out = tmp_path / "big.png"
    before = (tri.ENTRY_KERNEL.plain_calls, step.STEP_KERNEL.plain_calls)
    assert cli.main([str(path), "--device", "cpu", "-o", str(out)]) == 0
    assert (tri.ENTRY_KERNEL.plain_calls, step.STEP_KERNEL.plain_calls) \
        == (before[0] + 2, before[1] + 2)
    assert np.asarray(Image.open(out)).std() > 1.0


# --- the host build of the device code ---------------------------------------

_HARNESS = r"""
#include <algorithm>
#include <vector>

#include "tri.cu"
#include "step_fwd.cu"

// mode 0: row 6, 1: row 7; 4: the one-level entry walk (hit3.cuh
// tri_entry), 5: it and the unculled group exit (hit3.cuh tri_exit). The
// first n_staged superblocks are read from `sb_staged`. (Row 8:
// host_group_exit.)
extern "C" void host_tri(int mode, const float* tri, int n, const float* bb,
    int n_cb, const float* sb, const float* sb_staged, int n_sb,
    int n_staged, const float* o, const float* d, int s_ray, int s_comp,
    const float* live, const float* refr, const float* wg, int R,
    float* te, int* row, float* tx, int* xrow) {
  const mrt::Tris T{tri, bb};
  const mrt::Layout L{0, 0, 0, 0, 0, 0, 0, n, n_cb, 0};
  float chunks[64 * mrt::kBbCols];
  mrt::chunk_bounds(sb_staged, n_staged, chunks, 0, 1);
  const mrt::Supers S{sb_staged, sb, chunks, n_sb, n_staged};
  const mrt::TriRays q{o, d, s_ray, s_comp, live};
  for (int i = 0; i < R; ++i) {
    float oo[3], dd[3];
    mrt::Hit h{mrt::kBig, 0, -mrt::kBig, 0};
    if (mrt::tri_ray(q, i, oo, dd)) {
      if (mode == 0) {
        mrt::tri_entry_ray(T, L, S, oo, dd, h.te, h.row);
      } else if (mode == 1) {
        h = mrt::tri_entry_exit_ray(T, L, S, refr, oo, dd);
      } else {
        mrt::tri_entry(T, L, L.n_cb > 0, oo[0], oo[1], oo[2], dd[0], dd[1],
                       dd[2], h.te, h.row);
        if (mode == 5 && h.te < mrt::kBig)
          mrt::tri_exit(T, L, h.row, oo[0], oo[1], oo[2], dd[0], dd[1],
                        dd[2], h.tx, h.xrow);
      }
    }
    te[i] = h.te;
    row[i] = h.row;
    tx[i] = h.tx;
    xrow[i] = h.xrow;
  }
}

// Row 8 as the card splits its work (tri.cu exit_*): the live rays with a
// group (exit_group) queued by group, against the group's rows
// (exit_group_rows, exit_group_row) in slices of `slice` rows, taken last
// first; each slice's farthest hit of each ray (exit_rows) merged into
// the ray's key by max, as the kernel's atomicMax does; then
// exit_finish.
extern "C" void host_group_exit(const float* tri, const float* rkey,
    const int* rs, const int* re, int n_runs, const float* o, const float* d,
    int s_ray, int s_comp, const float* live, const float* wg, int R,
    int slice, float* tx, int* xrow) {
  const mrt::Runs G{rkey, rs, re, n_runs};
  const mrt::TriRays q{o, d, s_ray, s_comp, live};
  std::vector<int> grp(R, -1);
  std::vector<std::vector<int>> queue(n_runs);
  for (int i = 0; i < R; ++i) {
    const size_t b = static_cast<size_t>(i) * s_ray;
    if (live == nullptr || live[b] > 0.5f) grp[i] = mrt::exit_group(G, wg[i]);
    if (grp[i] >= 0) queue[grp[i]].push_back(i);
  }
  std::vector<unsigned long long> key(R, 0ull);
  std::vector<float> rows(static_cast<size_t>(slice) * mrt::kTriCols);
  std::vector<int> ids(slice);
  for (int g = 0; g < n_runs; ++g) {
    const int n_rows = queue[g].empty() ? 0 : mrt::exit_group_rows(G, g);
    for (int s = (n_rows - 1) / slice; s >= 0 && n_rows > 0; --s) {
      const int m = std::min(slice, n_rows - s * slice);
      for (int p = 0; p < m; ++p) {
        ids[p] = mrt::exit_group_row(G, g, s * slice + p);
        memcpy(&rows[static_cast<size_t>(p) * mrt::kTriCols],
               tri + static_cast<size_t>(ids[p]) * mrt::kTriCols,
               mrt::kTriCols * sizeof(float));
      }
      for (const int i : queue[g]) {
        float oo[3], dd[3], bt = -mrt::kBig;
        int br = -1;
        mrt::tri_ray(q, i, oo, dd);
        mrt::exit_rows(rows.data(), ids.data(), m, oo, dd, bt, br);
        if (br >= 0) key[i] = std::max(key[i], mrt::exit_key(bt, br));
      }
    }
  }
  for (int i = 0; i < R; ++i) {
    float oo[3], dd[3];
    tx[i] = -mrt::kBig;
    xrow[i] = 0;
    if (grp[i] >= 0 && mrt::tri_ray(q, i, oo, dd))
      mrt::exit_finish(tri, key[i], oo, dd, tx[i], xrow[i]);
  }
}

// the bounds of each run of 64 of n superblock AABBs (tri.cu chunk_bounds)
extern "C" void host_chunks(const float* sup, int n, float* out) {
  mrt::chunk_bounds(sup, n, out, 0, 1);
}

template <bool kRefract, bool kTrain, bool kTriIn>
static void tri_steps(const float* tab, const mrt::Tris& T,
    const mrt::Layout& lay, const float* lights, int L, float dk,
    const float* c0, const float* u8, int R, float* c1, float* hit,
    float* resid, const mrt::TriIn& tin, const mrt::Supers& S) {
  const mrt::Tex tex{nullptr, nullptr, nullptr, 0};
  for (int i = 0; i < R; ++i)
    mrt::step_ray<kRefract, kTrain, true, false, kTriIn>(
        tab, T, lay, lights, L, dk, tex, i, R, c0, u8, c1, hit, resid,
        mrt::StepWalk{nullptr, 0, {}, tin, S});
}

// one bounce step of a triangle scene: the kTri instance (tri_in = 0,
// the kernel sweeps the triangles) or kTriIn (their hits from tte...,
// the shadow sweeps through the n_sb superblocks sb, the first n_staged
// read from sb_staged)
extern "C" void host_tri_step(const float* tab, const int* l,
    const float* tri, const float* bb, const float* lights, int L, float dk,
    const float* c0, const float* u8, int R, int refract, int train,
    const float* tte, const int* trow, const float* ttx, const int* txrow,
    const float* sb, const float* sb_staged, int n_sb, int n_staged,
    float* c1, float* hit, float* resid) {
  const mrt::Layout lay{l[0], l[1], l[2], l[3], l[4],
                        l[5], l[6], l[7], l[8], l[9]};
  const mrt::Tris T{tri, bb};
  const mrt::TriIn tin{tte, trow, ttx, txrow};
  float chunks[64 * mrt::kBbCols];
  mrt::chunk_bounds(sb_staged, n_staged, chunks, 0, 1);
  const mrt::Supers S{sb_staged, sb, chunks, n_sb, n_staged};
  auto run = [&](auto fn) {
    fn(tab, T, lay, lights, L, dk, c0, u8, R, c1, hit, resid, tin, S);
  };
  const int sel = (refract ? 4 : 0) + (train ? 2 : 0) + (tte ? 1 : 0);
  switch (sel) {
    case 0: run(tri_steps<false, false, false>); break;
    case 1: run(tri_steps<false, false, true>); break;
    case 2: run(tri_steps<false, true, false>); break;
    case 3: run(tri_steps<false, true, true>); break;
    case 4: run(tri_steps<true, false, false>); break;
    case 5: run(tri_steps<true, false, true>); break;
    case 6: run(tri_steps<true, true, false>); break;
    default: run(tri_steps<true, true, true>); break;
  }
}
"""


@pytest.fixture(scope="module")
def host_tri(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    d = tmp_path_factory.mktemp("host_tri")
    (d / "shim.h").write_text(_SHIM)
    (d / "harness.cpp").write_text(_HARNESS)
    out = d / "libhost_tri.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-include", str(d / "shim.h"), "-I", CSRC,
                    "-o", str(out), str(d / "harness.cpp")], check=True,
                   capture_output=True, timeout=300)
    return ctypes.CDLL(os.fspath(out))


def _p(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _host_group_exit(lib, t, o, d, s_ray, s_comp, live, wg, R, n_rows=None,
                     slice_rows=5):
    """The host build's row 8 (``host_group_exit``) over the first
    ``n_rows`` rows of ``t`` (default all), the rows in slices of
    ``slice_rows``: (tx, xrow)."""
    runs = tri.group_runs(t, n_rows)
    tx, xrow = torch.empty(R), torch.empty(R, dtype=torch.int32)
    lib.host_group_exit(_p(t), _p(runs.key), _p(runs.start), _p(runs.end),
                        runs.key.shape[0], _p(o), _p(d), s_ray, s_comp,
                        _p(live), _p(wg), R, slice_rows, _p(tx), _p(xrow))
    return tx, xrow


def _host_tri(lib, mode, t, tbb, c, wg=None, refr=None, n_rows=None,
              staged=None):
    """The host build's row 6 / 7 / 8 (modes 0-2; 4, 5: the one-level
    walk, and with the unculled exit) on the carry ``c``'s rays and live
    row over the first ``n_rows`` rows (default all), the superblocks of
    ``tbb`` read from a staged copy up to ``staged`` (default all): (te,
    row, tx, xrow)."""
    n = c.shape[1]
    te, tx = torch.empty(n), torch.empty(n)
    row, xrow = (torch.empty(n, dtype=torch.int32) for _ in "ab")
    if mode == 2:
        te.fill_(tri.BIG)
        row.zero_()
        tx, xrow = _host_group_exit(lib, t, c, c[3:], 1, n,
                                    c[step.C_LIVE:], wg, n, n_rows)
        return te, row, tx, xrow
    tsb = None if tbb is None else tri.superbounds(tbb)
    n_sb = 0 if tsb is None else tsb.shape[0]
    staged = n_sb if staged is None else min(staged, n_sb)
    copy = None if tsb is None else tsb[:staged].clone()
    lib.host_tri(mode, _p(t), t.shape[0] if n_rows is None else n_rows,
                 _p(tbb), 0 if tbb is None else tbb.shape[0], _p(tsb),
                 _p(copy), n_sb, staged, _p(c), _p(c[3:]), 1, n,
                 _p(c[step.C_LIVE:]), _p(refr), _p(wg), n, _p(te), _p(row),
                 _p(tx), _p(xrow))
    return te, row, tx, xrow


def _live_carry(name, seed):
    o, d = _rays(name)
    c = step.primary_carry(torch.from_numpy(o.T.copy()),
                           torch.from_numpy(d.T.copy()))
    dead = torch.rand(c.shape[1], generator=torch.Generator().manual_seed(
        seed)) < 0.1
    c[step.C_LIVE, dead] = 0.0
    return c


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_host_tri_matches_plain(mode, host_tri):
    """Rows 6, 7 and 8 of the host build (mode 3: row 7 with half the rows
    marked to refract) on the big glass scene's culled tables, rays read
    from a carry (stride 1, components R apart) with a tenth of its lanes
    dead: equal to the plain versions bit for bit."""
    t, tbb = _culled("big_glass")
    t = t.detach().contiguous()
    c = _live_carry("big_glass", 4)
    o, d, live = c[0:3].T, c[3:6].T, c[step.C_LIVE]
    te_p, row_p = tri.entry_plain(t, o, d, tbb, live=live)
    wg = torch.where(te_p < tri.BIG * 0.5, t[row_p.long(), hit3._T_GID],
                     -5.0).contiguous()
    refr = None
    if mode == 3:
        mode, refr = 1, (torch.rand(t.shape[0], generator=torch.Generator()
                                    .manual_seed(8)) < 0.5).to(torch.float32)
    got = _host_tri(host_tri, mode, t, tbb, c, wg, refr)
    if mode == 0:
        want = (te_p, row_p)
    elif mode == 1:
        want = tri.entry_exit_plain(t, o, d, tbb, live=live, refr=refr)
    else:
        want = tri.group_exit_plain(t, o, d, wg, live=live)
    got = got[:2] if mode == 0 else got[2:] if mode == 2 else got
    hit = want[0].abs() < tri.BIG * 0.5
    assert 0.2 * R < int(hit.sum()) < R
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    dead = live < 0.5
    assert bool((got[0][dead] == (-tri.BIG if mode == 2 else tri.BIG)).all())


def _walk_rays(name, kind, n=R):
    """float32 (o, d) ``(n, 3)`` for the two-level walk's tests on the
    scene's culled tables: ``aimed`` (:func:`aimed_rays`), ``camera`` (a
    pinhole grid facing the mesh), ``axis`` (aimed rays with one or two
    direction components zero, and two NaN rays), ``inside`` (origins
    inside random blocks' AABBs, random directions)."""
    ps = _scene(name)[1]
    tbb = _culled(name)[1].numpy()
    rng = np.random.default_rng(17)
    o, d = aimed_rays(ps, n, 11)
    if kind == "camera":
        c = (tbb[:, :3].min(0) + tbb[:, 3:6].max(0)) / 2
        eye = c + np.array([0.1, -2.5, 0.5])
        f = (c - eye) / np.linalg.norm(c - eye)
        r = np.cross(f, [0.0, 0.0, 1.0])
        r /= np.linalg.norm(r)
        u = np.cross(r, f)
        side = int(np.sqrt(n))
        ys, xs = np.divmod(np.arange(n), side)
        px, py = (xs / side - 0.5) * 0.8, (ys / side - 0.5) * 0.8
        d = f + px[:, None] * r + py[:, None] * u
        o = np.broadcast_to(eye, d.shape)
    elif kind == "axis":
        k = np.arange(n) % 3
        d = d.copy()
        d[np.arange(n), k] = 0.0
        d[::4, (k[::4] + 1) % 3] = 0.0
        d[d.sum(1) == 0.0, 0] = 1.0
        o = o.copy()
        o[5, 1] = np.nan
        d[9, 2] = np.nan
    elif kind == "inside":
        b = tbb[rng.integers(0, len(tbb), n)]
        o = b[:, :3] + rng.random((n, 3)) * (b[:, 3:6] - b[:, :3])
        d = rng.normal(size=(n, 3))
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _ray_carry(o, d):
    return step.primary_carry(torch.from_numpy(o.T.copy()),
                              torch.from_numpy(d.T.copy()))


@pytest.mark.parametrize("kind", ["aimed", "camera", "axis", "inside"])
@pytest.mark.parametrize("name", ["odd_glass", "big_glass"])
def test_host_two_level_walk_equals_one_level(name, kind, host_tri):
    """The host build of rows 6 and 7 through the superblocks (the first 3
    superblocks read from a staged copy, or all of them) against the
    one-level walk (hit3.cuh tri_entry) and the plain versions: the entry
    (te, row) equal bit for bit, the culled group exit equal to
    ``entry_exit_plain``'s bit for bit, and against the unculled exit
    (hit3.cuh tri_exit, and row 8 = ``group_exit_plain``) different only
    on phantom exit hits, outside their block's AABB. Over all rows, and
    over a row count inside the last superblock and its last block."""
    t, tbb = _culled(name)
    t = t.detach().contiguous()
    c = _ray_carry(*_walk_rays(name, kind))
    c[step.C_LIVE, 3::10] = 0.0
    o, d, live = c[0:3].T, c[3:6].T, c[step.C_LIVE]
    Pt = t.shape[0]
    for n in (Pt, Pt - 37 - 64 * (Pt % 64 == 0)):
        one = _host_tri(host_tri, 5, t, tbb, c, n_rows=n)
        want = tri.entry_exit_plain(t, o, d, tbb, n, live)
        assert torch.equal(one[0], want[0]) and torch.equal(one[1], want[1])
        hit = want[0] < tri.BIG * 0.5
        assert int(hit.sum()) > (R // 4 if kind == "aimed" else R // 20)
        for staged in (3, None):
            two = _host_tri(host_tri, 0, t, tbb, c, n_rows=n, staged=staged)
            assert torch.equal(two[0], one[0]) and torch.equal(two[1], one[1])
            ee = _host_tri(host_tri, 1, t, tbb, c, n_rows=n, staged=staged)
            for g, w in zip(ee, want):
                assert torch.equal(g, w)
        wg = torch.where(hit, t[want[1].long(), hit3._T_GID],
                         -5.0).contiguous()
        full = _host_tri(host_tri, 2, t, None, c, wg=wg, n_rows=n)[2:]
        plain = tri.group_exit_plain(t, o, d, wg, n, live)
        assert torch.equal(full[0], plain[0]) and torch.equal(full[1],
                                                              plain[1])
        assert torch.equal(one[2][hit], full[0][hit])
        assert torch.equal(one[3][hit], full[1][hit])
        differs, phantom = tri.culled_exit_phantoms(
            tbb, o[hit], d[hit], (ee[2][hit], ee[3][hit]),
            (full[0][hit], full[1][hit]))
        assert torch.equal(differs, phantom), int((differs & ~phantom).sum())
    if kind == "axis":
        assert bool((two[0][[5, 9]] == tri.BIG).all())


def test_superbounds_hold_their_blocks():
    """Each superblock's AABB is the exact componentwise min / max of its
    blocks' corners (16 blocks, the last superblock partial), so its slab
    interval holds each block's: on the walk's rays, a block that any ray
    touches (entry, at any best) lies in a superblock it touches."""
    t, tbb = _culled("odd_glass")
    tsb = tri.superbounds(tbb)
    assert tsb.shape == (-(-tbb.shape[0] // tri.SUPER), hit3.BB_COLS)
    for s in range(tsb.shape[0]):
        blk = tbb[s * tri.SUPER:(s + 1) * tri.SUPER]
        lo = torch.minimum(blk[:, :3], blk[:, 3:6]).amin(0)
        hi = torch.maximum(blk[:, :3], blk[:, 3:6]).amax(0)
        assert torch.equal(tsb[s, :3], lo) and torch.equal(tsb[s, 3:6], hi)
    o, d = (torch.from_numpy(x) for x in _walk_rays("odd_glass", "axis"))
    invd = hit3._inv_dir(d)
    # a block of invalid rows only is inverted (lo above hi) and touches
    # nearly every ray: its superblock must too
    tbb = tbb.clone()
    tbb[21, :3], tbb[21, 3:6] = tri.BIG - 1e-4, -(tri.BIG - 1e-4)
    tsb = tri.superbounds(tbb)
    for best in (torch.full((R,), tri.BIG), torch.rand(R) * 3.0):
        for b in range(tbb.shape[0]):
            inner = hit3._slab_touch(tbb[b], o, invd, best)
            outer = hit3._slab_touch(tsb[b // tri.SUPER], o, invd, best)
            assert not bool((inner & ~outer).any()), b
    # every ray but the two NaN ones
    assert int(hit3._slab_touch(tbb[21], o, invd, best).sum()) == R - 2


@pytest.mark.parametrize("slice_rows", [1, 5, 64, 256])
def test_host_group_exit_split(slice_rows, host_tri):
    """Row 8's work split on the host (the run table, the queue by group,
    slices of ``slice_rows`` rows last first, the packed-key merge, the
    finish) against ``group_exit_plain`` bit for
    bit on ``stack_table``: several groups (one in two runs, -0.0 and +0.0
    ids, NaN rows), rays that ask for no group (-5, 42, NaN) or are dead,
    t ties across slices, the origin rays' -0 / +0 tie (group 3's lower
    row wins with its own t), and 301 rays; then the same on
    ``big_glass``'s rays (two 8,224-row groups) over all rows and a row
    count inside a group."""
    t, o, d = stack_table()
    n_r = o.shape[0]
    rng = np.random.default_rng(5)
    wg = torch.from_numpy(rng.choice(np.float32(
        [0.0, 1.0, 2.0, 3.0, 7.5, -0.0, -5.0, 42.0, np.nan]), n_r))
    wg[-12:] = 3.0
    live = torch.from_numpy((rng.random(n_r) > 0.1).astype(np.float32))
    live[-12:] = 1.0
    # rays as the carry holds them: (3, R), so live shares their stride
    oT, dT = o.T.contiguous(), d.T.contiguous()
    for n in (t.shape[0], 205):
        got = _host_group_exit(host_tri, t, oT, dT, 1, n_r, live, wg, n_r, n,
                               slice_rows)
        want = tri.group_exit_plain(t, o, d, wg, n, live)
        assert torch.equal(got[0].view(torch.int32),
                           want[0].view(torch.int32))
        assert torch.equal(got[1], want[1])
        hit = want[0] > -tri.BIG * 0.5
        assert int(hit.sum()) > n_r // 3
        # the origin rays: t = -0 (row 40) or +0 (row 200), row 40 wins
        if n == t.shape[0]:
            zero = want[0][-12:]
            assert bool((zero == 0.0).all()) and bool((want[1][-12:]
                                                       == 40).all())
            signs = torch.signbit(got[0][-12:])
            assert bool(signs.any()) and bool((~signs).any())
    # ties of t inside one group across slices: two rows of one height
    d_up = torch.zeros_like(d)
    d_up[:, 2] = 1.0
    got = _host_group_exit(host_tri, t, o, d_up, 3, 1, None,
                           torch.full((n_r,), 1.0), n_r, None, slice_rows)
    want = tri.group_exit_plain(t, o, d_up, torch.full((n_r,), 1.0))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int((want[0] > 0).sum()) > n_r // 2
    bt, bo, bd = (_culled("big_glass")[0].detach().contiguous(),
                  *(torch.from_numpy(x) for x in _rays("big_glass")))
    te, row = tri.entry_plain(bt, bo, bd)
    bwg = torch.where(te < tri.BIG * 0.5, bt[row.long(), hit3._T_GID],
                      -5.0).contiguous()
    assert len(set(bwg[te < tri.BIG * 0.5].tolist())) == 2
    for n in (bt.shape[0], 8224 + 1000):
        got = _host_group_exit(host_tri, bt, bo, bd, 3, 1, None, bwg, R, n,
                               slice_rows * 53)
        want = tri.group_exit_plain(bt, bo, bd, bwg, n)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert int((want[0] > -tri.BIG * 0.5).sum()) > R // 5


def test_group_runs_find_every_row_of_a_group():
    """``tri.group_runs``: one entry a row, a run's start keyed by its
    id, sorted (NaN last, a group's runs adjacent in row order); the rows
    of each id's runs are exactly the rows that hold the id (0.0's: rows
    0-29 and the -0.0 / +0.0 run, which ``==`` joins)."""
    t = stack_table()[0]
    runs = tri.group_runs(t)
    key, start, end = runs
    assert key.shape == start.shape == end.shape == (t.shape[0],)
    ok = ~torch.isnan(key)
    assert int(ok.sum()) == 7 and bool(ok[:7].all())
    gid = t[:, hit3._T_GID]
    for g in (0.0, 1.0, 2.0, 3.0, 7.5, 0.0):
        rows = torch.cat([torch.arange(int(a), int(b)) for k, a, b
                          in zip(key, start, end) if float(k) == g])
        assert torch.equal(rows, torch.nonzero(gid == g)[:, 0])
    assert torch.equal(key[ok], torch.sort(key[ok], stable=True).values)
    assert tri.group_runs(t, 0).key.shape == (0,)


def test_host_chunk_bounds(host_tri):
    """The host build of ``tri.cu``'s chunk bounds (the bound of each run
    of 64 superblocks, tested before their masks) over 150 random
    superblock AABBs: each run's componentwise min / max, exactly."""
    rng = np.random.default_rng(23)
    lo = rng.normal(size=(150, 3)).astype(np.float32)
    base = torch.from_numpy(np.concatenate(
        [lo, lo + rng.random((150, 3)).astype(np.float32),
         np.zeros((150, 2), np.float32)], 1))
    # each position of a run in turn holds its run's extremes
    for p in range(64):
        sup = base.clone()
        sup[p::64, :3] -= 10.0
        sup[p::64, 3:6] += 10.0
        out = torch.zeros((3, hit3.BB_COLS))
        host_tri.host_chunks(_p(sup), 150, _p(out))
        for c in range(3):
            run = sup[64 * c:64 * (c + 1)]
            assert torch.equal(out[c, :3], run[:, :3].amin(0)), p
            assert torch.equal(out[c, 3:6], run[:, 3:6].amax(0)), p


def test_culled_exit_phantom_gate_can_fail():
    """The gate of the culled exit (``tri.culled_exit_phantoms``): the
    culled plain exit passes it; a mutant cull (each block's AABB shrunk
    to its middle half, so real exits are skipped) fails it on many
    rays."""
    t, tbb = _culled("odd_glass")
    t = t.detach()
    o, d = (torch.from_numpy(x) for x in _walk_rays("odd_glass", "aimed"))
    te, row, tx, xrow = tri.entry_exit_plain(t, o, d, tbb)
    hit = te < tri.BIG * 0.5
    wg = torch.where(hit, t[row.long(), hit3._T_GID], -5.0)
    full = tri.group_exit_plain(t, o, d, wg)
    differs, phantom = tri.culled_exit_phantoms(tbb, o, d, (tx, xrow), full)
    assert not bool((differs & ~phantom).any())
    mid, half = (tbb[:, :3] + tbb[:, 3:6]) / 2, (tbb[:, 3:6] - tbb[:, :3]) / 4
    shrunk = torch.cat([mid - half, mid + half, tbb[:, 6:]], 1)
    bad = tri.entry_exit_plain(t, o, d, shrunk)
    differs, phantom = tri.culled_exit_phantoms(
        tbb, o[hit], d[hit], (bad[2][hit], bad[3][hit]),
        (full[0][hit], full[1][hit]))
    assert int((differs & ~phantom).sum()) > int(hit.sum()) // 10


@pytest.mark.parametrize("name", ["big_glass", "odd_glass"])
def test_culled_exit_matches_pallas_tri(name):
    """``hit3._tri_exit`` with the cull blocks (row 7's culled exit) fed
    the JAX entry's winner groups: the exit rows of pallas_tri's group
    exit, t within rtol 1e-5 / atol 1e-6, on the aimed rays (no phantom
    exit among them)."""
    AT, HT, thr, gid, _t = _consts(name)
    o, d = _rays(name) if name == "big_glass" else _walk_rays(name, "aimed")
    te_j, row_j = _jax_entry(name, o, d)
    hit = te_j < jpt._BIG * 0.5
    assert hit.sum() > R // 4
    wg = np.where(hit, gid[row_j], -5.0).astype(np.float32)
    tx_j, xrow_j = (np.asarray(x) for x in jpt.tri_group_exit(
        AT, HT, thr, gid[:, None], jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(wg)))
    t, tbb = _culled(name)
    best = torch.full((R,), -tri.BIG)
    tx, xrow = hit3._tri_exit(t.detach(), t.shape[0], torch.from_numpy(o),
                              torch.from_numpy(d), torch.from_numpy(wg),
                              best, tbb)
    np.testing.assert_array_equal(xrow.numpy()[hit], xrow_j[hit])
    _close_t(tx, tx_j, hit)


def _lay(tables):
    return torch.tensor(hit3.layout_ints(tables.layout)
                        + hit3.cull_ints(tables.layout, tables.tbb,
                                         tables.sbb), dtype=torch.int32)


def _host_step(lib, scene, tables, c0, u8, train, thit):
    n = c0.shape[1]
    c1, hit = torch.empty_like(c0), torch.empty(1, n)
    resid = torch.zeros(step.scene_res_rows(scene, tables.layout), n)
    tin = [None] * 4 if thit is None else \
        list(thit) + [None] * (4 - len(thit))
    keep = [t.detach().contiguous() for t in (tables.tab, tables.tri,
                                               tables.lights)]
    lay = _lay(tables)
    tsb = tri.superbounds(tables.tbb)
    lib.host_tri_step(
        _p(keep[0]), _p(lay), _p(keep[1]), _p(tables.tbb), _p(keep[2]),
        scene.n_lights, ctypes.c_float(DECAY), _p(c0), _p(u8), n,
        int(scene.any_refract), int(train), *(_p(x) for x in tin), _p(tsb),
        _p(tsb), tsb.shape[0], tsb.shape[0], _p(c1), _p(hit), _p(resid))
    return c1, hit, resid


def _host_thit(lib, scene, tables, c):
    """The host build's row 6 (opaque) or 7 (refractive, the group exit
    of the refracting rows' winners) on the carry."""
    mode = 1 if scene.any_refract else 0
    out = _host_tri(lib, mode, tables.tri.detach().contiguous(), tables.tbb,
                    c, refr=step.tri_refracts(tables) if mode else None)
    return out if mode else out[:2]


@pytest.mark.parametrize("name", ["mesh_opaque", "mesh_glass"])
def test_host_tri_in_equals_tri_instance(name, host_tri):
    """On the 960-triangle torus scenes (15 blocks, which the kTri instance
    sweeps itself), 3 steps of the kTriIn instance fed row 6 / row 7 of
    the host build equal the kTri instance's, carry, hit and residuals,
    bit for bit, render and train."""
    scene = compile_scene(schema.SceneConfig.from_json(mesh_scene(name)),
                          "cpu")
    tables = step.pack_step(scene)
    o, d = rays(R, seed=8)
    o = (o * 0.22).astype(np.float32)
    c = step.primary_carry(torch.from_numpy(o.T.copy()),
                           torch.from_numpy(d.T.copy()))
    u8s = torch.rand((3, step.n_uni(scene.any_refract), R),
                     generator=torch.Generator().manual_seed(9))
    n_tri_hits = 0
    for k in range(3):
        thit = _host_thit(host_tri, scene, tables, c)
        n_tri_hits += int((thit[0] < tri.BIG * 0.5).sum())
        for train in (False, True):
            a = _host_step(host_tri, scene, tables, c, u8s[k], train, None)
            b = _host_step(host_tri, scene, tables, c, u8s[k], train, thit)
            for x, y in zip(a, b):
                assert torch.equal(x, y), (k, train)
        c = a[0]
    assert n_tri_hits > R // 16


@pytest.mark.parametrize("name", ["big", "big_glass", "big_mixed"])
def test_host_tri_in_step_matches_plain(name, host_tri):
    """One step of the host kTriIn instance (fed the host rows 6 / 7) from
    a carry with dead lanes against ``step.step_plain``: hit equal, the
    carry within rtol 1e-4 / atol 1e-5 on all but 0.3% of rays, the
    residual rows of the other rays that hit within rtol 1e-4 / atol 1e-4
    and their rows, choices and occlusion bits equal."""
    _js, ps = _scene(name)
    tables = step.pack_step(ps)
    c = _live_carry(name, 7)
    u8 = torch.rand((step.n_uni(ps.any_refract), R),
                    generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        c1_p, hit_p, res_p = step.step_plain(ps, tables, DECAY, c, u8,
                                             want_resid=True)
    c1, hit, res = _host_step(host_tri, ps, tables, c, u8, True,
                              _host_thit(host_tri, ps, tables, c))
    assert torch.equal(hit, hit_p)
    live = hit_p[0] > 0.5
    assert int(live.sum()) > R // 4
    bad = (~torch.isclose(c1, c1_p, rtol=1e-4, atol=1e-5)).any(0)
    assert int(bad.sum()) <= 0.003 * R, int(bad.sum())
    good = live & ~bad
    floats = [step.RES_O + k for k in range(9)] + [step.RES_TE]
    exact = [step.RES_ROW, step.res_xrow(ps.n_lights)] + [
        step.RES_LOK + li for li in range(ps.n_lights)]
    if ps.any_refract:
        floats.append(step.RES_TX)
        exact.append(step.RES_CHOOSE)
    for r in floats:
        torch.testing.assert_close(res[r, good], res_p[r, good], rtol=1e-4,
                                   atol=1e-4, msg=f"row {r}")
    for r in exact:
        assert torch.equal(res[r, good], res_p[r, good]), r
    # the rays whose winner is a triangle
    assert int((res[step.RES_ROW, good] >= tables.layout[1]).sum()) > R // 8
