"""The port's closest-hit (plain version of the hit3 kernel) against the
JAX package's Pallas hit kernel in interpret mode and its dense jnp
closest_hit.

Tolerance: rows must be equal; t within rtol 1e-5 / atol 1e-6 on hits
(identical float32 formulas, ulp-level differences from reassociated
sums); misses are exactly (BIG, 0, -BIG, 0) on both sides. The ``glass``
scene adds a refractive mesh of 16 random triangles (one group of many
rows, swept without culling: a segment of one block).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micro_raytracer_tpu.models import compiler as jcomp
from micro_raytracer_tpu.models import schema
from micro_raytracer_tpu.ops import intersect as ji
from micro_raytracer_tpu.ops import pallas_hit3 as jh
from micro_raytracer_tpu_torch.ops import hit3, intersect as ti, step
from test_pallas_step import scenes
from torch_port_helpers import MIXED, port_scene, rays
from torch_mesh_helpers import one_torch_thread  # noqa: F401

# exact ties: two identical spheres (same segment), and a plane through
# z = 0 with a box whose top face lies on it (across segments)
TIES = {
    "renderer": [
        {"type": "sphere", "r": 0.3, "pos": [0.6, 0, 0]},
        {"type": "sphere", "r": 0.3, "pos": [0.6, 0, 0]},
        {"type": "plane", "n": [0, 0, 1], "pos": [0, 0, 0]},
        {"type": "box", "sizes": [0.6, 0.6, 0.5], "pos": [-0.6, 0, -0.25]},
    ],
}


def _scene(name):
    src = {"mixed": MIXED, "ties": TIES}.get(name) or scenes()[name]
    js = jcomp.compile_scene(schema.SceneConfig.from_json(src))
    return js, port_scene(js)


def _port_hit(ps, o, d, need_exit):
    frames = ti.build_frames(ps)
    tab = hit3.pack_scene(ps, frames)
    tri, tbb = hit3.tri_tables(ps, frames)
    return hit3.closest_hit(tab, hit3.seg_layout(ps.kind_counts),
                            torch.from_numpy(o), torch.from_numpy(d),
                            hit3.MODE_EXIT if need_exit else hit3.MODE_ENTRY,
                            tri, tbb)


def _check(got, want_hit, need_exit=True):
    te, row, tx, xrow = (t.numpy() for t in got)
    h = np.asarray(want_hit.hit)
    np.testing.assert_array_equal(te < hit3.BIG * 0.5, h)
    np.testing.assert_array_equal(row, np.asarray(want_hit.idx_entry))
    np.testing.assert_allclose(te[h], np.asarray(want_hit.t_entry)[h],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(te[~h], np.asarray(want_hit.t_entry)[~h])
    if need_exit:
        np.testing.assert_array_equal(xrow, np.asarray(want_hit.idx_exit))
        np.testing.assert_allclose(tx[h], np.asarray(want_hit.t_exit)[h],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(tx[~h],
                                      np.asarray(want_hit.t_exit)[~h])


@pytest.mark.parametrize("need_exit", [True, False])
@pytest.mark.parametrize("name", ["opaque", "glass_flat", "mixed", "glass"])
def test_plain_matches_pallas_interpret(name, need_exit, monkeypatch):
    monkeypatch.setenv("MRT_HIT3", "1")
    js, ps = _scene(name)
    o, d = rays()
    want = jh.closest_hit(js, ji.build_frames(js), jnp.asarray(o),
                          jnp.asarray(d), need_exit=need_exit)
    _check(_port_hit(ps, o, d, need_exit), want, need_exit)


@pytest.mark.parametrize("name", ["opaque", "glass_flat", "mixed", "glass"])
def test_plain_and_dense_match_jax_dense(name):
    """The plain sweep against the JAX package's dense jnp closest_hit."""
    js, ps = _scene(name)
    o, d = rays(seed=4)
    want = ji.closest_hit(js, ji.build_frames(js), jnp.asarray(o),
                          jnp.asarray(d), need_exit=True)
    _check(_port_hit(ps, o, d, True), want)


def test_ties_go_to_the_lowest_row(monkeypatch):
    """Rays straight down hit both identical spheres at the same t (the
    first wins), and the plane and the box top at the same t (the plane,
    an earlier segment, wins)."""
    monkeypatch.setenv("MRT_HIT3", "1")
    js, ps = _scene("ties")
    xs = np.linspace(-0.85, 0.85, 64, dtype=np.float32)
    o = np.stack([xs, np.zeros_like(xs), np.ones_like(xs)], -1)
    d = np.tile(np.asarray([[0, 0, -1]], np.float32), (64, 1))
    te, row, _tx, _xrow = (t.numpy() for t in _port_hit(ps, o, d, True))
    sph0, pln0 = 0, ps.kind_counts[0]
    on_sph = np.abs(xs - 0.6) < 0.29
    assert on_sph.any() and (row[on_sph] == sph0).all()
    on_box = np.abs(xs + 0.6) < 0.29
    assert on_box.any() and (row[on_box] == pln0).all()
    np.testing.assert_allclose(te[on_box], 1.0, rtol=0, atol=1e-6)
    for want in (jh.closest_hit(js, ji.build_frames(js), jnp.asarray(o),
                                jnp.asarray(d)),
                 ji.closest_hit(js, ji.build_frames(js), jnp.asarray(o),
                                jnp.asarray(d))):
        np.testing.assert_array_equal(row, np.asarray(want.idx_entry))


@pytest.mark.parametrize("need_exit", [True, False])
def test_sphere_grid_360_dense(need_exit):
    """The 360-sphere grid of test_pallas_hit3 (a segment that is no
    multiple of a block), dense semantics."""
    rng = np.random.default_rng(5)
    objs = [{"type": "sphere", "r": 0.18,
             "pos": [x * 0.5 - 2.0, y * 0.5 + 1.0, z * 0.5 - 1.0],
             "mat": {"rough": float(rng.uniform(0.2, 1.0))}}
            for x in range(9) for y in range(8) for z in range(5)]
    js = jcomp.compile_scene(schema.SceneConfig.from_json(
        {"renderer": objs}))
    ps = port_scene(js)
    o, _ = rays(seed=6)
    o[:, 1] -= 2.5                      # shoot from in front of the grid
    aim = np.random.default_rng(6).uniform([-2, 1, -1], [2, 4.5, 1],
                                           (len(o), 3))
    d = (aim - o) / np.linalg.norm(aim - o, axis=1, keepdims=True)
    d = d.astype(np.float32)
    want = ji.closest_hit(js, ji.build_frames(js), jnp.asarray(o),
                          jnp.asarray(d), need_exit=need_exit)
    assert np.asarray(want.hit).sum() > 50
    _check(_port_hit(ps, o, d, need_exit), want, need_exit)


@pytest.mark.parametrize("name", ["opaque", "glass_flat", "mixed", "glass"])
def test_any_hit_matches(name, monkeypatch):
    monkeypatch.setenv("MRT_HIT3", "1")
    js, ps = _scene(name)
    o, d = rays(seed=7)
    jfr = ji.build_frames(js)
    want = np.asarray(ji.any_hit(js, jfr, jnp.asarray(o), jnp.asarray(d)))
    np.testing.assert_array_equal(
        np.asarray(jh.any_hit(js, jfr, jnp.asarray(o), jnp.asarray(d))),
        want)
    frames = ti.build_frames(ps)
    tab = hit3.pack_scene(ps, frames)
    got = hit3.any_hit(tab, hit3.seg_layout(ps.kind_counts),
                       torch.from_numpy(o), torch.from_numpy(d),
                       *hit3.tri_tables(ps, frames))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["textured", "textured_flat"])
def test_unported_scene_classes_raise(name):
    """Textures are later work: the plain paths refuse them rather than
    return wrong hits."""
    _js, ps = _scene(name)
    with pytest.raises(NotImplementedError, match="not ported"):
        step.check_scene(ps)
    with pytest.raises(NotImplementedError, match="not ported"):
        hit3.pack_scene(ps, ti.build_frames(ps))


@pytest.mark.parametrize("name", ["glass_flat", "mixed", "glass"])
def test_trace_row_table_sweeps_like_the_sweep_table(name):
    """The trace's wider row table (sweep columns first) gives the same
    hits, in every mode, as the sweep table alone: the primary-hit pass
    reads it as it is."""
    _js, ps = _scene(name)
    o, d = (torch.from_numpy(a) for a in rays(seed=8))
    tables = step.pack_step(ps)
    assert tables.tab.shape == (ps.n_prims, step.ROW_COLS)
    sweep = hit3.pack_scene(ps, tables.frames)
    tri = (tables.tri, tables.tbb)
    for mode in (hit3.MODE_ENTRY, hit3.MODE_EXIT, hit3.MODE_ANY):
        for a, b in zip(hit3.closest_hit(tables.tab, tables.layout, o, d,
                                         mode, *tri),
                        hit3.closest_hit(sweep, tables.layout, o, d, mode,
                                         *tri)):
            assert torch.equal(a, b)


def test_layout_ints_keep_absent_kinds_ordered():
    assert hit3.layout_ints(hit3.seg_layout((8, 0, 16, 0))) == \
        [0, 8, 8, 0, 8, 16]
    assert hit3.layout_ints(hit3.seg_layout((0, 8, 8, 0))) == \
        [0, 0, 0, 8, 8, 8]


def test_layout_sweeps_to_the_last_valid_row():
    """The kernels test each segment only up to its last valid row
    (``kind_sweep``): the padding rows after it never hit."""
    assert hit3.layout_ints(hit3.seg_layout((8, 0, 16, 0), (2, 0, 14, 0))) \
        == [0, 2, 8, 0, 8, 14]
    _js, ps = _scene("mixed")
    valid = ps.prim_valid.numpy()
    assert sum(ps.kind_sweep) < ps.n_prims
    for kind in range(4):
        seg = valid[ps.seg(kind)]
        n = ps.kind_sweep[kind]
        assert seg[:n].any() == (n > 0) and not seg[n:].any()
        assert n == 0 or seg[n - 1]
    ints = hit3.layout_ints(step.pack_step(ps).layout)
    assert ints[1::2] == list(ps.kind_sweep[:3])
