"""The port's differentiable closest hit (``hit3.ClosestHit``, its plain
backward ``closest_hit_bwd_plain``) against the JAX package's
``pallas_hit3.make_closest_hit`` VJP (its kernel in interpret mode), on the
same constant tables and rays and the same numpy cotangents.

Cases: a mixed scene with a refractive 24-triangle mesh (one group of many
rows, so the exit row differs from the entry row), exact winner ties
across rows (two identical spheres; a box face on a plane: the lowest row
takes the gradient), rays through a box's edges and corners (a t attained
by two or three slab axes shares its cotangent evenly, as autograd of
``jnp.max`` does), and misses (random rays leave the scene). Both modes:
the group exit and entry only.

Tolerance: the per-ray cotangents of ``o`` and ``d`` rtol 1e-5, the
tables' rtol 1e-4 (each entry a float32 sum over hundreds of rays, summed
in another order: a plane row's position measured 2.2e-5), both with an
absolute floor of 1e-6 of each array's largest magnitude (both sides
recompute the same formulas; the JAX side fetches rows through a float32
one-hot product at the highest precision, which is exact, and reduces some
dot products in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micro_raytracer_tpu.models import schema
from micro_raytracer_tpu.models.compiler import compile_scene
from micro_raytracer_tpu.ops import intersect as ji
from micro_raytracer_tpu.ops import pallas_hit3
from micro_raytracer_tpu_torch.ops import hit3, tri as tri_ops
from torch_port_helpers import BOXES, TIES, edge_rays, port_scene, rays

RTOL, TAB_RTOL, FLOOR = 1e-5, 1e-4, 1e-6


def _mixed():
    rng = np.random.default_rng(2)
    tris = rng.uniform(-1, 1, (24, 3, 3)).astype(np.float32)
    return {"renderer": [
        {"type": "sphere", "r": 0.4, "pos": [0.3, 0.2, 0]},
        {"type": "sphere", "r": 0.25, "pos": [-0.5, 0.5, 0.2],
         "dir": [0, 0.6, 0.4, 0]},
        {"type": "plane", "n": [0, 0, 1], "pos": [0, 0, -0.8]},
        {"type": "plane", "n": [0.3, -1, 0.1], "pos": [0, 1.5, 0]},
        {"type": "box", "sizes": [0.3, 0.4, 0.5], "pos": [0.6, 0.8, 0],
         "dir": [0, 0.5, 0.5, 0.1]},
        {"type": "mesh", "mesh": tris.tolist(), "pos": [-0.2, 0.9, 0.1],
         "mat": {"opacity": 0.0, "glass": 0.1}},
    ]}


def _tie_rays():
    """TIES: rays onto the two identical spheres and onto the box face on
    the plane z = 0, from above, plus random rays."""
    o = np.asarray([[0.6, -2, 0.05], [0.55, -2, -0.1], [-0.6, 0.1, 2],
                    [-0.5, -0.2, 1.5], [-0.7, 0.05, 3]], np.float32)
    d = np.asarray([[0, 1, 0], [0, 1, 0.02], [0, 0, -1], [0.05, 0, -1],
                    [0, 0.02, -1]], np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ro, rd = rays(200, seed=6)
    return np.concatenate([o, ro]), np.concatenate([d.astype(np.float32),
                                                    rd])


CASES = {"mixed": (_mixed, lambda: rays(384, seed=5)),
         "ties": (lambda: TIES, _tie_rays),
         "box_edges": (lambda: BOXES, edge_rays)}


def _tables(js):
    """The JAX constants and the port's row and triangle tables holding
    the same values (the row table's first 18 columns: fr, ipos, pa, pr,
    valid, gid)."""
    fr = ji.build_frames(js)
    tp = ji.triangle_pack(js, fr) if js.kind_counts[
        schema.KIND_TRIANGLE] else None
    consts = pallas_hit3.pack_scene(js, fr, tp)
    f, ip, pa, pr, valid, gid, AT, HT, thr, _tbb = consts
    P = js.n_prims
    tab = torch.from_numpy(np.concatenate(
        [np.asarray(x, np.float32).reshape(P, -1)
         for x in (f, ip, pa, pr, valid, gid[:P])], 1))
    n_tri = js.kind_counts[schema.KIND_TRIANGLE]
    tri = None
    if n_tri:
        s = js.seg(schema.KIND_TRIANGLE)
        tri = tri_ops.from_pallas_consts(
            np.asarray(AT)[:n_tri], np.asarray(HT)[:n_tri],
            np.asarray(thr)[:n_tri], np.asarray(js.group_id)[s])
    return consts, tab, tri


def _close(name, got, want, rtol=TAB_RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all(), name
    atol = FLOOR * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=name)


@pytest.mark.parametrize("need_exit", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_closest_hit_vjp_matches_jax(case, need_exit, monkeypatch):
    monkeypatch.setenv("MRT_HIT3", "1")
    src, ray_fn = CASES[case]
    js = compile_scene(schema.SceneConfig.from_json(src()))
    ps = port_scene(js)
    layout = hit3.seg_layout(ps.kind_counts, ps.kind_sweep)
    o_np, d_np = ray_fn()
    consts, tab, tri = _tables(js)
    hit = pallas_hit3.make_closest_hit(pallas_hit3._seg_layout(js.kind_counts))
    out_j = hit(consts, need_exit, jnp.asarray(o_np), jnp.asarray(d_np))
    rng = np.random.default_rng(11)
    R = o_np.shape[0]
    ct_te = rng.standard_normal(R).astype(np.float32)
    ct_tx = rng.standard_normal(R).astype(np.float32)

    def f(c, o, d):
        te, _r, tx, _x = hit(c, need_exit, o, d)
        return te, tx

    _out, vjp = jax.vjp(f, consts, jnp.asarray(o_np), jnp.asarray(d_np))
    g_c, g_o, g_d = vjp((jnp.asarray(ct_te), jnp.asarray(ct_tx)))

    mode = hit3.MODE_EXIT if need_exit else hit3.MODE_ENTRY
    ins = [tab.clone().requires_grad_(True),
           None if tri is None else tri.clone().requires_grad_(True),
           torch.from_numpy(o_np).requires_grad_(True),
           torch.from_numpy(d_np).requires_grad_(True)]
    te, row, tx, xrow = hit3.ClosestHit.apply(*ins, layout, mode)
    # the same winners as the JAX kernel, t within an ulp or two
    np.testing.assert_array_equal(row.numpy(), np.asarray(out_j[1]))
    np.testing.assert_array_equal(xrow.numpy(), np.asarray(out_j[3]))
    np.testing.assert_allclose(te.detach().numpy(), np.asarray(out_j[0]),
                               rtol=1e-5)
    hits = int((te < hit3.BIG * 0.5).sum())
    assert 0 < hits < R, "the case needs hits and misses"
    if need_exit and tri is not None:
        assert bool(((xrow != row) & (te < hit3.BIG * 0.5)).any())
    torch.autograd.backward([te, tx], [torch.from_numpy(ct_te),
                                       torch.from_numpy(ct_tx)])
    d_tab = ins[0].grad.numpy()
    for name, cols, g in (("fr", slice(0, 9), g_c[0]),
                          ("ipos", slice(9, 12), g_c[1]),
                          ("pa", slice(12, 15), g_c[2]),
                          ("pr", slice(15, 16), g_c[3])):
        _close(name, d_tab[:, cols], np.asarray(g).reshape(js.n_prims, -1))
    assert not d_tab[:, 16:].any()
    if tri is not None:
        n = tri.shape[0]
        d_tri = ins[1].grad.numpy()
        _close("AT", d_tri[:, :9], np.asarray(g_c[6])[:n])
        _close("HT", d_tri[:, 9:12], np.asarray(g_c[7])[:n])
        assert np.abs(d_tri[:, :12]).max() > 0
    _close("o", ins[2].grad.numpy(), g_o, RTOL)
    _close("d", ins[3].grad.numpy(), g_d, RTOL)
    assert np.abs(d_tab[:, :16]).max() > 0


def test_box_edge_ties_share_the_cotangent():
    """A ray through the box's edge: its entry t is attained by two axes
    and its cotangent splits evenly between them (the fused backward's rule
    would give all of it to the first): d t / d ipos is the mean of the two
    axes' slab derivatives."""
    ps = port_scene(compile_scene(schema.SceneConfig.from_json(BOXES)))
    layout = hit3.seg_layout(ps.kind_counts, ps.kind_sweep)
    tab = hit3.pack_scene(ps, hit3.intersect.build_frames(ps))
    o = torch.tensor([[-2.0, -2.0, 0.1]])
    d = torch.nn.functional.normalize(torch.tensor([[1.0, 1.0, 0.0]]), dim=1)
    te, tx = hit3.winner_t_plain(tab.requires_grad_(True), layout, o, d,
                                 torch.zeros(1, dtype=torch.int32))
    (g,) = torch.autograd.grad(te, tab)
    # t = (ip_k - 0.5 - o_k) / d_k on axes x and y: each axis gets half
    want = 0.5 / float(d[0, 0])
    np.testing.assert_allclose(g[0, 9:12].numpy(), [want, want, 0.0],
                               rtol=1e-6)
