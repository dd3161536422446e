"""The whole trace's culled sweeps (``csrc/sph_walk.cuh`` and the culled
exit of ``csrc/hit3.cuh``), built for the CPU, and the plain exit-mode
sweep against the JAX package.

The host C++ compiler builds the device functions of ``trace_fwd.cu``
(with ``test_torch_kernel_host.py``'s shim: ``__device__`` defined away,
no FMA contraction, as ``nvcc -fmad=false``) and runs them one ray after
another:

* (a) the sphere walk of the whole-trace and primary-hit kernels
  (``walk_closest_hit`` entry only, ``walk_any_hit``: 8-row sub-blocks,
  nearest first from inside the segment, packed rows) equals the
  lowest-first walk of 64-row blocks (``hit3.cuh`` ``closest_hit``,
  ``any_hit``: the parent design) and ``hit3.closest_hit_plain`` /
  ``hit3.any_hit``, rows equal and t bit for bit, on the 13^3 grid (35
  blocks, a 64-bit lane mask), on ``inst_grid``'s generator (16 blocks,
  the whole trace's 32-bit mask), and on a grid whose duplicated spheres
  tie across blocks, for camera rays, rays from inside the blocks, rays
  after two plain bounce steps and rays from 100-300 units away that
  graze spheres;
* (b) in exit mode (``inst_glass``'s generator) the walk's exit, the
  winner row's own t1, equals ``hit3.cuh``'s dense exit sweep over the
  winner's group (``exit_seg``) and the plain sweep bit for bit;
* (c) on the 960-triangle torus (15 cull blocks), for camera rays, rays
  aimed at the torus and rays after two plain bounce steps, the culled
  exit-mode closest hit (the entry and the group exit culled per block,
  ``tri_exit_culled``) equals the plain culled sweep bit for bit, and the
  parent's unculled form (the same kernel code with no cull blocks) but
  on phantoms (``tri.culled_exit_phantoms``, and an entry hit outside its
  block's box): 0 of those on these rays;
* (d) the plain exit-mode sweep on the torus against the JAX package's
  closest hit (its Pallas kernel in interpret mode, ``MRT_HIT3=1``, which
  never culls an exit): rows equal, t within rtol 1e-5 / atol 1e-6, but
  on phantoms (none here); and the plain whole trace of ``mesh_glass``
  (the coarse torus) and the small ``inst_glass`` against the JAX trace
  (``MRT_STEP=1``, ``MRT_TRI_NOCULL=1``): ``test_torch_step.py``'s rule,
  rtol 1e-3 / atol 1e-4 on all but 0.5% of the rays, bounce 3.

The plain sweeps run with a correctly rounded square root
(``test_torch_step_walk._exact_sqrt``).
"""

import ctypes
import functools
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micro_raytracer_tpu.models import compiler as jcomp
from micro_raytracer_tpu.models import schema as jschema
from micro_raytracer_tpu.ops import intersect as ji
from micro_raytracer_tpu.ops import pallas_hit3 as jh
from micro_raytracer_tpu.ops import pallas_step as jps
from micro_raytracer_tpu_torch.models import camera, schema
from micro_raytracer_tpu_torch.models import tracer as ttr
from micro_raytracer_tpu_torch.models.compiler import (compile_camera,
                                                       compile_scene)
from micro_raytracer_tpu_torch.ops import hit3, step, tri
from micro_raytracer_tpu_torch.utils.kernels import CSRC
from chip_smoke import PHANTOM_SHARE, inst_scene
from test_torch_grad import _jax_pack
from test_torch_kernel_host import _SHIM
from test_torch_step_walk import _exact_sqrt, _lay, _sphere_rays, _tied  # noqa: F401,E501
from torch_mesh_helpers import CAMERA as MESH_CAMERA
from torch_mesh_helpers import aimed_rays, mesh_scene, small_torus
from torch_mesh_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import outlier_rows, port_scene, rays

R = 1024

_HARNESS = r"""
#include "trace_fwd.cu"

#include <vector>

static mrt::Layout layout(const int* l) {
  return mrt::Layout{l[0], l[1], l[2], l[3], l[4],
                     l[5], l[6], l[7], l[8], l[9]};
}

// closest hit (mode 0 entry, 1 entry and exit, 2 any) of each ray over a
// scene without triangles whose sphere segment has cull blocks: walk 0,
// hit3.cuh closest_hit / any_hit (64-row blocks lowest first; the exit
// dense); walk 1, sph_walk.cuh walk_closest_hit / walk_any_hit
template <class Mask>
static void sph_rays(int walk, int mode, const float* tab, const int* l,
    const float* sbb, const float* srows, const float* ssb, const float* o,
    const float* d, int R, float* te, int* row, float* tx, int* xrow) {
  const mrt::Layout lay = layout(l);
  const mrt::Tris T{nullptr, sbb};
  float seg[mrt::kBbCols];  // the blocks' AABB (shared memory there)
  mrt::chunk_bounds(sbb, lay.n_sb, seg, 0, 1);
  // the planes' and boxes' sweep rows at their own row numbers
  std::vector<float> pb(static_cast<size_t>(lay.box_start + lay.box_n + 1) *
                        mrt::kSweepCols);
  for (int r = lay.pln_start; r < lay.box_start + lay.box_n; ++r)
    for (int c = 0; c < mrt::kSweepCols; ++c)
      pb[r * mrt::kSweepCols + c] = tab[r * mrt::kRowCols + c];
  float tb[64];
  const mrt::SphWalk W{mrt::SphPack{srows, ssb, seg}, sbb, tb, 1,
                       pb.data()};
  for (int i = 0; i < R; ++i) {
    const float* a = o + 3 * i;
    const float* b = d + 3 * i;
    mrt::Hit h;
    if (mode == 2) {
      const bool hit =
          walk ? mrt::walk_any_hit<Mask>(lay, W, a[0], a[1], a[2], b[0],
                                         b[1], b[2])
               : mrt::any_hit<false, true, Mask>(tab, mrt::kRowCols, lay,
                                                 a[0], a[1], a[2], b[0],
                                                 b[1], b[2], T);
      h = mrt::Hit{hit ? -mrt::kBig : mrt::kBig, 0,
                   hit ? -mrt::kBig : mrt::kBig, 0};
    } else if (mode == 1) {
      h = walk ? mrt::walk_closest_hit<true, Mask>(lay, W, a[0], a[1], a[2],
                                                   b[0], b[1], b[2])
               : mrt::closest_hit<true, false, true, Mask>(
                     tab, mrt::kRowCols, lay, a[0], a[1], a[2], b[0], b[1],
                     b[2], T);
    } else {
      h = walk ? mrt::walk_closest_hit<false, Mask>(lay, W, a[0], a[1], a[2],
                                                    b[0], b[1], b[2])
               : mrt::closest_hit<false, false, true, Mask>(
                     tab, mrt::kRowCols, lay, a[0], a[1], a[2], b[0], b[1],
                     b[2], T);
    }
    te[i] = h.te;
    row[i] = h.row;
    tx[i] = h.tx;
    xrow[i] = h.xrow;
  }
}

extern "C" void host_sph(int walk, int mode, const float* tab, const int* l,
    const float* sbb, const float* srows, const float* ssb, const float* o,
    const float* d, int R, float* te, int* row, float* tx, int* xrow) {
  if (l[9] <= 32)
    sph_rays<unsigned>(walk, mode, tab, l, sbb, srows, ssb, o, d, R, te,
                       row, tx, xrow);
  else
    sph_rays<unsigned long long>(walk, mode, tab, l, sbb, srows, ssb, o, d,
                                 R, te, row, tx, xrow);
}

// the exit-mode closest hit of a scene with triangles (hit3.cuh
// closest_hit<true, true>): culled with the layout's cull blocks, or, with
// n_cb = 0 in the layout, unculled (the parent's form)
extern "C" void host_tri_exit(const float* tab, const int* l,
    const float* tri, const float* bb, const float* o, const float* d,
    int R, float* te, int* row, float* tx, int* xrow) {
  const mrt::Layout lay = layout(l);
  const mrt::Tris T{tri, bb};
  for (int i = 0; i < R; ++i) {
    const float* a = o + 3 * i;
    const float* b = d + 3 * i;
    const mrt::Hit h = mrt::closest_hit<true, true>(
        tab, mrt::kRowCols, lay, a[0], a[1], a[2], b[0], b[1], b[2], T);
    te[i] = h.te;
    row[i] = h.row;
    tx[i] = h.tx;
    xrow[i] = h.xrow;
  }
}
"""


@pytest.fixture(scope="module")
def sweep_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    d = tmp_path_factory.mktemp("host_sweep")
    (d / "shim.h").write_text(_SHIM)
    (d / "harness.cpp").write_text(_HARNESS)
    out = d / "libhost_sweep.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-include", str(d / "shim.h"), "-I", CSRC,
                    "-o", str(out), str(d / "harness.cpp")], check=True,
                   capture_output=True, timeout=300)
    return ctypes.CDLL(os.fspath(out))


def _p(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _hits(n):
    return (torch.empty(n), torch.empty(n, dtype=torch.int32),
            torch.empty(n), torch.empty(n, dtype=torch.int32))


@functools.lru_cache(maxsize=None)
def _grid(name):
    """The sphere grids of (a) and (b): ``grid13`` (13^3 spheres, 35
    blocks), ``inst_grid`` and ``inst_glass`` (``chip_smoke.py``'s
    generators: 1,000 spheres in 16 blocks, 343 in 6), ``ties``
    (``grid13`` with spheres copied onto rows of other blocks)."""
    if name in ("inst_grid", "inst_glass"):
        js = inst_scene(name)
    else:
        js = inst_scene("inst_grid", dims=(13, 13, 13))
    scene = compile_scene(schema.SceneConfig.from_json(js), "cpu")
    pairs = []
    if name == "ties":
        scene, pairs = _tied(scene)
    tables = step.pack_step(scene)
    assert tables.sbb is not None and tables.srows is not None
    return scene, tables, pairs


def _run_sph(lib, walk, mode, tables, o, d):
    n = o.shape[0]
    out = _hits(n)
    tab, lay = tables.tab.detach().contiguous(), _lay(tables)
    lib.host_sph(walk, mode, _p(tab), _p(lay), _p(tables.sbb),
                 _p(tables.srows), _p(tables.ssb), _p(o), _p(d), n,
                 *map(_p, out))
    return out


@pytest.mark.parametrize("kind", ["camera", "inside", "bounced", "far"])
@pytest.mark.parametrize("name", ["grid13", "inst_grid", "ties"])
def test_walk_equals_lowest_first_and_plain(name, kind, sweep_lib,
                                            _exact_sqrt):
    """(a): the whole trace's sphere walk, entry only and any-hit, against
    the parent's lowest-first walk and the plain culled sweep."""
    scene, tables, pairs = _grid(name)
    o, d = _sphere_rays(scene, tables, kind)
    want = hit3.closest_hit_plain(tables.tab, tables.layout, o, d,
                                  hit3.MODE_ENTRY, sbb=tables.sbb)
    assert int((want[0] < hit3.BIG * 0.5).sum()) > o.shape[0] // 4
    for walk in (0, 1):
        got = _run_sph(sweep_lib, walk, hit3.MODE_ENTRY, tables, o, d)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (walk, name, kind)
    if name == "ties":
        s = tables.layout[0][0][1]
        highs = torch.tensor([max(k, j) for k, j in pairs])
        assert not bool(torch.isin(want[1].long() - s, highs).any())
    plain = hit3.any_hit(tables.tab, tables.layout, o, d, sbb=tables.sbb)
    for walk in (0, 1):
        got = _run_sph(sweep_lib, walk, hit3.MODE_ANY, tables, o, d)
        assert torch.equal(got[0] < 0.0, plain), (walk, name, kind)


@pytest.mark.parametrize("kind", ["camera", "inside", "bounced"])
def test_walk_exit_is_the_winner_rows_t1(kind, sweep_lib, _exact_sqrt):
    """(b): on ``inst_glass``'s generator the walk's exit (the winner row's
    own t1) equals hit3.cuh's dense exit sweep over the winner's group and
    the plain exit-mode sweep, bit for bit."""
    scene, tables, _pairs = _grid("inst_glass")
    assert scene.any_refract
    o, d = _sphere_rays(scene, tables, kind)
    want = hit3.closest_hit_plain(tables.tab, tables.layout, o, d,
                                  hit3.MODE_EXIT, sbb=tables.sbb)
    hit = want[0] < hit3.BIG * 0.5
    assert int(hit.sum()) > o.shape[0] // 4
    # every hit has an exit, its own row
    assert torch.equal(want[3][hit], want[1][hit])
    assert bool((want[2][hit] >= want[0][hit]).all())
    for walk in (0, 1):
        got = _run_sph(sweep_lib, walk, hit3.MODE_EXIT, tables, o, d)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (walk, kind)


@functools.lru_cache(maxsize=None)
def _torus():
    scene = compile_scene(schema.SceneConfig.from_json(
        mesh_scene("mesh_glass")), "cpu")
    tables = step.pack_step(scene)
    assert tables.tbb is not None and tables.tbb.shape[0] == 15
    return scene, tables


def _torus_rays(scene, tables, kind):
    """float32 (o, d) (R, 3) of the glass torus room: ``camera`` rays of
    its camera, ``aimed`` rays toward its triangle blocks, ``bounced`` the
    camera rays after two plain bounce steps (those still live)."""
    gen = torch.Generator().manual_seed(41)
    if kind == "aimed":
        o, d = aimed_rays(scene, R, 17)
        return torch.from_numpy(o * np.float32(0.3)).contiguous(), \
            torch.from_numpy(d).contiguous()
    cam = compile_camera(schema.CameraConfig.from_json(MESH_CAMERA), "cpu")
    o, d = camera.gen_rays(cam, (64, 64),
                           torch.floor(torch.rand((4 * R, 2), generator=gen)
                                       * 64),
                           torch.rand((4 * R, 2), generator=gen))
    if kind == "bounced":
        c = step.primary_carry(o.T.contiguous(), d.T.contiguous())
        u8s = torch.rand((2, step.n_uni(True), c.shape[1]), generator=gen)
        with torch.no_grad():
            for k in range(2):
                c = step.step_plain(scene, tables, 0.85, c, u8s[k])[0]
        live = c[step.C_LIVE] > 0.5
        o, d = c[0:3].T[live], c[3:6].T[live]
    return o.contiguous(), d.contiguous()


def _entry_phantoms(tables, o, d, te, row):
    """Rays whose triangle winner's hit point (float64) lies outside its
    block's slacked AABB: the only entries a cull may drop."""
    s = tables.layout[1]
    k = (row.long() - s)
    on = (te < hit3.BIG * 0.5) & (k >= 0)
    b = (k.clamp(min=0) // hit3.CB).clamp(max=tables.tbb.shape[0] - 1)
    p = o.double() + te.double()[:, None] * d.double()
    box = tables.tbb[b].double()
    return on & ((p < box[:, :3]) | (p > box[:, 3:6])).any(1)


@pytest.mark.parametrize("kind", ["camera", "aimed", "bounced"])
def test_culled_triangle_exit_differs_only_on_phantoms(kind, sweep_lib,
                                                       _exact_sqrt):
    """(c): the exit-mode closest hit of the whole trace, its triangle
    entry and group exit culled per block, against the plain culled sweep
    (bit for bit) and against the parent's unculled form (the kernel code
    with no cull blocks): equal but on phantom entries or exits, and none
    of those on these rays."""
    scene, tables = _torus()
    o, d = _torus_rays(scene, tables, kind)
    n = o.shape[0]
    lay = _lay(tables)
    full_lay = lay.clone()
    full_lay[8] = 0
    args = (_p(tables.tab.detach().contiguous()), None,
            _p(tables.tri.detach().contiguous()), _p(tables.tbb), _p(o),
            _p(d), n)
    got, full = _hits(n), _hits(n)
    sweep_lib.host_tri_exit(args[0], _p(lay), *args[2:], *map(_p, got))
    sweep_lib.host_tri_exit(args[0], _p(full_lay), *args[2:],
                            *map(_p, full))
    want = hit3.closest_hit_plain(tables.tab, tables.layout, o, d,
                                  hit3.MODE_EXIT, tables.tri, tables.tbb)
    for g, w in zip(got, want):
        assert torch.equal(g, w), kind
    won = got[1] >= tables.layout[1]
    assert int(won.sum()) > 20, int(won.sum())
    entry_differs = ~((got[0] == full[0]) & (got[1] == full[1]))
    entry_ph = _entry_phantoms(tables, o, d, full[0], full[1])
    differs, phantom = tri.culled_exit_phantoms(
        tables.tbb, o, d, (got[2], got[3] - tables.layout[1]),
        (full[2], full[3] - tables.layout[1]))
    differs = differs & ~entry_differs
    assert not bool((entry_differs & ~entry_ph).any())
    assert not bool((differs & ~phantom).any())
    assert int(entry_differs.sum()) + int(differs.sum()) == 0
    # the cull skips most of the group's rows
    rows = hit3.tri_rows_tested(tables.tab, tables.layout, o, d,
                                hit3.MODE_EXIT, tables.tri, tables.tbb)
    rows_full = hit3.tri_rows_tested(tables.tab, tables.layout, o, d,
                                     hit3.MODE_EXIT, tables.tri, None)
    assert float(rows.float().mean()) < 0.5 * float(rows_full.float().mean())


@functools.lru_cache(maxsize=None)
def _jax_torus_hits():
    src = mesh_scene("mesh_glass")
    js = jcomp.compile_scene(jschema.SceneConfig.from_json(src))
    ps = port_scene(js)
    o, d = aimed_rays(ps, 512, 19)
    o = (o * np.float32(0.3)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MRT_HIT3", "1")
        h = jh.closest_hit(js, ji.build_frames(js), jnp.asarray(o),
                           jnp.asarray(d), need_exit=True)
    return ps, (o, d), tuple(np.asarray(x) for x in (
        h.hit, h.t_entry, h.idx_entry, h.t_exit, h.idx_exit))


def test_plain_exit_sweep_matches_jax_on_the_torus(_exact_sqrt):
    """(d): the port's plain exit-mode sweep (culled entry and group exit)
    on the 960-triangle torus against the JAX package's closest hit, which
    never culls an exit: rows equal and t within rtol 1e-5 / atol 1e-6 on
    every ray but phantoms, at most chip_smoke.PHANTOM_SHARE of them (none
    on these rays)."""
    ps, (o, d), (hit, te, row, tx, xrow) = _jax_torus_hits()
    tables = step.pack_step(ps)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    got = [t.numpy() for t in hit3.closest_hit(
        tables.tab, tables.layout, ot, dt, hit3.MODE_EXIT, tables.tri,
        tables.tbb)]
    assert (got[1] >= tables.layout[1]).sum() > 50
    same = ((got[0] < hit3.BIG * 0.5) == hit) & (got[1] == row) \
        & (~hit | ((got[3] == xrow)
                   & np.isclose(got[0], te, rtol=1e-5, atol=1e-6)
                   & np.isclose(got[2], tx, rtol=1e-5, atol=1e-6)))
    bad = np.flatnonzero(~same)
    if len(bad):
        ph_e = _entry_phantoms(tables, ot, dt, torch.from_numpy(te),
                               torch.from_numpy(row.astype(np.int32)))
        _d, ph_x = tri.culled_exit_phantoms(
            tables.tbb, ot, dt,
            (torch.from_numpy(got[2]), torch.from_numpy(got[3])
             - tables.layout[1]),
            (torch.from_numpy(tx), torch.from_numpy(
                xrow.astype(np.int32)) - tables.layout[1]))
        phantom = (ph_e | ph_x).numpy()
        assert phantom[bad].all(), bad
        assert len(bad) <= PHANTOM_SHARE * len(o), bad
    assert len(bad) == 0, bad


@pytest.mark.parametrize("name", ["mesh_glass", "inst_glass"])
def test_plain_trace_matches_jax(name, monkeypatch):
    """(d): the port's plain whole trace, whose exit-mode sweeps cull,
    against the JAX trace (its kernels in interpret mode, the triangle
    cull off: its block bounds omit a mesh's translation) on 256 rays from
    inside the scene, bounce 3: rtol 1e-3 / atol 1e-4 on all but 0.5% of
    the rays; first_live equal."""
    monkeypatch.setenv("MRT_STEP", "1")
    monkeypatch.setenv("MRT_HIT3", "1")
    monkeypatch.setenv("MRT_TRI_NOCULL", "1")
    src = mesh_scene(name, small_torus()) if name == "mesh_glass" \
        else inst_scene(name, True)
    js = jcomp.compile_scene(jschema.SceneConfig.from_json(src))
    ps = port_scene(js)
    tables = step.pack_step(ps)
    assert (tables.tbb if name == "mesh_glass" else tables.sbb) is not None
    n, K = 256, 4
    o, d = rays(n, seed=5)
    o = (o * np.float32(0.22) if name == "mesh_glass"
         else o * np.float32(1.2) + np.float32([0.0, 2.5, 0.5]))
    o = o.astype(np.float32)
    u8s = np.random.default_rng(6).random(
        (K, step.n_uni(ps.any_refract), n)).astype(np.float32)
    consts, attr, gattr, attr2, lights, tex = _jax_pack(js)
    A_j, B_j, fl_j = jps.trace_packed(
        js, consts, attr, lights, jnp.float32(0.85), jnp.asarray(o.T),
        jnp.asarray(d.T), jnp.asarray(u8s), tex=tex, inference=True,
        gattr=gattr, attr2=attr2)
    A, B, fl = step.trace_packed(
        ps, tables, ttr.decay_of(0.15), torch.from_numpy(o.T.copy()),
        torch.from_numpy(d.T.copy()), torch.from_numpy(u8s))
    assert np.asarray(fl_j).sum() > 0.25 * n
    np.testing.assert_array_equal(fl.numpy(), np.asarray(fl_j))
    for g, w in ((A, A_j), (B, B_j)):
        bad = outlier_rows(g.numpy().T, np.asarray(w).T, 1e-3, 1e-4)
        assert len(bad) <= 0.005 * n, bad
