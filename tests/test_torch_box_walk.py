"""The box walk (``csrc/box_walk.cuh``), built for the CPU, its tables
(``hit3.box_walk_tables``) and the plain box-walk sweep against the JAX
package.

The host C++ compiler builds the device functions of ``trace_fwd.cu``
(``test_torch_kernel_host.py``'s shim: ``__device__`` defined away, no FMA
contraction, as ``nvcc -fmad=false``) and runs them one ray after
another:

* (a) the walk's closest hit (entry, and entry with the exit, the winner
  row's own t1) and its any-hit (``box_closest_hit``, ``box_any_hit``:
  nodes and leaves nearest first, packed rows) equal the dense sweep of
  ``hit3.cuh`` (``closest_hit``, ``any_hit``: every box row) and the plain
  box-walk sweep (``hit3.sweep_plain`` with the walk's tables), rows equal
  and t bit for bit, on ``tex_blocks`` at its full 16 x 16 width and on
  the same grid with boxes copied onto boxes of other leaves (a ray that
  hits one hits both at the same t: the lowest row must win), for camera
  rays, rays from inside boxes, axis-parallel rays (direction components
  exactly 0), rays after two plain bounce steps, rays from box faces
  toward the light (shadow rays), rays from 100-300 units away that
  graze boxes, and rays along y just under boxes' bottom faces, where the
  box test's 1/EPS for a zero direction component reports hits up to EPS
  t outside the box (the walk's growth holds them); no dense winner lies
  outside the walk's grown boxes (``hit3.box_walk_phantoms``: 0 of
  them);
* (b) the plain box-walk sweep against the JAX package's closest hit (its
  Pallas kernel in interpret mode, ``MRT_HIT3=1``) on an 8 x 8 textured
  block grid (64 boxes, the least the walk takes), rows equal and t within
  rtol 1e-5 / atol 1e-6; and the plain whole trace of that scene against
  the JAX trace (``MRT_STEP=1``): ``test_torch_step.py``'s rule, rtol
  1e-3 / atol 1e-4 on all but 0.5% of the rays, bounce 3;
* (c) the walk's leaf and node AABBs contain every box's corners, and
  after an ``inst_pos`` update (the walk order kept, the bounds rebuilt)
  too;
* (d) the textured whole trace walking the boxes (``trace_ray``, kBox)
  and the refilling render's step (``ray_step``, kTex and kBox) equal the
  dense kTex trace bit for bit on ``tex_blocks``;
* the launch count of a named variant (``CudaKernel.variants``), by which
  the box walk's launches are counted.

The plain sweeps run with a correctly rounded square root
(``test_torch_step_walk._exact_sqrt``).
"""

import ctypes
import dataclasses
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
from micro_raytracer_tpu_torch.ops import hit3, step
from micro_raytracer_tpu_torch.utils.kernels import CSRC, CudaKernel
from chip_smoke import TEX_CAMERAS, tex_blocks
from test_torch_grad import _jax_pack
from test_torch_kernel_host import _SHIM
from test_torch_step_walk import _exact_sqrt, _lay  # noqa: F401
from torch_mesh_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import outlier_rows, port_scene

R = 1024

_HARNESS = r"""
#include "trace_fwd.cu"

#include <vector>

// closest hit (mode 0 entry, 1 entry and exit, 2 any) of each ray over a
// textured scene whose box segment is walked: walk 0, hit3.cuh
// closest_hit / any_hit (every box row); walk 1, box_walk.cuh
// box_closest_hit / box_any_hit over the tables bw of n boxes
extern "C" void host_box(int walk, int mode, const float* tab, const int* l,
    const float* bw, int n, const float* o, const float* d, int R,
    float* te, int* row, float* tx, int* xrow) {
  const mrt::Layout lay{l[0], l[1], l[2], l[3], l[4],
                        l[5], l[6], l[7], l[8], l[9]};
  // the sweep rows before the box segment (shared memory there)
  std::vector<float> pb(static_cast<size_t>(lay.box_start + 1) *
                        mrt::kSweepCols);
  for (int r = 0; r < lay.box_start; ++r)
    for (int c = 0; c < mrt::kSweepCols; ++c)
      pb[r * mrt::kSweepCols + c] = tab[r * mrt::kRowCols + c];
  std::vector<float> tb(mrt::box_nodes(n) + mrt::kBoxFan);
  const mrt::BoxWalk W{bw, bw + mrt::box_bounds_floats(n), tb.data(), 1,
                       pb.data(), n};
  for (int i = 0; i < R; ++i) {
    const float* a = o + 3 * i;
    const float* b = d + 3 * i;
    mrt::Hit h;
    if (mode == 2) {
      const bool hit =
          walk ? mrt::box_any_hit(lay, W, a[0], a[1], a[2], b[0], b[1], b[2])
               : mrt::any_hit<false, false>(tab, mrt::kRowCols, lay, a[0],
                                            a[1], a[2], b[0], b[1], b[2]);
      h = mrt::Hit{hit ? -mrt::kBig : mrt::kBig, 0,
                   hit ? -mrt::kBig : mrt::kBig, 0};
    } else if (mode == 1) {
      h = walk ? mrt::box_closest_hit<true>(lay, W, a[0], a[1], a[2], b[0],
                                            b[1], b[2])
               : mrt::closest_hit<true, false, false>(
                     tab, mrt::kRowCols, lay, a[0], a[1], a[2], b[0], b[1],
                     b[2]);
    } else {
      h = walk ? mrt::box_closest_hit<false>(lay, W, a[0], a[1], a[2], b[0],
                                             b[1], b[2])
               : mrt::closest_hit<false, false, false>(
                     tab, mrt::kRowCols, lay, a[0], a[1], a[2], b[0], b[1],
                     b[2]);
    }
    te[i] = h.te;
    row[i] = h.row;
    tx[i] = h.tx;
    xrow[i] = h.xrow;
  }
}

// the textured whole trace (render, refractive) of each ray from its
// primary hit: mode 0 trace_ray over the dense rows (the kTex instance),
// 1 trace_ray walking the boxes (kBox), 2 ray_step walking the boxes one
// step at a time (the refilling kBox render)
extern "C" void host_box_trace(int mode, const float* tab, const int* l,
    const float* bw, int n, const float* lights, int L, float dk,
    const int* maps, const float* atlas, const int* tmeta, int slots,
    const float* o0, const float* d0, const float* te0, const int* row0,
    const float* tx0, const int* xrow0, const float* u8s, int K, int R,
    float* A, float* B, float* fl) {
  const mrt::Layout lay{l[0], l[1], l[2], l[3], l[4],
                        l[5], l[6], l[7], l[8], l[9]};
  std::vector<float> pb(static_cast<size_t>(lay.box_start + 1) *
                        mrt::kSweepCols);
  for (int r = 0; r < lay.box_start; ++r)
    for (int c = 0; c < mrt::kSweepCols; ++c)
      pb[r * mrt::kSweepCols + c] = tab[r * mrt::kRowCols + c];
  std::vector<float> tb(mrt::box_nodes(n) + mrt::kBoxFan);
  const mrt::BoxWalk W{bw, bw + mrt::box_bounds_floats(n), tb.data(), 1,
                       pb.data(), n};
  const mrt::Tex tex{maps, atlas, tmeta, slots};
  const mrt::Tris T{nullptr, nullptr};
  const mrt::Seg sg{0, K};
  for (int i = 0; i < R; ++i) {
    const mrt::Hit h{te0[i], row0[i], tx0[i], xrow0[i]};
    if (mode == 0) {
      mrt::trace_ray<true, false, false, true>(
          tab, tab, T, lay, lights, L, dk, tex, i, R, sg, o0, d0, h, u8s, A,
          B, fl, nullptr, nullptr);
    } else if (mode == 1) {
      mrt::trace_ray<true, false, false, true, false, true>(
          tab, tab, T, lay, lights, L, dk, tex, i, R, sg, o0, d0, h, u8s, A,
          B, fl, nullptr, nullptr, mrt::SphWalk{}, W);
    } else {
      mrt::Carry c{mrt::v3(o0[i], o0[R + i], o0[2 * R + i]),
                   mrt::v3(d0[i], d0[R + i], d0[2 * R + i]),
                   mrt::v3(1.0f, 1.0f, 1.0f), mrt::v3(0.0f, 0.0f, 0.0f),
                   1.0f};
      float first_live = 0.0f;
      int steps = 0;
      for (int k = 0; k < K; ++k)
        if (!mrt::ray_step<true, false, false, true, true>(
                tab, T, lay, lights, L, dk, i, R, k, h, u8s, c, first_live,
                nullptr, steps, mrt::SphWalk{}, tex, W))
          break;
      A[i] = c.A.x; A[R + i] = c.A.y; A[2 * R + i] = c.A.z;
      B[i] = c.B.x; B[R + i] = c.B.y; B[2 * R + i] = c.B.z;
      fl[i] = first_live;
    }
  }
}
"""


@pytest.fixture(scope="module")
def box_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    d = tmp_path_factory.mktemp("host_box")
    (d / "shim.h").write_text(_SHIM)
    (d / "harness.cpp").write_text(_HARNESS)
    out = d / "libhost_box.so"
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


# box pairs (k, j), segment-local: box j becomes a copy of box k
# (position, frame, sizes), in another leaf of the walk's order
PAIRS = ((5, 200), (130, 7), (64, 250), (33, 180), (99, 160))


@functools.lru_cache(maxsize=None)
def _blocks(name):
    """``tex_blocks`` (16 x 16 boxes over a plane), or ``ties``: the same
    grid with the boxes of PAIRS copied, after the walk order was taken
    from the grid (so each copy keeps its leaf)."""
    scene = compile_scene(schema.SceneConfig.from_json(tex_blocks()), "cpu")
    tables = step.pack_step(scene)
    assert tables.box is not None and tables.box.n == 256
    if name == "ties":
        s = scene.seg(schema.KIND_BOX).start
        pos, dirs = scene.inst_pos.clone(), scene.inst_dir.clone()
        for k, j in PAIRS:
            pos[s + j], dirs[s + j] = pos[s + k], dirs[s + k]
        scene = dataclasses.replace(scene, inst_pos=pos, inst_dir=dirs)
        tables = step.pack_step(scene)
        rows = hit3._box_parts(tables.box)[3][:, 15].long() - s
        where = {int(r): i // hit3.BOX_LEAF for i, r in enumerate(rows)}
        assert all(where[k] != where[j] for k, j in PAIRS)
    return scene, tables


def _box_rays(scene, tables, kind):
    """float32 (o, d) (n, 3) of the block grid: ``camera`` rays of its
    camera, ``inside`` rays from random points of random boxes in random
    directions, ``axis`` rays from random points of the grid's AABB along
    +-x, +-y, +-z (components exactly 0), ``bounced`` the camera rays after
    two plain bounce steps (those still live), ``faces`` rays from points
    on the boxes' top faces toward the light (shadow rays: origin 1e-4
    off the face), ``far`` rays from 100-300 units away that graze random
    boxes' edges, ``under`` rays along +y from y = -8 at 0.3e-3 to 1.5e-3
    under the bottom face of random boxes above the ground whose frame
    keeps y (unrotated)."""
    gen = torch.Generator().manual_seed(23)
    s = scene.seg(schema.KIND_BOX)
    ip, sz = scene.inst_pos[s][:256], scene.prim_a[s][:256]
    k = torch.randint(0, 256, (R,), generator=gen)
    unit = torch.nn.functional.normalize
    if kind == "inside":
        o = ip[k] + (torch.rand((R, 3), generator=gen) - 0.5) * sz[k] * 0.98
        return o.contiguous(), unit(torch.randn((R, 3), generator=gen),
                                    dim=1).contiguous()
    if kind == "axis":
        lo, hi = ip.amin(0) - 1.0, ip.amax(0) + 1.0
        o = lo + torch.rand((R, 3), generator=gen) * (hi - lo)
        d = torch.zeros((R, 3))
        ax = torch.randint(0, 3, (R,), generator=gen)
        d[torch.arange(R), ax] = torch.where(
            torch.rand(R, generator=gen) < 0.5, -1.0, 1.0)
        return o.contiguous(), d.contiguous()
    if kind == "faces":
        top = ip[k] + torch.stack([
            (torch.rand(R, generator=gen) - 0.5) * sz[k, 0],
            (torch.rand(R, generator=gen) - 0.5) * sz[k, 1],
            0.5 * sz[k, 2]], 1)
        light = torch.tensor([2.0, 4.0, 6.0])
        d = unit(light - top, dim=1)
        return (top + d * 1e-4).contiguous(), d.contiguous()
    if kind == "under":
        # boxes whose frame maps y to y: d' = M d keeps x and z exactly 0
        f = step.intersect.build_frames(scene)[s][:256]
        along = (f[:, 0, 1] == 0.0) & (f[:, 2, 1] == 0.0)
        ok = torch.nonzero(along & (ip[:, 2] - 0.5 * sz[:, 2] > -1.45))[:, 0]
        k = ok[torch.randint(0, ok.numel(), (R,), generator=gen)]
        gap = 3e-4 + 1.2e-3 * torch.rand(R, generator=gen)
        o = torch.stack([ip[k, 0] + (torch.rand(R, generator=gen) - 0.5)
                         * 0.9 * sz[k, 0], torch.full((R,), -8.0),
                         ip[k, 2] - 0.5 * sz[k, 2] - gap], 1)
        d = torch.tensor([[0.0, 1.0, 0.0]]).expand(R, 3)
        return o.contiguous(), d.contiguous()
    if kind == "far":
        edge = ip[k] + 0.5 * sz[k] * torch.where(
            torch.rand((R, 3), generator=gen) < 0.5, -1.0, 1.0)
        edge[:, 0] = ip[k, 0] + (torch.rand(R, generator=gen) - 0.5) \
            * sz[k, 0]
        d = unit(torch.randn((R, 3), generator=gen), dim=1)
        dist = 100.0 + 200.0 * torch.rand(R, generator=gen)
        return (edge - d * dist[:, None]).contiguous(), d.contiguous()
    cam = compile_camera(schema.CameraConfig.from_json(
        TEX_CAMERAS["tex_blocks"]), "cpu")
    o, d = camera.gen_rays(cam, (64, 64),
                           torch.floor(torch.rand((R, 2), generator=gen)
                                       * 64),
                           torch.rand((R, 2), generator=gen))
    if kind == "bounced":
        c = step.primary_carry(o.T.contiguous(), d.T.contiguous())
        u8s = torch.rand((2, step.n_uni(scene.any_refract), R),
                         generator=gen)
        with torch.no_grad():
            for j in range(2):
                c = step.step_plain(scene, tables, 0.85, c, u8s[j])[0]
        live = c[step.C_LIVE] > 0.5
        assert int(live.sum()) > R // 4
        o, d = c[0:3].T[live], c[3:6].T[live]
    return o.contiguous(), d.contiguous()


def _run_box(lib, walk, mode, tables, o, d):
    n = o.shape[0]
    out = _hits(n)
    tab, lay = tables.tab.detach().contiguous(), _lay(tables)
    lib.host_box(walk, mode, _p(tab), _p(lay), _p(tables.box.tab),
                 tables.box.n, _p(o), _p(d), n, *map(_p, out))
    return out


@pytest.mark.parametrize("kind", ["camera", "inside", "axis", "bounced",
                                  "faces", "far", "under"])
@pytest.mark.parametrize("name", ["tex_blocks", "ties"])
def test_walk_equals_dense_sweep_and_plain(name, kind, box_lib,
                                           _exact_sqrt):
    """(a): the box walk, entry, exit and any-hit, against hit3.cuh's
    dense sweep and the plain box-walk sweep, rows and t bit for bit; no
    phantom."""
    scene, tables = _blocks(name)
    o, d = _box_rays(scene, tables, kind)
    box_start = tables.layout[0][-1][1]
    for mode in (hit3.MODE_ENTRY, hit3.MODE_EXIT, hit3.MODE_ANY):
        want = hit3.closest_hit_plain(tables.tab, tables.layout, o, d, mode,
                                      box=tables.box)
        dense, walk = (_run_box(box_lib, w, mode, tables, o, d)
                       for w in (0, 1))
        for w, g, f in zip(want, walk, dense):
            assert torch.equal(g, w), (name, kind, mode)
            assert torch.equal(f, w), (name, kind, mode)
        hit = want[0] < hit3.BIG * 0.5
        if mode == hit3.MODE_ANY:
            continue
        boxes = hit & (want[1] >= box_start)
        assert int(boxes.sum()) > o.shape[0] // 20, (name, kind)
        assert not bool(hit3.box_walk_phantoms(
            tables.tab, tables.layout, o, d, want[0], want[1],
            tables.box).any())
        if mode == hit3.MODE_EXIT:
            assert torch.equal(want[3][hit], want[1][hit])
    if name == "ties" and kind in ("camera", "inside"):
        # a ray that hits a copied pair takes the lower row
        highs = torch.tensor([box_start + max(k, j) for k, j in PAIRS])
        lows = torch.tensor([box_start + min(k, j) for k, j in PAIRS])
        got = hit3.closest_hit_plain(tables.tab, tables.layout, o, d,
                                     hit3.MODE_ENTRY, box=tables.box)[1]
        assert not bool(torch.isin(got.long(), highs).any())
        if kind == "inside":
            assert bool(torch.isin(got.long(), lows).any())
    # the walk tests a few dozen rows where the dense sweep tests 256
    rows, _slabs = hit3.box_walk_work(tables.tab, tables.layout, o, d,
                                      hit3.MODE_ENTRY, tables.box)
    if kind != "far":
        assert float(rows.float().mean()) < 64.0, kind


def _corners(scene):
    """World corners (256, 8, 3) of the block grid's boxes (float64)."""
    s = scene.seg(schema.KIND_BOX)
    frames = step.intersect.build_frames(scene)[s][:256].double()
    ip = scene.inst_pos[s][:256].double()
    sz = scene.prim_a[s][:256].double()
    signs = torch.tensor([[a, b, c] for a in (-0.5, 0.5) for b in (-0.5, 0.5)
                          for c in (-0.5, 0.5)], dtype=torch.float64)
    q = signs[None] * sz[:, None]                       # object offsets
    return ip[:, None] + torch.linalg.solve(frames[:, None], q[..., None])[
        ..., 0]


def _contains(tables, scene):
    s = scene.seg(schema.KIND_BOX).start
    _head, nodes, leaves, rows = hit3._box_parts(tables.box)
    loc = rows[:, 15].long() - s
    c = _corners(scene)[loc]                            # walk order
    i = torch.arange(tables.box.n)
    for bb, k in ((leaves, i // hit3.BOX_LEAF),
                  (nodes, i // (hit3.BOX_LEAF * hit3.BOX_FAN))):
        lo, hi = bb[k, None, :3].double(), bb[k, None, 3:6].double()
        assert bool(((c >= lo) & (c <= hi)).all())


def test_walk_bounds_hold_every_box():
    """(c): every box's corners lie in its leaf's and its node's AABB, and
    still after an inst_pos update (the order kept, the bounds rebuilt)."""
    scene, tables = _blocks("tex_blocks")
    _contains(tables, scene)
    s = scene.seg(schema.KIND_BOX)
    gen = torch.Generator().manual_seed(4)
    pos = scene.inst_pos.clone()
    pos[s] += (torch.rand(pos[s].shape, generator=gen) - 0.5) * 0.6
    moved = dataclasses.replace(scene, inst_pos=pos)
    t2 = step.pack_step(moved)
    assert torch.equal(t2.box.tab[-tables.box.n * 16:].view(-1, 16)[:, 15],
                       tables.box.tab[-tables.box.n * 16:].view(-1, 16)[:, 15])
    assert not torch.equal(t2.box.tab, tables.box.tab)
    _contains(t2, moved)


@functools.lru_cache(maxsize=None)
def _jax_grid():
    src = tex_blocks(small=True, grid=8)
    js = jcomp.compile_scene(jschema.SceneConfig.from_json(src))
    return src, js, port_scene(js)


def test_plain_walk_matches_jax_closest_hit(_exact_sqrt):
    """(b): the plain box-walk sweep on the 8 x 8 block grid against the
    JAX package's closest hit (Pallas kernel in interpret mode), exit
    mode: rows equal, t within rtol 1e-5 / atol 1e-6."""
    _src, js, ps = _jax_grid()
    tables = step.pack_step(ps)
    assert tables.box is not None and tables.box.n == 64
    gen = np.random.default_rng(7)
    n = 512
    o = (gen.random((n, 3)) * [10.0, 10.0, 3.0] + [-5.0, 0.0, -1.5]).astype(
        np.float32)
    d = gen.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MRT_HIT3", "1")
        h = jh.closest_hit(js, ji.build_frames(js), jnp.asarray(o),
                           jnp.asarray(d), need_exit=True)
    hit, te, row, tx, xrow = (np.asarray(x) for x in (
        h.hit, h.t_entry, h.idx_entry, h.t_exit, h.idx_exit))
    got = [t.numpy() for t in hit3.closest_hit(
        tables.tab, tables.layout, torch.from_numpy(o), torch.from_numpy(d),
        hit3.MODE_EXIT, box=tables.box)]
    assert (got[1] >= tables.layout[0][-1][1]).sum() > n // 4
    np.testing.assert_array_equal(got[0] < hit3.BIG * 0.5, hit)
    np.testing.assert_array_equal(got[1][hit], row[hit])
    np.testing.assert_array_equal(got[3][hit], xrow[hit])
    np.testing.assert_allclose(got[0][hit], te[hit], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[2][hit], tx[hit], rtol=1e-5, atol=1e-6)


def test_plain_walk_trace_matches_jax(monkeypatch):
    """(b): the port's plain whole trace of the 8 x 8 block grid (its
    sweeps walk the boxes) against the JAX trace (its kernels in interpret
    mode) on 256 camera rays, bounce 3: rtol 1e-3 / atol 1e-4 on all but
    0.5% of the rays; first_live equal."""
    monkeypatch.setenv("MRT_STEP", "1")
    monkeypatch.setenv("MRT_HIT3", "1")
    _src, js, ps = _jax_grid()
    tables = step.pack_step(ps)
    assert tables.box is not None
    n, K = 256, 4
    cam = compile_camera(schema.CameraConfig.from_json(
        {"pos": [0, -3, 3], "dir": [0, 0, 1, -0.6], "fov": 70}), "cpu")
    gen = torch.Generator().manual_seed(8)
    o, d = camera.gen_rays(cam, (32, 32),
                           torch.floor(torch.rand((n, 2), generator=gen)
                                       * 32),
                           torch.rand((n, 2), generator=gen))
    o, d = o.numpy().astype(np.float32), d.numpy().astype(np.float32)
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
    assert np.asarray(fl_j).sum() > 0.5 * n
    np.testing.assert_array_equal(fl.numpy(), np.asarray(fl_j))
    for g, w in ((A, A_j), (B, B_j)):
        bad = outlier_rows(g.numpy().T, np.asarray(w).T, 1e-3, 1e-4)
        assert len(bad) <= 0.005 * n, bad


def test_walk_trace_and_refilled_steps_equal_dense_trace(box_lib,
                                                         _exact_sqrt):
    """The textured whole trace of ``tex_blocks`` (render, bounce 8) from
    the same primary hits: ``trace_ray`` walking the boxes (the kBox
    instances) and ``ray_step`` walking them one step at a time (the
    refilling kBox render, which computes the exit side only where the
    draw can choose it) give ``trace_ray``'s A, B and first_live over the
    dense rows (the parent's kTex instance) bit for bit."""
    scene, tables = _blocks("tex_blocks")
    assert scene.any_refract
    o, d = _box_rays(scene, tables, "camera")
    n, K = o.shape[0], 9
    oT, dT = o.T.contiguous(), d.T.contiguous()
    u8s = torch.rand((K, step.n_uni(True), n),
                     generator=torch.Generator().manual_seed(12))
    hit0 = [t.contiguous() for t in hit3.closest_hit_plain(
        tables.tab, tables.layout, o, d, hit3.MODE_EXIT, box=tables.box)]
    tab, lay = tables.tab.detach().contiguous(), _lay(tables)
    lights = tables.lights.detach().contiguous()
    slots = sum(1 << k for k in range(6) if scene.map_slots[k])
    outs = []
    for mode in (0, 1, 2):
        out = (torch.empty(3, n), torch.empty(3, n), torch.empty(1, n))
        box_lib.host_box_trace(
            mode, _p(tab), _p(lay), _p(tables.box.tab), tables.box.n,
            _p(lights), scene.n_lights, ctypes.c_float(0.85),
            _p(tables.maps), _p(tables.atlas), _p(tables.tmeta), slots,
            _p(oT), _p(dT), *map(_p, hit0), _p(u8s), K, n, *map(_p, out))
        outs.append(out)
    assert int(outs[0][2].sum()) > n // 2
    for walk in outs[1:]:
        for x, y in zip(outs[0], walk):
            assert torch.equal(x, y)


def test_launch_counts_its_variant():
    """``CudaKernel.launch`` counts every launch and, under its name, a
    named variant's (the box walk's instances, which chip_smoke.py's
    textured main path reads); a failed launch counts nothing."""
    k = CudaKernel("probe", "hit3.cu", (), "probe", [])
    rcs = iter([0, 0, 7])
    k._fn = lambda *_a: next(rcs)
    k.launch(1)
    k.launch(2, variant="box_walk")
    with pytest.raises(RuntimeError):
        k.launch(3, variant="box_walk")
    assert k.launches == 2 and k.variants == {"box_walk": 1}
