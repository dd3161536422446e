"""The per-step forward's walks (``csrc/step_fwd.cu``), built for the CPU.

The host C++ compiler builds ``step_fwd.cu``'s device functions (with
``test_torch_kernel_host.py``'s shim: ``__device__`` defined away, no FMA
contraction, as ``nvcc -fmad=false``) and runs them one ray after another:

* the closest hit of a culled sphere segment, walked nearest first through
  its 64-row blocks and their 8-row sub-blocks (``step_closest_hit``),
  equals the lowest-first walk of ``hit3.cuh`` (``closest_hit``, which the
  whole-trace kernels run) and ``hit3.closest_hit_plain``: rows equal and t
  bit for bit, on the 13^3 grid (35 blocks), on ``inst_grid3k``'s
  generator (53 blocks) and on a grid whose duplicated spheres tie across
  blocks; the occlusion walk (``step_any_hit``) equals ``hit3.cuh``'s
  ``any_hit`` and ``hit3.any_hit``;
* the kTriIn shadow sweep (``any_hit_in``: the triangle segment through
  the superblocks, ``tri_walk.cuh tri_any_walk``) equals the one-level
  walk of ``hit3.cuh`` (``any_hit``, ``tri_any_seg``) and ``hit3.any_hit``
  on a mesh of 257 cull blocks, with the superblocks staged or read from
  global memory.

Rays: camera rays, rays from inside random blocks' AABBs, rays after two
plain bounce steps, and rays from 100-300 units away that graze spheres
(whose hits the sphere test's rounding can put outside the boxes' slack:
the sub-blocks' boxes grow with the distance); the walks must tie the
lowest-first walk on every one. A closest hit outside its block's AABB
(a phantom, which would let the walk orders part) is counted, and must
not occur on the rays that start inside the grid. The plain sweeps run with a
correctly rounded square root (:func:`_exact_sqrt`): PyTorch's CPU
``sqrt`` of float32 is one ulp off on some inputs, where the kernels'
``sqrtf`` and PyTorch on the card round correctly.
"""

import ctypes
import functools
import os
import shutil
import subprocess

import pytest
import torch

from micro_raytracer_tpu_torch.models import camera, schema
from micro_raytracer_tpu_torch.models.compiler import (compile_camera,
                                                       compile_scene)
from micro_raytracer_tpu_torch.ops import hit3, step, tri
from micro_raytracer_tpu_torch.utils.kernels import CSRC
from chip_smoke import inst_scene
from test_torch_kernel_host import _SHIM
from torch_inst_helpers import CAMERA as INST_CAMERA
from torch_mesh_helpers import aimed_rays, big_mesh
from torch_mesh_helpers import one_torch_thread  # noqa: F401

R = 1024

_HARNESS = r"""
#include "step_fwd.cu"

static mrt::Layout layout(const int* l) {
  return mrt::Layout{l[0], l[1], l[2], l[3], l[4],
                     l[5], l[6], l[7], l[8], l[9]};
}

// the closest hit (entry only) of each ray over a scene without
// triangles: mode 0, hit3.cuh closest_hit (the sphere blocks lowest
// first); 1, step_fwd.cu step_closest_hit (nearest first, sub-blocks)
extern "C" void host_entry(int mode, const float* tab, const int* l,
    const float* sbb, const float* srows, const float* ssb, const float* o,
    const float* d, int R, float* te, int* row) {
  const mrt::Layout lay = layout(l);
  const mrt::Tris T{nullptr, sbb};
  float seg[mrt::kBbCols];  // the blocks' AABB (shared memory there)
  mrt::chunk_bounds(sbb, lay.n_sb, seg, 0, 1);
  const mrt::SphPack P{srows, ssb, seg};
  float tb[64];
  for (int i = 0; i < R; ++i) {
    const float* a = o + 3 * i;
    const float* b = d + 3 * i;
    const mrt::Hit h =
        mode == 0
            ? mrt::closest_hit<false, false, true, unsigned long long>(
                  tab, mrt::kRowCols, lay, a[0], a[1], a[2], b[0], b[1],
                  b[2], T)
            : mrt::step_closest_hit<false, false, true, true>(
                  tab, lay, a[0], a[1], a[2], b[0], b[1], b[2], T, P, tb, 1);
    te[i] = h.te;
    row[i] = h.row;
  }
}

// occlusion of each ray: mode 0, hit3.cuh any_hit (the sphere blocks and
// the triangle blocks one level); 1, step_fwd.cu step_any_hit (sphere
// sub-blocks); 2, any_hit_in (the kTriIn shadow sweep: the triangle
// segment through the n_sb superblocks sb, the first n_staged read from
// sb_staged)
extern "C" void host_any(int mode, const float* tab, const int* l,
    const float* tri, const float* bb, const float* srows, const float* ssb,
    const float* sb, const float* sb_staged, int n_sb, int n_staged,
    const float* o, const float* d, int R, int* out) {
  const mrt::Layout lay = layout(l);
  const mrt::Tris T{tri, bb};
  const mrt::SphPack P{srows, ssb};
  float chunks[64 * mrt::kBbCols];
  mrt::chunk_bounds(sb_staged, n_staged, chunks, 0, 1);
  const mrt::Supers S{sb_staged, sb, chunks, n_sb, n_staged};
  const bool tri_ = lay.tri_n > 0;
  for (int i = 0; i < R; ++i) {
    const float* a = o + 3 * i;
    const float* b = d + 3 * i;
    bool hit;
    if (mode == 2)
      hit = mrt::any_hit_in(tab, lay, T, S, a[0], a[1], a[2], b[0], b[1],
                            b[2]);
    else if (mode == 1)
      hit = mrt::step_any_hit<false, true, true>(tab, lay, a[0], a[1], a[2],
                                                 b[0], b[1], b[2], T, P);
    else if (tri_)
      hit = mrt::any_hit<true, false, unsigned long long>(
          tab, mrt::kRowCols, lay, a[0], a[1], a[2], b[0], b[1], b[2], T);
    else
      hit = mrt::any_hit<false, true, unsigned long long>(
          tab, mrt::kRowCols, lay, a[0], a[1], a[2], b[0], b[1], b[2], T);
    out[i] = hit;
  }
}
"""


@pytest.fixture(scope="module")
def walk_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    d = tmp_path_factory.mktemp("host_walk")
    (d / "shim.h").write_text(_SHIM)
    (d / "harness.cpp").write_text(_HARNESS)
    out = d / "libhost_walk.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-include", str(d / "shim.h"), "-I", CSRC,
                    "-o", str(out), str(d / "harness.cpp")], check=True,
                   capture_output=True, timeout=300)
    return ctypes.CDLL(os.fspath(out))


def _p(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


@pytest.fixture
def _exact_sqrt(monkeypatch):
    """torch.sqrt of float32 correctly rounded (through float64, whose
    double rounding is exact for a square root) while a test runs."""
    sqrt = torch.sqrt

    def exact(x, *a, **k):
        if x.dtype == torch.float32:
            return sqrt(x.double(), *a, **k).float()
        return sqrt(x, *a, **k)

    monkeypatch.setattr(torch, "sqrt", exact)


def _lay(tables):
    return torch.tensor(hit3.layout_ints(tables.layout)
                        + hit3.cull_ints(tables.layout, tables.tbb,
                                         tables.sbb), dtype=torch.int32)


def _tied(scene):
    """The scene with rows copied onto rows of other blocks: each pair
    (k, j) makes sphere j the same sphere as k (position, frame, radius,
    material), so a ray that hits one hits both at the same t, and the
    lowest row must win whichever block a walk visits first."""
    n = scene.kind_counts[schema.KIND_SPHERE]
    pairs = [(5, 700), (1300, 70), (640, 1990), (2100, 30), (333, 1555)]
    for f in ("prim_r", "inst_pos", "inst_dir", "mat_id", "prim_valid"):
        v = getattr(scene, f).clone()
        for k, j in pairs:
            assert max(k, j) < n
            v[j] = v[k]
        setattr(scene, f, v)
    return scene, pairs


@functools.lru_cache(maxsize=None)
def _mesh_case():
    """The 16,448-triangle mesh alone (257 cull blocks, 17 superblocks):
    no dense row occludes a ray before its triangle walk."""
    js = big_mesh()
    js["renderer"] = [r for r in js["renderer"] if r["type"] == "mesh"]
    scene = compile_scene(schema.SceneConfig.from_json(js), "cpu")
    return scene, step.pack_step(scene)


def _sphere_scene(name):
    if name == "inst_grid3k":
        js = inst_scene("inst_grid3k")
    else:
        js = inst_scene("inst_grid", dims=(13, 13, 13))
    scene = compile_scene(schema.SceneConfig.from_json(js), "cpu")
    pairs = []
    if name == "ties":
        scene, pairs = _tied(scene)
    tables = step.pack_step(scene)
    assert tables.sbb is not None and tables.srows is not None
    return scene, tables, pairs


def _sphere_rays(scene, tables, kind):
    """float32 (o, d) (R, 3): ``camera`` rays of the grid's camera,
    ``inside`` rays from random points of random blocks' AABBs in random
    directions, ``bounced`` the camera rays after two plain bounce
    steps (the rays still live), ``far`` rays from 100 to 300 units away
    that graze random spheres (tangent within 1e-4 of the radius), where
    the sphere test's rounding puts hits outside the boxes' slack."""
    gen = torch.Generator().manual_seed(21)
    if kind == "far":
        fr, ipos, pa, pr, valid, _gid = hit3.split_sweep(tables.tab)
        k = torch.randint(0, tables.layout[0][0][3], (R,), generator=gen)
        d = torch.nn.functional.normalize(torch.randn((R, 3), generator=gen),
                                          dim=1)
        u = torch.randn((R, 3), generator=gen)
        u = torch.nn.functional.normalize(
            u - (u * d).sum(1, keepdim=True) * d, dim=1)
        r = pr[k, 0] * (1.0 + (torch.rand(R, generator=gen) - 0.5) * 2e-4)
        p = ipos[k] + u * r[:, None]
        s = 100.0 + 200.0 * torch.rand(R, generator=gen)
        return (p - d * s[:, None]).contiguous(), d.contiguous()
    if kind == "inside":
        bb = tables.sbb[torch.randint(0, tables.sbb.shape[0], (R,),
                                      generator=gen)]
        o = bb[:, :3] + torch.rand((R, 3), generator=gen) * (bb[:, 3:6]
                                                             - bb[:, :3])
        d = torch.nn.functional.normalize(torch.randn((R, 3), generator=gen),
                                          dim=1)
        return o.contiguous(), d.contiguous()
    cam = compile_camera(schema.CameraConfig.from_json(INST_CAMERA), "cpu")
    o, d = camera.gen_rays(cam, (64, 64),
                           torch.floor(torch.rand((R, 2), generator=gen)
                                       * 64),
                           torch.rand((R, 2), generator=gen))
    if kind == "bounced":
        c = step.primary_carry(o.T.contiguous(), d.T.contiguous())
        u8s = torch.rand((2, step.n_uni(scene.any_refract), R),
                         generator=gen)
        with torch.no_grad():
            for k in range(2):
                c = step.step_plain(scene, tables, 0.85, c, u8s[k])[0]
        live = c[step.C_LIVE] > 0.5
        assert int(live.sum()) > R // 4
        o, d = c[0:3].T[live], c[3:6].T[live]
    return o.contiguous(), d.contiguous()


def _phantoms(tables, o, d, te, row):
    """Rays whose winning sphere row hit before its block's or sub-block's
    AABB begins (a hit outside its box): where the walk orders could part."""
    _kind, s, _c, n = tables.layout[0][0]
    k = row.long() - s
    sph = (te < hit3.BIG * 0.5) & (k >= 0) & (k < n)
    k = k.clamp(0, n - 1)
    invd = hit3._inv_dir(d)
    out = torch.zeros_like(sph)
    for bbs, rows in ((tables.sbb, hit3.CB), (tables.ssb, hit3.SPH_SUB)):
        tmin = torch.stack([hit3._slab(bbs[b], o, invd)[0]
                            for b in range(bbs.shape[0])], 1)
        out |= sph & (te < tmin.gather(1, (k // rows)[:, None])[:, 0])
    return out


@pytest.mark.parametrize("kind", ["camera", "inside", "bounced", "far"])
@pytest.mark.parametrize("name", ["grid13", "inst_grid3k", "ties"])
def test_nearest_walk_equals_lowest_first(name, kind, walk_lib,
                                          _exact_sqrt):
    """The nearest-first walk through blocks and sub-blocks against the
    lowest-first walk and the plain culled sweep: t bit for bit, rows
    equal; on ``ties`` the duplicated spheres' rays take the lower row.
    The occlusion walk with sub-blocks against hit3.cuh's and the plain
    any-hit on the same rays."""
    scene, tables, pairs = _sphere_scene(name)
    o, d = _sphere_rays(scene, tables, kind)
    n = o.shape[0]
    lay = _lay(tables)
    tab = tables.tab.detach().contiguous()
    got = {}
    for mode in (0, 1):
        te = torch.empty(n)
        row = torch.empty(n, dtype=torch.int32)
        walk_lib.host_entry(mode, _p(tab), _p(lay), _p(tables.sbb),
                            _p(tables.srows), _p(tables.ssb), _p(o), _p(d),
                            n, _p(te), _p(row))
        got[mode] = (te, row)
    want = hit3.closest_hit_plain(tab, tables.layout, o, d, hit3.MODE_ENTRY,
                                  sbb=tables.sbb)
    hit = want[0] < hit3.BIG * 0.5
    assert int(hit.sum()) > n // 4
    for mode in (0, 1):
        assert torch.equal(got[mode][0], want[0]), mode
        assert torch.equal(got[mode][1], want[1]), mode
    if kind != "far":
        assert not bool(_phantoms(tables, o, d, want[0], want[1]).any())
    if name == "ties":
        lows = torch.tensor([min(k, j) for k, j in pairs])
        highs = torch.tensor([max(k, j) for k, j in pairs])
        s = tables.layout[0][0][1]
        on_pair = torch.isin(want[1].long() - s, lows)
        assert not bool(torch.isin(want[1].long() - s, highs).any())
        if kind == "inside":
            assert int(on_pair.sum()) > 0
    occ = {}
    for mode in (0, 1):
        out = torch.empty(n, dtype=torch.int32)
        walk_lib.host_any(mode, _p(tab), _p(lay), None, _p(tables.sbb),
                          _p(tables.srows), _p(tables.ssb), None, None, 0, 0,
                          _p(o), _p(d), n, _p(out))
        occ[mode] = out.bool()
    plain = hit3.any_hit(tab, tables.layout, o, d, sbb=tables.sbb)
    assert torch.equal(occ[0], plain) and torch.equal(occ[1], plain)
    # far rays cross the grid: every one occluded
    assert 0 < int(plain.sum()) < n or kind == "far"


def test_far_phantoms_take_the_lowest_first_walk(walk_lib, _exact_sqrt):
    """Rays from 100 to 300 units that graze ``inst_grid3k``'s spheres
    (within 2e-4 of the radius): where the sphere test's rounding puts the
    winning hit before its block's box (a phantom), the order of the walk
    decides the winner, and a ray from outside the segment's box walks
    lowest first, as hit3.cuh does: the same t and row as it and as the
    plain culled sweep. (A nearest-first walk there takes another row on
    some of them.)"""
    scene, tables, _pairs = _sphere_scene("inst_grid3k")
    tab = tables.tab.detach().contiguous()
    lay = _lay(tables)
    fr, ipos, pa, pr, valid, _gid = hit3.split_sweep(tab)
    n = 1 << 18
    gen = torch.Generator().manual_seed(2)
    k = torch.randint(0, tables.layout[0][0][3], (n,), generator=gen)
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen),
                                      dim=1)
    u = torch.randn((n, 3), generator=gen)
    u = torch.nn.functional.normalize(u - (u * d).sum(1, keepdim=True) * d,
                                      dim=1)
    r = pr[k, 0] * (1.0 + (torch.rand(n, generator=gen) - 0.5) * 4e-4)
    o = ipos[k] + u * r[:, None] - d * (100.0 + 200.0 * torch.rand(
        n, generator=gen))[:, None]
    o, d = o.contiguous(), d.contiguous()
    te = torch.empty(n)
    row = torch.empty(n, dtype=torch.int32)
    walk_lib.host_entry(0, _p(tab), _p(lay), _p(tables.sbb),
                        _p(tables.srows), _p(tables.ssb), _p(o), _p(d), n,
                        _p(te), _p(row))
    # the rays whose winner hit lies before its block's box
    s0 = tables.layout[0][0][1]
    sph = (te < hit3.BIG * 0.5) & (row.long() >= s0) \
        & (row.long() < s0 + tables.layout[0][0][3])
    b = ((row.long() - s0).clamp(min=0) // hit3.CB)
    box = tables.sbb[b]
    invd = hit3._inv_dir(d)
    tmin = torch.minimum((box[:, :3] - o) * invd,
                         (box[:, 3:6] - o) * invd).amax(1)
    idx = (sph & (te < tmin)).nonzero()[:, 0]
    assert idx.numel() >= 10, idx.numel()
    o, d = o[idx].contiguous(), d[idx].contiguous()
    m = idx.numel()
    got = {}
    for mode in (0, 1):
        t_ = torch.empty(m)
        r_ = torch.empty(m, dtype=torch.int32)
        walk_lib.host_entry(mode, _p(tab), _p(lay), _p(tables.sbb),
                            _p(tables.srows), _p(tables.ssb), _p(o), _p(d),
                            m, _p(t_), _p(r_))
        got[mode] = (t_, r_)
    want = hit3.closest_hit_plain(tab, tables.layout, o, d, hit3.MODE_ENTRY,
                                  sbb=tables.sbb)
    for mode in (0, 1):
        assert torch.equal(got[mode][0], want[0]), mode
        assert torch.equal(got[mode][1], want[1]), mode


def _mesh_rays(scene, tables, kind):
    """Shadow-like rays of the 257-block mesh scene: ``aimed`` at random
    points of its blocks, ``inside`` from random points of random blocks'
    AABBs in random directions, ``axis`` aimed rays with direction
    components zero."""
    o, d = aimed_rays(scene, R, 13)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    gen = torch.Generator().manual_seed(23)
    if kind == "inside":
        bb = tables.tbb[torch.randint(0, tables.tbb.shape[0], (R,),
                                      generator=gen)]
        o = bb[:, :3] + torch.rand((R, 3), generator=gen) * (bb[:, 3:6]
                                                             - bb[:, :3])
        d = torch.nn.functional.normalize(torch.randn((R, 3), generator=gen),
                                          dim=1)
    elif kind == "axis":
        d = d.clone()
        k = torch.arange(R) % 3
        d[torch.arange(R), k] = 0.0
        d = torch.nn.functional.normalize(d, dim=1)
    return o.float().contiguous(), d.float().contiguous()


@pytest.mark.parametrize("kind", ["aimed", "inside", "axis"])
def test_two_level_any_hit_equals_one_level(kind, walk_lib, _exact_sqrt):
    """The kTriIn shadow sweep through the superblocks (the first 3 read
    from a staged copy, or all of them) against the one-level walk and
    the plain any-hit, on the 16,448-triangle mesh alone (257 cull blocks,
    17 superblocks): the same occlusion bit on every ray."""
    scene, tables = _mesh_case()
    assert tables.tbb.shape[0] == 257 and tables.tsb is not None
    o, d = _mesh_rays(scene, tables, kind)
    lay = _lay(tables)
    tab = tables.tab.detach().contiguous()
    t = tables.tri.detach().contiguous()
    sb = tri.superbounds(tables.tbb)
    plain = hit3.any_hit(tab, tables.layout, o, d, t, tables.tbb)
    assert R // 50 < int(plain.sum()) < R - R // 50
    for mode, staged in ((0, None), (2, None), (2, 3)):
        n_staged = sb.shape[0] if staged is None else staged
        copy = sb[:n_staged].clone()
        out = torch.empty(R, dtype=torch.int32)
        walk_lib.host_any(mode, _p(tab), _p(lay), _p(t), _p(tables.tbb),
                          None, None, _p(sb), _p(copy), sb.shape[0],
                          n_staged, _p(o), _p(d), R, _p(out))
        assert torch.equal(out.bool(), plain), (mode, staged)
