"""The CUDA sources' per-ray arithmetic, built for the CPU.

``csrc/trace_fwd.cu`` and ``csrc/trace_bwd.cu`` keep a ray's whole trace
(``mrt::trace_ray``) and its whole backward (``mrt::trace_ray_bwd``) in
device functions outside their ``__CUDACC__`` sections. Here the host C++
compiler builds those functions, with ``__device__`` defined away and
without FMA contraction (as ``nvcc -fmad=false``), runs them one ray after
another with a plain accumulator in place of the kernel's shared-memory
one, and holds them against the plain versions the card tests use:
``trace_plain(want_resid=True)`` and autograd through ``trace_plain``;
the closest-hit sweep of ``csrc/hit3.cuh`` with its triangle segment and
per-ray block cull is held against ``hit3.closest_hit_plain``: rows equal
and t bit for bit (both round every product and sum alike).
What this cannot see — the launch, the shared-memory staging, the atomics
and the partial sums — the card tests (``test_torch_cuda.py``) cover.

Tolerances, as the card tests state them: A and B within rtol 1e-4 /
atol 1e-5 on all but 0.3% of rays (sin, cos and square roots are libm's
here and PyTorch's there, and a one-ulp difference can flip a sampling
branch); on the rest the residual rows o, d, A, te, tx within rtol 1e-4 /
atol 1e-4 and the winner row, refract choice and occlusion bits equal; the
cotangents within rtol 2e-3 and an absolute floor of 1e-5 of the largest
magnitude of each compared array, for output cotangents that are zero on
the off-path rays. The mesh scenes (``torch_mesh_helpers``) shoot their
rays from inside the room.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from micro_raytracer_tpu_torch.models import schema
from micro_raytracer_tpu_torch.models.compiler import compile_scene
from micro_raytracer_tpu_torch.ops import hit3, step
from micro_raytracer_tpu_torch.utils.kernels import CSRC
from torch_mesh_helpers import (CLUSTERED_LIT, aimed_rays, mesh_scene,
                                two_tori)
from torch_mesh_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import MIXED, MIXED_OPAQUE, rays

SCENES = {"mixed": MIXED, "mixed_opaque": MIXED_OPAQUE,
          "mesh_glass": mesh_scene("mesh_glass"),
          "mesh_opaque": mesh_scene("mesh_opaque"),
          "clustered": CLUSTERED_LIT, "two_tori": two_tori()}
R, K, DECAY = 1024, 9, 0.85

# what the device code needs of CUDA, on the host
_SHIM = r"""
#pragma once
#include <math.h>
#include <stddef.h>
#include <string.h>
#define __device__
#define __forceinline__ inline
#define __ldg(p) (*(p))
static inline float __int_as_float(int i) {
  float f;
  memcpy(&f, &i, sizeof f);
  return f;
}
struct HostDim3 { int x, y, z; };
static const HostDim3 threadIdx{0, 0, 0}, blockDim{1, 1, 1};
"""

_HARNESS = r"""
#include "trace_fwd.cu"
#include "trace_bwd.cu"

namespace {
struct HostAcc {
  float* d_tab;
  float* d_lights;
  float* d_tri;
  int L;
  void row(int row, const float* d_at) {
    for (int c = 0; c < mrt::kRowCols; ++c)
      d_tab[row * mrt::kRowCols + c] += d_at[c];
  }
  void tri(int t, const float* d_gh) {
    for (int k = 0; k < 4; ++k) d_tri[4 * t + k] += d_gh[k];
  }
  void light(const float* d_lt) {
    for (int c = 0; c < L * mrt::kLightCols; ++c)
      if (c % mrt::kLightCols != 6) d_lights[c] += d_lt[c];
  }
};
}  // namespace

static mrt::Layout layout(const int* l) {
  return mrt::Layout{l[0], l[1], l[2], l[3], l[4], l[5], l[6], l[7], l[8]};
}

template <bool kTri>
static void fwd_rays(const float* tab, const mrt::Tris& T,
    const mrt::Layout& lay, const float* lights, int L, float dk,
    const float* o0, const float* d0, const float* te0, const int* row0,
    const float* tx0, const int* xrow0, const float* u8s, int K, int R,
    int refract, float* A, float* B, float* fl, float* resid, int* n_live) {
  for (int i = 0; i < R; ++i) {
    const mrt::Hit h{te0[i], row0[i], tx0[i], xrow0[i]};
    if (refract)
      mrt::trace_ray<true, true, kTri>(tab, tab, T, lay, lights, L, dk, i, R,
                                       K, o0, d0, h, u8s, A, B, fl, resid,
                                       n_live);
    else
      mrt::trace_ray<false, true, kTri>(tab, tab, T, lay, lights, L, dk, i, R,
                                        K, o0, d0, h, u8s, A, B, fl, resid,
                                        n_live);
  }
}

extern "C" void host_fwd_train(const float* tab, const int* lay9,
    const float* tri, const float* bb, const float* lights, int L, float dk,
    const float* o0, const float* d0, const float* te0, const int* row0,
    const float* tx0, const int* xrow0, const float* u8s, int K, int R,
    int refract, float* A, float* B, float* fl, float* resid, int* n_live) {
  const mrt::Layout lay = layout(lay9);
  const mrt::Tris T{tri, bb};
  if (lay.tri_n > 0)
    fwd_rays<true>(tab, T, lay, lights, L, dk, o0, d0, te0, row0, tx0, xrow0,
                   u8s, K, R, refract, A, B, fl, resid, n_live);
  else
    fwd_rays<false>(tab, T, lay, lights, L, dk, o0, d0, te0, row0, tx0,
                    xrow0, u8s, K, R, refract, A, B, fl, resid, n_live);
}

// the hit kernel's per-ray body: mode 0 entry, 1 entry and exit, 2 any
extern "C" void host_closest_hit(const float* tab, int stride,
    const int* lay9, const float* tri, const float* bb, const float* o,
    const float* d, int R, int mode, float* te, int* row, float* tx,
    int* xrow) {
  const mrt::Layout lay = layout(lay9);
  const mrt::Tris T{tri, bb};
  for (int i = 0; i < R; ++i) {
    const float* a = o + 3 * i;
    const float* b = d + 3 * i;
    mrt::Hit h;
    if (mode == 2) {
      const bool hit = mrt::any_hit<true>(tab, stride, lay, a[0], a[1], a[2],
                                          b[0], b[1], b[2], T);
      h = mrt::Hit{hit ? -mrt::kBig : mrt::kBig, 0, hit ? -mrt::kBig
                                                        : mrt::kBig, 0};
    } else if (mode == 1) {
      h = mrt::closest_hit<true, true>(tab, stride, lay, a[0], a[1], a[2],
                                       b[0], b[1], b[2], T);
    } else {
      h = mrt::closest_hit<false, true>(tab, stride, lay, a[0], a[1], a[2],
                                        b[0], b[1], b[2], T);
    }
    te[i] = h.te;
    row[i] = h.row;
    tx[i] = h.tx;
    xrow[i] = h.xrow;
  }
}

template <bool kTri>
static void bwd_rays(const float* tab, const mrt::Tris& T,
    const mrt::Layout& lay, const float* lights, int L, float dk,
    const float* resid, const int* n_live, const float* u8s, int R,
    int refract, const float* ctA, const float* ctB, float* d_o, float* d_d,
    HostAcc& acc) {
  for (int i = 0; i < R; ++i) {
    const mrt::V3 a = mrt::v3(ctA[i], ctA[R + i], ctA[2 * R + i]);
    const mrt::V3 b = mrt::v3(ctB[i], ctB[R + i], ctB[2 * R + i]);
    mrt::V3 co, cd;
    if (refract)
      mrt::trace_ray_bwd<true, kTri>(tab, tab, T, lay, lights, L, dk, i, R,
                                     resid, n_live[i], u8s, a, b, co, cd,
                                     acc);
    else
      mrt::trace_ray_bwd<false, kTri>(tab, tab, T, lay, lights, L, dk, i, R,
                                      resid, n_live[i], u8s, a, b, co, cd,
                                      acc);
    d_o[i] = co.x; d_o[R + i] = co.y; d_o[2 * R + i] = co.z;
    d_d[i] = cd.x; d_d[R + i] = cd.y; d_d[2 * R + i] = cd.z;
  }
}

extern "C" void host_bwd(const float* tab, const int* lay9,
    const float* tri, const float* lights, int L, float dk,
    const float* resid, const int* n_live, const float* u8s, int R,
    int refract, const float* ctA, const float* ctB, float* d_o, float* d_d,
    float* d_tab, float* d_lights, float* d_tri) {
  const mrt::Layout lay = layout(lay9);
  const mrt::Tris T{tri, nullptr};
  HostAcc acc{d_tab, d_lights, d_tri, L};
  if (lay.tri_n > 0)
    bwd_rays<true>(tab, T, lay, lights, L, dk, resid, n_live, u8s, R,
                   refract, ctA, ctB, d_o, d_d, acc);
  else
    bwd_rays<false>(tab, T, lay, lights, L, dk, resid, n_live, u8s, R,
                    refract, ctA, ctB, d_o, d_d, acc);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    d = tmp_path_factory.mktemp("host_kernels")
    (d / "shim.h").write_text(_SHIM)
    (d / "harness.cpp").write_text(_HARNESS)
    out = d / "libhost_kernels.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-include", str(d / "shim.h"), "-I", CSRC,
                    "-o", str(out), str(d / "harness.cpp")], check=True,
                   capture_output=True, timeout=300)
    return ctypes.CDLL(os.fspath(out))


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


def _opt(t):
    """A pointer to a contiguous tensor, or NULL for None."""
    return None if t is None else _p(t)


def _rays(name, n, seed):
    """(3, R) lane-major rays: random ones for the mixed scenes, from
    inside the room for the mesh scenes, aimed at the clusters for the
    clustered one (whose shadow rays reach the triangles)."""
    o, d = rays(n, seed=seed)
    if name.startswith("mesh") or name == "two_tori":
        o = (o * 0.22).astype(np.float32)
    elif name == "clustered":
        o, d = aimed_rays(compile_scene(schema.SceneConfig.from_json(
            SCENES[name]), "cpu"), n, seed)
    return tuple(torch.from_numpy(a.T.copy()) for a in (o, d))


def _lay(tables):
    return torch.tensor(hit3.layout_ints(tables.layout)
                        + hit3.tri_ints(tables.layout, tables.tbb),
                        dtype=torch.int32)


def _case(name, lib):
    """The host build's training forward and the plain one, on the same
    random rays and uniforms."""
    scene = compile_scene(schema.SceneConfig.from_json(SCENES[name]), "cpu")
    tables = step.pack_step(scene)
    tab = tables.tab.detach().contiguous()
    lights = tables.lights.detach().contiguous()
    tri = tables.tri.detach().contiguous()
    oT, dT = _rays(name, R, 3)
    u8s = torch.rand((K, step.n_uni(scene.any_refract), R),
                     generator=torch.Generator().manual_seed(4))
    L = scene.n_lights
    lay = _lay(tables)
    with torch.no_grad():
        hit0 = [t.contiguous() for t in hit3.closest_hit_plain(
            tab, tables.layout, oT.T, dT.T, step.primary_mode(scene), tri,
            tables.tbb)]
    A, B = torch.empty(3, R), torch.empty(3, R)
    fl = torch.empty(1, R)
    res = torch.zeros(K, step.res_rows(L, tables.layout[3]), R)
    n_live = torch.empty(R, dtype=torch.int32)
    lib.host_fwd_train(
        _p(tab), _p(lay), _opt(tri), _opt(tables.tbb), _p(lights), L,
        ctypes.c_float(DECAY), _p(oT), _p(dT), *map(_p, hit0), _p(u8s), K, R,
        int(scene.any_refract), _p(A), _p(B), _p(fl), _p(res), _p(n_live))
    with torch.no_grad():
        plain = step.trace_plain(scene, tables, DECAY, oT, dT, u8s,
                                 want_resid=True)
    A_r, B_r, fl_r, res_r, n_live_r = plain
    bad = n_live != n_live_r
    for g, w in ((A, A_r), (B, B_r)):
        bad |= (~torch.isclose(g, w, rtol=1e-4, atol=1e-5)).any(0)
    assert torch.equal(fl, fl_r)
    assert int(bad.sum()) <= 0.003 * R
    return (scene, tables, lay, oT, dT, u8s, bad, (res, n_live),
            (res_r, n_live_r))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_host_trace_fwd_train_matches_plain(name, host_lib):
    scene, tables, _l, _o, _d, _u, bad, (res, n_live), (res_r, _n) = _case(
        name, host_lib)
    live = (torch.arange(K)[:, None] < n_live[None]) & ~bad[None]
    # the open scene's paths leave it sooner than a room's
    assert int(live.sum()) > (R // 2 if name == "clustered" else R)
    floats = [step.RES_O + c for c in range(9)] + [step.RES_TE]
    exact = [step.RES_ROW] + [step.RES_LOK + li
                              for li in range(scene.n_lights)]
    if scene.any_refract:
        floats.append(step.RES_TX)
        exact.append(step.RES_CHOOSE)
    if tables.layout[3]:
        exact.append(step.res_xrow(scene.n_lights))
    for r in floats:
        torch.testing.assert_close(res[:, r][live], res_r[:, r][live],
                                   rtol=1e-4, atol=1e-4, msg=f"row {r}")
    for r in exact:
        assert torch.equal(res[:, r][live], res_r[:, r][live]), r


@pytest.mark.parametrize("name", sorted(SCENES))
def test_host_trace_bwd_matches_autograd_of_plain(name, host_lib):
    """The backward walk on the plain residuals, so that both sides
    linearize at the same point."""
    scene, tables, lay, oT, dT, u8s, bad, _mine, (res, n_live) = _case(
        name, host_lib)
    rng = np.random.default_rng(5)
    ctA, ctB = (torch.from_numpy(rng.normal(size=(3, R)).astype(np.float32))
                for _ in range(2))
    ctA[:, bad] = 0.0
    ctB[:, bad] = 0.0
    tab = tables.tab.detach().contiguous()
    lights = tables.lights.detach().contiguous()
    tri = tables.tri.detach().contiguous()
    got = (torch.zeros_like(tab), torch.zeros_like(lights),
           torch.zeros(3, R), torch.zeros(3, R), torch.zeros(tri.shape[0], 4))
    host_lib.host_bwd(
        _p(tab), _p(lay), _opt(tri), _p(lights), scene.n_lights,
        ctypes.c_float(DECAY), _p(res.contiguous()), _p(n_live), _p(u8s), R,
        int(scene.any_refract), _p(ctA), _p(ctB), _p(got[2]), _p(got[3]),
        _p(got[0]), _p(got[1]), _p(got[4]))
    want = list(step.trace_bwd_plain(scene, tables, DECAY, oT, dT, u8s, ctA,
                                     ctB))
    want[4] = torch.cat([want[4][:, 6:9], want[4][:, 11:12]], 1)
    assert float(want[0].abs().max()) > 0
    if tri.shape[0]:
        assert float(want[4].abs().max()) > 0
    for gname, g, w in zip(("d_tab", "d_lights", "d_oT", "d_dT", "d_tri"),
                           got, want):
        assert bool(torch.isfinite(g).all()), gname
        atol = 1e-5 * max(float(w.abs().max()) if w.numel() else 0.0, 1e-30)
        torch.testing.assert_close(g, w, rtol=2e-3, atol=atol, msg=gname)


@pytest.mark.parametrize("name", ["mesh_glass", "mesh_opaque", "clustered",
                                  "two_tori"])
def test_host_closest_hit_matches_plain(name, host_lib):
    """The sweep with the triangle segment, in every mode, against the
    plain version: rows and t equal (the cull of entry-only and any-hit
    sweeps included)."""
    scene = compile_scene(schema.SceneConfig.from_json(SCENES[name]), "cpu")
    tables = step.pack_step(scene)
    assert tables.tbb is not None
    tab = tables.tab.detach().contiguous()
    tri = tables.tri.detach().contiguous()
    oT, dT = _rays(name, 4096, 6)
    o, d = oT.T.contiguous(), dT.T.contiguous()
    lay = _lay(tables)
    for mode in (hit3.MODE_ENTRY, hit3.MODE_EXIT, hit3.MODE_ANY):
        got = (torch.empty(4096), torch.empty(4096, dtype=torch.int32),
               torch.empty(4096), torch.empty(4096, dtype=torch.int32))
        host_lib.host_closest_hit(_p(tab), step.ROW_COLS, _p(lay), _p(tri),
                                  _opt(tables.tbb), _p(o), _p(d), 4096, mode,
                                  *map(_p, got))
        with torch.no_grad():
            want = hit3.closest_hit_plain(tab, tables.layout, o, d, mode, tri,
                                          tables.tbb)
        assert int((want[1] >= tables.layout[1]).sum()) > 100 or \
            mode == hit3.MODE_ANY
        for g, w in zip(got, want):
            assert torch.equal(g, w), mode
