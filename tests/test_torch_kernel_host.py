"""The CUDA sources' per-ray arithmetic, built for the CPU.

``csrc/trace_fwd.cu`` and ``csrc/trace_bwd.cu`` keep a ray's whole trace
(``mrt::trace_ray``) and its whole backward (``mrt::trace_ray_bwd``) in
device functions outside their ``__CUDACC__`` sections. Here the host C++
compiler builds those functions, with ``__device__`` defined away and
without FMA contraction (as ``nvcc -fmad=false``), runs them one ray after
another with a plain accumulator in place of the kernel's shared-memory
one, and holds them against the plain versions the card tests use:
``trace_plain(want_resid=True)`` and autograd through ``trace_plain``.
What this cannot see — the launch, the shared-memory staging, the atomics
and the partial sums — the card tests (``test_torch_cuda.py``) cover.

Tolerances, as the card tests state them: A and B within rtol 1e-4 /
atol 1e-5 on all but 0.3% of rays (sin, cos and square roots are libm's
here and PyTorch's there, and a one-ulp difference can flip a sampling
branch); on the rest the residual rows o, d, A, te, tx within rtol 1e-4 /
atol 1e-4 and the winner row, refract choice and occlusion bits equal; the
cotangents within rtol 2e-3 and an absolute floor of 1e-5 of the largest
magnitude of each compared array, for output cotangents that are zero on
the off-path rays.
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
from torch_port_helpers import MIXED, MIXED_OPAQUE, rays

SCENES = {"mixed": MIXED, "mixed_opaque": MIXED_OPAQUE}
R, K, DECAY = 1024, 9, 0.85

# what the device code needs of CUDA, on the host
_SHIM = r"""
#pragma once
#include <math.h>
#include <stddef.h>
#include <string.h>
#define __device__
#define __forceinline__ inline
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
  int L;
  void row(int row, const float* d_at) {
    for (int c = 0; c < mrt::kRowCols; ++c)
      d_tab[row * mrt::kRowCols + c] += d_at[c];
  }
  void light(const float* d_lt) {
    for (int c = 0; c < L * mrt::kLightCols; ++c)
      if (c % mrt::kLightCols != 6) d_lights[c] += d_lt[c];
  }
};
}  // namespace

extern "C" void host_fwd_train(const float* tab, const int* lay6,
    const float* lights, int L, float dk, const float* o0, const float* d0,
    const float* te0, const int* row0, const float* tx0, const int* xrow0,
    const float* u8s, int K, int R, int refract, float* A, float* B,
    float* fl, float* resid, int* n_live) {
  const mrt::Layout lay{lay6[0], lay6[1], lay6[2], lay6[3], lay6[4], lay6[5]};
  for (int i = 0; i < R; ++i) {
    const mrt::Hit h{te0[i], row0[i], tx0[i], xrow0[i]};
    if (refract)
      mrt::trace_ray<true, true>(tab, lay, lights, L, dk, i, R, K, o0, d0, h,
                                 u8s, A, B, fl, resid, n_live);
    else
      mrt::trace_ray<false, true>(tab, lay, lights, L, dk, i, R, K, o0, d0, h,
                                  u8s, A, B, fl, resid, n_live);
  }
}

extern "C" void host_bwd(const float* tab, const int* lay6,
    const float* lights, int L, float dk, const float* resid,
    const int* n_live, const float* u8s, int R, int refract,
    const float* ctA, const float* ctB, float* d_o, float* d_d,
    float* d_tab, float* d_lights) {
  const mrt::Layout lay{lay6[0], lay6[1], lay6[2], lay6[3], lay6[4], lay6[5]};
  HostAcc acc{d_tab, d_lights, L};
  for (int i = 0; i < R; ++i) {
    const mrt::V3 a = mrt::v3(ctA[i], ctA[R + i], ctA[2 * R + i]);
    const mrt::V3 b = mrt::v3(ctB[i], ctB[R + i], ctB[2 * R + i]);
    mrt::V3 co, cd;
    if (refract)
      mrt::trace_ray_bwd<true>(tab, lay, lights, L, dk, i, R, resid,
                               n_live[i], u8s, a, b, co, cd, acc);
    else
      mrt::trace_ray_bwd<false>(tab, lay, lights, L, dk, i, R, resid,
                                n_live[i], u8s, a, b, co, cd, acc);
    d_o[i] = co.x; d_o[R + i] = co.y; d_o[2 * R + i] = co.z;
    d_d[i] = cd.x; d_d[R + i] = cd.y; d_d[2 * R + i] = cd.z;
  }
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


def _case(name, lib):
    """The host build's training forward and the plain one, on the same
    random rays and uniforms."""
    scene = compile_scene(schema.SceneConfig.from_json(SCENES[name]), "cpu")
    tables = step.pack_step(scene)
    tab = tables.tab.detach().contiguous()
    lights = tables.lights.detach().contiguous()
    oT, dT = (torch.from_numpy(a.T.copy()) for a in rays(R, seed=3))
    u8s = torch.rand((K, step.n_uni(scene.any_refract), R),
                     generator=torch.Generator().manual_seed(4))
    L = scene.n_lights
    lay6 = torch.tensor(hit3.layout_ints(tables.layout), dtype=torch.int32)
    hit0 = [t.contiguous() for t in hit3.closest_hit_plain(
        tab, tables.layout, oT.T, dT.T, step.primary_mode(scene))]
    A, B = torch.empty(3, R), torch.empty(3, R)
    fl = torch.empty(1, R)
    res = torch.zeros(K, step.res_rows(L), R)
    n_live = torch.empty(R, dtype=torch.int32)
    lib.host_fwd_train(
        _p(tab), _p(lay6), _p(lights), L, ctypes.c_float(DECAY), _p(oT),
        _p(dT), *map(_p, hit0), _p(u8s), K, R, int(scene.any_refract),
        _p(A), _p(B), _p(fl), _p(res), _p(n_live))
    with torch.no_grad():
        plain = step.trace_plain(scene, tables, DECAY, oT, dT, u8s,
                                 want_resid=True)
    A_r, B_r, fl_r, res_r, n_live_r = plain
    bad = n_live != n_live_r
    for g, w in ((A, A_r), (B, B_r)):
        bad |= (~torch.isclose(g, w, rtol=1e-4, atol=1e-5)).any(0)
    assert torch.equal(fl, fl_r)
    assert int(bad.sum()) <= 0.003 * R
    return (scene, tables, lay6, oT, dT, u8s, bad, (res, n_live),
            (res_r, n_live_r))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_host_trace_fwd_train_matches_plain(name, host_lib):
    scene, _t, _l, _o, _d, _u, bad, (res, n_live), (res_r, _n) = _case(
        name, host_lib)
    live = (torch.arange(K)[:, None] < n_live[None]) & ~bad[None]
    assert int(live.sum()) > R
    floats = [step.RES_O + c for c in range(9)] + [step.RES_TE]
    exact = [step.RES_ROW] + [step.RES_LOK + li
                              for li in range(scene.n_lights)]
    if scene.any_refract:
        floats.append(step.RES_TX)
        exact.append(step.RES_CHOOSE)
    for r in floats:
        torch.testing.assert_close(res[:, r][live], res_r[:, r][live],
                                   rtol=1e-4, atol=1e-4, msg=f"row {r}")
    for r in exact:
        assert torch.equal(res[:, r][live], res_r[:, r][live]), r


@pytest.mark.parametrize("name", sorted(SCENES))
def test_host_trace_bwd_matches_autograd_of_plain(name, host_lib):
    """The backward walk on the plain residuals, so that both sides
    linearize at the same point."""
    scene, tables, lay6, oT, dT, u8s, bad, _mine, (res, n_live) = _case(
        name, host_lib)
    rng = np.random.default_rng(5)
    ctA, ctB = (torch.from_numpy(rng.normal(size=(3, R)).astype(np.float32))
                for _ in range(2))
    ctA[:, bad] = 0.0
    ctB[:, bad] = 0.0
    tab = tables.tab.detach().contiguous()
    lights = tables.lights.detach().contiguous()
    got = (torch.zeros_like(tab), torch.zeros_like(lights),
           torch.zeros(3, R), torch.zeros(3, R))
    host_lib.host_bwd(
        _p(tab), _p(lay6), _p(lights), scene.n_lights,
        ctypes.c_float(DECAY), _p(res.contiguous()), _p(n_live), _p(u8s), R,
        int(scene.any_refract), _p(ctA), _p(ctB), _p(got[2]), _p(got[3]),
        _p(got[0]), _p(got[1]))
    want = step.trace_bwd_plain(scene, tables, DECAY, oT, dT, u8s, ctA, ctB)
    assert float(want[0].abs().max()) > 0
    for gname, g, w in zip(("d_tab", "d_lights", "d_oT", "d_dT"), got, want):
        assert bool(torch.isfinite(g).all()), gname
        atol = 1e-5 * max(float(w.abs().max()), 1e-30)
        torch.testing.assert_close(g, w, rtol=2e-3, atol=atol, msg=gname)
