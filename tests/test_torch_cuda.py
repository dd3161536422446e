"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device: it carries the ``cuda`` marker and
skips elsewhere. This file imports no JAX, so it runs on a machine without
it; there, skip the JAX test harness's conftest:

    python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

Tolerances: the closest-hit kernel is compiled without FMA contraction and
follows the plain version's operation order, so rows are equal and t is
within rtol 1e-5 / atol 1e-6. The trace is compared at rtol 1e-4 / atol
1e-5 on all but 0.3% of rays, and within 1e-3 absolute on the rest: the
plain version repeats the kernel's sweep and step operation for operation,
but its sin, cos and square roots are PyTorch's, and a one-ulp difference
can flip a sampling branch. These scenes' random rays graze rotated boxes
and planes more often than camera rays in a room; measured on the card,
no ray of 16,384 falls outside.

Training: the train instance's A, B and first_live equal the render
instance's bit for bit. Against ``trace_plain(want_resid=True)``, rays
outside the trace tolerance above, or whose count of live steps differs,
are left out (the same 0.3% cap); on the rest, every live step's residual
rows agree — o, d, A, te and tx within rtol 1e-4 / atol 1e-4, the winner
row, the refract choice and the occlusion bits equal. The backward kernel
is fed the plain residuals, so both sides linearize at the same point, and
is held against autograd through ``trace_plain`` for random output
cotangents that are zero on those rays: rtol 2e-3 with an absolute floor of
1e-5 of the largest magnitude of each compared array, as the CPU tests hold
the plain trace against the JAX package. Two backward runs give equal
per-ray cotangents, and table cotangents within rtol 1e-5 / 1e-6 of the
largest magnitude: a block adds into shared memory in no fixed order.

Mesh scenes (``torch_mesh_helpers``: the 960-triangle torus, glass or
diffuse, in the slice room; rays from inside the room): the closest-hit
kernel's rows and t equal the plain version's bit for bit, the per-ray
block cull included; the trace, residual and backward checks are those
above, and the backward's triangle cotangents (``G[2]``, ``h[2]``) are held
to the same rule. Triangle rows accumulate with global atomics, so two
backward runs on a mesh scene differ at float32 rounding (rtol 1e-5 / 1e-6
of the largest magnitude, as for the shared-memory rows). ``clustered``
is an open scene (three clusters of 70 triangles over a plane, a light
above): its shadow rays reach the triangle segment, which a closed room's
never do (their any-hit sweep meets a wall first).

Ill-conditioned rays (chip_smoke.py, phase 7): a step that starts inside a
thin box wall and runs nearly parallel to it takes its t as the difference
of two slab terms ~1e4 times larger, so float32 rounding decides its
gradient, and the kernel and the plain version disagree there. Only the
scenes in ILL_CONDITIONED (rays from inside the slice room, whose walls
are thin boxes) have such rays; every other scene's rays are all held to
the tolerance above. On those scenes a ray outside it must be shown
ill-conditioned: the plain version run in float64 on that ray moves its
d_oT or d_dT by more than the tolerance, and the kernel's lie within twice
that move of the plain float32 ones (each float32 program is that far from
the exact value); the other rays' d_oT and d_dT, and the table
cotangents summed over all rays, are held as above.
"""

import numpy as np
import pytest
import torch

from micro_raytracer_tpu_torch.frontends import cli
from micro_raytracer_tpu_torch.models import schema
from micro_raytracer_tpu_torch.models.compiler import compile_scene
from micro_raytracer_tpu_torch.ops import hit3, step
from torch_mesh_helpers import (CLUSTERED_LIT, aimed_rays, mesh_scene,
                                small_torus, two_tori)
from torch_port_helpers import (MIXED, MIXED_OPAQUE,  # noqa: F401
                                cuda_device, outlier_rows, rays)

SCENES = {"mixed": MIXED, "mixed_opaque": MIXED_OPAQUE,
          "mesh_glass": mesh_scene("mesh_glass"),
          "mesh_opaque": mesh_scene("mesh_opaque"),
          "clustered": CLUSTERED_LIT, "two_tori": two_tori()}
# scenes whose rays may be ill-conditioned (module docstring)
ILL_CONDITIONED = {"mesh_opaque"}


def _scene(name, device):
    return compile_scene(schema.SceneConfig.from_json(SCENES[name]), device)


def _rays(n, device, seed=1, name="mixed"):
    """Random rays; a mesh scene's start inside the room, the clustered
    scene's aim at random points of its triangle blocks' AABBs."""
    o, d = rays(n, seed)
    if name.startswith("mesh") or name == "two_tori":
        o = (o * 0.22).astype(np.float32)
    elif name == "clustered":
        o, d = aimed_rays(_scene(name, "cpu"), n, seed)
    return tuple(torch.from_numpy(a).to(device) for a in (o, d))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCENES))
def test_closest_hit_kernel_matches_plain(name, cuda_device):
    """Row-major rays on the sweep table, and lane-major views on the
    trace's row table (the primary-hit pass's inputs)."""
    scene = _scene(name, cuda_device)
    tables = step.pack_step(scene)
    tri = (tables.tri, tables.tbb)
    o, d = _rays(1 << 14, cuda_device, name=name)
    oT, dT = o.T.contiguous(), d.T.contiguous()
    for tab, o_, d_ in ((hit3.pack_scene(scene, tables.frames), o, d),
                        (tables.tab, oT.T, dT.T)):
        for mode in (hit3.MODE_EXIT, hit3.MODE_ENTRY, hit3.MODE_ANY):
            before = hit3.KERNEL.launches
            got = hit3.closest_hit(tab, tables.layout, o_, d_, mode, *tri)
            assert hit3.KERNEL.launches == before + 1
            ref = hit3.closest_hit_plain(tab, tables.layout, o, d, mode,
                                         *tri)
            for g, r in zip(got, ref):
                if g.dtype == torch.int32 or scene.kind_counts[3]:
                    assert torch.equal(g, r)
                else:
                    torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)
            if scene.kind_counts[3] and mode != hit3.MODE_ANY:
                assert int((got[1] >= tables.layout[1]).sum()) > 500


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCENES))
def test_trace_kernel_matches_plain(name, cuda_device):
    scene = _scene(name, cuda_device)
    tables = step.pack_step(scene)
    R = 1 << 14
    o, d = (t.T.contiguous() for t in _rays(R, cuda_device, seed=2,
                                            name=name))
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    u8s = torch.rand((9, step.n_uni(scene.any_refract), R), generator=gen,
                     device=cuda_device)
    before = (hit3.KERNEL.launches, step.KERNEL.launches)
    A, B, fl = step.trace_packed(scene, tables, 0.85, o, d, u8s)
    assert (hit3.KERNEL.launches, step.KERNEL.launches) == \
        (before[0] + 1, before[1] + 1)
    A_r, B_r, fl_r = step.trace_plain(scene, tables, 0.85, o, d, u8s)
    assert torch.equal(fl, fl_r) and bool(fl.any())
    bad = set()
    for g, r in ((A, A_r), (B, B_r)):
        bad |= set(outlier_rows(g.T.cpu().numpy(), r.T.cpu().numpy(), 1e-4,
                                1e-5).tolist())
    good = torch.ones(R, dtype=torch.bool)
    good[sorted(bad)] = False
    err_in = max(float((g - r).cpu()[:, good].abs().max())
                 for g, r in ((A, A_r), (B, B_r)))
    print(f"{name}: {len(bad)} of {R} rays outside tolerance; max abs err "
          f"{err_in:.3g} on the rest")
    assert len(bad) <= 0.003 * R and err_in <= 1e-3, (len(bad), err_in)


@pytest.mark.cuda
def test_cli_render_runs_the_kernels(cuda_device, tmp_path):
    """The CLI's main path launches the primary-hit and trace kernels and
    never the plain versions."""
    for k in (hit3.KERNEL, step.KERNEL):
        k.launches = k.plain_calls = 0
    out = tmp_path / "o.png"
    assert cli.main(["--obj", "sphere", "--light", "point:", "-0.5", "-1",
                     "0.5", "--res", "64", "48", "--sample", "2",
                     "-o", str(out)]) == 0
    assert step.KERNEL.launches > 0 and hit3.KERNEL.launches > 0
    assert step.KERNEL.plain_calls == 0 and hit3.KERNEL.plain_calls == 0
    from PIL import Image

    img = np.asarray(Image.open(out))
    assert img.shape == (48, 64, 3) and img.max() > 20


@pytest.mark.cuda
def test_cli_renders_a_mesh_scene_on_the_kernels(cuda_device, tmp_path):
    """A JSON scene with an inline mesh, and the same with its mesh in an
    OBJ file, render through the kernels alone, to the same image."""
    import json

    tris = small_torus()
    imgs = []
    for obj_file in (False, True):
        scene = mesh_scene("mesh_glass", tris)
        if obj_file:
            path = tmp_path / "torus.obj"
            lines = [f"v {x} {y} {z}" for x, y, z in tris.reshape(-1, 3)]
            lines += [f"f {3 * i + 1} {3 * i + 2} {3 * i + 3}"
                      for i in range(len(tris))]
            path.write_text("\n".join(lines) + "\n")
            scene["renderer"][-1]["mesh"] = str(path)
        cfg = tmp_path / f"s{int(obj_file)}.json"
        cfg.write_text(json.dumps({"scene": scene, "frame": {
            "res": [64, 64], "cam": {"pos": [0, -1.25, 0], "fov": 60}},
            "rt": {"bounce": 4, "sample": 2}}))
        for k in (hit3.KERNEL, step.KERNEL):
            k.launches = k.plain_calls = 0
        out = tmp_path / f"o{int(obj_file)}.png"
        assert cli.main([str(cfg), "-o", str(out)]) == 0
        assert hit3.KERNEL.launches == 2 and step.KERNEL.launches == 2
        assert step.KERNEL.plain_calls == 0 and hit3.KERNEL.plain_calls == 0
        from PIL import Image

        imgs.append(np.asarray(Image.open(out)))
    assert np.array_equal(imgs[0], imgs[1]) and imgs[0].std() > 5.0


@pytest.mark.cuda
def test_kernel_refuses_unported_scenes(cuda_device):
    scene = compile_scene(schema.SceneConfig.from_json(
        {"renderer": [{"type": "sphere", "r": 0.5, "mat": {"tex": {
            "w": 2, "h": 1, "dat": [[1, 0, 0], [0, 1, 0]]}}}]}),
        cuda_device)
    o, d = (t.T.contiguous() for t in _rays(64, cuda_device))
    with pytest.raises(NotImplementedError, match="not ported"):
        step.trace_packed(scene, step.pack_step(scene), 0.85, o, d,
                          torch.rand((2, 4, 64), device=cuda_device))


# --- training: the residual-writing forward and the backward kernel ---------

K_TRAIN = 9
TRACE_RTOL, TRACE_ATOL, TRACE_CAP = 1e-4, 1e-5, 0.003


def _train_inputs(name, device, R=1 << 14):
    scene = _scene(name, device)
    tables = step.pack_step(scene)
    oT, dT = (t.T.contiguous() for t in _rays(R, device, seed=3, name=name))
    gen = torch.Generator(device=device).manual_seed(4)
    u8s = torch.rand((K_TRAIN, step.n_uni(scene.any_refract), R),
                     generator=gen, device=device)
    return scene, tables, oT, dT, u8s


def _off_path(A, B, A_r, B_r, n_live=None, n_live_r=None):
    """(R,) bool on the card: rays outside the trace tolerance (or with
    another count of live steps)."""
    bad = torch.zeros(A.shape[1], dtype=torch.bool, device=A.device)
    for g, r in ((A, A_r), (B, B_r)):
        bad |= (~torch.isclose(g, r, rtol=TRACE_RTOL,
                               atol=TRACE_ATOL)).any(0)
    if n_live is not None:
        bad |= n_live != n_live_r
    return bad


def _close(name, got, want, rtol=2e-3, floor=1e-5):
    atol = floor * max(float(want.abs().max()), 1e-30)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCENES))
def test_trace_fwd_train_matches_render_and_plain(name, cuda_device):
    scene, tables, oT, dT, u8s = _train_inputs(name, cuda_device)
    R = oT.shape[1]
    hit0 = step.primary_hits(scene, tables, oT, dT)
    before = step.TRAIN_KERNEL.launches
    A, B, fl, res, n_live = step.trace_fwd_train(scene, tables, 0.85, oT, dT,
                                                 u8s, hit0)
    assert step.TRAIN_KERNEL.launches == before + 1
    for g, r in zip((A, B, fl), step.trace_fwd(scene, tables, 0.85, oT, dT,
                                                u8s, hit0)):
        assert torch.equal(g, r)
    A_r, B_r, fl_r, res_r, n_live_r = step.trace_plain(
        scene, tables, 0.85, oT, dT, u8s, want_resid=True)
    assert torch.equal(fl, fl_r)
    bad = _off_path(A, B, A_r, B_r, n_live, n_live_r)
    print(f"{name}: {int(bad.sum())} of {R} rays off the plain path")
    assert int(bad.sum()) <= TRACE_CAP * R
    live = ((torch.arange(K_TRAIN, device=cuda_device)[:, None]
             < n_live[None]) & ~bad[None])
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


def _bwd_case(name, device):
    """The backward kernel and autograd through the plain trace, both at
    the plain forward's residuals, for cotangents zero on off-path rays."""
    scene, tables, oT, dT, u8s = _train_inputs(name, device)
    R = oT.shape[1]
    hit0 = step.primary_hits(scene, tables, oT, dT)
    A, B, _fl, _res, n_live = step.trace_fwd_train(scene, tables, 0.85, oT,
                                                   dT, u8s, hit0)
    A_r, B_r, _f, res_r, n_live_r = step.trace_plain(
        scene, tables, 0.85, oT, dT, u8s, want_resid=True)
    bad = _off_path(A, B, A_r, B_r, n_live, n_live_r)
    assert int(bad.sum()) <= TRACE_CAP * R
    rng = np.random.default_rng(5)
    ctA, ctB = (torch.from_numpy(rng.normal(size=(3, R)).astype(np.float32))
                .to(device) for _ in range(2))
    ctA[:, bad] = 0.0
    ctB[:, bad] = 0.0
    return scene, tables, oT, dT, u8s, res_r, n_live_r, ctA, ctB


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCENES))
def test_trace_bwd_matches_autograd_of_plain(name, cuda_device):
    scene, tables, oT, dT, u8s, res, n_live, ctA, ctB = _bwd_case(
        name, cuda_device)
    before = step.BWD_KERNEL.launches
    got = step.trace_bwd(scene, tables, 0.85, u8s, res, n_live, ctA, ctB)
    assert step.BWD_KERNEL.launches == before + 1
    want = step.trace_bwd_plain(scene, tables, 0.85, oT, dT, u8s, ctA, ctB)
    out = torch.zeros(oT.shape[1], dtype=torch.bool, device=oT.device)
    atols = [1e-5 * float(w.abs().max()) for w in want[2:4]]
    for g, w, atol in zip(got[2:4], want[2:4], atols):
        out |= (~torch.isclose(g, w, rtol=2e-3, atol=atol)).any(0)
    idx = out.nonzero()[:, 0].tolist()
    print(f"{name}: {len(idx)} rays of {oT.shape[1]} outside tolerance: "
          f"{idx[:8]}; kernel d_dT {got[3][:, idx[:4]].T.tolist()}, plain "
          f"{want[3][:, idx[:4]].T.tolist()}")
    if idx:
        assert name in ILL_CONDITIONED, f"{name}: rays {idx[:8]} disagree"
        # the plain version in float64 on those rays
        t64 = tables._replace(tab=tables.tab.double(),
                              lights=tables.lights.double(),
                              tri=tables.tri.double())
        w64 = step.trace_bwd_plain(
            scene, t64, 0.85, *(t[..., idx].double()
                                for t in (oT, dT, u8s, ctA, ctB)))
        moved = torch.zeros(len(idx), dtype=torch.bool, device=oT.device)
        for gname, g, w, w_64, atol in zip(("d_oT", "d_dT"), got[2:4],
                                           want[2:4], w64[2:4], atols):
            g, w = g[:, idx].double(), w[:, idx].double()
            tol = 2e-3 * w.abs() + atol
            gap = (w - w_64).abs()
            moved |= (gap > tol).any(0)
            # per ray: the kernel's largest error within twice the plain
            # version's largest move
            err = ((g - w).abs() - tol).amax(0)
            print(f"{gname}: kernel {g.T.tolist()}, plain {w.T.tolist()}, "
                  f"float64 {w_64.T.tolist()}")
            assert bool((err <= 2.0 * gap.amax(0)).all()), gname
        assert bool(moved.all()), f"{name}: well-conditioned rays disagree"
    assert float(want[0].abs().max()) > 0
    if scene.kind_counts[3]:
        assert float(want[4].abs().max()) > 0
    for gname, g, w in zip(("d_tab", "d_lights", "d_oT", "d_dT", "d_tri"),
                           got, want):
        assert bool(torch.isfinite(g).all()), gname
        if gname in ("d_oT", "d_dT"):   # the rays held above left out
            g, w = g[:, ~out], w[:, ~out]
        if w.numel():
            _close(gname, g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mixed", "mesh_glass"])
def test_trace_bwd_run_to_run(name, cuda_device):
    scene, tables, _oT, _dT, u8s, res, n_live, ctA, ctB = _bwd_case(
        name, cuda_device)
    a = step.trace_bwd(scene, tables, 0.85, u8s, res, n_live, ctA, ctB)
    b = step.trace_bwd(scene, tables, 0.85, u8s, res, n_live, ctA, ctB)
    assert torch.equal(a[2], b[2]) and torch.equal(a[3], b[3])
    for gname, g, w in zip(("d_tab", "d_lights", "d_tri"),
                           (a[0], a[1], a[4]), (b[0], b[1], b[4])):
        if w.numel():
            _close(gname, g, w, rtol=1e-5, floor=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mixed", "mesh_glass"])
def test_train_step_runs_the_kernels(name, cuda_device):
    """make_train_step on the card: the primary-hit pass, the train
    instance and the backward kernel once each, no plain version, and
    finite gradients on every trainable leaf."""
    from micro_raytracer_tpu_torch.models.compiler import compile_camera
    from micro_raytracer_tpu_torch.parallel import shard

    cfg = schema.SceneConfig.from_json(SCENES[name])
    scene = compile_scene(cfg, cuda_device)
    cam = compile_camera(schema.CameraConfig.from_json(
        {"pos": [0, -2, 0]} if name == "mixed" else
        {"pos": [0, -1.25, 0], "fov": 60}), cuda_device)
    params = {k: getattr(scene, k).detach().clone().requires_grad_(True)
              for k in shard.TRAINABLE_FIELDS}
    W = H = 32
    ys, xs = torch.meshgrid(torch.arange(float(H)), torch.arange(float(W)),
                            indexing="ij")
    coords = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).to(
        cuda_device)
    target = torch.full((W * H, 3), 0.5, device=cuda_device)
    kernels = (hit3.KERNEL, step.KERNEL, step.TRAIN_KERNEL, step.BWD_KERNEL)
    for k in kernels:
        k.launches = k.plain_calls = 0
    ts = shard.make_train_step((W, H), 3, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    loss, new = ts.step(params, scene, cam, 0.15, coords, target, gen)
    assert [k.launches for k in kernels] == [1, 0, 1, 1]
    assert [k.plain_calls for k in kernels] == [0, 0, 0, 0]
    assert bool(torch.isfinite(loss))
    for k, p in params.items():
        assert bool(torch.isfinite(p.grad).all()), k
        assert new[k].requires_grad and new[k].is_leaf
    assert float(params["mat_albedo"].grad.abs().max()) > 0
    if scene.kind_counts[3]:      # the torus moves and turns
        for k in ("inst_pos", "inst_dir"):
            g = params[k].grad[scene.seg(3)]
            assert float(g.abs().max()) > 0, k
