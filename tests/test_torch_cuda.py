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
largest magnitude: the kernel adds them in no fixed order (float64 sums
for the sphere, plane and box rows and the lights, float32 atomics for
triangle rows). Three layouts of a warp's lanes test the backward's
warp-aggregated scatter: one row for all 32 lanes, up to 32 rows, and
live-step counts far apart (``test_trace_bwd_warp_layouts``).

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

Textured scenes (``torch_tex_helpers``: the stand-ins ``tex_dof`` and
``tex_blocks`` at full width, camera rays; ``tex_mesh``, the glass room
with textured walls and a textured torus, rays from inside the room) run
the kernels' kTex instances. Beside the 0.3% above, at most a quarter of
the rays at a texel edge (``max_flips``) may be dropped as shown texel
flips: rays outside the tolerance that have a texel coordinate within
``step.TEX_EDGE`` of an integer at a live step (``trace_plain``'s
``work["tex_edge"]``); the texel residual rows of the other rays are
equal.

Instance-class scenes (``torch_inst_helpers``: ``inst_grid``, 1,000
instanced spheres over a plane, and ``inst_glass``, 343 of which a
twentieth are glass; camera rays): the closest-hit kernel's rows and t
equal the plain version's bit for bit in every mode, with the per-ray
sphere-block cull; the other checks are those above. Their spheres are
convex mirrors that move a path about tenfold per bounce and whose grazing
hits give t as 1 / sqrt(disc), so they are in ILL_CONDITIONED below. The
render split into segments with live lanes packed first between them
(``tracer.trace_fused``'s ``cuts``) equals the unsegmented render bit for
bit, on them and on ``mesh_glass``.

``ties`` (two identical spheres; a box whose top face lies on a plane)
hits exact ties of the winner t: the lowest row wins and takes the whole
gradient in the kernels and in the plain version.

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

import dataclasses

import numpy as np
import pytest
import torch

from micro_raytracer_tpu_torch.frontends import cli
from micro_raytracer_tpu_torch.models import schema
from micro_raytracer_tpu_torch.models import tracer as ttr
from micro_raytracer_tpu_torch.models.compiler import compile_scene
from micro_raytracer_tpu_torch.ops import hit3, step, tri
from torch_inst_helpers import CAMERA as INST_CAMERA
from torch_inst_helpers import inst_scene
from torch_inst_helpers import render_json as inst_json
from torch_mesh_helpers import (CLUSTERED_LIT, aimed_rays, big_mesh,
                                mesh_scene, small_torus, two_tori)
from torch_port_helpers import (BOXES, MIXED, MIXED_OPAQUE,  # noqa: F401
                                TIES, cuda_device, edge_rays, outlier_rows,
                                rays)
from torch_tex_helpers import CAMERAS, max_flips, render_json, tex_scene
from chip_smoke import LIGHTS8_CAMERA, lights8

SCENES = {"mixed": MIXED, "mixed_opaque": MIXED_OPAQUE,
          "mesh_glass": mesh_scene("mesh_glass"),
          "mesh_opaque": mesh_scene("mesh_opaque"),
          "clustered": CLUSTERED_LIT, "two_tori": two_tori(),
          "tex_dof": tex_scene("tex_dof"),
          "tex_blocks": tex_scene("tex_blocks"),
          "tex_mesh": tex_scene("tex_mesh"), "ties": TIES,
          "inst_grid": inst_scene("inst_grid"),
          "inst_glass": inst_scene("inst_glass")}
CAMERAS = dict(CAMERAS, inst_grid=INST_CAMERA, inst_glass=INST_CAMERA)
# scenes whose rays may be ill-conditioned (module docstring)
ILL_CONDITIONED = {"mesh_opaque", "tex_mesh", "inst_grid", "inst_glass"}


def _scene(name, device):
    return compile_scene(schema.SceneConfig.from_json(SCENES[name]), device)


def _rays(n, device, seed=1, name="mixed"):
    """Random rays; a mesh scene's start inside the room, the clustered
    scene's aim at random points of its triangle blocks' AABBs; the
    textured stand-ins' are camera rays at random pixels of a 256x256
    frame."""
    if name in CAMERAS:
        from micro_raytracer_tpu_torch.models import camera
        from micro_raytracer_tpu_torch.models.compiler import compile_camera

        cam = compile_camera(schema.CameraConfig.from_json(CAMERAS[name]),
                             device)
        gen = torch.Generator(device=device).manual_seed(seed)
        return camera.gen_rays(
            cam, (256, 256),
            torch.floor(torch.rand((n, 2), generator=gen, device=device)
                        * 256), torch.rand((n, 2), generator=gen,
                                           device=device))
    o, d = rays(n, seed)
    if name.startswith("mesh") or name in ("two_tori", "tex_mesh"):
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
    tri = (tables.tri, tables.tbb, tables.sbb)
    exact = scene.kind_counts[3] or tables.sbb is not None
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
                if g.dtype == torch.int32 or exact:
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
    work = _work(R, cuda_device)
    A_r, B_r, fl_r = step.trace_plain(scene, tables, 0.85, o, d, u8s,
                                      work=work)
    assert torch.equal(fl, fl_r) and bool(fl.any())
    bad = set()
    for g, r in ((A, A_r), (B, B_r)):
        bad |= set(outlier_rows(g.T.cpu().numpy(), r.T.cpu().numpy(), 1e-4,
                                1e-5).tolist())
    good = torch.ones(R, dtype=torch.bool)
    good[sorted(bad)] = False
    flips = int((~good & work["tex_edge"].cpu()).sum())
    err_in = max(float((g - r).cpu()[:, good].abs().max())
                 for g, r in ((A, A_r), (B, B_r)))
    print(f"{name}: {len(bad)} of {R} rays outside tolerance, {flips} of "
          f"them shown texel flips; max abs err {err_in:.3g} on the rest")
    assert len(bad) - flips <= 0.003 * R and err_in <= 1e-3, (len(bad),
                                                              err_in)
    assert flips <= max_flips(int(work["tex_edge"].sum()))
    if scene.has_maps:
        assert work["tex_fetch"] > R


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
        # one trace launch per segment of a sample's render
        segs = len(ttr.compact_cuts(compile_scene(schema.SceneConfig
                                                  .from_json(scene), "cpu"),
                                    5, True)) + 1
        assert hit3.KERNEL.launches == 2
        assert step.KERNEL.launches == 2 * segs
        assert step.KERNEL.plain_calls == 0 and hit3.KERNEL.plain_calls == 0
        from PIL import Image

        imgs.append(np.asarray(Image.open(out)))
    assert np.array_equal(imgs[0], imgs[1]) and imgs[0].std() > 5.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["inst_grid", "inst_glass", "mesh_glass"])
def test_compacted_render_equals_unsegmented(name, cuda_device):
    """trace_fused split at steps 2, 4 and 6, live lanes packed first
    between the segments: one primary-hit launch and four trace launches,
    and the unsegmented render's radiance bit for bit."""
    scene = _scene(name, cuda_device)
    tables = step.pack_step(scene)
    R = 1 << 14
    o, d = _rays(R, cuda_device, seed=5, name=name)
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    u8s = torch.rand((9, step.n_uni(scene.any_refract), R), generator=gen,
                     device=cuda_device)
    flat = ttr.trace_fused(scene, tables, 8, o, d, 0.15, u8s, cuts=[])
    before = (hit3.KERNEL.launches, step.KERNEL.launches)
    split = ttr.trace_fused(scene, tables, 8, o, d, 0.15, u8s,
                            cuts=[2, 4, 6])
    assert (hit3.KERNEL.launches, step.KERNEL.launches) == \
        (before[0] + 1, before[1] + 4)
    assert torch.equal(split, flat) and float(flat.std()) > 0.01


@pytest.mark.cuda
def test_cli_renders_an_instanced_scene_on_the_kernels(cuda_device,
                                                        tmp_path):
    """The small grid's JSON renders through the kernels alone: one
    primary-hit launch per sample and one trace launch per segment of the
    sample's compacted render."""
    import json

    from PIL import Image

    cfg = tmp_path / "inst.json"
    cfg.write_text(json.dumps(inst_json("inst_grid", small=True, res=64,
                                        bounce=8, sample=2)))
    for k in (hit3.KERNEL, step.KERNEL):
        k.launches = k.plain_calls = 0
    out = tmp_path / "inst.png"
    assert cli.main([str(cfg), "-o", str(out)]) == 0
    segs = len(ttr.compact_cuts(_scene("inst_grid", "cpu"), 9, True)) + 1
    assert hit3.KERNEL.launches == 2 and step.KERNEL.launches == 2 * segs
    assert step.KERNEL.plain_calls == 0 and hit3.KERNEL.plain_calls == 0
    assert np.asarray(Image.open(out)).std() > 5.0


@pytest.mark.cuda
def test_kernel_refuses_unported_scenes(cuda_device):
    """Textured scenes, once refused here, now run the kernels' kTex
    instances and no plain version: the render, train and backward
    kernels' outputs are the textured plain version's (the texture
    changes them: the same scene's plain trace without its maps
    differs)."""
    scene = compile_scene(schema.SceneConfig.from_json(
        {"renderer": [{"type": "sphere", "r": 0.5, "mat": {"tex": {
            "w": 2, "h": 1, "dat": [[1, 0, 0], [0, 1, 0]]}}}],
         "light": [{"type": "point", "pos": [-0.5, -1, 0.5]}]}),
        cuda_device)
    tables = step.pack_step(scene)
    o, d = (t.T.contiguous() for t in _rays(1024, cuda_device))
    u8s = torch.rand((3, 4, 1024), device=cuda_device)
    kernels = (hit3.KERNEL, step.KERNEL, step.TRAIN_KERNEL, step.BWD_KERNEL)
    for k in kernels:
        k.launches = k.plain_calls = 0
    A, B, fl = step.trace_packed(scene, tables, 0.85, o, d, u8s)
    hit0 = step.primary_hits(scene, tables, o, d)
    At, Bt, _fl, res, n_live = step.trace_fwd_train(scene, tables, 0.85, o,
                                                    d, u8s, hit0)
    ct = torch.ones_like(A)
    got = step.trace_bwd(scene, tables, 0.85, u8s, res, n_live, ct, ct)
    assert [k.launches for k in kernels] == [2, 1, 1, 1]
    assert [k.plain_calls for k in kernels] == [0, 0, 0, 0]
    assert torch.equal(A, At) and torch.equal(B, Bt) and bool(fl.any())
    A_r, B_r, _f = step.trace_plain(scene, tables, 0.85, o, d, u8s)
    torch.testing.assert_close(B, B_r, rtol=1e-4, atol=1e-5)
    bare = tables._replace(maps=None, atlas=None, tmeta=None)
    assert float((step.trace_plain(scene, bare, 0.85, o, d, u8s)[1]
                  - B_r).abs().max()) > 0.1
    want = step.trace_bwd_plain(scene, tables, 0.85, o, d, u8s, ct, ct)
    _close("d_tab", got[0], want[0])


@pytest.mark.cuda
def test_cli_renders_a_textured_scene_on_the_kernels(cuda_device, tmp_path):
    """A textured JSON (both stand-ins, small) renders through the kernels
    alone."""
    import json

    from PIL import Image

    for name in ("tex_dof", "tex_blocks"):
        cfg = tmp_path / f"{name}.json"
        cfg.write_text(json.dumps(render_json(name, small=True, res=64,
                                              bounce=4, sample=2)))
        for k in (hit3.KERNEL, step.KERNEL):
            k.launches = k.plain_calls = 0
        out = tmp_path / f"{name}.png"
        assert cli.main([str(cfg), "-o", str(out)]) == 0
        assert hit3.KERNEL.launches == 2 and step.KERNEL.launches == 2
        assert step.KERNEL.plain_calls == 0 and hit3.KERNEL.plain_calls == 0
        assert np.asarray(Image.open(out)).std() > 5.0


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


def _work(R, device):
    return {"sweep": 0, "shadow": 0,
            "tex_edge": torch.zeros(R, dtype=torch.bool, device=device)}


def _off_path(A, B, A_r, B_r, n_live=None, n_live_r=None, edge=None):
    """(R,) bool on the card: rays outside the trace tolerance (or with
    another count of live steps), at most TRACE_CAP of them; with
    ``edge`` (texel-edge rays) also the shown texel flips, at most
    ``max_flips`` of the edge rays more."""
    bad = torch.zeros(A.shape[1], dtype=torch.bool, device=A.device)
    for g, r in ((A, A_r), (B, B_r)):
        bad |= (~torch.isclose(g, r, rtol=TRACE_RTOL,
                               atol=TRACE_ATOL)).any(0)
    if n_live is not None:
        bad |= n_live != n_live_r
    if edge is None:
        edge = torch.zeros_like(bad)
    R = bad.shape[0]
    assert int((bad & ~edge).sum()) <= TRACE_CAP * R
    assert int((bad & edge).sum()) <= max_flips(int(edge.sum()))
    return bad | edge


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
    work = _work(R, cuda_device)
    A_r, B_r, fl_r, res_r, n_live_r = step.trace_plain(
        scene, tables, 0.85, oT, dT, u8s, want_resid=True, work=work)
    assert torch.equal(fl, fl_r)
    bad = _off_path(A, B, A_r, B_r, n_live, n_live_r, work["tex_edge"])
    print(f"{name}: {int(bad.sum())} of {R} rays off the plain path or at "
          f"a texel edge")
    live = ((torch.arange(K_TRAIN, device=cuda_device)[:, None]
             < n_live[None]) & ~bad[None])
    # the open scenes' paths leave them sooner than a room's
    assert int(live.sum()) > (R // 2 if name in ("clustered", "tex_dof",
                                                 "ties") else R)
    floats = [step.RES_O + c for c in range(9)] + [step.RES_TE]
    exact = [step.RES_ROW] + [step.RES_LOK + li
                              for li in range(scene.n_lights)]
    if scene.any_refract:
        floats.append(step.RES_TX)
        exact.append(step.RES_CHOOSE)
    if tables.layout[3]:
        exact.append(step.res_xrow(scene.n_lights))
    r_tex = step.res_rows(scene.n_lights, tables.layout[3])
    assert res.shape[1] - r_tex == step.tex_rows(scene)
    exact += list(range(r_tex, res.shape[1]))       # the texels
    for r in floats:
        torch.testing.assert_close(res[:, r][live], res_r[:, r][live],
                                   rtol=1e-4, atol=1e-4, msg=f"row {r}")
    for r in exact:
        assert torch.equal(res[:, r][live], res_r[:, r][live]), r


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mixed", "inst_grid"])
def test_refill_leaves_its_counters_zeroed(name, cuda_device):
    """The lane refill's ray counters (``step.refills``: the render of a
    dense-row scene, and training with sphere cull blocks) are zero again
    after each launch, so repeated launches on one stream, of different
    sizes, give the same outputs as the first."""
    scene, tables, oT, dT, u8s = _train_inputs(name, cuda_device)
    hit0 = step.primary_hits(scene, tables, oT, dT)
    assert step.refills(scene, tables, False)
    assert step.refills(scene, tables, True) == (tables.sbb is not None)
    first = step.trace_fwd(scene, tables, 0.85, oT, dT, u8s, hit0)
    h = oT.shape[1] // 3
    half = step.trace_fwd(scene, tables, 0.85, oT[:, :h].contiguous(),
                          dT[:, :h].contiguous(), u8s[..., :h].contiguous(),
                          [t[:h].contiguous() for t in hit0])
    train = step.trace_fwd_train(scene, tables, 0.85, oT, dT, u8s, hit0)
    again = step.trace_fwd(scene, tables, 0.85, oT, dT, u8s, hit0)
    torch.cuda.synchronize()
    for a, b, c, t in zip(first, again, half, train):
        assert torch.equal(a, b) and torch.equal(a, t)
        assert torch.equal(a[:, :h], c)
    for nxt in step._COUNTERS.values():
        assert int(nxt.abs().sum()) == 0


def _bwd_case(name, device, rays=None):
    """The backward kernel and autograd through the plain trace, both at
    the plain forward's residuals, for cotangents zero on off-path rays
    (``rays``: lane-major ``(oT, dT)`` of the same count in place of the
    scene's own)."""
    scene, tables, oT, dT, u8s = _train_inputs(name, device)
    if rays is not None:
        oT, dT = rays
    R = oT.shape[1]
    hit0 = step.primary_hits(scene, tables, oT, dT)
    A, B, _fl, _res, n_live = step.trace_fwd_train(scene, tables, 0.85, oT,
                                                   dT, u8s, hit0)
    work = _work(R, device)
    A_r, B_r, _f, res_r, n_live_r = step.trace_plain(
        scene, tables, 0.85, oT, dT, u8s, want_resid=True, work=work)
    bad = _off_path(A, B, A_r, B_r, n_live, n_live_r, work["tex_edge"])
    rng = np.random.default_rng(5)
    ctA, ctB = (torch.from_numpy(rng.normal(size=(3, R)).astype(np.float32))
                .to(device) for _ in range(2))
    ctA[:, bad] = 0.0
    ctB[:, bad] = 0.0
    return scene, tables, oT, dT, u8s, res_r, n_live_r, ctA, ctB


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCENES))
def test_trace_bwd_matches_autograd_of_plain(name, cuda_device):
    _hold_bwd(name, *_bwd_case(name, cuda_device))


def _warp_rays(case, device, R=1 << 14):
    """The scene and lane-major rays of a warp layout of the backward's
    scatter: ``one_row``, MIXED's floor seen from above (every lane of a
    warp first hits one row: the worst conflict); ``many_rows``,
    inst_grid's camera rays shuffled (a warp's lanes hit spheres all over
    the grid: up to 32 rows); ``mixed_live``, rays from random points of
    the open MIXED scene (paths of 1 to 9 steps in one warp)."""
    if case == "one_row":
        rng = np.random.default_rng(11)
        o = np.stack([rng.uniform(-1.8, -1.2, R), rng.uniform(-1.8, -1.2, R),
                      rng.uniform(0.5, 1.0, R)], 1)
        d = np.stack([rng.normal(0.0, 0.05, R), rng.normal(0.0, 0.05, R),
                      -np.ones(R)], 1)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o, d = (torch.from_numpy(a.astype(np.float32)).to(device)
                for a in (o, d))
        return "mixed", (o.T.contiguous(), d.T.contiguous())
    name = "inst_grid" if case == "many_rows" else "mixed"
    o, d = _rays(R, device, seed=3, name=name)
    if case == "many_rows":
        perm = torch.from_numpy(np.random.default_rng(12).permutation(R))
        o, d = o[perm.to(device)], d[perm.to(device)]
    return name, (o.T.contiguous(), d.T.contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_row", "many_rows", "mixed_live"])
def test_trace_bwd_warp_layouts(case, cuda_device):
    """The warp-aggregated scatter of the backward kernel against autograd
    of the plain trace where a warp's lanes share one row, hold up to 32
    rows, or have live-step counts far apart."""
    name, rays = _warp_rays(case, cuda_device)
    args = _bwd_case(name, cuda_device, rays)
    res, n_live = args[5], args[6]
    rows = res[0, step.RES_ROW].long().view(-1, 32)
    live = (n_live > 0).view(-1, 32)
    if case == "one_row":
        one = live.all(1) & (rows == rows[:, :1]).all(1)
        assert float(one.float().mean()) >= 0.9
    elif case == "many_rows":
        distinct = [len(set(r[m].tolist())) for r, m in zip(rows, live)]
        assert np.mean(distinct) >= 16
    else:
        n = n_live.view(-1, 32)
        assert float((n.max(1).values - n.min(1).values).float().mean()) >= 3
    _hold_bwd(name, *args)


def _hold_bwd(name, scene, tables, oT, dT, u8s, res, n_live, ctA, ctB):
    """The backward kernel against autograd of the plain trace (module
    docstring: the per-ray rule, the ill-conditioned rays, the tables)."""
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
@pytest.mark.parametrize("name", ["mixed", "mesh_glass", "tex_blocks"])
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
@pytest.mark.parametrize("name", ["mixed", "mesh_glass", "tex_blocks"])
def test_train_step_runs_the_kernels(name, cuda_device):
    """make_train_step on the card: the primary-hit pass, the train
    instance and the backward kernel once each, no plain version, and
    finite gradients on every trainable leaf."""
    from micro_raytracer_tpu_torch.models.compiler import compile_camera
    from micro_raytracer_tpu_torch.parallel import shard

    cfg = schema.SceneConfig.from_json(SCENES[name])
    scene = compile_scene(cfg, cuda_device)
    cam = compile_camera(schema.CameraConfig.from_json(
        CAMERAS.get(name) or ({"pos": [0, -2, 0]} if name == "mixed" else
                              {"pos": [0, -1.25, 0], "fov": 60})),
        cuda_device)
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


# --- the per-step path (csrc/step_fwd.cu, csrc/step_bwd.cu) -----------------
#
# step_fwd / step_fwd_train against the plain step (step.step_plain) from a
# mid-trace carry: hit equal, the carry within the trace tolerance on all
# but TRACE_CAP of the rays, the train instance bit for bit the render
# instance, the residuals of the other rays that hit as in the train
# test above. step_bwd on the plain residuals against autograd of the
# plain step, as the whole-trace backward is held (a sphere grid's rays
# outside must be shown ill-conditioned by float64, the rule above). The
# per-step route against the whole trace: radiance bit for bit; under a
# gradient d_oT and d_dT bit for bit (the same transposes per ray) and the
# table cotangents within rtol 1e-5 and 1e-6 of the largest magnitude
# (their sums run in another order).

STEP_SCENES = {"lights8": lights8(),
               "grid13": inst_scene("inst_grid", dims=(13, 13, 13))}
STEP_CAMERAS = {"lights8": LIGHTS8_CAMERA, "grid13": INST_CAMERA}
STEP_ILL = {"grid13", "inst_grid"}


def _step_case(name, device, R=1 << 14):
    """A scene, its tables, a mid-trace carry (two plain steps from camera
    or random rays) and the next step's uniforms."""
    js = STEP_SCENES.get(name) or SCENES[name]
    scene = compile_scene(schema.SceneConfig.from_json(js), device)
    tables = step.pack_step(scene)
    if name in STEP_SCENES:
        cams = dict(CAMERAS, **STEP_CAMERAS)
        from micro_raytracer_tpu_torch.models import camera
        from micro_raytracer_tpu_torch.models.compiler import compile_camera

        cam = compile_camera(schema.CameraConfig.from_json(cams[name]),
                             device)
        gen = torch.Generator(device=device).manual_seed(3)
        o, d = camera.gen_rays(
            cam, (256, 256),
            torch.floor(torch.rand((R, 2), generator=gen, device=device)
                        * 256), torch.rand((R, 2), generator=gen,
                                           device=device))
    else:
        o, d = _rays(R, device, seed=3, name=name)
    gen = torch.Generator(device=device).manual_seed(4)
    u8s = torch.rand((3, step.n_uni(scene.any_refract), R), generator=gen,
                     device=device)
    with torch.no_grad():
        c0 = step.primary_carry(o.T.contiguous(), d.T.contiguous())
        for k in range(2):
            c0 = step.step_plain(scene, tables, 0.85, c0, u8s[k])[0]
    return scene, tables, c0, u8s[2]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lights8", "grid13", "mixed",
                                  "mesh_glass", "inst_grid"])
def test_step_kernels_match_plain(name, cuda_device):
    scene, tables, c0, u8 = _step_case(name, cuda_device)
    R = c0.shape[1]
    before = (step.STEP_KERNEL.launches, step.STEP_TRAIN_KERNEL.launches)
    c1, hit = step.step_fwd(scene, tables, 0.85, c0, u8)
    c1_t, hit_t, res = step.step_fwd_train(scene, tables, 0.85, c0, u8)
    assert (step.STEP_KERNEL.launches, step.STEP_TRAIN_KERNEL.launches) \
        == (before[0] + 1, before[1] + 1)
    assert torch.equal(c1, c1_t) and torch.equal(hit, hit_t)
    c1_p, hit_p, res_p = step.step_plain(scene, tables, 0.85, c0, u8,
                                         want_resid=True)
    assert torch.equal(hit, hit_p)
    live = hit[0] > 0.5
    assert int(live.sum()) > R // 16
    bad = (~torch.isclose(c1, c1_p, rtol=TRACE_RTOL,
                          atol=TRACE_ATOL)).any(0)
    assert int(bad.sum()) <= TRACE_CAP * R, int(bad.sum())
    good = live & ~bad
    floats = [step.RES_O + c for c in range(9)] + [step.RES_TE]
    exact = [step.RES_ROW] + [step.RES_LOK + li
                              for li in range(scene.n_lights)]
    if scene.any_refract:
        floats.append(step.RES_TX)
        exact.append(step.RES_CHOOSE)
    if tables.layout[3]:
        exact.append(step.res_xrow(scene.n_lights))
    for r in floats:
        torch.testing.assert_close(res[r, good], res_p[r, good], rtol=1e-4,
                                   atol=1e-4, msg=f"row {r}")
    for r in exact:
        assert torch.equal(res[r, good], res_p[r, good]), r

    # the backward on the plain residuals
    ct1 = torch.from_numpy(np.random.default_rng(5).normal(
        size=(step.CARRY_ROWS, R)).astype(np.float32)).to(cuda_device)
    ct1[:, bad] = 0.0
    _hold_step_bwd(name, scene, tables, c0, u8, res_p, hit_p, ct1)


def _hold_step_bwd(name, scene, tables, c0, u8, res_p, hit_p, ct1):
    """step_bwd against autograd of the plain step (the rule above, a
    sphere grid's rays outside shown ill-conditioned by float64), then
    run to run: the per-ray cotangents bit for bit, the tables' sums at
    float32 rounding."""
    R = c0.shape[1]
    before = step.STEP_BWD_KERNEL.launches
    got = step.step_bwd(scene, tables, 0.85, c0, u8, res_p, hit_p, ct1)
    assert step.STEP_BWD_KERNEL.launches == before + 1
    want = step.step_bwd_plain(scene, tables, 0.85, c0, u8, ct1)
    atol = 1e-5 * float(want[2].abs().max())
    out = (~torch.isclose(got[2], want[2], rtol=2e-3, atol=atol)).any(0)
    idx = out.nonzero()[:, 0]
    if len(idx):
        assert name in STEP_ILL, f"{name}: rays {idx[:8].tolist()} disagree"
        assert len(idx) <= TRACE_CAP * R
        t64 = tables._replace(tab=tables.tab.double(),
                              lights=tables.lights.double(),
                              tri=tables.tri.double())
        w64 = step.step_bwd_plain(scene, t64, 0.85, c0[:, idx].double(),
                                  u8[:, idx].double(),
                                  ct1[:, idx].double())[2]
        g, w = got[2][:, idx].double(), want[2][:, idx].double()
        tol = 2e-3 * w.abs() + atol
        gap = (w - w64).abs()
        assert bool(((gap > tol).any(0)).all()), "well-conditioned rays"
        assert bool((((g - w).abs() - tol).amax(0)
                     <= 2.0 * gap.amax(0)).all())
    assert float(want[0].abs().max()) > 0
    for gname, g, w in zip(("d_tab", "d_lights", "d_c0", "d_tri"), got,
                           want):
        assert bool(torch.isfinite(g).all()), gname
        if gname == "d_c0":
            g, w = g[:, ~out], w[:, ~out]
        if w.numel():
            _close(gname, g, w)
    # run to run: the per-ray cotangents bit for bit, the tables' sums at
    # float32 rounding
    again = step.step_bwd(scene, tables, 0.85, c0, u8, res_p, hit_p, ct1)
    assert torch.equal(got[2], again[2])
    for gname, g, w in zip(("d_tab", "d_lights", "d_tri"),
                           (got[0], got[1], got[3]),
                           (again[0], again[1], again[3])):
        if w.numel():
            _close(gname, g, w, rtol=1e-5, floor=1e-6)
    return got


def _lit_plane(n_lights):
    """A ground plane and one sphere under ``n_lights`` point lights (the
    per-step path: more than 4)."""
    rng = np.random.default_rng(n_lights)
    lights = [{"type": "point", "pos": [float(x), float(y), 2.0],
               "pwr": 0.2} for x, y in rng.uniform(-2, 2, (n_lights, 2))]
    return {"renderer": [
        {"type": "plane", "n": [0, 0, 1], "pos": [0, 0, 0],
         "mat": {"rough": 0.4}},
        {"type": "sphere", "r": 0.3, "pos": [0.8, 0.8, 0.3]}],
        "light": lights}


def _warp_step_case(case, device, R=1 << 14):
    """A per-step backward case whose warps hold: ``one_row`` every lane on
    the ground plane; ``distinct_rows`` up to 32 sphere rows (the 13^3
    grid's camera rays, shuffled); ``mixed`` the mixed scene's rays;
    ``dead_lanes`` the grid's rays with four lanes in seven dead;
    ``triangle_rows`` the glass torus; ``many_lights`` 200 lights, whose
    warp slots do not fit in shared memory (the global float64 sums).
    Returns (name, scene, tables, c0, u8)."""
    if case in ("one_row", "many_lights"):
        L = 8 if case == "one_row" else 200
        scene = compile_scene(schema.SceneConfig.from_json(_lit_plane(L)),
                              device)
        tables = step.pack_step(scene)
        rng = np.random.default_rng(7)
        o = np.stack([rng.uniform(-2.0, 0.2, R), rng.uniform(-2.0, 0.2, R),
                      np.full(R, 1.5)], 1)
        d = np.stack([rng.normal(0, 0.05, R), rng.normal(0, 0.05, R),
                      -np.ones(R)], 1)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        c0 = step.primary_carry(
            *(torch.from_numpy(a.T.astype(np.float32)).contiguous()
              .to(device) for a in (o, d)))
        u8 = torch.rand((step.n_uni(scene.any_refract), R),
                        generator=torch.Generator(device=device)
                        .manual_seed(4), device=device)
        return "lit_plane", scene, tables, c0, u8
    name = {"distinct_rows": "grid13", "dead_lanes": "grid13",
            "mixed": "mixed", "triangle_rows": "mesh_glass"}[case]
    scene, tables, c0, u8 = _step_case(name, device, R)
    if case == "triangle_rows":
        # primaries from inside the room aimed at the torus's blocks
        rng = np.random.default_rng(6)
        o = rng.uniform(-0.3, 0.3, (R, 3))
        bb = tables.tbb.cpu().numpy()[rng.integers(0, len(tables.tbb), R)]
        d = bb[:, :3] + rng.random((R, 3)) * (bb[:, 3:6] - bb[:, :3]) - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        c0 = step.primary_carry(
            *(torch.from_numpy(np.ascontiguousarray(a.T, np.float32))
              .to(device) for a in (o, d)))
    if case == "distinct_rows":
        perm = torch.from_numpy(np.random.default_rng(12).permutation(R))
        c0, u8 = c0[:, perm.to(device)], u8[:, perm.to(device)]
    if case == "dead_lanes":
        lane = torch.arange(R, device=device) % 7
        c0 = c0.clone()
        c0[step.C_LIVE, (lane == 1) | (lane == 2) | (lane == 4)
           | (lane == 6)] = 0.0
    return name, scene, tables, c0.contiguous(), u8.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lights8", "grid13", "mesh_glass"])
def test_step_bwd_run_to_run(name, cuda_device, monkeypatch):
    """step_bwd twice, and with the dense rows summed in global memory
    instead of per block in shared memory: the per-ray cotangents bit for
    bit, the table sums (float64, in no fixed order) within rtol 1e-5."""
    scene, tables, c0, u8 = _step_case(name, cuda_device)
    _c1, hit, res = step.step_fwd_train(scene, tables, 0.85, c0, u8)
    ct1 = torch.from_numpy(np.random.default_rng(7).normal(
        size=(step.CARRY_ROWS, c0.shape[1])).astype(np.float32)).to(
        cuda_device)
    runs = [step.step_bwd(scene, tables, 0.85, c0, u8, res, hit, ct1)
            for _ in range(2)]
    monkeypatch.setattr(step, "_step_shared_rows", lambda n, L: False)
    runs.append(step.step_bwd(scene, tables, 0.85, c0, u8, res, hit, ct1))
    a = runs[0]
    for b in runs[1:]:
        assert torch.equal(a[2], b[2])
        for gname, g, w in zip(("d_tab", "d_lights", "d_tri"),
                               (a[0], a[1], a[3]), (b[0], b[1], b[3])):
            if w.numel():
                _close(gname, g, w, rtol=1e-5, floor=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_row", "distinct_rows", "mixed",
                                  "dead_lanes", "triangle_rows",
                                  "many_lights"])
def test_step_bwd_warp_layouts(case, cuda_device):
    """step_bwd's warp-wide sums (rows summed by a reduce-scatter, each
    light's row per warp) against autograd of the plain step where a
    warp's lanes share one row, hold up to 32 rows, have dead lanes among
    them, sit on triangle rows (float atomics), or see more lights than
    the warps' shared slots hold; and each ray's cotangents do not depend
    on its warp: the same rays shuffled give the same d_c0 bit for bit."""
    name, scene, tables, c0, u8 = _warp_step_case(case, cuda_device)
    R = c0.shape[1]
    _c1, hit_p, res_p = step.step_plain(scene, tables, 0.85, c0, u8,
                                        want_resid=True)
    hit = hit_p[0] > 0.5
    rows = torch.where(hit, res_p[step.RES_ROW], -1.0).view(-1, 32)
    if case == "one_row":
        same = (rows == rows[:, :1]).all(1) & (rows[:, 0] >= 0)
        assert float(same.float().mean()) >= 0.9
    elif case == "distinct_rows":
        distinct = [len(set(r[r >= 0].tolist())) for r in rows]
        assert np.mean(distinct) >= 12
    elif case == "dead_lanes":
        assert 0.2 < float(hit.float().mean()) < 0.5
    elif case == "triangle_rows":
        assert int((res_p[step.RES_ROW][hit] >= tables.layout[1]).sum()) \
            > R // 8
    elif case == "many_lights":
        # float64 slots of each warp past the shared-memory budget
        assert step._STEP_BWD_WARPS * scene.n_lights * step.LIGHT_COLS \
            * 8 > step._STEP_SHARED_BYTES
    ct1 = torch.from_numpy(np.random.default_rng(5).normal(
        size=(step.CARRY_ROWS, R)).astype(np.float32)).to(cuda_device)
    got = _hold_step_bwd(name, scene, tables, c0, u8, res_p, hit_p, ct1)
    perm = torch.from_numpy(np.random.default_rng(9).permutation(R)).to(
        cuda_device)
    shuf = step.step_bwd(scene, tables, 0.85, c0[:, perm].contiguous(),
                         u8[:, perm].contiguous(),
                         res_p[:, perm].contiguous(),
                         hit_p[:, perm].contiguous(),
                         ct1[:, perm].contiguous())
    assert torch.equal(shuf[2], got[2][:, perm])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mixed", "mixed_opaque", "mesh_glass",
                                  "mesh_opaque", "tex_blocks", "tex_mesh",
                                  "inst_grid", "inst_glass"])
def test_steps_equal_whole_trace(name, cuda_device):
    """The per-step path on a scene the whole trace takes: A, B and
    first_live bit for bit; under a gradient the primaries' cotangents
    bit for bit and the tables' within rtol 1e-5."""
    scene, tables, oT, dT, u8s = _train_inputs(name, cuda_device,
                                               R=1 << 13)
    assert step.route(scene, True) == "trace"
    A, B, fl = step.trace_packed(scene, tables, 0.85, oT, dT, u8s)
    As, Bs, fls = step.trace_steps(scene, tables, 0.85, oT, dT, u8s)
    assert torch.equal(A, As) and torch.equal(B, Bs)
    assert torch.equal(fl, fls)
    rng = np.random.default_rng(6)
    ctA, ctB = (torch.from_numpy(rng.normal(size=(3, oT.shape[1])).astype(
        np.float32)).to(cuda_device) for _ in range(2))

    def grads(fn):
        ins = [t.detach().clone().requires_grad_(True)
               for t in (tables.tab, tables.lights, tables.tri, oT, dT)]
        t = tables._replace(tab=ins[0], lights=ins[1], tri=ins[2])
        A_, B_, _fl = fn(scene, t, 0.85, ins[3], ins[4], u8s)
        torch.autograd.backward((A_, B_), (ctA, ctB))
        return [x.grad for x in ins]

    whole = grads(step.trace_packed)
    steps = grads(step.trace_steps)
    for gname, g, w in zip(("d_tab", "d_lights", "d_tri"), steps[:3],
                           whole[:3]):
        if w is not None and w.numel():
            _close(gname, g, w, rtol=1e-5, floor=1e-6)
    assert torch.equal(steps[3], whole[3]) and torch.equal(steps[4], whole[4])


@pytest.mark.cuda
@pytest.mark.parametrize("n_lights", [1, 5])
def test_route_renders_and_trains_past_256_triangle_blocks(n_lights,
                                                           cuda_device):
    """A mesh past hit3.MAX_TRI_BLOCKS cull blocks (``big_mesh``: 16,448
    rows, 257 blocks in 17 superblocks), diffuse, glass, and diffuse beside
    a glass sphere, with 1 light and with 5: rows 6, 7 (also with the
    step's refracting rows) and 8 (``csrc/tri.cu``) equal their plain
    versions bit for bit on a carry with dead lanes, row 7's entry row 6's,
    and row 7's culled exit row 8's unculled one but on phantom exits
    (``tri.culled_exit_phantoms``); the render takes the per-step path, one
    tri_entry (a refractive scene: tri_entry_exit) and one step_fwd launch
    per step,
    and matches the plain per-step trace (the trace tolerance above); a
    gradient takes step_fwd_train and step_bwd per step, finite, with
    non-zero cotangents of the mesh's instance positions."""
    kernels = (hit3.KERNEL, step.KERNEL, step.TRAIN_KERNEL, step.BWD_KERNEL,
               step.STEP_KERNEL, step.STEP_TRAIN_KERNEL,
               step.STEP_BWD_KERNEL, tri.ENTRY_KERNEL,
               tri.ENTRY_EXIT_KERNEL, tri.EXIT_KERNEL)
    R, K = 1 << 12, 4
    for glass, glass_sphere in ((False, False), (True, False),
                                (False, True)):
        js = big_mesh(glass, n_lights, glass_sphere)
        scene = compile_scene(schema.SceneConfig.from_json(js), cuda_device)
        tables = step.pack_step(scene)
        assert tables.tbb.shape[0] == 257
        assert step.route(scene, False) == step.route(scene, True) == "steps"
        o, d = aimed_rays(compile_scene(schema.SceneConfig.from_json(js),
                                        "cpu"), R, 3)
        oT = torch.from_numpy(o.T.copy()).to(cuda_device)
        dT = torch.from_numpy(d.T.copy()).to(cuda_device)
        c = step.primary_carry(oT, dT)
        c[step.C_LIVE, ::10] = 0.0
        args = (tables.tri.detach(), c[0:3].T, c[3:6].T)
        n = tables.layout[3]
        te, row = tri.tri_entry(*args, tables.tbb, n, c[step.C_LIVE],
                                tsb=tables.tsb)
        want = tri.entry_plain(*args, tables.tbb, n, c[step.C_LIVE])
        assert torch.equal(te, want[0]) and torch.equal(row, want[1])
        assert int((te < tri.BIG * 0.5).sum()) > R // 4
        ee = tri.tri_entry_exit(*args, tables.tbb, n, c[step.C_LIVE],
                                tsb=tables.tsb)
        want = tri.entry_exit_plain(*args, tables.tbb, n, c[step.C_LIVE])
        for g, w in zip(ee, want):
            assert torch.equal(g, w)
        refr = step.tri_refracts(tables)
        got = tri.tri_entry_exit(*args, tables.tbb, n, c[step.C_LIVE],
                                 refr=refr, tsb=tables.tsb)
        want = tri.entry_exit_plain(*args, tables.tbb, n, c[step.C_LIVE],
                                    refr=refr)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        wg = torch.where(te < tri.BIG * 0.5,
                         tables.tri[row.long(), hit3._T_GID].detach(), -5.0)
        gx = tri.tri_group_exit(*args, wg.contiguous(), n, c[step.C_LIVE])
        want = tri.group_exit_plain(*args, wg, n, c[step.C_LIVE])
        for g, w in zip(gx, want):
            assert torch.equal(g, w)
        won = te < tri.BIG * 0.5
        assert torch.equal(ee[0], te) and torch.equal(ee[1], row)
        differs, phantom = tri.culled_exit_phantoms(
            tables.tbb, args[1][won], args[2][won], (ee[2][won], ee[3][won]),
            (gx[0][won], gx[1][won]))
        assert torch.equal(differs, phantom)
        assert int(phantom.sum()) <= 0.001 * int(won.sum())
        # the render: the per-step path through the kernels
        u8s = torch.rand((K, step.n_uni(scene.any_refract), R),
                         generator=torch.Generator(device=cuda_device)
                         .manual_seed(4), device=cuda_device)
        for k in kernels:
            k.launches = k.plain_calls = 0
        with torch.no_grad():
            A, B, fl = step.trace_packed(scene, tables, 0.85, oT, dT, u8s)
        sweep = tri.ENTRY_EXIT_KERNEL if scene.any_refract \
            else tri.ENTRY_KERNEL
        want_l = {k.name: 0 for k in kernels}
        want_l.update({sweep.name: K, step.STEP_KERNEL.name: K})
        assert {k.name: k.launches for k in kernels} == want_l
        assert not any(k.plain_calls for k in kernels)
        cp = step.primary_carry(oT, dT)
        for k in range(K):
            cp, hit_p = step.step_plain(scene, tables, 0.85, cp, u8s[k])
            fl_p = hit_p if k == 0 else fl_p
        assert torch.equal(fl, fl_p)
        _off_path(A, B, cp[8:11], cp[11:14])
        # training: the step's train instance and backward
        for k in kernels:
            k.launches = k.plain_calls = 0
        pos = scene.inst_pos.detach().clone().requires_grad_(True)
        s2 = dataclasses.replace(scene, inst_pos=pos)
        t2 = step.pack_step(s2)
        A, B, _fl = step.trace_packed(s2, t2, 0.85, oT, dT, u8s)
        (A.sum() + B.sum()).backward()
        want_l = {k.name: 0 for k in kernels}
        want_l.update({sweep.name: K, step.STEP_TRAIN_KERNEL.name: K,
                       step.STEP_BWD_KERNEL.name: K})
        assert {k.name: k.launches for k in kernels} == want_l
        g = pos.grad
        s = scene.seg(schema.KIND_TRIANGLE)
        assert bool(torch.isfinite(g).all())
        assert float(g[s].abs().max()) > 0


def _odd_rays(ps, tbb, kind, n):
    """float32 numpy (o, d) ``(n, 3)`` for the two-level walk: ``aimed``
    (:func:`aimed_rays`), ``axis`` (aimed, one or two direction components
    zero, two NaN rays), ``inside`` (origins inside random blocks'
    AABBs)."""
    rng = np.random.default_rng(17)
    o, d = aimed_rays(ps, n, 11)
    if kind == "axis":
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


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["aimed", "axis", "inside"])
def test_two_level_walk_matches_plain(kind, cuda_device):
    """Rows 6 and 7 of ``csrc/tri.cu`` (the two-level walk, the culled
    group exit) on 10,006 glass triangles (``big_tris(5003)`` instanced
    twice: 157 cull blocks in 10 superblocks, the last partial, a group
    boundary inside a block), with a tenth of the lanes dead, over all
    rows and over a row count inside the last block: equal to the plain
    versions bit for bit (also with the step's refracting rows), row 7's
    entry row 6's, and row 7's exit row 8's but on phantom exits."""
    from torch_mesh_helpers import big_tris

    js = big_mesh(True)
    js["renderer"][0]["mesh"] = big_tris(5003, seed=6).tolist()
    ps = compile_scene(schema.SceneConfig.from_json(js), "cpu")
    scene = compile_scene(schema.SceneConfig.from_json(js), cuda_device)
    tables = step.pack_step(scene)
    # 157 blocks: the whole-trace kernels' bound, so the table build makes
    # no superblocks; the wrappers take them from tri.superbounds
    t, tbb = tables.tri.detach(), tables.tbb
    tsb = tri.superbounds(tbb)
    n_tri = tables.layout[3]
    assert (t.shape[0], n_tri, tbb.shape[0], tsb.shape[0]) == \
        (10008, 10006, 157, 10)
    R = 1 << 12
    o, d = _odd_rays(ps, tbb.cpu().numpy(), kind, R)
    c = step.primary_carry(torch.from_numpy(o.T.copy()).to(cuda_device),
                           torch.from_numpy(d.T.copy()).to(cuda_device))
    c[step.C_LIVE, 3::10] = 0.0
    o, d, live = c[0:3].T, c[3:6].T, c[step.C_LIVE]
    for n in (n_tri, n_tri - 37):
        te, row = tri.tri_entry(t, o, d, tbb, n, live, tsb=tsb)
        want = tri.entry_plain(t, o, d, tbb, n, live)
        assert torch.equal(te, want[0]) and torch.equal(row, want[1])
        won = te < tri.BIG * 0.5
        assert int(won.sum()) > R // 20
        for refr in (None, step.tri_refracts(tables)):
            ee = tri.tri_entry_exit(t, o, d, tbb, n, live, refr, tsb=tsb)
            want = tri.entry_exit_plain(t, o, d, tbb, n, live, refr)
            for g, w in zip(ee, want):
                assert torch.equal(g, w)
        assert torch.equal(ee[0], te) and torch.equal(ee[1], row)
        wg = torch.where(won, t[row.long(), hit3._T_GID], -5.0).contiguous()
        gx = tri.tri_group_exit(t, o, d, wg, n, live)
        differs, phantom = tri.culled_exit_phantoms(
            tbb, o[won], d[won], (ee[2][won], ee[3][won]),
            (gx[0][won], gx[1][won]))
        assert torch.equal(differs, phantom)
        assert int(phantom.sum()) <= 0.001 * int(won.sum())


@pytest.mark.cuda
def test_group_exit_kernel_matches_plain(cuda_device):
    """Row 8's kernel (``csrc/tri.cu`` ``mrt_tri_exit``: the rays queued by
    group, (ray tile x row slice) items, the packed-key merge) against
    ``group_exit_plain`` bit for bit, and equal to itself on a second run
    (the atomics' order does not reach the outputs): on ``stack_table``
    (several groups, one in two runs, -0.0 / +0.0 ids, NaN rows; rays
    asking for no group or dead; the origin rays' -0 / +0 tie; 301 rays),
    over all rows and a row count inside a group; on the two-group
    16,448-row mesh table with 4,133 carried rays (a tenth dead) asking
    for either group or none, over all rows and 9,224; one launch a
    call, and the run table passed or built."""
    from torch_mesh_helpers import stack_table

    t, o, d = stack_table()
    rng = np.random.default_rng(5)
    n_r = o.shape[0]
    wg = torch.from_numpy(rng.choice(np.float32(
        [0.0, 1.0, 2.0, 3.0, 7.5, -0.0, -5.0, 42.0, np.nan]), n_r))
    wg[-12:] = 3.0
    live = torch.from_numpy((rng.random(n_r) > 0.1).astype(np.float32))
    live[-12:] = 1.0
    cases = [(t, o, d, wg, live, (t.shape[0], 205))]
    js = big_mesh(True)
    scene = compile_scene(schema.SceneConfig.from_json(js), cuda_device)
    tables = step.pack_step(scene)
    R = 4133
    bo, bd = aimed_rays(compile_scene(schema.SceneConfig.from_json(js),
                                      "cpu"), R, 7)
    c = step.primary_carry(torch.from_numpy(bo.T.copy()).to(cuda_device),
                           torch.from_numpy(bd.T.copy()).to(cuda_device))
    c[step.C_LIVE, ::10] = 0.0
    bt = tables.tri.detach()
    ids = torch.unique(bt[:tables.layout[3], hit3._T_GID]).cpu()
    assert ids.numel() == 2
    bwg = torch.from_numpy(rng.choice(np.float32(
        [float(ids[0]), float(ids[1]), -5.0]), R))
    cases.append((bt, c[0:3].T, c[3:6].T, bwg, c[step.C_LIVE],
                  (tables.layout[3], 9224)))
    for tab, o_, d_, wg_, live_, ns in cases:
        tab = tab.to(cuda_device)
        o_, d_ = o_.to(cuda_device), d_.to(cuda_device)
        wg_, live_ = wg_.to(cuda_device), live_.to(cuda_device)
        if o_.stride(0) != live_.stride(0):
            # rays as the carry holds them, so live shares their stride
            o_, d_ = o_.T.contiguous().T, d_.T.contiguous().T
        for n in ns:
            tri.EXIT_KERNEL.launches = 0
            got = tri.tri_group_exit(tab, o_, d_, wg_, n, live_)
            again = tri.tri_group_exit(tab, o_, d_, wg_, n, live_)
            assert tri.EXIT_KERNEL.launches == 2
            want = tri.group_exit_plain(tab, o_, d_, wg_, n, live_)
            for g, a, w in zip(got, again, want):
                if g.dtype == torch.float32:
                    g, a, w = (x.view(torch.int32) for x in (g, a, w))
                assert torch.equal(g, w) and torch.equal(a, w)
            assert int((want[0] > -tri.BIG * 0.5).sum()) > 50


@pytest.mark.cuda
def test_cli_and_training_run_the_step_kernels(cuda_device, tmp_path):
    """lights8 (8 lights) renders through the CLI on the step kernel, one
    launch per step and sample, and trains on its train instance and
    backward, with no whole-trace kernel and no plain version."""
    import json

    from micro_raytracer_tpu_torch.models.compiler import compile_camera
    from micro_raytracer_tpu_torch.parallel import shard
    from PIL import Image

    kernels = (hit3.KERNEL, step.KERNEL, step.TRAIN_KERNEL, step.BWD_KERNEL,
               step.STEP_KERNEL, step.STEP_TRAIN_KERNEL,
               step.STEP_BWD_KERNEL)
    for k in kernels:
        k.launches = k.plain_calls = 0
    path = tmp_path / "lights8.json"
    path.write_text(json.dumps({
        "scene": lights8(), "frame": {"res": [48, 48], "cam": LIGHTS8_CAMERA},
        "rt": {"bounce": 3, "sample": 2}}))
    out = tmp_path / "out.png"
    assert cli.main([str(path), "-o", str(out)]) == 0
    assert [k.launches for k in kernels] == [0, 0, 0, 0, 8, 0, 0]
    assert np.asarray(Image.open(out)).std() > 5.0
    scene = compile_scene(schema.SceneConfig.from_json(lights8()),
                          cuda_device)
    cam = compile_camera(schema.CameraConfig.from_json(LIGHTS8_CAMERA),
                         cuda_device)
    params = {k: getattr(scene, k).detach().clone().requires_grad_(True)
              for k in shard.TRAINABLE_FIELDS}
    ys, xs = torch.meshgrid(torch.arange(32.0), torch.arange(32.0),
                            indexing="ij")
    coords = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).to(
        cuda_device)
    ts = shard.make_train_step((32, 32), 3, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    loss, _new = ts.step(params, scene, cam, 0.15, coords,
                         torch.full((1024, 3), 0.5, device=cuda_device), gen)
    assert [k.launches for k in kernels] == [0, 0, 0, 0, 8, 4, 4]
    assert all(k.plain_calls == 0 for k in kernels)
    assert bool(torch.isfinite(loss))
    for k in ("mat_albedo", "light_pwr", "light_color"):
        g = params[k].grad
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0, k


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["inst_grid", "inst_glass"])
def test_sphere_walk_instances_match_per_step_path(name, cuda_device):
    """The whole trace's and the primary-hit kernel's walk of a culled
    sphere segment (csrc/sph_walk.cuh: sub-blocks, nearest first from
    inside the grid, the winner row's own exit): closest_hit equals the
    dense sweep in every mode on camera rays; the render instance equals
    the per-step path (whose step_fwd walks the same blocks; on the glass
    grid its exit-mode entry is dense) bit for bit, the train instance the
    render instance, and where the render compacts, its segments the
    whole render. (A whole trace with the blocks culled may differ from
    the dense one on a phantom any-hit: 1 ray of 8,192 on inst_grid's
    plain versions.)"""
    scene = _scene(name, cuda_device)
    tables = step.pack_step(scene)
    R = 1 << 15
    o, d = _rays(R, cuda_device, seed=3, name=name)
    for mode in (hit3.MODE_EXIT, hit3.MODE_ENTRY, hit3.MODE_ANY):
        got = hit3.closest_hit(tables.tab, tables.layout, o, d, mode,
                               sbb=tables.sbb,
                               walk=(tables.srows, tables.ssb))
        want = hit3.closest_hit(tables.tab, tables.layout, o, d, mode)
        for g, w in zip(got, want):
            assert torch.equal(g, w), mode
    oT, dT = o.T.contiguous(), d.T.contiguous()
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    u8s = torch.rand((9, step.n_uni(scene.any_refract), R), generator=gen,
                     device=cuda_device)
    hit0 = step.primary_hits(scene, tables, oT, dT)
    A, B, fl = step.trace_fwd(scene, tables, 0.85, oT, dT, u8s, hit0)
    A_s, B_s, fl_s = step.trace_steps(scene, tables, 0.85, oT, dT, u8s)
    assert torch.equal(A, A_s) and torch.equal(B, B_s)
    assert torch.equal(fl, fl_s) and bool(fl.any())
    train = step.trace_fwd_train(scene, tables, 0.85, oT, dT, u8s, hit0)
    for g, w in zip(train[:3], (A, B, fl)):
        assert torch.equal(g, w)
    assert step.instance_resources(scene, tables, "trace_fwd")["registers"]
    cuts = ttr.compact_cuts(scene, 9, True)
    if cuts:
        renders = [ttr.trace_fused(scene, tables, 8, o, d, 0.15, u8s, cuts=c)
                   for c in ([], cuts)]
        assert torch.equal(*renders)


@pytest.mark.cuda
def test_culled_triangle_exit_differs_only_on_phantoms(cuda_device):
    """The exit-mode closest hit on the glass torus, its triangle entry
    and group exit culled per block, against the plain culled sweep (bit
    for bit) and the unculled plain sweep: equal but on phantom entries
    and exits (tri.culled_exit_phantoms), none on these rays."""
    scene = _scene("mesh_glass", cuda_device)
    tables = step.pack_step(scene)
    o, d = _rays(1 << 15, cuda_device, seed=5, name="mesh_glass")
    args = (tables.tab, tables.layout, o, d, hit3.MODE_EXIT, tables.tri)
    got = hit3.closest_hit(*args, tables.tbb)
    for g, w in zip(got, hit3.closest_hit_plain(*args, tables.tbb)):
        assert torch.equal(g, w)
    full = hit3.closest_hit_plain(*args, None)
    assert torch.equal(got[0], full[0]) and torch.equal(got[1], full[1])
    s = tables.layout[1]
    won = got[1] >= s
    assert int(won.sum()) > 1000
    differs, phantom = tri.culled_exit_phantoms(
        tables.tbb, o[won], d[won], (got[2][won], got[3][won] - s),
        (full[2][won], full[3][won] - s))
    assert not bool((differs & ~phantom).any())
    assert int(differs.sum()) == 0


@pytest.mark.cuda
def test_step_kernels_past_the_staged_lights(cuda_device):
    """``chip_smoke.lights_many`` (2,051 lights: 2,048 staged in shared
    memory, the rest read from global memory): step_fwd and
    step_fwd_train against each other and the plain step, step_bwd
    against autograd of the plain step, as test_step_kernels_match_plain
    holds them."""
    from chip_smoke import lights_many

    scene = compile_scene(schema.SceneConfig.from_json(lights_many()),
                          cuda_device)
    tables = step.pack_step(scene)
    assert scene.n_lights > step.STEP_MAX_LIGHTS
    R = 1 << 12
    o, d = _rays(R, cuda_device, seed=6, name="mixed")
    c0 = step.primary_carry(o.T.contiguous(), d.T.contiguous())
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    u8 = torch.rand((step.n_uni(scene.any_refract), R), generator=gen,
                    device=cuda_device)
    c1, hit = step.step_fwd(scene, tables, 0.85, c0, u8)
    c1_t, hit_t, res = step.step_fwd_train(scene, tables, 0.85, c0, u8)
    assert torch.equal(c1, c1_t) and torch.equal(hit, hit_t)
    c1_p, hit_p, res_p = step.step_plain(scene, tables, 0.85, c0, u8,
                                         want_resid=True)
    assert torch.equal(hit, hit_p) and int(hit.sum()) > R // 4
    bad = (~torch.isclose(c1, c1_p, rtol=TRACE_RTOL,
                          atol=TRACE_ATOL)).any(0)
    assert int(bad.sum()) <= TRACE_CAP * R, int(bad.sum())
    live = (hit[0] > 0.5) & ~bad
    lok = [step.RES_LOK + li for li in range(scene.n_lights)]
    assert torch.equal(res[lok][:, live], res_p[lok][:, live])
    assert float(c1[11:14].abs().max()) > 0
    ct1 = torch.from_numpy(np.random.default_rng(7).normal(
        size=(step.CARRY_ROWS, R)).astype(np.float32)).to(cuda_device)
    ct1[:, bad] = 0.0
    _hold_step_bwd("lights_many", scene, tables, c0, u8, res_p, hit_p, ct1)


def _blocks_rays(scene, tables, device, R):
    """Camera rays of tex_blocks' camera and the same rays after two
    bounce steps of the per-step path (those still live)."""
    o, d = _rays(R, device, seed=6, name="tex_blocks")
    gen = torch.Generator(device=device).manual_seed(7)
    c = step.primary_carry(o.T.contiguous(), d.T.contiguous())
    u8s = torch.rand((2, step.n_uni(True), R), generator=gen, device=device)
    for k in range(2):
        c = step.step_fwd(scene, tables, 0.85, c, u8s[k])[0]
    live = c[step.C_LIVE] > 0.5
    return [(o, d), (c[0:3].T[live].contiguous(), c[3:6].T[live].contiguous())]


@pytest.mark.cuda
def test_box_walk_instances_match_plain_and_dense(cuda_device):
    """The box walk (csrc/box_walk.cuh) on tex_blocks: the primary-hit
    kernel's kBox instance equals the plain box-walk sweep and the dense
    instance (the same tables without the walk) bit for bit in every mode,
    on camera rays and bounced rays; the render instance (kBox) equals the
    dense render instance, the train instance the render instance, a
    render in two segments (the kBox segment instances) the whole one, and
    the per-step path (dense box sweeps) the whole trace, bit for bit."""
    scene = _scene("tex_blocks", cuda_device)
    tables = step.pack_step(scene)
    assert tables.box is not None and tables.box.n == 256
    dense = tables._replace(box=None)
    for o, d in _blocks_rays(scene, tables, cuda_device, 1 << 15):
        for mode in (hit3.MODE_EXIT, hit3.MODE_ENTRY, hit3.MODE_ANY):
            before = hit3.KERNEL.launches
            got = hit3.closest_hit(tables.tab, tables.layout, o, d, mode,
                                   box=tables.box)
            assert hit3.KERNEL.launches == before + 1
            want = hit3.closest_hit_plain(tables.tab, tables.layout, o, d,
                                          mode, box=tables.box)
            flat = hit3.closest_hit(tables.tab, tables.layout, o, d, mode)
            for g, w, f in zip(got, want, flat):
                assert torch.equal(g, w) and torch.equal(g, f), mode
    R = 1 << 15
    o, d = _rays(R, cuda_device, seed=8, name="tex_blocks")
    oT, dT = o.T.contiguous(), d.T.contiguous()
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    u8s = torch.rand((9, step.n_uni(True), R), generator=gen,
                     device=cuda_device)
    hit0 = step.primary_hits(scene, tables, oT, dT)
    step.KERNEL.variants = {}
    A, B, fl = step.trace_fwd(scene, tables, 0.85, oT, dT, u8s, hit0)
    want = step.trace_fwd(scene, dense, 0.85, oT, dT, u8s,
                          step.primary_hits(scene, dense, oT, dT))
    assert step.KERNEL.variants == {"box_walk": 1}
    for g, w in zip((A, B, fl), want):
        assert torch.equal(g, w)
    train = step.trace_fwd_train(scene, tables, 0.85, oT, dT, u8s, hit0)
    for g, w in zip(train[:3], (A, B, fl)):
        assert torch.equal(g, w)
    dense_train = step.trace_fwd_train(scene, dense, 0.85, oT, dT, u8s,
                                       hit0)
    assert torch.equal(train[4], dense_train[4])
    live = torch.arange(9, device=cuda_device)[:, None, None] \
        < train[4][None, None]
    assert torch.equal(torch.where(live, train[3], 0.0),
                       torch.where(live, dense_train[3], 0.0))
    renders = [ttr.trace_fused(scene, tables, 8, o, d, 0.15, u8s, cuts=c)
               for c in ([], [4])]
    assert torch.equal(*renders)
    A_s, B_s, fl_s = step.trace_steps(scene, tables, 0.85, oT, dT, u8s)
    assert torch.equal(A, A_s) and torch.equal(B, B_s)
    assert torch.equal(fl, fl_s) and bool(fl.any())
    res = step.instance_resources(scene, tables, "trace_fwd")
    assert res["registers"] and res["warps_per_sm"] > 0


@pytest.mark.cuda
def test_box_walk_gate_keeps_the_old_instances(cuda_device, monkeypatch):
    """Scenes under the gate (hit3.box_culled: textured, no triangles, at
    least BOX_CULL_MIN valid boxes) launch their old instances: tex_dof,
    the small tex_blocks (16 boxes), the room and tex_mesh get no walk
    tables, and their instances' template flags carry no kBox; a walk
    table handed to a launch that cannot take one, a launch without its
    tables, or the box walk's whole render without its refill counters
    raises; a source that does not build raises."""
    for name, src in (("tex_dof", SCENES["tex_dof"]),
                      ("small", tex_scene("tex_blocks", small=True)),
                      ("room", SCENES["mixed"]),
                      ("tex_mesh", SCENES["tex_mesh"])):
        scene = compile_scene(schema.SceneConfig.from_json(src), cuda_device)
        tables = step.pack_step(scene)
        assert tables.box is None, name
    scene = _scene("tex_blocks", cuda_device)
    tables = step.pack_step(scene)
    o, d = _rays(256, cuda_device, name="tex_blocks")
    small = step.pack_step(compile_scene(schema.SceneConfig.from_json(
        tex_scene("tex_blocks", small=True)), cuda_device))
    with pytest.raises(ValueError):
        hit3.closest_hit(small.tab, small.layout, o, d, box=tables.box)
    packed = hit3._pack([0] * 19 + [256])
    with pytest.raises(RuntimeError):
        # n_bw > 0 with no tables: the entry point refuses the launch
        hit3.KERNEL.launch(packed[1], *[None if t is hit3._c_ptr else 0
                                        for t in hit3.KERNEL.argtypes[1:]])
    bad = type(hit3.KERNEL)("box_walk_bad", "box_walk.cuh", (), "nope", [])
    with pytest.raises(RuntimeError):
        bad.fn()
    # the box walk's whole render has only its refilling instance
    oT, dT = o.T.contiguous(), d.T.contiguous()
    u8s = torch.rand((3, step.n_uni(True), 256), device=cuda_device)
    hit0 = step.primary_hits(scene, tables, oT, dT)
    monkeypatch.setattr(step, "refills", lambda *_a: False)
    with pytest.raises(RuntimeError):
        step.trace_fwd(scene, tables, 0.85, oT, dT, u8s, hit0)


@pytest.mark.cuda
def test_box_walk_reads_rows_past_the_stage(cuda_device):
    """A 24 x 24 block grid (576 boxes, past hit3.BOX_STAGE_MAX): the
    kBox instances read the packed rows from global memory; closest_hit in
    every mode and the render instance still equal the dense instances
    bit for bit."""
    from chip_smoke import tex_blocks

    scene = compile_scene(schema.SceneConfig.from_json(
        tex_blocks(small=True, grid=24)), cuda_device)
    tables = step.pack_step(scene)
    assert tables.box is not None and tables.box.n > hit3.BOX_STAGE_MAX
    dense = tables._replace(box=None)
    o, d = _rays(1 << 14, cuda_device, seed=10, name="tex_blocks")
    for mode in (hit3.MODE_EXIT, hit3.MODE_ENTRY, hit3.MODE_ANY):
        got = hit3.closest_hit(tables.tab, tables.layout, o, d, mode,
                               box=tables.box)
        want = hit3.closest_hit(tables.tab, tables.layout, o, d, mode)
        for g, w in zip(got, want):
            assert torch.equal(g, w), mode
        if mode == hit3.MODE_ENTRY:
            assert int((got[1] >= tables.layout[0][-1][1]).sum()) > 1000
    oT, dT = o.T.contiguous(), d.T.contiguous()
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    u8s = torch.rand((9, step.n_uni(True), oT.shape[1]), generator=gen,
                     device=cuda_device)
    hit0 = step.primary_hits(scene, tables, oT, dT)
    got = step.trace_fwd(scene, tables, 0.85, oT, dT, u8s, hit0)
    want = step.trace_fwd(scene, dense, 0.85, oT, dT, u8s, hit0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# --- the record path and its differentiable closest hit ---------------------

REC_SCENES = {"mixed": MIXED, "mesh_glass": SCENES["mesh_glass"],
              "tex_blocks": SCENES["tex_blocks"],
              "inst_grid": SCENES["inst_grid"], "ties": TIES}


def _rec_args(name, device, n=1 << 14, seed=3):
    """The VJP's inputs on the card: the scene's tables, rays, the closest
    hit in the scene's mode and seeded cotangents (chip_smoke.py)."""
    from chip_smoke import hit_bwd_args

    scene = compile_scene(schema.SceneConfig.from_json(REC_SCENES[name]),
                          device)
    tables = step.pack_step(scene)
    o, d = _rays(n, device, seed, name)
    gen = torch.Generator(device=device).manual_seed(seed)
    return hit_bwd_args(scene, tables, o.contiguous(), d.contiguous(), gen)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(REC_SCENES))
def test_hit3_bwd_matches_winner_t_plain(name, cuda_device):
    """hit3_bwd against autograd of ``hit3.winner_t_plain`` (chip_smoke.py
    check_hit_bwd's rule: per-ray d_o, d_d rtol 1e-6 of the plain float32
    version, table cotangents rtol 1e-5 of the float64 plain sums, rays
    that float64 shows ill-conditioned left out, at most
    chip_smoke.ILL_BWD_SHARE)."""
    from chip_smoke import ILL_BWD_SHARE, check_hit_bwd

    args = _rec_args(name, cuda_device)
    hit3.BWD_KERNEL.launches = hit3.BWD_KERNEL.plain_calls = 0
    errs = check_hit_bwd(name, args)
    assert hit3.BWD_KERNEL.launches == 3
    assert errs["ill_share"] <= ILL_BWD_SHARE


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [hit3.MODE_EXIT, hit3.MODE_ENTRY])
def test_hit3_bwd_splits_box_edge_ties(mode, cuda_device):
    """Rays through a box's edges and corners (``edge_rays``: two or three
    slab axes attain the entry or exit t): hit3_bwd shares each tied t's
    cotangent evenly among the axes, as its plain version (autograd of
    ``amax`` / ``amin``) and the JAX package's VJP do; the table and
    per-ray cotangents within rtol 1e-5 / atol 1e-6."""
    from micro_raytracer_tpu_torch.ops import intersect

    scene = compile_scene(schema.SceneConfig.from_json(BOXES), cuda_device)
    tab = hit3.pack_scene(scene, intersect.build_frames(scene)).contiguous()
    layout = hit3.seg_layout(scene.kind_counts, scene.kind_sweep)
    o, d = (torch.from_numpy(a).to(cuda_device) for a in edge_rays())
    te, row, tx, xrow = hit3.closest_hit(tab, layout, o, d, mode)
    ct = torch.linspace(0.5, 1.5, 2 * o.shape[0],
                        device=cuda_device).view(2, -1)
    args = (tab, layout, o, d, mode, te, row, tx, xrow, ct[0], ct[1])
    got = hit3.closest_hit_bwd(*args)
    want = hit3.closest_hit_bwd_plain(*args)
    assert float(want[0][:, 9:15].abs().max()) > 0
    for j in (0, 2, 3):
        torch.testing.assert_close(got[j], want[j], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mixed", "mesh_glass", "inst_grid"])
def test_hit3_bwd_run_to_run(name, cuda_device):
    """Two launches give the same row cotangents and per-ray d_o, d_d bit
    for bit (float64 row sums rounded once; per-ray values in a fixed
    order)."""
    args = _rec_args(name, cuda_device, n=1 << 16, seed=4)
    a = hit3.closest_hit_bwd(*args)
    b = hit3.closest_hit_bwd(*args)
    for j in (0, 2, 3):            # d_tab, d_o, d_d
        assert torch.equal(a[j], b[j]), j
    if a[1] is not None:           # triangle rows: float32 atomics
        torch.testing.assert_close(a[1], b[1], rtol=1e-5,
                                   atol=1e-6 * float(a[1].abs().max()))
    assert float(a[0].abs().max()) > 0


@pytest.mark.cuda
def test_hit3_paths_past_the_staged_rows_match_plain(cuda_device):
    """The closest hit's kWalk instance with a 64-bit block mask
    (``inst_grid3k``: 3,384 rows in 53 blocks) and its kGlobal instance
    (``box_grid``: 2,116 untextured boxes; and a mesh past 256 cull blocks
    with the dense rows in global memory and its blocks read in place)
    against the plain sweep in every mode, rows and t bit for bit."""
    from chip_smoke import box_grid
    from micro_raytracer_tpu_torch.models import camera
    from micro_raytracer_tpu_torch.models.compiler import compile_camera

    cam = compile_camera(schema.CameraConfig.from_json(INST_CAMERA),
                         cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    n = 1 << 14
    o, d = camera.gen_rays(
        cam, (256, 256), torch.floor(torch.rand(
            (n, 2), generator=gen, device=cuda_device) * 256),
        torch.rand((n, 2), generator=gen, device=cuda_device))
    for src, walked in ((inst_scene("inst_grid3k"), True), (box_grid(), False),
                        (big_mesh(glass=True), False)):
        scene = compile_scene(schema.SceneConfig.from_json(src), cuda_device)
        t = step.pack_step(scene)
        assert (t.sbb is not None) == walked
        assert t.layout[1] > 2048 or hit3.tri_blocks(t.layout[2]) > 256
        for mode in (hit3.MODE_EXIT, hit3.MODE_ENTRY, hit3.MODE_ANY):
            tri_t = t.tri if t.layout[2] else None
            got = hit3.closest_hit(t.tab, t.layout, o, d, mode, tri_t, t.tbb,
                                   t.sbb, step._walk(t), t.box)
            want = hit3.closest_hit_plain(t.tab, t.layout, o, d, mode, tri_t,
                                          t.tbb, t.sbb, t.box)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (mode, walked)
            assert bool((got[0] < hit3.BIG * 0.5).any())


@pytest.mark.cuda
def test_no_fuse_runs_hit3_and_its_vjp_on_the_card(cuda_device, tmp_path,
                                                   monkeypatch):
    """MRT_NO_FUSE=1 on a CUDA device: the CLI's render launches hit3.cu
    (closest hit and shadows) and no whole-trace kernel; a training step
    launches hit3_bwd once a bounce; no plain version runs. A failed launch
    raises and nothing falls back."""
    from micro_raytracer_tpu_torch.models.compiler import compile_camera
    from micro_raytracer_tpu_torch.parallel import shard

    monkeypatch.setenv("MRT_NO_FUSE", "1")
    kernels = (hit3.KERNEL, hit3.BWD_KERNEL, step.KERNEL, step.TRAIN_KERNEL,
               step.BWD_KERNEL, step.STEP_KERNEL)
    for k in kernels:
        k.launches = k.plain_calls = 0
    out = tmp_path / "rec.png"
    assert cli.main(["--obj", "sphere", "--light", "point:", "-0.5", "-1",
                     "0.5", "--res", "32", "32", "--sample", "2",
                     "--bounce", "3", "--device", "cuda", "-o",
                     str(out)]) == 0 and out.exists()
    assert hit3.KERNEL.launches == 2 * 4 * 2
    assert [k.launches for k in kernels[2:]] == [0, 0, 0, 0]
    assert all(k.plain_calls == 0 for k in kernels)
    scene = _scene("mixed", cuda_device)
    cam = compile_camera(schema.CameraConfig.from_json({"pos": [0, -2, 0]}),
                         cuda_device)
    params, scene = shard.split_params(scene)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    ys, xs = torch.meshgrid(torch.arange(32.0), torch.arange(32.0),
                            indexing="ij")
    coords = torch.stack([xs.ravel(), ys.ravel()], -1).to(cuda_device)
    target = torch.rand((1024, 3), device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    ts = shard.make_train_step((32, 32), 3, device=cuda_device)
    for k in kernels:
        k.launches = k.plain_calls = 0
    loss, _new = ts.step(params, scene, cam, 0.15, coords, target, gen)
    assert torch.isfinite(loss)
    assert hit3.BWD_KERNEL.launches == 4
    assert [k.launches for k in kernels[2:]] == [0, 0, 0, 0]
    assert all(k.plain_calls == 0 for k in kernels)
    assert float(params["inst_pos"].grad.abs().max()) > 0

    def broken(*_a, **_k):
        raise RuntimeError("mrt_hit3_bwd launch failed: CUDA error 1")

    monkeypatch.setattr(hit3.BWD_KERNEL, "launch", broken)
    with pytest.raises(RuntimeError, match="hit3_bwd"):
        ts.step(params, scene, cam, 0.15, coords, target, gen)
    assert hit3.BWD_KERNEL.plain_calls == 0


# --- the closest hit's dense schedule and its VJP's one launch --------------

def _frame_rays(name, n, device, seed):
    """``n`` camera rays of the stand-in ``name`` (the room or a textured
    stand-in) at random pixels of its 1080x1080 frame."""
    from chip_smoke import camera_rays, rec_inputs

    _cfg, scene, tables, cam = rec_inputs(name, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    o, d = camera_rays(cam, n, gen, device)
    return scene, tables, o, d


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["room", "tex_dof"])
def test_dense_schedule_matches_plain_bit_for_bit(name, cuda_device):
    """The dense instance's schedule (``csrc/hit3.cu``
    closest_hit_dense_kernel: persistent blocks, staged rows, two rays a
    thread) against ``closest_hit_plain`` in every mode, te, row, tx and
    xrow bit for bit, at R = 1, 31, 257 and the frame + 3 (a last warp
    with one pair short), through the main path's wrapper
    (``step.hits``) and ``hit3.closest_hit``."""
    scene, tables, o, d = _frame_rays(name, 1080 * 1080 + 3, cuda_device, 5)
    assert not tables.layout[2] and tables.sbb is None and tables.box is None
    for R in (1, 31, 257, o.shape[0]):
        for mode in (hit3.MODE_EXIT, hit3.MODE_ENTRY, hit3.MODE_ANY):
            want = hit3.closest_hit_plain(tables.tab, tables.layout, o[:R],
                                          d[:R], mode)
            before = hit3.KERNEL.launches
            got = step.hits(tables, o[:R], d[:R], mode)
            again = hit3.closest_hit(tables.tab, tables.layout, o[:R],
                                     d[:R], mode)
            assert hit3.KERNEL.launches == before + 2
            for g, a, w in zip(got, again, want):
                assert torch.equal(g, w), (R, mode)
                assert torch.equal(a, w), (R, mode)
        if R > 1000:
            assert int((want[0] < hit3.BIG * 0.5).sum()) > R // 2


def _vjp_case(name, device, n, zero=False):
    """The VJP's inputs (chip_smoke.hit_bwd_args) of ``n`` rays of a scene
    of REC_SCENES, with zero cotangents where ``zero``."""
    args = list(_rec_args(name, device, n=n, seed=6))
    if zero:
        args[9] = torch.zeros_like(args[9])
        args[10] = torch.zeros_like(args[10])
    return args


def _assert_same_bwd(a, b, what):
    for j in (0, 2, 3):                 # d_tab, d_o, d_d
        assert torch.equal(a[j], b[j]), (what, j)
    assert (a[1] is None) == (b[1] is None), what
    if a[1] is not None:                # triangle rows: float32 atomics
        torch.testing.assert_close(a[1], b[1], rtol=1e-5,
                                   atol=1e-6 * float(b[1].abs().max()))


@pytest.mark.cuda
def test_hit3_bwd_back_to_back_equals_fresh(cuda_device):
    """hit3_bwd called back to back on scenes of different dense and
    triangle row counts, with all-zero cotangents and with R = 0, equals
    each call made alone on a fresh workspace; the workspace is zero after
    every call (the last block returns it to zero)."""
    cases = [("mesh_glass", 1 << 15, False), ("mixed", 1 << 14, False),
             ("inst_grid", 1 << 15, False), ("mixed", 1 << 14, True),
             ("mesh_glass", 0, False), ("ties", 4097, False),
             ("mesh_glass", 1 << 15, True)]
    args = [_vjp_case(n, cuda_device, r, z) for n, r, z in cases]
    fresh = []
    for a in args:
        hit3._BWD_WORKSPACE.clear()
        fresh.append(hit3.closest_hit_bwd(*a))
    for k, a in enumerate(args):
        assert float(fresh[k][0].abs().max()) > 0 or cases[k][1] == 0 \
            or cases[k][2]
        if cases[k][1] == 0 or cases[k][2]:
            assert int(torch.count_nonzero(fresh[k][0])) == 0
            assert int(torch.count_nonzero(fresh[k][2])) == 0
    for order in (range(len(args)), reversed(range(len(args)))):
        for k in order:
            got = hit3.closest_hit_bwd(*args[k])
            _assert_same_bwd(got, fresh[k], cases[k])
            torch.cuda.synchronize()
            for ws in hit3._BWD_WORKSPACE.values():
                assert int(torch.count_nonzero(ws)) == 0, cases[k]


def _device_ops(fn):
    """The device operations one call of ``fn`` launches (torch.profiler,
    after a warm-up call)."""
    from chip_smoke import _busy_share

    fn()
    torch.cuda.synchronize()
    return _busy_share(fn)[3]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["room", "mesh_glass"])
def test_hit_wrappers_launch_one_device_operation(name, cuda_device):
    """A profiled call of the primary-hit pass (``step.primary_hits``)
    launches exactly one device operation, and one of hit3_bwd's wrapper
    (``hit3.closest_hit_bwd``: the mask, the outputs and the finish in the
    kernel; no memset) at most two, and here one."""
    from chip_smoke import hit_bwd_args

    scene, tables, o, d = _frame_rays(name, 1 << 16, cuda_device, 7)
    oT, dT = o.T.contiguous(), d.T.contiguous()
    assert _device_ops(lambda: step.primary_hits(scene, tables, oT, dT)) \
        == 1
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    args = hit_bwd_args(scene, tables, oT.T, dT.T, gen)
    assert _device_ops(lambda: hit3.closest_hit_bwd(*args)) == 1


@pytest.mark.cuda
def test_mesh_renders_on_the_card(cuda_device):
    """``make_mesh`` past the machine's card count raises; the slice room
    over the card named twice renders the one-device framebuffer bit for
    bit as (dp, sp) = (2, 1) and within rtol 1e-5 as (1, 2), launching
    the closest hit and the whole trace once per sample and ray part."""
    from chip_smoke import SLICE_ARGS
    from micro_raytracer_tpu_torch.models.render import Renderer
    from micro_raytracer_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="the machine has"):
        make_mesh(torch.cuda.device_count() + 1)
    cfg = cli.parse_render(cli.build_parser().parse_args(
        SLICE_ARGS + ["--res", "64", "64", "--sample", "4"]))
    fbs = []
    for mesh in (None, make_mesh(2, sp=1, device=[cuda_device] * 2),
                 make_mesh(2, sp=2, device=[cuda_device] * 2)):
        hit3.KERNEL.launches = step.KERNEL.launches = 0
        r = Renderer(cfg, seed=3, device=cuda_device, mesh=mesh)
        r.execute_many(4)
        dp = 1 if mesh is None else mesh.shape["dp"]
        assert hit3.KERNEL.launches == step.KERNEL.launches == 4 * dp
        fbs.append(r.framebuffer())
    np.testing.assert_array_equal(fbs[1], fbs[0])
    np.testing.assert_allclose(fbs[2], fbs[0], rtol=1e-5, atol=1e-6)
    assert float(fbs[0].sum()) > 0


@pytest.mark.cuda
def test_mesh_renders_and_trains_on_distinct_cards(cuda_device):
    """On a machine with two or more cards: the slice room rendered on card
    1 equals card 0's bit for bit; over the first two (or four) cards as
    (dp, sp) = (2, 1) (and (4, 1)) it equals it bit for bit, as (1, 2)
    (and (2, 2)) within rtol 1e-5, each card launching the closest hit
    and the whole trace once per sample of its ray part; a dp = 2
    training step over cards 0 and 1 gives the loss and gradients of the
    same step over card 0 named twice within rtol 1e-5."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more cards")
    from chip_smoke import SLICE_ARGS
    from micro_raytracer_tpu_torch.models.compiler import compile_camera
    from micro_raytracer_tpu_torch.models.render import Renderer
    from micro_raytracer_tpu_torch.parallel import shard
    from micro_raytracer_tpu_torch.parallel.mesh import make_mesh

    cfg = cli.parse_render(cli.build_parser().parse_args(
        SLICE_ARGS + ["--res", "64", "64", "--sample", "4"]))

    def render(**kw):
        hit3.KERNEL.launches = step.KERNEL.launches = 0
        r = Renderer(cfg, seed=3, **kw)
        r.execute_many(4)
        return r.framebuffer(), hit3.KERNEL.launches, step.KERNEL.launches

    one = render(device="cuda:0")[0]
    np.testing.assert_array_equal(render(device="cuda:1")[0], one)
    meshes = [(2, 1), (2, 2)] + ([(4, 1), (4, 2)] if n >= 4 else [])
    for k, sp in meshes:
        mesh = make_mesh(k, sp=sp)
        fb, n_hit, n_step = render(mesh=mesh)
        assert n_hit == n_step == 4 * mesh.shape["dp"]
        if sp == 1:
            np.testing.assert_array_equal(fb, one)
        else:
            np.testing.assert_allclose(fb, one, rtol=1e-5, atol=1e-6)
    scene = compile_scene(cfg.scene, "cuda:0")
    cam = compile_camera(cfg.frame.cam, "cuda:0")
    R = 4096
    ys, xs = np.divmod(np.arange(R), 64)
    coords = torch.from_numpy(np.stack([xs, ys], -1).astype(
        np.float32)).to("cuda:0")
    gen = torch.Generator(device="cuda:0").manual_seed(4)
    u_aprt, u8s = ttr.draw_uniforms(gen, R, cfg.rt.bounce,
                                    scene.any_refract, coords.device)
    target = torch.full((R, 3), 0.2, device="cuda:0")
    out = []
    for devs in (["cuda:0", "cuda:0"], ["cuda:0", "cuda:1"]):
        ts = shard.make_train_step(cfg.frame.render_res, cfg.rt.bounce,
                                   mesh=make_mesh(2, sp=1, device=devs))
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in shard.split_params(scene)[0].items()}
        loss, _new = ts.step_u(params, scene, cam, cfg.rt.loss, coords,
                               target, u_aprt[None], u8s[None])
        out.append((loss, {k: p.grad for k, p in params.items()}))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=1e-5, atol=0)
    for k, w in out[0][1].items():
        g = out[1][1][k]
        assert (g is None) == (w is None), k
        if w is not None:
            torch.testing.assert_close(
                g, w, rtol=1e-5, atol=1e-6 * float(w.abs().max()) + 1e-12)


_NCCL_WORKER = r"""
import json, sys
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[1])
from micro_raytracer_tpu_torch.parallel import distributed
assert distributed.initialize(device="cuda")
t = torch.tensor([float(dist.get_rank() + 1)], device="cuda")
dist.all_reduce(t)
print(json.dumps({"slice": distributed.local_slice(11),
                  "primary": distributed.is_primary(), "sum": float(t),
                  "card": torch.cuda.current_device()}))
dist.destroy_process_group()
"""


@pytest.mark.cuda
def test_two_processes_over_nccl(cuda_device):
    """On a machine with two or more cards: two processes joined by
    ``distributed.initialize`` over nccl (a localhost address, a 120 s
    limit each) take cards 0 and 1, an all-reduce on the cards sees
    both, and their slices of 11 cover it."""
    import json
    import os
    import socket
    import subprocess
    import sys

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank))
        env.pop("LOCAL_RANK", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _NCCL_WORKER, root], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    assert [o["card"] for o in outs] == [0, 1]
    assert [o["sum"] for o in outs] == [3.0, 3.0]
    assert [o["primary"] for o in outs] == [True, False]
    assert [tuple(o["slice"]) for o in outs] == [(0, 6), (6, 11)]
