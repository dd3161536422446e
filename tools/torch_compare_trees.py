#!/usr/bin/env python3
"""Compare the port's room, mesh and textured kernels between two
checkouts, on one NVIDIA GPU: the same inputs through each tree's kernels,
then every output compared.

    python3 tools/torch_compare_trees.py dump <tree> <out.pt>
    python3 tools/torch_compare_trees.py compare <a.pt> <b.pt>
    python3 tools/torch_compare_trees.py time <tree> <tag>

``dump`` imports the package and ``chip_smoke.py`` of ``<tree>`` and runs,
on the slice room, the two mesh scenes, the two textured and the
Instance-class stand-ins of ``chip_smoke.py``, 2^18 camera rays (seed 31)
through the primary-hit pass, both instances of the trace kernel and the
backward kernel, and on its per-step stand-ins (where it has them) one step
of both instances of the step kernel from the primaries, a second step,
and the step's backward; it saves every output (a step's residuals on the
rays that hit, the rest unwritten). ``compare``
holds two dumps equal: every per-ray output bit for bit, the table
cotangents (shared-memory and atomic sums in no fixed order) within rtol
1e-5 and 1e-6 of the largest magnitude. It exits 1 when they differ.
``time`` builds ``<tree>``'s kernels and prints ``<tag>`` and one JSON
object: the CUDA-event ms of each kernel (``chip_smoke.cuda_ms``) at the
full frame of each scene that tree's ``chip_smoke.py`` has (the room, the
mesh scenes and, where present, the textured, Instance-class and per-step
stand-ins; the step kernels at step 0). Run the trees
interleaved in one call (parent, change, change, parent) to compare them.
"""

import json
import os
import sys

NAMES = ("te0", "row0", "tx0", "xrow0", "A", "B", "first_live", "A_train",
         "B_train", "first_live_train", "resid", "n_live", "d_oT", "d_dT",
         "d_tab", "d_lights", "d_tri")
STEP_OUTS = ("c1", "hit", "c1_train", "hit_train", "resid", "c2", "d_tab",
             "d_lights", "d_c0", "d_tri")
SUMS = ("d_tab", "d_lights", "d_tri")


def dump(tree, out):
    out = os.path.abspath(out)
    sys.path.insert(0, os.path.abspath(tree))
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from micro_raytracer_tpu_torch.models import tracer
    from micro_raytracer_tpu_torch.models.compiler import (compile_camera,
                                                           compile_scene)
    from micro_raytracer_tpu_torch.ops import step

    dev = torch.device("cuda")
    res = {}
    for name in ("room", "mesh_glass", "mesh_opaque", *cs.TEX_NAMES,
                 *getattr(cs, "INST_NAMES", ())):
        cfg = _config(cs, name)
        scene = compile_scene(cfg.scene, dev)
        tables = step.pack_step(scene)
        decay = tracer.decay_of(cfg.rt.loss)
        gen = torch.Generator(device=dev).manual_seed(31)
        o, d = cs.camera_rays(compile_camera(cfg.frame.cam, dev), 1 << 18,
                              gen, dev)
        oT, dT = o.T.contiguous(), d.T.contiguous()
        u8s = torch.rand((cs.BOUNCE + 1, step.n_uni(scene.any_refract),
                          oT.shape[1]), generator=gen, device=dev)
        hit0 = step.primary_hits(scene, tables, oT, dT)
        fwd = step.trace_fwd(scene, tables, decay, oT, dT, u8s, hit0)
        train = step.trace_fwd_train(scene, tables, decay, oT, dT, u8s, hit0)
        ctA, ctB = (torch.randn((3, oT.shape[1]), generator=gen, device=dev)
                    for _ in range(2))
        g = step.trace_bwd(scene, tables, decay, u8s, train[3], train[4],
                           ctA, ctB)
        res[name] = dict(zip(NAMES, [t.cpu() for t in (
            *hit0, *fwd, *train, g[2], g[3], g[0], g[1], g[4])]))
    for name in getattr(cs, "STEP_NAMES", ()):
        cfg = cs.step_config(name)
        scene = compile_scene(cfg.scene, dev)
        tables = step.pack_step(scene)
        decay = tracer.decay_of(cfg.rt.loss)
        gen = torch.Generator(device=dev).manual_seed(31)
        o, d = cs.camera_rays(compile_camera(cfg.frame.cam, dev), 1 << 18,
                              gen, dev)
        c0 = step.primary_carry(o.T.contiguous(), d.T.contiguous())
        u8 = torch.rand((step.n_uni(scene.any_refract), c0.shape[1]),
                        generator=gen, device=dev)
        c1, hit = step.step_fwd(scene, tables, decay, c0, u8)
        c1t, hitt, resid = step.step_fwd_train(scene, tables, decay, c0, u8)
        c2 = step.step_fwd(scene, tables, decay, c1, u8)[0]
        ct1 = torch.randn(c0.shape, generator=gen, device=dev)
        g = step.step_bwd(scene, tables, decay, c0, u8, resid, hitt, ct1)
        res[name] = dict(zip(STEP_OUTS, [t.cpu() for t in (
            c1, hit, c1t, hitt, resid[:, hitt[0] > 0.5], c2, g[0], g[1],
            g[2], g[3])]))
    torch.save(res, out)


def _config(cs, name):
    """The render config of a scene of a tree's ``chip_smoke.py``."""
    if name == "room":
        return cs.slice_config()
    if name.startswith("tex"):
        return cs.tex_config(name)
    if name.startswith("inst"):
        return cs.inst_config(name)
    return cs.mesh_config(name)


def time_tree(tree, tag):
    sys.path.insert(0, os.path.abspath(tree))
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from micro_raytracer_tpu_torch.models import tracer
    from micro_raytracer_tpu_torch.models.compiler import compile_scene
    from micro_raytracer_tpu_torch.ops import hit3, step

    dev = torch.device("cuda")
    cs.phase_build()
    names = ["room", *cs.MESH_NAMES, *getattr(cs, "TEX_NAMES", ()),
             *getattr(cs, "INST_NAMES", ())]
    out = _time_steps(cs, dev)
    for name in names:
        cfg = _config(cs, name)
        scene = compile_scene(cfg.scene, dev)
        tables = step.pack_step(scene)
        decay = tracer.decay_of(cfg.rt.loss)
        gen = torch.Generator(device=dev).manual_seed(2)
        oT, dT = cs.main_path_rays(cfg, gen, dev)
        u8s = torch.rand((cs.BOUNCE + 1, step.n_uni(scene.any_refract),
                          oT.shape[1]), generator=gen, device=dev)
        hit0 = step.primary_hits(scene, tables, oT, dT)
        res = step.trace_fwd_train(scene, tables, decay, oT, dT, u8s, hit0)
        ct = torch.randn((3, oT.shape[1]), generator=gen, device=dev)
        args = (tables.tab, tables.layout, oT.T, dT.T,
                step.primary_mode(scene), tables.tri, tables.tbb)
        if getattr(tables, "sbb", None) is not None:
            args += (tables.sbb,)
        out[name] = {
            "trace_fwd": cs.cuda_ms(lambda: step.trace_fwd(
                scene, tables, decay, oT, dT, u8s, hit0), 10),
            "trace_fwd_train": cs.cuda_ms(lambda: step.trace_fwd_train(
                scene, tables, decay, oT, dT, u8s, hit0), 10),
            "trace_bwd": cs.cuda_ms(lambda: step.trace_bwd(
                scene, tables, decay, u8s, res[3], res[4], ct, ct), 10),
            "closest_hit": cs.cuda_ms(lambda: hit3.closest_hit(*args), 20)}
    print(tag, json.dumps(out), flush=True)


def _time_steps(cs, dev):
    """The step kernels' ms at step 0 of the frame of each per-step
    stand-in of the tree's chip_smoke.py."""
    import torch

    from micro_raytracer_tpu_torch.models import tracer
    from micro_raytracer_tpu_torch.models.compiler import compile_scene
    from micro_raytracer_tpu_torch.ops import step

    out = {}
    for name in getattr(cs, "STEP_NAMES", ()):
        cfg = cs.step_config(name)
        scene = compile_scene(cfg.scene, dev)
        tables = step.pack_step(scene)
        decay = tracer.decay_of(cfg.rt.loss)
        gen = torch.Generator(device=dev).manual_seed(2)
        c0 = step.primary_carry(*cs.main_path_rays(cfg, gen, dev))
        u8 = torch.rand((step.n_uni(scene.any_refract), c0.shape[1]),
                        generator=gen, device=dev)
        _c1, hit, resid = step.step_fwd_train(scene, tables, decay, c0, u8)
        ct1 = torch.randn(c0.shape, generator=gen, device=dev)
        out[name] = {
            "step_fwd": cs.cuda_ms(lambda: step.step_fwd(
                scene, tables, decay, c0, u8), 10),
            "step_fwd_train": cs.cuda_ms(lambda: step.step_fwd_train(
                scene, tables, decay, c0, u8), 10),
            "step_bwd": cs.cuda_ms(lambda: step.step_bwd(
                scene, tables, decay, c0, u8, resid, hit, ct1), 10)}
    return out


def compare(a_path, b_path):
    import torch

    a, b = torch.load(a_path), torch.load(b_path)
    same = True
    for scene in a:
        for name in a[scene]:
            x, y = a[scene][name], b[scene][name]
            if name in SUMS:
                scale = float(y.abs().max()) if y.numel() else 0.0
                ok = torch.allclose(x, y, rtol=1e-5,
                                    atol=1e-6 * max(scale, 1e-30))
            else:
                ok = torch.equal(x, y)
            print(f"{scene} {name}: {'equal' if ok else 'DIFFERS'}")
            same &= ok
    print("ALL SAME" if same else "OUTPUTS DIFFER")
    return 0 if same else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["dump"] and len(sys.argv) == 4:
        dump(*sys.argv[2:])
    elif sys.argv[1:2] == ["compare"] and len(sys.argv) == 4:
        sys.exit(compare(*sys.argv[2:]))
    elif sys.argv[1:2] == ["time"] and len(sys.argv) == 4:
        time_tree(*sys.argv[2:])
    else:
        sys.exit(__doc__)
