#!/usr/bin/env python3
"""Compare the port's room, mesh and textured kernels between two
checkouts, on one NVIDIA GPU: the same inputs through each tree's kernels,
then every output compared.

    python3 tools/torch_compare_trees.py dump <tree> <out.pt>
    python3 tools/torch_compare_trees.py compare <a.pt> <b.pt>
    python3 tools/torch_compare_trees.py time <tree> <tag> [scene ...]
    python3 tools/torch_compare_trees.py ablate <tree> <workdir>
    python3 tools/torch_compare_trees.py ablate <tree> <workdir> tri|walk
    python3 tools/torch_compare_trees.py big_main <tree> <tag>
    python3 tools/torch_compare_trees.py pairs <tree_a> <tree_b> [pairs]
    python3 tools/torch_compare_trees.py reference <tree> <out.pt> <scene>...

``dump`` imports the package and ``chip_smoke.py`` of ``<tree>`` and runs,
on the slice room, the two mesh scenes, the two textured and the
Instance-class stand-ins of ``chip_smoke.py``, 2^18 camera rays (seed 31)
through the primary-hit pass, both instances of the trace kernel and the
backward kernel, and on its per-step stand-ins (where it has them) one step
of both instances of the step kernel from the primaries, a second step,
and the step's backward, and on its big meshes (``mesh_big``,
``mesh_big_glass``) rows 6, 7 (every row refracting, and the step's
refracting rows) and 8 on 2^18 camera rays at steps 0 and 2 and on 2^17
random rays; it saves every output (a step's residuals on the
rays that hit, the rest unwritten). ``compare``
holds two dumps equal: every per-ray output bit for bit (row 7's exit
outputs, culled since the two-level walk, are reported where they differ
and not held: ``chip_smoke.py`` phase 22 shows each such ray a phantom),
the table cotangents (shared-memory and atomic sums in no fixed order)
within rtol 1e-5 and 1e-6 of the largest magnitude, each sum's worst entry
printed;
where a row- or light-table sum differs, it also prints how far each
tree's own sum moves when the backward runs on the two halves of the rays
and the halves are added in float64 (the dump keeps those sums). It exits
1 when they differ.
``time`` builds ``<tree>``'s kernels and prints ``<tag>`` and one JSON
object: the CUDA-event ms of each kernel (``chip_smoke.cuda_ms``) at the
full frame of each scene that tree's ``chip_smoke.py`` has (the room, the
mesh scenes and, where present, the textured, Instance-class and per-step
stand-ins; the step kernels at step 0; where a render runs in segments,
their summed time; on the big meshes rows 6 / 7 at each of a sample's
nine steps of the frame, row 8 at step 0 and the whole step at step 0),
or at the scenes named (``big`` for the big meshes), and the registers
and spills ``ptxas`` gave each whole-trace kernel instance and the
triangle kernels.
Run the trees interleaved in one call (parent, change, change, parent) to
compare them.

``ablate`` attributes the room's whole-trace kernel times: it copies
``<tree>`` into ``<workdir>`` once per variant of ``csrc/trace_fwd.cu`` or
``csrc/trace_bwd.cu`` (``ABLATIONS``: on the single-thread-per-ray
kernels the shadow sweeps removed, the refract side removed, 64 / 128 /
256 threads per block under ``__launch_bounds__``, the backward's shared
atomics made plain adds; on the redesigned backward its register cap
lifted or its warp sums taken from 4 or 16 lanes of a shared row, 4 of a
global one), builds the variants in parallel, times each as ``time``
does on the room and ``inst_grid`` (interleaved, the unchanged tree first and last), and prints the room's
live-step histogram from the train instance's ``n_live`` with the
warp-max over warp-mean ratio. A variant whose anchor text the tree does
not hold is reported as not applicable. The variants are for timing only:
their outputs are wrong.

``ablate <tree> <workdir> tri`` times variants of the triangle
kernels instead (``TRI_ABLATIONS``: the one-level walk with its rows
removed, its slab tests removed, or row 7's exit removed) on the big
meshes, and prints the walk's per-ray work at each step
(``_walk_stats``); ``walk`` the two-level walk's options
(``TRI_WALK_ABLATIONS``).

``big_main`` runs a tree's big-mesh main path (``chip_smoke.py`` phases
23-24: the CLI renders of the three big scenes, one HTTP request, 3
training steps of ``mesh_big``); run two trees interleaved in one call.

``pairs`` times the room's main path end to end in two trees at once: a
worker process per tree (its package and ``chip_smoke.py``) sets up the
training step (``chip_smoke.train_setup``, ``make_train_step``) and the
CLI render, warms both, and then, ``pairs`` times (10 by default), each
tree in turn, alternating which goes first (a, b, b, a, ...), takes three
training steps from the same leaves (each timed to a synchronize) and one
16-spp CLI render (``chip_smoke.render_cli``). It prints each tree's
per-pair step means and render rays/s, their medians, and in how many
pairs ``b`` was the faster.

``reference`` holds a tree's backward table sums against a float64
reference on ``dump``'s inputs (the same rays, uniforms and cotangents)
for each scene named: the plain trace (``step.trace_plain``) in float64
over the same rays gives each ray's path; the rays whose path (live
steps, winner rows, refract choices, occlusion bits) is the float32
train kernel's form the subset on which autograd of the plain trace in
float64 (``step.trace_bwd_plain``) gives the reference sums, and the
tree's backward kernel runs on the same subset. It prints, for d_tab and
d_lights, the entry farthest from the reference in units of ``compare``'s
tolerance and every light entry; ``<out.pt>`` keeps the sums.
"""

import json
import os
import re
import shutil
import subprocess
import sys

NAMES = ("te0", "row0", "tx0", "xrow0", "A", "B", "first_live", "A_train",
         "B_train", "first_live_train", "resid", "n_live", "d_oT", "d_dT",
         "d_tab", "d_lights", "d_tri")
STEP_OUTS = ("c1", "hit", "c1_train", "hit_train", "resid", "c2", "d_tab",
             "d_lights", "d_c0", "d_tri")
SUMS = ("d_tab", "d_lights", "d_tri")
SPLIT = "_split"   # a sum from the rays' two halves, added in float64


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
        # the same sums from the two halves of the rays, added in float64:
        # how far the tree's own rounding moves them
        h, R = oT.shape[1] // 2, oT.shape[1]
        halves = [step.trace_bwd(
            scene, tables, decay, u8s[..., s].contiguous(),
            train[3][..., s].contiguous(), train[4][s].contiguous(),
            ctA[:, s].contiguous(), ctB[:, s].contiguous())
            for s in (slice(0, h), slice(h, R))]
        for j, key in ((0, "d_tab"), (1, "d_lights")):
            res[name][key + SPLIT] = (halves[0][j].double()
                                      + halves[1][j].double()).cpu()
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
    for name in getattr(cs, "BIG_NAMES", ()):
        cfg, scene, tables, decay = _big_setup(cs, name, dev)
        gen = torch.Generator(device=dev).manual_seed(31)
        o, d = cs.camera_rays(compile_camera(cfg.frame.cam, dev), 1 << 18,
                              gen, dev)
        carries = _big_carries(cs, scene, tables, decay, o.T.contiguous(),
                               d.T.contiguous(), gen, 3)
        o, d = cs.random_rays(1 << 17, gen, dev)
        rand = step.primary_carry((o * cs.BIG_SCALE).T.contiguous(),
                                  d.T.contiguous())
        res[name] = {}
        for tag, c in (("step0", carries[0]), ("step2", carries[2]),
                       ("random", rand)):
            for key, v in _tri_rows(tables, c).items():
                res[name][f"{tag}_{key}"] = v.cpu()
    torch.save(res, out)


# --- the triangle segment (rows 6-8) on the big scenes -----------------------

# row 7's exit outputs: the culled exit (since rows 6-7's two-level walk) may
# differ from an unculled one on a phantom exit hit, outside its block's
# AABB (chip_smoke.py phase 22 shows each such ray); compare reports them
CULLED_EXIT = ("ee_tx", "ee_xrow", "eer_tx", "eer_xrow")


def _big_setup(cs, name, dev):
    """(cfg, scene, tables, decay) of a big scene of a tree's
    ``chip_smoke.py``, built from its JSON and OBJ files."""
    import tempfile

    cfg = cs.big_render_config(name, tempfile.mkdtemp(prefix="cmp_big_"))[0]
    scene, tables, decay, _cam = cs.big_inputs(cfg, dev)
    return cfg, scene, tables, decay


def _big_carries(cs, scene, tables, decay, oT, dT, gen, steps):
    """The carries of ``steps`` bounce steps of the rays ``oT``, ``dT``
    (3, R), stepped by the tree's step_fwd (step 0 first)."""
    import torch

    from micro_raytracer_tpu_torch.ops import step

    u8s = torch.rand((steps, step.n_uni(scene.any_refract), oT.shape[1]),
                     generator=gen, device=oT.device)
    out = [step.primary_carry(oT, dT)]
    for k in range(steps - 1):
        out.append(step.step_fwd(scene, tables, decay, out[-1], u8s[k])[0])
    return out


def _cull_kw(tables):
    """The tri wrappers' superblock argument where the tree has one."""
    tsb = getattr(tables, "tsb", None)
    return {} if tsb is None else {"tsb": tsb}


def _tri_rows(tables, c, live=None):
    """Rows 6, 7 (every row refracting, and the step's refracting rows)
    and 8 (fed row 6's winner groups) on the carry ``c``'s rays:
    ``{output: tensor}``."""
    import torch

    from micro_raytracer_tpu_torch.ops import hit3, step, tri

    t, tbb, n = tables.tri.detach(), tables.tbb, tables.layout[3]
    o, d = c[0:3].T, c[3:6].T
    live = c[step.C_LIVE] if live is None else live
    kw = _cull_kw(tables)
    te, row = tri.tri_entry(t, o, d, tbb, n, live, **kw)
    ee = tri.tri_entry_exit(t, o, d, tbb, n, live, **kw)
    eer = tri.tri_entry_exit(t, o, d, tbb, n, live,
                             refr=step.tri_refracts(tables), **kw)
    wg = torch.where(te < tri.BIG * 0.5, t[row.long(), hit3._T_GID],
                     -5.0).contiguous()
    gx = tri.tri_group_exit(t, o, d, wg, n, live)
    return dict(zip(("e_te", "e_row", "ee_te", "ee_row", "ee_tx", "ee_xrow",
                     "eer_te", "eer_row", "eer_tx", "eer_xrow", "gx_tx",
                     "gx_xrow"), (te, row, *ee, *eer, *gx)))


def _time_big(cs, dev, rows_only=False):
    """Rows 6 / 7 at each of a sample's nine steps of the frame (step 0
    first; ``step.tri_hits``, the main path's call), row 8 at step 0 fed
    row 6's winner groups, and the kTriIn step_fwd at step 0, on each big
    scene of the tree's ``chip_smoke.py``. ``rows_only``: the
    ``tri_rows_only`` variant, fed each ray's winner block in its live
    row."""
    import torch

    from micro_raytracer_tpu_torch.ops import hit3, step, tri

    out = {}
    for name in getattr(cs, "BIG_NAMES", ()):
        cfg, scene, tables, decay = _big_setup(cs, name, dev)
        gen = torch.Generator(device=dev).manual_seed(2)
        carries = _big_carries(cs, scene, tables, decay,
                               *cs.main_path_rays(cfg, gen, dev), gen,
                               cs.BOUNCE + 1)
        t, tbb, n = tables.tri.detach(), tables.tbb, tables.layout[3]
        ms = []
        for c in carries:
            if rows_only:
                te, row = step.tri_hits(scene, tables, c)[:2]
                live = torch.where(te < tri.BIG * 0.5,
                                   2.0 + (row // hit3.CB).float(), 1.6)
                live = torch.where(c[step.C_LIVE] > 0.5, live, 0.0)
                sweep = tri.tri_entry_exit if scene.any_refract \
                    else tri.tri_entry
                kw = {"refr": step.tri_refracts(tables)} \
                    if scene.any_refract else {}
                ms.append(cs.cuda_ms(lambda c=c, live=live: sweep(
                    t, c[0:3].T, c[3:6].T, tbb, n, live.contiguous(),
                    **kw), 3))
            else:
                ms.append(cs.cuda_ms(
                    lambda c=c: step.tri_hits(scene, tables, c), 3))
        c0 = carries[0]
        te, row = step.tri_hits(scene, tables, c0)[:2]
        wg = torch.where(te < tri.BIG * 0.5, t[row.long(), hit3._T_GID],
                         -5.0).contiguous()
        u8 = torch.rand((step.n_uni(scene.any_refract), c0.shape[1]),
                        generator=gen, device=dev)
        out[name] = {
            "tri_step_ms": ms, "tri_sample_ms": sum(ms),
            "tri_exit_ms": cs.cuda_ms(lambda: tri.tri_group_exit(
                t, c0[0:3].T, c0[3:6].T, wg, n), 3),
            "step_fwd_ms": cs.cuda_ms(lambda: step.step_fwd(
                scene, tables, decay, c0, u8), 3)}
        del carries
    return out


def _walk_stats(cs, dev):
    """Per-ray work of the triangle walk at each of a sample's nine steps
    of each big scene, on 4,096 warps (32 consecutive rays of the frame's
    Morton order) drawn at random: block AABBs the ray touches before its
    best t (the one-level walk sweeps their rows), the union and the
    busiest lane of a warp, superblocks of 16 and 32 blocks touched at all,
    and the winner group's exit rows (unculled) against the blocks a
    refracting winner's ray meets at all (an upper bound of the culled
    exit's). From the plain sweeps, on the tree's own tables."""
    import torch

    from micro_raytracer_tpu_torch.ops import hit3, step, tri

    BIG = hit3.BIG
    out = {}
    for name in getattr(cs, "BIG_NAMES", ()):
        cfg, scene, tables, decay = _big_setup(cs, name, dev)
        gen = torch.Generator(device=dev).manual_seed(2)
        carries = _big_carries(cs, scene, tables, decay,
                               *cs.main_path_rays(cfg, gen, dev), gen,
                               cs.BOUNCE + 1)
        t, tbb, n = tables.tri.detach(), tables.tbb, tables.layout[3]
        nb = tbb.shape[0]
        R = carries[0].shape[1]
        g = torch.Generator().manual_seed(5)
        warps = torch.randperm(R // 32, generator=g)[:4096].sort().values
        sub = (warps[:, None] * 32 + torch.arange(32)).flatten().to(dev)
        refr = step.tri_refracts(tables)
        sups = {}
        for sb in (16, 32):
            pad = (-nb) % sb
            lo = torch.minimum(tbb[:, :3], tbb[:, 3:6])
            hi = torch.maximum(tbb[:, :3], tbb[:, 3:6])
            lo = torch.cat([lo, lo[-1:].expand(pad, 3)]).view(-1, sb, 3)
            hi = torch.cat([hi, hi[-1:].expand(pad, 3)]).view(-1, sb, 3)
            sups[sb] = torch.cat([lo.amin(1), hi.amax(1)], 1)
        steps = []
        for c in carries:
            cs_ = c[:, sub]
            o, d = cs_[0:3].T.contiguous(), cs_[3:6].T.contiguous()
            live = cs_[step.C_LIVE] > 0.5
            invd = hit3._inv_dir(d)
            best = torch.full((o.shape[0],), BIG, device=dev)
            touched = torch.zeros((o.shape[0], nb), dtype=torch.bool,
                                  device=dev)
            ever = torch.zeros_like(touched)
            big = torch.full_like(best, BIG)
            for b, (lo, hi) in enumerate(hit3._blocks(n)):
                tt, ok = hit3._tri_block(t[lo:hi], o, d)
                touch = hit3._slab_touch(tbb[b], o, invd, best) & live
                ever[:, b] = hit3._slab_touch(tbb[b], o, invd, big) & live
                touched[:, b] = touch
                bm = torch.where(ok & touch[:, None], tt, BIG).amin(1)
                best = torch.minimum(best, bm)
            te, row = tri.entry_plain(t, o, d, tbb, n,
                                      cs_[step.C_LIVE].contiguous())
            hit = te < BIG * 0.5
            k = touched.sum(1).float()
            wk = touched.view(-1, 32, nb)
            rec = {"live": float(live.float().mean()),
                   "hit": float(hit.float().mean()),
                   "blocks": float(k.mean()),
                   "rows": float(k.mean() * hit3.CB),
                   "warp_union_blocks": float(wk.any(1).sum(1).float()
                                              .mean()),
                   "warp_max_blocks": float(k.view(-1, 32).amax(1).mean())}
            for sb, sbb in sups.items():
                s_t = torch.stack([hit3._slab_touch(sbb[s], o, invd, big)
                                   & live for s in range(sbb.shape[0])], 1)
                rec[f"sup{sb}"] = float(s_t.sum(1).float().mean())
                rec[f"sup{sb}_warp_union"] = float(
                    s_t.view(-1, 32, sbb.shape[0]).any(1).sum(1).float()
                    .mean())
            if scene.any_refract:
                w = row.long()
                xr = hit & (refr[w] > 0.5)
                span = (t[w, hit3._T_GE].clamp(max=n)
                        - t[w, hit3._T_GS]).float()
                rec["exit_share"] = float(xr.float().mean())
                rec["exit_rows_unculled"] = float(
                    torch.where(xr, span, 0.0).mean())
                rec["exit_blocks_met"] = float(
                    torch.where(xr, ever.sum(1).float(), 0.0).mean())
                rec["exit_warp_share"] = float(
                    xr.view(-1, 32).any(1).float().mean())
            steps.append(rec)
        out[name] = steps
        del carries
    return out


def _config(cs, name):
    """The render config of a scene of a tree's ``chip_smoke.py``."""
    if name == "room":
        return cs.slice_config()
    if name.startswith("tex"):
        return cs.tex_config(name)
    if name.startswith("inst"):
        return cs.inst_config(name)
    return cs.mesh_config(name)


def time_tree(tree, tag, *only):
    sys.path.insert(0, os.path.abspath(tree))
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from micro_raytracer_tpu_torch.models import tracer
    from micro_raytracer_tpu_torch.models.compiler import compile_scene
    from micro_raytracer_tpu_torch.ops import hit3, step, tri

    dev = torch.device("cuda")
    if only:
        for k in (hit3.KERNEL, step.KERNEL, step.TRAIN_KERNEL,
                  step.BWD_KERNEL, step.STEP_KERNEL, tri.ENTRY_KERNEL):
            k.fn()
    else:
        cs.phase_build()
    names = ["room", *cs.MESH_NAMES, *getattr(cs, "TEX_NAMES", ()),
             *getattr(cs, "INST_NAMES", ())]
    names = [n for n in names if not only or n in only]
    out = {} if only else _time_steps(cs, dev)
    out["ptxas"] = {**ptxas_table(step.KERNEL.build_log),
                    **ptxas_table(step.BWD_KERNEL.build_log)}
    if not only or "big" in only:
        out["big"] = _time_big(cs, dev)
        out["ptxas"].update(tri_ptxas(tri.ENTRY_KERNEL.build_log))
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
        # where the render runs in segments (tracer.compact_cuts), their
        # summed kernel time: the segment instances
        seg = cs.check_segmented(name, scene, tables, decay, cfg.rt.loss, oT,
                                 dT, u8s, hit0, out[name]["trace_fwd"])
        if seg:
            out[name]["trace_fwd_segments"] = seg["ms"]
    print(tag, json.dumps(out), flush=True)


def ptxas_table(log):
    """``{kernel<template flags>: [registers, spill stores, spill loads]}``
    for the whole-trace kernels of an ``nvcc -Xptxas -v`` log."""
    out = {}
    for name, v in _ptxas(log).items():
        k = re.search(r"(trace_(?:fwd|bwd)_kernel)I((?:Lb[01]E)+)", name)
        if k:
            flags = ",".join(re.findall(r"Lb([01])E", k.group(2)))
            out[f"{k.group(1)}<{flags}>"] = list(v)
    return out


def tri_ptxas(log):
    """``{tri kernel[<mode>]: [registers, spill stores, spill loads, warps
    per SM]}`` of ``csrc/tri.cu``'s ``nvcc -Xptxas -v`` log; warps per SM
    computed from the registers at the kernels' 128 threads a block
    (65,536 registers an SM, allocated 256 to a warp; at most 64 warps and
    32 blocks; their static shared memory, 8 KB at most, limits none)."""
    out = {}
    for name, v in _ptxas(log).items():
        k = re.search(r"(tri_\w*kernel)(?:ILi(\d)E)?", name)
        if k:
            per_warp = -(-v[0] * 32 // 256) * 256
            blocks = min(32, 65536 // max(per_warp * 4, 1), 16)
            key = k.group(1) + (f"<{k.group(2)}>" if k.group(2) else "")
            out[key] = list(v) + [blocks * 4]
    return out


def _ptxas(log):
    """``{entry function: [registers, spill stores, spill loads]}`` of an
    ``nvcc -Xptxas -v`` log (a parent tree may have no parser of its
    own)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = [0, 0, 0]
        elif name is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                out[name][1:] = [int(m.group(1)), int(m.group(2))]
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[name][0] = int(m.group(1))
    return out


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


_LB = "__global__ void trace_fwd_kernel("
# variant: [(file, relative to the package's csrc/, anchor, replacement)]
ABLATIONS = {
    "fwd_noshadow": [(
        "trace_fwd.cu",
        "light_ok[li] = !any_hit<kTri, kSph>(s_tab, kRowCols, lay, so.x, "
        "so.y,\n                                          so.z, ln.x, ln.y, "
        "ln.z, T);",
        "light_ok[li] = so.x == so.x;")],
    "fwd_norefract": [
        ("trace_fwd.cu", "    if (kRefract) {\n      // refract from the "
         "exit hit", "    if (false) {\n      // refract from the exit hit"),
        ("trace_fwd.cu", "      u_emit = u[3 * R];\n    }",
         "      u_emit = u[(kRefract ? 7 : 3) * R];\n    }")],
    **{f"fwd_t{t}": [
        ("trace_fwd.cu", _LB,
         f"__global__ void __launch_bounds__({t}) trace_fwd_kernel("),
        ("trace_fwd.cu", "const int threads = 128;",
         f"const int threads = {t};")] for t in (64, 128, 256)},
    "bwd_plainadd": [
        ("trace_bwd.cu", "atomicAdd(dst + g, d_at[mrt::tab_col(g)]);",
         "dst[g] += d_at[mrt::tab_col(g)];"),
        ("trace_bwd.cu", "if (c != 6) atomicAdd(lights + li * "
         "mrt::kLightCols + c,\n                              d_lt[li * "
         "mrt::kLightCols + c]);",
         "if (c != 6) lights[li * mrt::kLightCols + c] +=\n"
         "                              d_lt[li * mrt::kLightCols + c];")],
    # the redesigned backward's options
    "bwd_minblocks1": [("trace_bwd.cu", "constexpr int kMinBlocks = 2;",
                        "constexpr int kMinBlocks = 1;")],
    **{f"bwd_aggshared{n}": [("trace_bwd.cu", "constexpr int kAggShared = 8;",
                              f"constexpr int kAggShared = {n};")]
       for n in (4, 16)},
    "bwd_aggglobal4": [("trace_bwd.cu", "constexpr int kAggGlobal = 2;",
                        "constexpr int kAggGlobal = 4;")],
}


# the triangle segment's variants (``ablate <tree> <workdir> tri``): on the
# one-level walk of hit3.cuh tri_entry, its rows removed (each touched block
# costs its slab test only), its slab tests removed (each ray sweeps the 64
# rows of its winner's block, fed in its live row: about the rows the cull
# leaves), or row 7's group exit removed
_TRI_ROWS = "    const int hi = imin(lo + kCullRows, L.tri_n);"
_TRI_TOUCH = ("        !block_touch(T.bb + b * kBbCols, ox, oy, oz, ix, iy, "
              "iz, best))\n      continue;\n")
TRI_ABLATIONS = {
    "tri_slabs_only": [("hit3.cuh", _TRI_TOUCH + _TRI_ROWS,
                        _TRI_TOUCH + "    row += 1;\n    const int hi = lo;")],
    "tri_rows_only": [
        ("tri.cu", "  float o[3], d[3];\n  mrt::Hit h{",
         "  float o[4], d[3];\n  mrt::Hit h{"),
        ("tri.cu", "  if (q.live != nullptr && !(q.live[b] > 0.5f)) return "
         "false;\n",
         "  if (q.live != nullptr && !(q.live[b] > 0.5f)) return false;\n"
         "  o[3] = q.live != nullptr ? q.live[b] : 1.0f;\n"),
        ("tri.cu", "  tri_entry(T, L, L.n_cb > 0, o[0], o[1], o[2], d[0], "
         "d[1], d[2], te, row);",
         "  if (o[3] < 1.5f) {\n"
         "    tri_entry(T, L, L.n_cb > 0, o[0], o[1], o[2], d[0], d[1], "
         "d[2], te, row);\n    return;\n  }\n"
         "  const int lo = (static_cast<int>(o[3]) - 2) * kCullRows;\n"
         "  if (lo < 0) return;\n"
         "  for (int i = lo; i < imin(lo + kCullRows, L.tri_n); ++i) {\n"
         "    float t;\n"
         "    if (tri_hit(T.tab + i * kTriCols, o[0], o[1], o[2], d[0], "
         "d[1], d[2], t) && t < te) {\n"
         "      te = t;\n      row = L.tri_start + i;\n    }\n  }")],
    "tri_noexit": [
        ("tri.cu", "    tri_exit(T, L, h.row, o[0], o[1], o[2], d[0], d[1], "
         "d[2], h.tx, h.xrow);",
         "    h.tx = h.te;\n    h.xrow = h.row;")],
}


# the two-level walk's options (``ablate <tree> <workdir> walk``):
# superblocks of 32 blocks, row 7's culled group exit removed, the rows
# read by hit3.cuh tri_hit's scalar loads, no chunk bound
TRI_WALK_ABLATIONS = {
    "walk_sup32": [("tri.cu", "constexpr int kSupBlocks = 16;",
                    "constexpr int kSupBlocks = 32;"),
                   ("tri.py", "SUPER = 16", "SUPER = 32")],
    "walk_noexit": [("tri.cu", "  } else if (L.n_cb == 0) {\n    tri_exit(T, "
                     "L, h.row, o[0], o[1], o[2], d[0], d[1], d[2], h.tx, "
                     "h.xrow);\n  } else {",
                     "  } else if (L.n_cb == 0) {\n    tri_exit(T, L, h.row, "
                     "o[0], o[1], o[2], d[0], d[1], d[2], h.tx, h.xrow);\n"
                     "  } else if (true) {\n    h.tx = h.te;\n    h.xrow = "
                     "h.row;\n  } else {")],
    "walk_scalar_rows": [
        ("tri.cu", "tri_hit4(T.tab + i * kTriCols, ox, oy, oz, dx, dy, dz, "
         "t, gid);",
         "tri_hit(T.tab + i * kTriCols, ox, oy, oz, dx, dy, dz, t);\n"
         "          gid = __ldg(T.tab + i * kTriCols + T_GID);")],
    "walk_nochunk": [
        ("tri.cu", "    const bool chunked =\n        c + kChunk <= "
         "S.n_staged || (S.n_staged == S.n && c < S.n);",
         "    const bool chunked = false;")],
}


def ablate(tree, work, which="room"):
    """The ``ablate`` mode (module docstring)."""
    tree, work = os.path.abspath(tree), os.path.abspath(work)
    me = os.path.abspath(__file__)
    pkg = "micro_raytracer_tpu_torch"
    trees = {}
    variants = {"tri": TRI_ABLATIONS, "walk": TRI_WALK_ABLATIONS}.get(
        which, ABLATIONS)
    tri_set = which in ("tri", "walk")
    for name, patches in {"base": [], **variants}.items():
        dst = os.path.join(work, name)
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(os.path.join(tree, pkg), os.path.join(dst, pkg),
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
        shutil.copy(os.path.join(tree, "chip_smoke.py"), dst)
        ok = True
        for src, old, new in patches:
            path = os.path.join(dst, pkg, "ops" if src.endswith(".py")
                                else "csrc", src)
            text = open(path).read()
            ok &= old in text
            with open(path, "w") as fh:
                fh.write(text.replace(old, new))
        if ok:
            trees[name] = dst
        else:
            print(f"ablate {name}: not applicable", flush=True)
    kernels = ("step.STEP_KERNEL, tri.ENTRY_KERNEL" if tri_set else
               "hit3.KERNEL, step.KERNEL, step.TRAIN_KERNEL, "
               "step.BWD_KERNEL")
    build = ("import sys; sys.path.insert(0, sys.argv[1]); "
             "from micro_raytracer_tpu_torch.ops import hit3, step, tri; "
             f"[k.fn() for k in ({kernels})]")
    procs = [subprocess.Popen([sys.executable, "-c", build, t])
             for t in trees.values()]
    for p in procs:
        p.wait()
    order = ["base", *[n for n in trees if n != "base"], "base"]
    for name in order:
        if tri_set:
            subprocess.run([sys.executable, me, "_tri_time", trees[name],
                            name], check=True)
        else:
            subprocess.run([sys.executable, me, "time", trees[name], name,
                            "room", "inst_grid"], check=True)
    if which == "tri":
        subprocess.run([sys.executable, me, "_tri_stats", trees["base"]],
                       check=True)
    elif not tri_set:
        _live_histogram(trees["base"])


def big_main(tree, tag):
    """The ``big_main`` mode: a tree's big-mesh main path as its
    ``chip_smoke.py`` phases 23 and 24 run it (``phase_big_main``: the CLI
    renders of ``mesh_big``, ``mesh_big_glass`` and ``mesh_big_mixed``
    with their launch counts, one HTTP request; ``phase_train``: 3 training
    steps of ``mesh_big``), printed as ``<tag>`` and one JSON object."""
    import tempfile

    import logging

    sys.path.insert(0, os.path.abspath(tree))
    os.chdir(tree)
    import chip_smoke as cs
    from micro_raytracer_tpu_torch.models import schema

    # as chip_smoke.py's main: no echo of a 65,536-triangle scene
    logging.getLogger("raytrace").addFilter(cs._NoSceneEcho())
    cs.phase_build()
    card = cs.card_line()
    counts, train_counts = {}, {}
    render = cs.phase_big_main(card, counts)
    cfg = cs.big_render_config("mesh_big",
                               tempfile.mkdtemp(prefix="cmp_big_"))[0]
    train = cs.phase_train(cfg, card, train_counts, "mesh_big",
                           moved=schema.KIND_TRIANGLE)
    print(tag, json.dumps({"card": card, "render": render, "train": train,
                           "render_launches": counts,
                           "train_launches": train_counts}), flush=True)


def _tri_mode(tree, tag, what):
    """``_tri_time``: a tree's rows 6-8 on the big scenes
    (:func:`_time_big`, ``tag`` ``tri_rows_only`` feeding winner blocks),
    with ``csrc/tri.cu``'s registers; ``_tri_stats``: the walk's per-ray
    work (:func:`_walk_stats`)."""
    sys.path.insert(0, os.path.abspath(tree))
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from micro_raytracer_tpu_torch.ops import tri

    dev = torch.device("cuda")
    if what == "stats":
        print("tri_stats", json.dumps(_walk_stats(cs, dev)), flush=True)
        return
    out = _time_big(cs, dev, rows_only=tag == "tri_rows_only")
    out["ptxas"] = tri_ptxas(tri.ENTRY_KERNEL.build_log)
    print(tag, json.dumps(out), flush=True)


def _live_histogram(tree):
    """The room's and inst_grid's live steps per ray (train instance) at
    the frame: histogram, and the lane-steps a warp runs (its longest
    lane's count x 32) over those its lanes need."""
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from micro_raytracer_tpu_torch.models import tracer
    from micro_raytracer_tpu_torch.models.compiler import compile_scene
    from micro_raytracer_tpu_torch.ops import step

    dev = torch.device("cuda")
    for name in ("room", "inst_grid"):
        cfg = _config(cs, name)
        scene = compile_scene(cfg.scene, dev)
        tables = step.pack_step(scene)
        decay = tracer.decay_of(cfg.rt.loss)
        gen = torch.Generator(device=dev).manual_seed(2)
        oT, dT = cs.main_path_rays(cfg, gen, dev)
        u8s = torch.rand((cs.BOUNCE + 1, step.n_uni(scene.any_refract),
                          oT.shape[1]), generator=gen, device=dev)
        hit0 = step.primary_hits(scene, tables, oT, dT)
        n = step.trace_fwd_train(scene, tables, decay, oT, dT, u8s,
                                 hit0)[4].long()
        hist = torch.bincount(n, minlength=cs.BOUNCE + 2).tolist()
        w = n[: n.numel() // 32 * 32].view(-1, 32)
        ratio = float(w.max(1).values.sum() * 32) / float(w.sum())
        print("live_steps", name, json.dumps(
            {"hist": hist, "mean": float(n.float().mean()),
             "warp_max_over_mean": ratio}), flush=True)


def compare(a_path, b_path):
    import torch

    a, b = torch.load(a_path), torch.load(b_path)
    same = True
    for scene in a:
        for name in a[scene]:
            if name.endswith(SPLIT):
                continue
            x, y = a[scene][name], b[scene][name]
            note = ""
            if name in SUMS:
                scale = float(y.abs().max()) if y.numel() else 0.0
                tol = 1e-5 * y.abs() + 1e-6 * max(scale, 1e-30)
                ratio = (x - y).abs() / tol
                ok = not bool((ratio > 1).any())
                if ratio.numel():
                    j = int(ratio.argmax())
                    note = (f" (worst {float(ratio.flatten()[j]):.3g} of "
                            f"the tolerance at flat index {j}: "
                            f"{float(x.flatten()[j])!r} against "
                            f"{float(y.flatten()[j])!r})")
                    if not ok and name + SPLIT in a[scene] \
                            and name + SPLIT in b[scene]:
                        moved = [float((t[name].flatten()[j].double()
                                        - t[name + SPLIT].flatten()[j]).abs())
                                 for t in (a[scene], b[scene])]
                        note += (f"; each tree's own sum moves by "
                                 f"{moved[0]:.3g}, {moved[1]:.3g} when its "
                                 f"rays are split in halves")
            else:
                ok = torch.equal(x, y)
                if not ok and x.shape == y.shape:
                    note = f" ({int((x != y).sum())} elements)"
                if not ok and name.split("_", 1)[-1] in CULLED_EXIT:
                    # a culled exit against an unculled one: reported,
                    # held ray by ray in chip_smoke.py phase 22
                    note += " (row 7's exit, culled against unculled)"
                    ok = True
            print(f"{scene} {name}: {'equal' if ok else 'DIFFERS'}{note}")
            same &= ok
    print("ALL SAME" if same else "OUTPUTS DIFFER")
    return 0 if same else 1


def _room_worker(tree):
    """A ``pairs`` worker: the room's training step and CLI render of
    ``tree``, run on each command read from stdin (``train`` or
    ``render``), each result a ``RESULT`` line of JSON on stdout."""
    import tempfile
    import time

    sys.path.insert(0, os.path.abspath(tree))
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from micro_raytracer_tpu_torch.parallel import shard

    dev = torch.device("cuda")
    cfg = cs.slice_config()
    params, scene, cam, coords, target, gen, _rows = cs.train_setup(cfg)
    ts = shard.make_train_step((cs.RES, cs.RES), cs.BOUNCE, device=dev)
    png = os.path.join(tempfile.mkdtemp(prefix="pairs_"), "room.png")

    def train():
        secs = []
        for _ in range(cs.TRAIN_STEPS):
            t0 = time.perf_counter()
            ts.step(params, scene, cam, cfg.rt.loss, coords, target, gen)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return secs

    def render():
        return cs.render_cli(png)[0]

    train()
    render()
    print("RESULT ready", flush=True)
    for line in sys.stdin:
        what = line.strip()
        out = train() if what == "train" else render()
        print("RESULT " + json.dumps(out), flush=True)


def pairs(tree_a, tree_b, n=10):
    """The ``pairs`` mode (module docstring)."""
    import statistics

    me = os.path.abspath(__file__)
    trees = {"a": os.path.abspath(tree_a), "b": os.path.abspath(tree_b)}
    procs = {k: subprocess.Popen([sys.executable, me, "_room_worker", t],
                                 stdin=subprocess.PIPE,
                                 stdout=subprocess.PIPE, text=True)
             for k, t in trees.items()}

    def result(k):
        for line in procs[k].stdout:
            if line.startswith("RESULT "):
                return json.loads(line[7:]) if line[7:12] != "ready" \
                    else None
        raise RuntimeError(f"worker {k} ({trees[k]}) ended")

    def ask(k, what):
        procs[k].stdin.write(what + "\n")
        procs[k].stdin.flush()
        return result(k)

    try:
        for k in procs:
            result(k)
        rays = cs_rays = None
        step_ms = {"a": [], "b": []}
        render = {"a": [], "b": []}
        for i in range(int(n)):
            for k in (("a", "b") if i % 2 == 0 else ("b", "a")):
                secs = ask(k, "train")
                step_ms[k].append(1e3 * sum(secs) / len(secs))
                render[k].append(ask(k, "render"))
        cs_rays = 1080 * 1080 * 16
        rays = {k: [cs_rays / s for s in v] for k, v in render.items()}
        out = {"trees": trees,
               "step_ms": step_ms,
               "median_step_ms": {k: statistics.median(v)
                                  for k, v in step_ms.items()},
               "b_faster_steps": sum(b < a for a, b in zip(step_ms["a"],
                                                            step_ms["b"])),
               "render_rays_per_s": rays,
               "median_render_rays_per_s": {k: statistics.median(v)
                                            for k, v in rays.items()},
               "b_faster_renders": sum(b < a for a, b in zip(render["a"],
                                                              render["b"])),
               "pairs": int(n)}
        print(json.dumps(out), flush=True)
    finally:
        for p in procs.values():
            p.stdin.close()
            p.wait()


def reference(tree, out, *names):
    """The ``reference`` mode (module docstring)."""
    out = os.path.abspath(out)
    sys.path.insert(0, os.path.abspath(tree))
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from micro_raytracer_tpu_torch.models import tracer
    from micro_raytracer_tpu_torch.models.compiler import (compile_camera,
                                                           compile_scene)
    from micro_raytracer_tpu_torch.ops import step

    dev, f64 = torch.device("cuda"), torch.float64
    res = {}
    for name in names:
        cfg = _config(cs, name)
        scene = compile_scene(cfg.scene, dev)
        tables = step.pack_step(scene)
        decay = tracer.decay_of(cfg.rt.loss)
        # dump's inputs, drawn in its order
        gen = torch.Generator(device=dev).manual_seed(31)
        o, d = cs.camera_rays(compile_camera(cfg.frame.cam, dev), 1 << 18,
                              gen, dev)
        oT, dT = o.T.contiguous(), d.T.contiguous()
        u8s = torch.rand((cs.BOUNCE + 1, step.n_uni(scene.any_refract),
                          oT.shape[1]), generator=gen, device=dev)
        hit0 = step.primary_hits(scene, tables, oT, dT)
        _A, _B, _fl, resid, n_live = step.trace_fwd_train(
            scene, tables, decay, oT, dT, u8s, hit0)
        ctA, ctB = (torch.randn((3, oT.shape[1]), generator=gen, device=dev)
                    for _ in range(2))
        t64 = tables._replace(**{
            k: getattr(tables, k).to(f64) for k in ("tab", "lights", "tri",
                                                    "tbb", "sbb")
            if getattr(tables, k, None) is not None})
        L = scene.n_lights
        # the residual rows that hold a step's discrete choices
        pick = [step.RES_ROW, step.RES_CHOOSE,
                *[step.RES_LOK + j for j in range(L)]]
        if tables.layout[3]:
            pick.append(step.res_xrow(L))
        keep, ref = [], None
        for s in range(0, oT.shape[1], 1 << 15):
            sl = slice(s, s + (1 << 15))
            args = (oT[:, sl].to(f64), dT[:, sl].to(f64), u8s[..., sl].to(f64))
            with torch.no_grad():
                *_x, r64, n64 = step.trace_plain(scene, t64, decay, *args,
                                                 want_resid=True)
            n32 = n_live[sl].long()
            same = n64.long() == n32
            k_idx = torch.arange(r64.shape[0], device=dev)[:, None]
            live = k_idx < n32[None, :]
            for row in pick:
                eq = (r64[:, row, :] == resid[:, row, sl].to(f64)) | ~live
                same &= eq.all(0)
            idx = torch.nonzero(same).flatten()
            keep.append(idx + s)
            g = step.trace_bwd_plain(
                scene, t64, decay, args[0][:, idx], args[1][:, idx],
                args[2][..., idx], ctA[:, sl][:, idx].to(f64),
                ctB[:, sl][:, idx].to(f64))[:2]   # d_tab, d_lights
            ref = g if ref is None else tuple(a + b for a, b in zip(ref, g))
        keep = torch.cat(keep)
        g = step.trace_bwd(scene, tables, decay, u8s[..., keep].contiguous(),
                           resid[..., keep].contiguous(),
                           n_live[keep].contiguous(),
                           ctA[:, keep].contiguous(),
                           ctB[:, keep].contiguous())
        rec = {"rays": int(oT.shape[1]), "kept": int(keep.numel())}
        for j, key in ((0, "d_tab"), (1, "d_lights")):
            x, y = g[j].double().cpu(), ref[j].cpu()
            scale = float(y.abs().max())
            ratio = (x - y).abs() / (1e-5 * y.abs() + 1e-6 * max(scale,
                                                                  1e-30))
            w = int(ratio.argmax())
            rec[key] = {"worst_of_tolerance": float(ratio.flatten()[w]),
                        "at": w, "kernel": float(x.flatten()[w]),
                        "reference": float(y.flatten()[w])}
            res[(name, key)] = (x, y)
        rec["d_lights"]["kernel_all"] = g[1].flatten().tolist()
        rec["d_lights"]["reference_all"] = ref[1].flatten().tolist()
        print("reference", name, json.dumps(rec), flush=True)
    torch.save(res, out)


if __name__ == "__main__":
    if sys.argv[1:2] == ["dump"] and len(sys.argv) == 4:
        dump(*sys.argv[2:])
    elif sys.argv[1:2] == ["compare"] and len(sys.argv) == 4:
        sys.exit(compare(*sys.argv[2:]))
    elif sys.argv[1:2] == ["time"] and len(sys.argv) >= 4:
        time_tree(*sys.argv[2:])
    elif sys.argv[1:2] == ["ablate"] and len(sys.argv) in (4, 5):
        ablate(*sys.argv[2:])
    elif sys.argv[1:2] == ["big_main"] and len(sys.argv) == 4:
        big_main(*sys.argv[2:])
    elif sys.argv[1:2] == ["_tri_time"] and len(sys.argv) == 4:
        _tri_mode(*sys.argv[2:], "time")
    elif sys.argv[1:2] == ["_tri_stats"] and len(sys.argv) == 3:
        _tri_mode(sys.argv[2], "", "stats")
    elif sys.argv[1:2] == ["pairs"] and len(sys.argv) in (4, 5):
        pairs(*sys.argv[2:])
    elif sys.argv[1:2] == ["_room_worker"] and len(sys.argv) == 3:
        _room_worker(sys.argv[2])
    elif sys.argv[1:2] == ["reference"] and len(sys.argv) >= 5:
        reference(*sys.argv[2:])
    else:
        sys.exit(__doc__)
