#!/usr/bin/env python3
"""Compare the port's room, mesh and textured kernels between two
checkouts, on one NVIDIA GPU: the same inputs through each tree's kernels,
then every output compared.

    python3 tools/torch_compare_trees.py dump <tree> <out.pt>
    python3 tools/torch_compare_trees.py compare <a.pt> <b.pt>
    python3 tools/torch_compare_trees.py time <tree> <tag> [scene ...]
    python3 tools/torch_compare_trees.py ablate <tree> <workdir>
    python3 tools/torch_compare_trees.py ablate <tree> <workdir> tri|walk
    python3 tools/torch_compare_trees.py ablate <tree> <workdir> step|steps
    python3 tools/torch_compare_trees.py ablate <tree> <workdir> sweep|tex
    python3 tools/torch_compare_trees.py big_main <tree> <tag>
    python3 tools/torch_compare_trees.py pairs <tree_a> <tree_b> [pairs]
    python3 tools/torch_compare_trees.py reference <tree> <out.pt> <scene>...

``dump`` imports the package and ``chip_smoke.py`` of ``<tree>`` and runs,
on the slice room, the two mesh scenes, the two textured and the
Instance-class stand-ins of ``chip_smoke.py``, 2^18 camera rays (seed 31)
through the primary-hit pass, both instances of the trace kernel and the
backward kernel, and on its per-step stand-ins and big meshes (where it
has them) a sample's nine steps of the render instance of the step kernel
from 2^18 camera rays (each from the tree's own carry), the train
instance and the step's backward at steps 0 and 3, and on its big meshes
(``mesh_big``,
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
and the halves are added in float64 (the dump keeps those sums). Where a
per-step carry differs it names the rays and keeps them, with their input
carry and uniforms, in ``carry_diffs.pt`` beside ``<b.pt>``. It exits 1
when they differ.
``time`` builds ``<tree>``'s kernels and prints ``<tag>`` and one JSON
object: the CUDA-event ms of each kernel (``chip_smoke.cuda_ms``) at the
full frame of each scene that tree's ``chip_smoke.py`` has (the room, the
mesh scenes and, where present, the textured, Instance-class and per-step
stand-ins; the step kernels at each of a sample's nine steps, the
backward fed each step's train residuals (``steps`` names these alone);
where a render runs in segments,
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

``ablate <tree> <workdir> step`` times the per-step kernels (rows 4-5)
instead: variants of their one-level design (``STEP_ABLATIONS``: step_fwd's
shadow sweeps removed, its sphere rows or kTriIn shadow rows removed, the
kTriIn shadow walk stopped after its first block; step_bwd's row or light
adds made plain adds, its reduce kernel removed) on ``lights8``,
``inst_grid3k`` and the big meshes at step 0 and over a sample's nine
launches, every variant on the carries the unchanged tree stepped and
saved (the unchanged tree also on each carry with its live lanes first),
and prints the walks' per-ray work at each step (``_step_stats``);
``steps`` the redesigned walk's options (``STEP_WALK_ABLATIONS``).

``ablate <tree> <workdir> tex`` times the textured whole trace and the
primary-hit pass of the dense design (``TEX_ABLATIONS``: the exit the
winner row's own, a flat per-box cull, no texel fetches, the row table
in global memory) as ``time`` does on ``tex_blocks`` and ``tex_dof``, and
prints their live-step histograms (the lane refill's room).

``ablate <tree> <workdir> sweep`` times the whole trace's sweeps
(``SWEEP_ABLATIONS``: the exit sweeps removed, the entries culled in exit
mode, both, the row table read from global memory instead of shared) as
``time`` does on ``mesh_glass``, ``inst_grid`` and ``inst_glass`` (rows 1,
1t, 2; warps per SM of each instance), then on the unchanged tree the
warps per SM of ``inst_grid``'s instance at each count of staged rows
(``_occupancy_table``) and the per-step route against the whole trace,
whole and compacted, render and training, on ``inst_grid`` and
``inst_glass`` (``_routes``).

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
STEP_OUTS = ("c1_train", "hit_train", "resid", "d_tab", "d_lights", "d_c0",
             "d_tri")
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
    for name in (*getattr(cs, "STEP_NAMES", ()),
                 *getattr(cs, "BIG_NAMES", ())):
        cfg, scene, tables, decay = _step_setup(cs, name, dev)
        gen = torch.Generator(device=dev).manual_seed(31)
        o, d = cs.camera_rays(compile_camera(cfg.frame.cam, dev), 1 << 18,
                              gen, dev)
        c = step.primary_carry(o.T.contiguous(), d.T.contiguous())
        u8s = torch.rand((cs.BOUNCE + 1, step.n_uni(scene.any_refract),
                          c.shape[1]), generator=gen, device=dev)
        ct1 = torch.randn(c.shape, generator=gen, device=dev)
        rec = {"c@0": c.cpu(), "u8s": u8s.cpu()}
        # a sample's nine steps from the same primaries, each from the
        # tree's own carry; the train instance and the backward at steps
        # 0 and 3
        for k in range(cs.BOUNCE + 1):
            if k in (0, 3):
                c1t, hitt, resid = step.step_fwd_train(scene, tables, decay,
                                                       c, u8s[k])
                g = step.step_bwd(scene, tables, decay, c, u8s[k], resid,
                                  hitt, ct1)
                rec.update({f"{key}@{k}": t.cpu() for key, t in zip(
                    STEP_OUTS, (c1t, hitt, resid[:, hitt[0] > 0.5], *g))})
            c, hit = step.step_fwd(scene, tables, decay, c, u8s[k])
            rec[f"c@{k + 1}"], rec[f"hit@{k}"] = c.cpu(), hit.cpu()
        res[f"{name} steps"] = rec
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
                  step.BWD_KERNEL, step.STEP_KERNEL, step.STEP_BWD_KERNEL,
                  tri.ENTRY_KERNEL):
            k.fn()
    else:
        cs.phase_build()
    names = ["room", *cs.MESH_NAMES, *getattr(cs, "TEX_NAMES", ()),
             *getattr(cs, "INST_NAMES", ())]
    names = [n for n in names if not only or n in only]
    out = _time_steps(cs, dev) if not only or "steps" in only else {}
    out["ptxas"] = {**hit_ptxas(hit3.KERNEL.build_log),
                    **ptxas_table(step.KERNEL.build_log),
                    **ptxas_table(step.BWD_KERNEL.build_log),
                    **step_ptxas(step.STEP_KERNEL.build_log,
                                 step.STEP_BWD_KERNEL.build_log)}
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
        out[name] = {
            "trace_fwd": cs.cuda_ms(lambda: step.trace_fwd(
                scene, tables, decay, oT, dT, u8s, hit0), 10),
            "trace_fwd_train": cs.cuda_ms(lambda: step.trace_fwd_train(
                scene, tables, decay, oT, dT, u8s, hit0), 10),
            "trace_bwd": cs.cuda_ms(lambda: step.trace_bwd(
                scene, tables, decay, u8s, res[3], res[4], ct, ct), 10),
            "closest_hit": cs.cuda_ms(lambda: step.primary_hits(
                scene, tables, oT, dT), 20)}
        # where the render runs in segments (tracer.compact_cuts), their
        # summed kernel time: the segment instances
        if hasattr(step, "resident_warps"):
            out[name]["warps"] = {w: step.resident_warps(scene, tables, w)
                                  for w in ("trace_fwd", "trace_fwd_train")}
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


def hit_ptxas(log):
    """``{closest_hit_kernel<template flags>: [registers, spill stores,
    spill loads]}`` of the primary-hit kernel's ``nvcc -Xptxas -v`` log."""
    out = {}
    for name, v in _ptxas(log).items():
        k = re.search(r"(closest_hit_kernel)I((?:Lb[01]E)+)", name)
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
    """The step kernels at the frame of each per-step stand-in of the
    tree's chip_smoke.py and of its big meshes (:func:`_step_sample`):
    step 0 and a sample's nine launches."""
    out = {}
    for name in (*getattr(cs, "STEP_NAMES", ()),
                 *getattr(cs, "BIG_NAMES", ())):
        cfg, scene, tables, decay = _step_setup(cs, name, dev)
        carries, u8s = _step_carries(cs, cfg, scene, tables, decay, dev)
        out[name] = _step_sample(cs, scene, tables, decay, carries, u8s)
        del carries, u8s
    return out


# --- the per-step kernels (rows 4-5) at the frame ----------------------------

def _step_setup(cs, name, dev):
    """(cfg, scene, tables, decay) of a per-step scene of a tree's
    ``chip_smoke.py``: a per-step stand-in or a big mesh."""
    if name in getattr(cs, "BIG_NAMES", ()):
        return _big_setup(cs, name, dev)
    from micro_raytracer_tpu_torch.models import tracer
    from micro_raytracer_tpu_torch.models.compiler import compile_scene
    from micro_raytracer_tpu_torch.ops import step

    cfg = cs.step_config(name)
    scene = compile_scene(cfg.scene, dev)
    return cfg, scene, step.pack_step(scene), tracer.decay_of(cfg.rt.loss)


def _step_carries(cs, cfg, scene, tables, decay, dev, path=None):
    """The carries ``(BOUNCE + 1, 14, R)`` of a sample's nine steps of the
    frame (camera rays in Morton order, seed 2; step 0 first) and their
    uniforms, stepped by the tree's step_fwd; with ``path``, loaded from
    there when it exists (saved there otherwise), so that every variant of
    an ablation times the same inputs."""
    import torch

    from micro_raytracer_tpu_torch.ops import step

    if path is not None and os.path.exists(path):
        c, u8s = torch.load(path)
        return c.to(dev), u8s.to(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    oT, dT = cs.main_path_rays(cfg, gen, dev)
    u8s = torch.rand((cs.BOUNCE + 1, step.n_uni(scene.any_refract),
                      oT.shape[1]), generator=gen, device=dev)
    c = [step.primary_carry(oT, dT)]
    for k in range(cs.BOUNCE):
        c.append(step.step_fwd(scene, tables, decay, c[-1], u8s[k])[0])
    c = torch.stack(c)
    if path is not None:
        torch.save((c.cpu(), u8s.cpu()), path)
    return c, u8s


def _live_first(c, u8):
    """The carry ``c`` and uniforms ``u8`` with the live lanes first (in
    order): the same work, its dead lanes in whole dead blocks."""
    import torch

    from micro_raytracer_tpu_torch.ops import step

    perm = torch.argsort((c[step.C_LIVE] <= 0.5).to(torch.int8), stable=True)
    return c[:, perm].contiguous(), u8[:, perm].contiguous()


def _step_sample(cs, scene, tables, decay, carries, u8s, packed=False):
    """CUDA-event ms of step_fwd at each of a sample's nine steps (the
    kTriIn instances without the triangle sweep they launch first,
    ``chip_smoke.step_alone_ms``), of step_fwd_train at step 0, and of
    step_bwd at each step fed that step's train residuals; the live share
    of each step's lanes; ``packed``: step_fwd also on each carry with its
    live lanes first (:func:`_live_first`)."""
    import torch

    from micro_raytracer_tpu_torch.ops import step

    gen = torch.Generator(device=carries.device).manual_seed(5)
    ct1 = torch.randn(carries.shape[1:], generator=gen,
                      device=carries.device)
    out = {"live": [], "fwd": [], "bwd": [], "fwd_packed": []}
    for k in range(carries.shape[0]):
        c, u = carries[k], u8s[k]
        out["live"].append(float((c[step.C_LIVE] > 0.5).float().mean()))
        out["fwd"].append(cs.step_alone_ms(
            scene, tables, c,
            lambda c=c, u=u: step.step_fwd(scene, tables, decay, c, u)))
        if packed:
            cp, up = _live_first(c, u)
            out["fwd_packed"].append(cs.step_alone_ms(
                scene, tables, cp,
                lambda: step.step_fwd(scene, tables, decay, cp, up)))
            del cp, up
        _c1, hit, resid = step.step_fwd_train(scene, tables, decay, c, u)
        if k == 0:
            out["train0"] = cs.step_alone_ms(
                scene, tables, c,
                lambda: step.step_fwd_train(scene, tables, decay, c, u))
        out["bwd"].append(cs.cuda_ms(lambda: step.step_bwd(
            scene, tables, decay, c, u, resid, hit, ct1), 3))
        del resid
    for key in ("fwd", "bwd", "fwd_packed"):
        out[key + "_sample"] = sum(out[key])
    if not packed:
        del out["fwd_packed"], out["fwd_packed_sample"]
    return out


def _sph_walks(tables, o, d, live, any_hit):
    """Per ray (``o``, ``d`` (n, 3), ``live`` (n,)) of a scene with sphere
    cull blocks: the blocks its slab test touches at all, and the blocks a
    closest-hit walk (``any_hit``: a shadow walk, to its first hit) sweeps
    in the lowest-first order of hit3.cuh sph_entry / sph_any and in
    nearest-first order (entry t ascending, stopping at the first block
    that begins beyond the best t). From the plain row tests."""
    import torch

    from micro_raytracer_tpu_torch.models import schema
    from micro_raytracer_tpu_torch.ops import hit3

    BIG = hit3.BIG
    sbb = tables.sbb
    nb = sbb.shape[0]
    kind, s, c, n = tables.layout[0][0]
    assert kind == schema.KIND_SPHERE
    fr, ipos, pa, pr, valid, _gid = hit3.split_sweep(tables.tab.detach())
    t0, _t1, ok = hit3._kind_block(kind, s, s + c, fr, ipos, pa, pr, valid,
                                   o, d)
    pad = nb * hit3.CB - c
    ok = torch.nn.functional.pad(ok, (0, pad)).view(-1, nb, hit3.CB)
    t0 = torch.nn.functional.pad(t0, (0, pad)).view(-1, nb, hit3.CB)
    bmin = torch.where(ok, t0, BIG).amin(-1)
    bany = ok.any(-1)
    invd = hit3._inv_dir(d)
    tmin = torch.stack([hit3._slab(sbb[b], o, invd)[0] for b in range(nb)], 1)
    touch = torch.stack([hit3._slab_touch(sbb[b], o, invd,
                                          torch.full_like(o[:, 0], BIG))
                         for b in range(nb)], 1) & live[:, None]
    key = torch.where(touch, tmin, float("inf"))
    order = torch.argsort(key, dim=1, stable=True)
    out = {"touched": touch.sum(1)}
    for walk in ("lowest", "nearest"):
        best = torch.full_like(o[:, 0], BIG)
        found = torch.zeros_like(live)
        on = live.clone()
        swept = torch.zeros_like(out["touched"])
        for j in range(nb):
            b = torch.full_like(order[:, 0], j) if walk == "lowest" \
                else order[:, j]
            tm = key.gather(1, b[:, None])[:, 0]
            if any_hit:
                sw = on & torch.isfinite(tm) & ~found
                found |= sw & bany.gather(1, b[:, None])[:, 0]
            else:
                sw = on & (tm <= best)
                best = torch.minimum(best, torch.where(
                    sw, bmin.gather(1, b[:, None])[:, 0], BIG))
                if walk == "nearest":
                    on &= sw
            swept += sw
        out[walk] = swept
    return out


def _tri_any_walks(tables, o, d, live):
    """Per shadow ray of a kTriIn scene: the slab tests of the one-level
    walk (hit3.cuh tri_any_seg: every block in order up to the first that
    holds a hit) and of a two-level walk over the superblocks (the chunk
    bound, the superblocks where the chunk is met, the blocks of each met
    superblock in order up to the first hit), and the triangle rows each
    sweeps (a swept block's rows up to its first hit). From the plain
    triangle tests."""
    import torch

    from micro_raytracer_tpu_torch.ops import hit3, tri

    BIG = hit3.BIG
    t, tbb, n = tables.tri.detach(), tables.tbb, tables.layout[3]
    nb = tbb.shape[0]
    sup = tri.superbounds(tbb)
    ns = sup.shape[0]
    invd = hit3._inv_dir(d)
    big = torch.full_like(o[:, 0], BIG)
    ok = hit3._tri_block_any(t[:n], o, d)
    ok = torch.nn.functional.pad(ok, (0, nb * hit3.CB - n)).view(
        -1, nb, hit3.CB)
    first = torch.where(ok.any(-1), hit3.intersect.first_index(
        ok.view(-1, hit3.CB)).view(-1, nb).long() + 1, hit3.CB)
    touch = torch.stack([hit3._slab_touch(tbb[b], o, invd, big)
                         for b in range(nb)], 1) & live[:, None]
    hit_b = touch & ok.any(-1)
    idx = torch.arange(nb, device=o.device)
    stop = torch.where(hit_b.any(1), torch.where(hit_b, idx, nb).amin(1),
                       nb - 1)
    upto = idx[None, :] <= stop[:, None]
    one_rows = torch.where(touch & upto, first, 0).sum(1)
    one_tests = torch.where(live, stop + 1, 0)
    s_touch = torch.stack([hit3._slab_touch(sup[s], o, invd, big)
                           for s in range(ns)], 1) & live[:, None]
    blk_sup = idx // tri.SUPER
    met = s_touch[:, blk_sup]
    sup_upto = blk_sup[None, :] <= (stop // tri.SUPER)[:, None]
    two_tests = torch.where(live, 1 + ns * s_touch.any(1), 0) + (
        met & sup_upto & (idx[None, :] % tri.SUPER == 0)).sum(1) * tri.SUPER
    return {"one_level_tests": one_tests, "two_level_tests": two_tests,
            "rows": one_rows, "occluded": hit_b.any(1)}


def _step_stats(cs, dev, carries_dir):
    """Per-ray work of the per-step kernels at each of a sample's nine
    steps of each per-step scene, on 4,096 warps (32 consecutive rays of
    the frame's Morton order) drawn at random: live lanes per warp and
    the share of warps with none; on ``inst_grid3k`` the closest-hit
    sweep's touched sphere blocks and the blocks swept before the best t
    lowest first and nearest first (mean over live rays and the busiest
    lane of a warp), the same for each shadow walk (to its first hit);
    on the big meshes each shadow ray's slab tests one level and two
    levels (256 of the warps). From the plain sweeps, on the tree's own
    tables and the saved carries."""
    import torch

    from micro_raytracer_tpu_torch.ops import hit3, step

    out = {}
    for name in ("lights8", "inst_grid3k", *getattr(cs, "BIG_NAMES", ())):
        cfg, scene, tables, decay = _step_setup(cs, name, dev)
        carries, _u8s = _step_carries(
            cs, cfg, scene, tables, decay, dev,
            os.path.join(carries_dir, f"{name}.pt"))
        R = carries.shape[2]
        g = torch.Generator().manual_seed(5)
        big = name in getattr(cs, "BIG_NAMES", ())
        nw = 256 if big else 4096
        warps = torch.randperm(R // 32, generator=g)[:nw].sort().values
        sub = (warps[:, None] * 32 + torch.arange(32)).flatten().to(dev)
        steps = []
        for k in range(carries.shape[0]):
            c = carries[k][:, sub]
            o, d = c[0:3].T.contiguous(), c[3:6].T.contiguous()
            live = c[step.C_LIVE] > 0.5
            lw = live.view(-1, 32).sum(1).float()
            rec = {"live_lanes_per_warp": float(lw.mean()),
                   "dead_warps": float((lw == 0).float().mean())}

            def stats(w, mask, tag):
                for key, v in w.items():
                    if v.dtype == torch.bool:
                        continue
                    v = torch.where(mask, v, 0).float()
                    rec[f"{tag}{key}"] = float(v.sum() / max(int(mask.sum()),
                                                             1))
                    rec[f"{tag}{key}_warp_max"] = float(
                        v.view(-1, 32).amax(1).mean())

            te = torch.cat([hit3.sweep_plain(
                tables.tab.detach(), (tables.layout[0], tables.layout[1], 0,
                                      0), o[s:s + 4096], d[s:s + 4096],
                hit3.MODE_ENTRY, sbb=tables.sbb)[0]
                for s in range(0, o.shape[0], 4096)])
            if big:
                th = step.tri_hits(scene, tables, c.contiguous())
                te = torch.minimum(te, th[0])
            hit = live & (te < hit3.BIG * 0.5)
            rec["hit"] = float(hit.float().mean())
            if tables.sbb is not None:
                w = {}
                for s in range(0, o.shape[0], 4096):
                    part = _sph_walks(tables, o[s:s + 4096], d[s:s + 4096],
                                      live[s:s + 4096], False)
                    for key, v in part.items():
                        w.setdefault(key, []).append(v)
                stats({key: torch.cat(v) for key, v in w.items()}, live,
                      "entry_")
            p = o + d * te[:, None]
            for li in range(scene.n_lights):
                if not (tables.sbb is not None or big):
                    break
                lv = step._light_vec(tables.lights[li].detach(), p)
                ln = lv / torch.sqrt((lv * lv).sum(1, keepdim=True))
                so = p + ln * hit3.EPS
                on = hit
                if big:
                    # the dense rows are swept first: a shadow ray they
                    # occlude walks no triangle block
                    on = hit & ~torch.cat([hit3.sweep_plain(
                        tables.tab.detach(), (tables.layout[0],
                                              tables.layout[1], 0, 0),
                        so[s:s + 4096], ln[s:s + 4096],
                        hit3.MODE_ANY)[0] < 0.0
                        for s in range(0, o.shape[0], 4096)])
                w = {}
                for s in range(0, o.shape[0], 1024 if big else 4096):
                    e = s + (1024 if big else 4096)
                    part = (_tri_any_walks(tables, so[s:e], ln[s:e],
                                           on[s:e]) if big else
                            _sph_walks(tables, so[s:e], ln[s:e], on[s:e],
                                       True))
                    for key, v in part.items():
                        w.setdefault(key, []).append(v)
                stats({key: torch.cat(v) for key, v in w.items()}, on,
                      f"shadow{li}_")
            steps.append(rec)
        out[name] = steps
        del carries
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
    "walk_sup32": [("tri_walk.cuh", "constexpr int kSupBlocks = 16;",
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
        ("tri_walk.cuh", "tri_hit4(T.tab + i * kTriCols, ox, oy, oz, dx, dy, "
         "dz, t, gid);",
         "tri_hit(T.tab + i * kTriCols, ox, oy, oz, dx, dy, dz, t);\n"
         "          gid = __ldg(T.tab + i * kTriCols + T_GID);")],
    "walk_nochunk": [
        ("tri_walk.cuh", "    const bool chunked =\n        c + kChunk <= "
         "S.n_staged || (S.n_staged == S.n && c < S.n);",
         "    const bool chunked = false;")],
}


# the per-step kernels' variants (``ablate <tree> <workdir> step``), on the
# one-level design of rows 4-5 (lowest-first blocks, one ray per thread,
# float-atomic scatter): step_fwd's shadow sweeps removed; the sphere
# cull's row sweeps removed (the slab tests kept); the kTriIn shadow walk
# (hit3.cuh tri_any_seg) with its rows removed, or stopped after the first
# block it touches; step_bwd's row adds (shared and global) or light adds
# made plain racy adds, or its reduce kernel removed. The dead lanes are
# measured without a variant: the same carry with its live lanes first
# (``fwd_packed``).
_SPH_ENTRY_ROWS = ("    const int lo = b * kCullRows;\n"
                   "    entry_seg<kSphere>(tab, stride, L.sph_start + lo,\n"
                   "                       imin(kCullRows, L.sph_n - lo), ox, "
                   "oy, oz, dx, dy, dz,\n                       best, row);")
_SPH_ANY_ROWS = ("    const int lo = low_bit(m) * kCullRows;\n"
                 "    if (any_seg<kSphere>(tab, stride, L.sph_start + lo,\n"
                 "                         imin(kCullRows, L.sph_n - lo), ox, "
                 "oy, oz, dx, dy,\n                         dz))\n"
                 "      return true;")
_TRI_ANY_ROWS = ("      if (tri_any(T.tab + i * kTriCols, ox, oy, oz, dx, dy, "
                 "dz)) return true;\n  }\n  return false;")
STEP_ABLATIONS = {
    "step_noshadow": [(
        "step_fwd.cu",
        "        const bool ok = !any_hit<kTri, kSph, StepMask>(\n"
        "            tab, kRowCols, lay, so.x, so.y, so.z, ln_e.x, ln_e.y, "
        "ln_e.z, T);",
        "        const bool ok = so.x == so.x;")],
    "step_sph_slabs_only": [
        ("hit3.cuh", _SPH_ENTRY_ROWS, "    row += b;"),
        ("hit3.cuh", _SPH_ANY_ROWS,
         "    if (low_bit(m) * kCullRows == L.sph_n + 1) return true;")],
    "step_tri_any_slabs_only": [(
        "hit3.cuh",
        "    for (int i = lo; i < hi; ++i)\n" + _TRI_ANY_ROWS,
        "    if (hi == L.tri_n + 1) return true;\n  }\n  return false;")],
    "step_tri_any_first_block": [(
        "hit3.cuh", _TRI_ANY_ROWS,
        _TRI_ANY_ROWS.replace("  }\n  return false;",
                              "    return false;\n  }\n  return false;"))],
    "bwd_rows_plainadd": [
        ("step_bwd.cu", "if (d_at[c] != 0.0f) atomicAdd(dst + c, d_at[c]);",
         "if (d_at[c] != 0.0f) dst[c] += d_at[c];"),
        ("step_bwd.cu", "atomicAdd(dst + g, d_at[mrt::tab_col(g)]);",
         "dst[g] += d_at[mrt::tab_col(g)];")],
    "bwd_lights_plainadd": [(
        "step_bwd.cu",
        "if (c != 6) atomicAdd(lights + li * mrt::kLightCols + c, g[c]);",
        "if (c != 6) lights[li * mrt::kLightCols + c] += g[c];")],
    "bwd_noreduce": [("step_bwd.cu", "  if (n_out)\n    reduce_kernel<<<",
                      "  if (false)\n    reduce_kernel<<<")],
}


# the per-step forward's walk options (``ablate <tree> <workdir> steps``):
# the sphere blocks walked lowest first by every ray, the sub-blocks'
# tests removed (every row of a visited block swept), the sub-blocks'
# boxes not grown (timing only: a far ray's hits may be dropped), the
# warps not refilled (each its 32 rays in place)
STEP_WALK_ABLATIONS = {
    "sw_lowest_first": [
        ("step_fwd.cu", "  const bool inside = ox >= g[0]",
         "  const bool inside = false && ox >= g[0]")],
    "sw_no_sub": [(
        "step_fwd.cu",
        "    if (!sub_touch(P.sub + s * kBbCols, ox, oy, oz, ix, iy, iz, "
        "best))\n      continue;\n", "")],
    "sw_bare_sub": [(
        "step_fwd.cu",
        "  const float grow = b.z * (1.0f + qx * qx + qy * qy + qz * qz);",
        "  const float grow = 0.0f * (b.z + qx + qy + qz);")],
    "sw_no_refill": [(
        "step_fwd.cu",
        "    if (j < R && !on) dead(j);\n    const unsigned bal = "
        "__ballot_sync(kFull, on);",
        "    if (j < R && !on) dead(j);\n    if (on) live(j);\n"
        "    const unsigned bal = __ballot_sync(kFull, false);")],
}


# the whole trace's sweeps (``ablate <tree> <workdir> sweep``), on rows 1,
# 1t and 2 of mesh_glass, inst_grid and inst_glass: the exit sweeps removed
# (every closest hit its own exit), the entries culled in exit mode (the
# triangle and sphere blocks as in entry mode; the phantom differences
# allowed), both, and the rows read from the global row table instead of
# shared memory (trace_fwd.cu stages no rows: more warps per SM). Timing
# only: the variants' outputs are wrong.
_SW_EXIT = "  if (!kNeedExit) {\n    h.tx = best;\n    h.xrow = row;"
_SW_CULL = [
    ("hit3.cuh", "kSph && !kNeedExit && L.n_sb > 0", "kSph && L.n_sb > 0"),
    ("hit3.cuh", "tri_entry(T, L, !kNeedExit && L.n_cb > 0,",
     "tri_entry(T, L, L.n_cb > 0,")]
SWEEP_ABLATIONS = {
    "sweep_noexit": [("hit3.cuh", _SW_EXIT, _SW_EXIT.replace("!kNeedExit",
                                                          "true"))],
    "sweep_cull_entry": _SW_CULL,
    "sweep_cull_entry_noexit": _SW_CULL + [
        ("hit3.cuh", _SW_EXIT, _SW_EXIT.replace("!kNeedExit", "true"))],
    "sweep_rows_global": [
        ("trace_fwd.cu", "  float* s_tab = smem;\n  float* s_lt = smem + P * "
         "mrt::kRowCols;", "  const float* s_tab = tab;\n  float* s_lt = "
         "smem;"),
        ("trace_fwd.cu", "    mrt::stage(s_tab, tab, P, mrt::kRowCols, "
         "mrt::kRowCols);\n", ""),
        ("trace_fwd.cu", "  return (static_cast<size_t>(a.P) * mrt::kRowCols "
         "+", "  return (static_cast<size_t>(0) * mrt::kRowCols +")],
}
SWEEP_SCENES = ("mesh_glass", "inst_grid", "inst_glass")

# the textured whole trace and the primary-hit pass (``ablate <tree>
# <workdir> tex``) on tex_blocks and tex_dof, rows 1-tex, 1t-tex and 2 of
# the dense design: (a) the exit the winner row's own t1 instead of the
# group scan over every row; (b) a flat per-box cull standing in for a
# perfect one: a box row is tested only where the ray meets its world
# AABB (|M|^T sizes / 2 about its position, 1e-3 slack) at or before its
# best t (any-hit: at all), so it tests the rows a perfect cull leaves and
# pays a slab test per box on top; (c) no texel fetches (the uv and the
# texel reads removed); (e) the row table read from global memory instead
# of staged in shared memory (trace_fwd.cu and hit3.cu). (d), the lane
# refill, is read from the live-step histogram (``_live_histogram``: the
# lane-steps a warp runs over those its rays need). Timing only: the
# variants' outputs are wrong.
_TX_EXIT = (
    "    exit_seg<kSphere>(tab, stride, L.sph_start, L.sph_n, wg, ox, oy, oz, "
    "dx,\n                      dy, dz, xbest, xrow);\n"
    "    exit_seg<kPlane>(tab, stride, L.pln_start, L.pln_n, wg, ox, oy, oz, "
    "dx,\n                     dy, dz, xbest, xrow);\n"
    "    exit_seg<kBox>(tab, stride, L.box_start, L.box_n, wg, ox, oy, oz, "
    "dx, dy,\n                   dz, xbest, xrow);\n")
_TX_OWN = (
    "    if (best < kBig && row >= L.box_start)\n"
    "      exit_seg<kBox>(tab, stride, row, 1, wg, ox, oy, oz, dx, dy, dz,\n"
    "                     xbest, xrow);\n"
    "    else if (best < kBig)\n"
    "      exit_seg<kPlane>(tab, stride, row, 1, wg, ox, oy, oz, dx, dy, dz,\n"
    "                       xbest, xrow);\n")
_TX_PRE = '''// (ablation) the world AABB test of box row r before its row test
__device__ __forceinline__ bool box_pre(const float* r, float ox, float oy,
                                        float oz, float ix, float iy,
                                        float iz, float best) {
  const float o[3] = {ox, oy, oz}, inv[3] = {ix, iy, iz};
  float tmin = -kBig, tmax = kBig;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float h = 0.5f * (fabsf(r[j]) * r[C_PA] + fabsf(r[3 + j]) *
                            r[C_PA + 1] + fabsf(r[6 + j]) * r[C_PA + 2]) +
                    1e-3f;
    const float t1 = (r[C_IP + j] - h - o[j]) * inv[j];
    const float t2 = (r[C_IP + j] + h - o[j]) * inv[j];
    tmin = fmaxf(tmin, fminf(t1, t2));
    tmax = fminf(tmax, fmaxf(t1, t2));
  }
  return tmax >= fmaxf(tmin, 0.0f) && tmin <= best;
}

// Entry sweep of one kind segment: strict `<` keeps the lowest row on ties.
'''
_TX_ENTRY = ("  for (int i = start; i < start + n; ++i) {\n    float t0, t1;\n"
             "    if (row_hit<K>(tab + i * stride, ox, oy, oz, dx, dy, dz, "
             "t0, t1) &&\n        t0 < best) {")
_TX_ANY = ("  for (int i = start; i < start + n; ++i) {\n    float t0, t1;\n"
           "    if (row_hit<K>(tab + i * stride, ox, oy, oz, dx, dy, dz, "
           "t0, t1))\n      return true;")
_TX_INV = ("  const float ix_ = 1.0f / (dx == 0.0f ? kEps : dx);\n"
           "  const float iy_ = 1.0f / (dy == 0.0f ? kEps : dy);\n"
           "  const float iz_ = 1.0f / (dz == 0.0f ? kEps : dz);\n")


def _tx_pre(loop, best):
    head = "  for (int i = start; i < start + n; ++i) {\n    float t0, t1;\n"
    return _TX_INV + loop.replace(head, head + (
        "    if (K == kBox && !box_pre(tab + i * stride, ox, oy, oz, ix_, "
        f"iy_, iz_, {best}))\n      continue;\n"))


TEX_ABLATIONS = {
    "tex_exit_own": [("hit3.cuh", _TX_EXIT, _TX_OWN)],
    "tex_box_flat_cull": [
        ("hit3.cuh", "// Entry sweep of one kind segment: strict `<` keeps "
         "the lowest row on ties.\n", _TX_PRE),
        ("hit3.cuh", _TX_ENTRY, _tx_pre(_TX_ENTRY, "best")),
        ("hit3.cuh", _TX_ANY, _tx_pre(_TX_ANY, "kBig"))],
    "tex_no_fetch": [
        ("trace_step.cuh", "  if (tv.id[0] >= 0) {\n    const float* px",
         "  if (false) {\n    const float* px"),
        ("trace_step.cuh", "    if (tv.id[s] >= 0) tv.v[2 + s] = __ldg(",
         "    if (false) tv.v[2 + s] = __ldg(")],
    "tex_rows_global": SWEEP_ABLATIONS["sweep_rows_global"] + [
        ("hit3.cu", "    mrt::stage(s_tab, tab, P, stride, "
         "mrt::kSweepCols);\n", ""),
        ("hit3.cu", "mrt::any_hit<kTri>(s_tab, mrt::kSweepCols,",
         "mrt::any_hit<kTri>(tab, stride,"),
        ("hit3.cu", "mrt::closest_hit<true, kTri>(s_tab, mrt::kSweepCols,",
         "mrt::closest_hit<true, kTri>(tab, stride,"),
        ("hit3.cu", "mrt::closest_hit<false, kTri>(s_tab, mrt::kSweepCols,",
         "mrt::closest_hit<false, kTri>(tab, stride,")],
}
TEX_SCENES = ("tex_blocks", "tex_dof")


def _routes(cs, dev):
    """The per-step route against the whole trace, whole and compacted, on
    ``inst_grid`` and ``inst_glass`` at the frame (one sample, 16 CUDA-event
    runs each, the primary-hit pass included): render (``trace_fused``
    with no cuts and with the JAX package's cuts; ``step.trace_steps``)
    and a training pass (forward and backward of the whole trace's
    ``TraceFunction``; of the per-step path's ``StepFunction`` chain)."""
    import torch

    from micro_raytracer_tpu_torch.models import tracer
    from micro_raytracer_tpu_torch.models.compiler import compile_scene
    from micro_raytracer_tpu_torch.ops import step

    out = {}
    for name in ("inst_grid", "inst_glass"):
        cfg = cs.inst_config(name)
        scene = compile_scene(cfg.scene, dev)
        tables = step.pack_step(scene)
        decay = tracer.decay_of(cfg.rt.loss)
        gen = torch.Generator(device=dev).manual_seed(2)
        oT, dT = cs.main_path_rays(cfg, gen, dev)
        u8s = torch.rand((cs.BOUNCE + 1, step.n_uni(scene.any_refract),
                          oT.shape[1]), generator=gen, device=dev)
        ct = torch.randn((3, oT.shape[1]), generator=gen, device=dev)
        loss = cfg.rt.loss
        cuts = tracer.jax_cuts(scene, cs.BOUNCE + 1)

        def render(c):
            return tracer.trace_fused(scene, tables, cs.BOUNCE, oT.T, dT.T,
                                      loss, u8s, cuts=c)

        def steps():
            return step.trace_steps(scene, tables, decay, oT, dT, u8s)

        tab = tables.tab.detach().requires_grad_(True)
        gt = tables._replace(tab=tab)

        def train_whole():
            A, B, _fl = step.TraceFunction.apply(
                tab, gt.lights, gt.tri, oT, dT, scene, gt, decay, u8s)
            torch.autograd.grad(((A + B) * ct).sum(), tab)

        def train_steps():
            A, B, _fl = step.trace_steps(scene, gt, decay, oT, dT, u8s)
            torch.autograd.grad(((A + B) * ct).sum(), tab)

        same = torch.equal(steps()[1], step.trace_packed(
            scene, tables, decay, oT, dT, u8s)[1])
        out[name] = {
            "render_whole_ms": cs.cuda_ms(lambda: render([]), 16),
            "render_compacted_ms": cs.cuda_ms(lambda: render(cuts), 16),
            "cuts": cuts,
            "render_steps_ms": cs.cuda_ms(steps, 16),
            "train_whole_ms": cs.cuda_ms(train_whole, 8),
            "train_steps_ms": cs.cuda_ms(train_steps, 8),
            "steps_equal_whole": same}
        print("route", name, json.dumps(out[name]), flush=True)
    return out


def _occupancy_table(cs, dev):
    """Resident warps per SM of ``inst_grid``'s whole-trace render instance
    against the rows its shared memory holds (each row 104 B beside its
    lights and cull blocks): the card's ``cudaOccupancy`` answer for the
    row counts of the Instance class."""
    import ctypes

    from micro_raytracer_tpu_torch.models.compiler import compile_scene
    from micro_raytracer_tpu_torch.ops import hit3, step

    scene = compile_scene(cs.inst_config("inst_grid").scene, dev)
    tables = step.pack_step(scene)
    t = hit3.table_args(tables.layout, tables.tri, tables.tbb, tables.sbb)
    out = {}
    for P in (0, 64, 128, 256, 384, 512, 768, 1008, 1536, 2048):
        for train in (0, 1):
            w = ctypes.c_int(0)
            # (a tree with the box walk takes its boxes, 0 here)
            box = [0] * (len(step.FWD_OCCUPANCY.argtypes) - 17)
            rc = step.FWD_OCCUPANCY.fn()(
                P, *t[:6], t[7], t[8], t[10], t[12], scene.n_lights, 0,
                int(scene.any_refract), train, 1, *box, ctypes.byref(w))
            out[f"{P} rows{' train' if train else ''}"] = \
                None if rc else w.value
    return out


def _sweep_extra(tree):
    """The unchanged tree's routes and occupancy table (``ablate ...
    sweep``)."""
    sys.path.insert(0, os.path.abspath(tree))
    os.chdir(tree)
    import torch

    import chip_smoke as cs

    dev = torch.device("cuda")
    print("occupancy", json.dumps(_occupancy_table(cs, dev)), flush=True)
    print("routes", json.dumps(_routes(cs, dev)), flush=True)


def _step_mode(tree, tag, carries_dir, what):
    """``_step_time``: a tree's step kernels on the per-step scenes at the
    frame (:func:`_step_sample` on the saved carries; the unchanged tree,
    ``tag`` base, also live-first), with ``csrc/step_*.cu``'s registers;
    ``_step_stats``: the walks' per-ray work (:func:`_step_stats`)."""
    sys.path.insert(0, os.path.abspath(tree))
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from micro_raytracer_tpu_torch.ops import step

    dev = torch.device("cuda")
    os.makedirs(carries_dir, exist_ok=True)
    if what == "stats":
        print("step_stats", json.dumps(_step_stats(cs, dev, carries_dir)),
              flush=True)
        return
    out = {}
    for name in ("lights8", "inst_grid3k", *getattr(cs, "BIG_NAMES", ())):
        cfg, scene, tables, decay = _step_setup(cs, name, dev)
        carries, u8s = _step_carries(
            cs, cfg, scene, tables, decay, dev,
            os.path.join(carries_dir, f"{name}.pt"))
        out[name] = _step_sample(cs, scene, tables, decay, carries, u8s,
                                 packed=tag == "base")
        del carries, u8s
    out["ptxas"] = step_ptxas(step.STEP_KERNEL.build_log,
                              step.STEP_BWD_KERNEL.build_log)
    print(tag, json.dumps(out), flush=True)


def step_ptxas(*logs):
    """``{kernel<template flags>: [registers, spill stores, spill loads]}``
    for the per-step kernels of ``nvcc -Xptxas -v`` logs."""
    out = {}
    for log in logs:
        for name, v in _ptxas(log).items():
            k = re.search(r"(step_(?:fwd|fwd_in|bwd)_kernel)I((?:Lb[01]E)+)",
                          name)
            if k:
                flags = ",".join(re.findall(r"Lb([01])E", k.group(2)))
                out[f"{k.group(1)}<{flags}>"] = list(v)
    return out


def ablate(tree, work, which="room"):
    """The ``ablate`` mode (module docstring)."""
    tree, work = os.path.abspath(tree), os.path.abspath(work)
    me = os.path.abspath(__file__)
    pkg = "micro_raytracer_tpu_torch"
    trees = {}
    variants = {"tri": TRI_ABLATIONS, "walk": TRI_WALK_ABLATIONS,
                "step": STEP_ABLATIONS, "steps": STEP_WALK_ABLATIONS,
                "sweep": SWEEP_ABLATIONS,
                "tex": TEX_ABLATIONS}.get(which, ABLATIONS)
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
               "hit3.KERNEL, step.KERNEL, step.BWD_KERNEL, step.STEP_KERNEL, "
               "step.STEP_BWD_KERNEL, tri.ENTRY_KERNEL" if which == "sweep"
               else
               "hit3.KERNEL, step.KERNEL, step.TRAIN_KERNEL, step.BWD_KERNEL, "
               "step.STEP_KERNEL, step.STEP_BWD_KERNEL, tri.ENTRY_KERNEL"
               if which == "tex" else
               "step.STEP_KERNEL, step.STEP_TRAIN_KERNEL, "
               "step.STEP_BWD_KERNEL, tri.ENTRY_KERNEL, "
               "tri.ENTRY_EXIT_KERNEL" if which in ("step", "steps") else
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
    if which in ("step", "steps"):
        # the base tree steps the frame first and saves the carries that
        # every variant times
        carries = os.path.join(work, "carries")
        for name in order:
            subprocess.run([sys.executable, me, "_step_time", trees[name],
                            name, carries], check=True)
        subprocess.run([sys.executable, me, "_step_stats", trees["base"],
                        carries], check=True)
        return
    if which == "sweep":
        for name in order:
            subprocess.run([sys.executable, me, "time", trees[name], name,
                            *SWEEP_SCENES], check=True)
        subprocess.run([sys.executable, me, "_sweep_extra", trees["base"]],
                       check=True)
        return
    if which == "tex":
        for name in order:
            subprocess.run([sys.executable, me, "time", trees[name], name,
                            *TEX_SCENES], check=True)
        _live_histogram(trees["base"], TEX_SCENES)
        return
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


def _live_histogram(tree, names=("room", "inst_grid")):
    """The live steps per ray (train instance) at the frame of the scenes
    ``names`` (the room and inst_grid): histogram, and the lane-steps a
    warp runs (its longest lane's count x 32) over those its lanes
    need."""
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from micro_raytracer_tpu_torch.models import tracer
    from micro_raytracer_tpu_torch.models.compiler import compile_scene
    from micro_raytracer_tpu_torch.ops import step

    dev = torch.device("cuda")
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
    diffs = {}
    for scene in a:
        for name in a[scene]:
            if name.endswith(SPLIT):
                continue
            x, y = a[scene][name], b[scene][name]
            note = ""
            if name.split("@")[0] in SUMS:
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
                if not ok and x.dim() == 2 and x.shape == y.shape \
                        and name.startswith("c@"):
                    # a carry: the rays that differ, with their input
                    # carry and uniforms, kept for a closer look
                    cols = ((x != y) & ~(x.isnan() & y.isnan())).any(0)
                    idx = cols.nonzero()[:, 0]
                    k = int(name[2:])
                    diffs[(scene, name)] = {
                        "idx": idx, "a": x[:, idx], "b": y[:, idx],
                        "c_in": a[scene][f"c@{k - 1}"][:, idx],
                        "u8": a[scene]["u8s"][k - 1][:, idx]}
                    note += f" (rays {idx[:8].tolist()}, rows " \
                        f"{((x != y).any(1)).nonzero()[:, 0].tolist()})"
                if not ok and name.split("_", 1)[-1] in CULLED_EXIT:
                    # a culled exit against an unculled one: reported,
                    # held ray by ray in chip_smoke.py phase 22
                    note += " (row 7's exit, culled against unculled)"
                    ok = True
            print(f"{scene} {name}: {'equal' if ok else 'DIFFERS'}{note}")
            same &= ok
    print("ALL SAME" if same else "OUTPUTS DIFFER")
    if diffs:
        out = os.path.join(os.path.dirname(os.path.abspath(b_path)),
                           "carry_diffs.pt")
        torch.save(diffs, out)
        print(f"the differing carries' rays: {out}")
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
    elif sys.argv[1:2] == ["_step_time"] and len(sys.argv) == 5:
        _step_mode(*sys.argv[2:], "time")
    elif sys.argv[1:2] == ["_step_stats"] and len(sys.argv) == 4:
        _step_mode(sys.argv[2], "", sys.argv[3], "stats")
    elif sys.argv[1:2] == ["_sweep_extra"] and len(sys.argv) == 3:
        _sweep_extra(sys.argv[2])
    elif sys.argv[1:2] == ["pairs"] and len(sys.argv) in (4, 5):
        pairs(*sys.argv[2:])
    elif sys.argv[1:2] == ["_room_worker"] and len(sys.argv) == 3:
        _room_worker(sys.argv[2])
    elif sys.argv[1:2] == ["reference"] and len(sys.argv) >= 5:
        reference(*sys.argv[2:])
    else:
        sys.exit(__doc__)
