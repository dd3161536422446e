#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                # from the repository root
    python3 chip_smoke.py --render-only  # phase 1 and the render timing
    python3 chip_smoke.py --train-only   # phases 1-2 and phase 8 alone
    python3 chip_smoke.py --compaction   # renders with and without
                                         # live-first compaction
    python3 chip_smoke.py --big          # phases 22-24 alone
    python3 chip_smoke.py --records      # phase 25 alone
    python3 chip_smoke.py --hit-split [tree]  # the closest hit's and its
                                         # VJP's host / device split (of
                                         # another checkout's package)
    python3 chip_smoke.py --gate <tree> [runs]  # the timing gate against
                                         # another checkout (below)

Phases, each of which raises on failure:

1. card: CUDA present; name and power limit from nvidia-smi; TF32 off.
2. build: nvcc builds every kernel source of ``micro_raytracer_tpu_torch/csrc``
   (``hit3.cu``, ``hit3_bwd.cu``, ``trace_fwd.cu`` with its render and
   train instances, ``trace_bwd.cu``, ``step_fwd.cu``,
   ``step_fwd_many.cu``, ``step_bwd.cu``, ``tri.cu``), one nvcc
   process per source, all started together.
3. closest_hit kernel against its plain PyTorch version on the slice
   scene's row table, on 2^17 random rays and on the main path's input
   (the primary rays of the whole 1080x1080 frame in Morton order, as
   views of lane-major rays): closest (entry + exit), entry-only and
   any-hit; rows equal, t within rtol 1e-5 / atol 1e-6. The primary-hit
   pass (``step.primary_hits``) timed at the frame, split into the host's
   time to issue a call and the device's time (``wrapper_split``; so in
   phases 9, 12 and 15).
4. The trace (primary-hit pass, then trace_fwd) against its plain
   version, bounce 8, the same uniforms, on 2^17 camera rays at random
   pixels and on the main path's input: A, B and radiance within rtol
   1e-4 / atol 1e-5 on all but at most 0.1% of rays, and A and B within
   1e-3 on the rest (a float32 rounding difference can flip a sampling
   branch such as ``u < 0.8`` or ``k >= 0``, and that ray's path then
   differs; measured: under 0.03% of rays, and under 2e-4 on the rest).
   Then the whole per-ray radiance on a 64x64 frame, CUDA against the CPU
   path, from the same uniforms. Both kernels and both plain versions are
   timed at the main path's shape.
5. main path: the CLI renders the slice scene (a CornellBox2-class room:
   five thin-box walls, two coloured, an emissive box light, a glass and a
   metal sphere, one point light) at 1080x1080, ssaa 1, bounce 8, 16 spp;
   the launch counters show it ran both kernels (the primary-hit pass and
   the trace, once per sample each) and never the plain versions;
   the image is non-constant and shows the lit emitter. Then 9 more
   renders: the median, quartiles and range of the render loop's rays/s
   over the 10. ``--render-only`` runs only phase 1 and this timing (one
   warm-up render, then 10); a copy of this file placed beside another
   tree's package times that tree's render loop the same way.
6. server: the HTTP service answers three render requests with JPEGs.
7. training kernels: on 2^17 camera rays of the slice scene and on the
   main path's frame (phase 4's inputs), bounce 8: the train instance of
   the trace kernel equals the render instance bit for bit (A, B,
   first_live) and agrees with ``trace_plain(want_resid=True)`` — the same
   outlier rule as phase 4, rays whose live-step count differs counted
   among the outliers; on the rest every live step's residuals within
   rtol 1e-4 / atol 1e-4 and the winner row, refract choice and occlusion
   bits equal. The backward kernel, fed the plain residuals and random
   output cotangents (zero on the outlier rays), agrees with autograd
   through the plain trace within rtol 2e-3 and an absolute floor of 1e-5
   of each array's largest magnitude; at the frame the kernel runs on the
   whole frame and the per-ray cotangents of a fixed 2^17 of its rays are
   held, with the table cotangents from a launch over those rays and the
   plain backward on them alone (``frame_subset``; so in phases 9, 12, 15
   and 18 too). Both kernels and both plain versions are timed (the plain
   backward on the 2^17 rays).
8. training main path: a target rendered with the true slice scene (the
   render kernels, 4 spp), ``mat_albedo`` and ``light_pwr`` perturbed,
   then 3 steps of ``make_train_step`` at 1080x1080, bounce 8, one path
   per pixel: the loss and every gradient finite, ``mat_albedo``,
   ``light_pwr`` and ``inst_pos`` with non-zero gradients, and the launch
   counters at one ``closest_hit``, ``trace_fwd_train`` and ``trace_bwd``
   per step and no plain version. It prints the seconds per step, fwd+bwd
   rays/s and peak device memory, then profiles one more step from the
   starting parameters for the device's busy time (over that step's wall:
   the busy share; and over the timed steps' mean), its operation count
   and its kernel times.
   ``--train-only`` runs phases 1, 2 and this one; beside another tree's
   package it times that tree's training step the same way.
9. mesh kernels: the two mesh scenes (the slice room with the glass sphere
   replaced by a 960-triangle torus: ``mesh_glass``, glass, whose sweeps
   take the group exit, and ``mesh_opaque``, diffuse, whose entry sweeps
   cull per 64-row block): every kernel against its plain version as in
   phases 3, 4 and 7 — closest_hit on 2^17 random and 2^17 camera rays
   (rows and t bit for bit), the trace on 2^17 camera rays, the train
   instance and the backward on 2^15 camera rays (the triangle cotangents
   included) — and each of them again at the main path's shape, the full
   frame, where they are timed; the triangle rows each sweep tests after
   the cull come from the plain version (``hit3.tri_rows_tested``,
   ``trace_plain(work=...)``). ``mesh_glass``'s render, compacted at steps
   3 and 6, against the unsegmented one at the frame, bit for bit. On
   ``mesh_glass`` the exit-mode sweep, whose triangle entry and group exit
   cull per block, against the unculled plain sweep (the JAX package's) on
   2^17 camera and 2^17 random rays: equal but on phantom entries and
   exits (phase 22's rule, at most PHANTOM_SHARE of the rays).
10. mesh main path: the CLI renders ``mesh_opaque`` and ``mesh_glass``,
   written as scene JSON files, at 1080x1080, bounce 8, 16 spp: both
   kernels once per sample and no plain version (launch counters), a
   non-constant image (``mesh_glass`` renders in three segments, one
   trace launch each: ``tracer.compact_cuts``); ten renders of each for
   the median, quartiles and range of rays/s, and one profiled render for
   the device's busy share. The HTTP service answers one ``mesh_glass``
   request.
11. mesh training: 3 steps of ``make_train_step`` on ``mesh_glass`` at
   1080x1080, bounce 8, one path per pixel, from perturbed ``mat_albedo``,
   ``light_pwr`` and torus ``inst_pos``: finite loss and gradients,
   non-zero ``inst_pos`` / ``inst_dir`` gradients on the torus rows, one
   ``closest_hit``, ``trace_fwd_train`` and ``trace_bwd`` per step; seconds
   per step, fwd+bwd rays/s, peak memory and one profiled step.

12. textured kernels: the stand-ins ``tex_dof`` (the class of dof.json: a
   checker-textured ground, a sphere-mapped, a metal, an emissive and a
   glass sphere, depth of field) and ``tex_blocks`` (the class of
   Minecraft.json: a 16 x 16 grid of unit boxes over a plane, 257 rows,
   eight materials whose cross-atlas textures use all six map slots),
   built here (tests/torch_tex_helpers.py imports them): the closest-hit
   pass, the trace's render instance (the kTex instances), its train
   instance (bit for bit the render instance; its residuals, texel rows
   included, against ``trace_plain(want_resid=True)``) and the backward
   (against autograd of the plain trace, phase 9's rule) on 2^17 camera
   rays and at the full frame, where they are timed and bounded. Beside
   OUTLIER_SHARE, at most TEX_FLIP_SHARE of the rays at a texel edge may
   be left out as shown texel flips: rays outside tolerance with a texel
   coordinate within 1e-4 of an integer at a live step (``trace_plain``'s
   ``work["tex_edge"]``). The plain forward runs in chunks of 2^18 rays.
   ``tex_blocks``'s box segment is walked (``csrc/box_walk.cuh``, the
   kBox instances of ``hit3.cu`` and ``trace_fwd.cu``): its closest hit in
   every mode and its render at the frame also equal the dense instances
   (the same tables without the walk) bit for bit, no dense winner lies
   outside the walk's boxes (``hit3.box_walk_phantoms``, at most
   PHANTOM_SHARE), and it logs the box rows and slab tests per sweep
   (``trace_plain``'s counts, ``hit3.box_walk_work``; the render's bound
   counts the exit side only on the steps whose draw can choose it), the
   dense
   instances' times and bounds beside the walk's, registers and warps per
   SM.
13. textured main path: the CLI renders both stand-ins from JSON files at
   1080x1080, bounce 8, 16 spp: both kernels once per sample and no plain
   version, every launch of ``tex_blocks`` the box walk's instances (the
   wrappers count them, ``CudaKernel.variants``) and none of
   ``tex_dof``'s; ten renders each for the spread of rays/s, one profiled; the
   HTTP service answers one ``tex_dof`` request.
14. textured training: 3 steps of ``make_train_step`` on ``tex_blocks``
   at 1080x1080, bounce 8, one path per pixel, as phase 8.
15. Instance-class kernels: the stand-ins ``inst_grid`` (the class of
   Instance.json: a 10 x 10 x 10 grid of instanced spheres over a plane,
   1,008 rows, the sphere segment culled in 16 blocks of 64 rows) and
   ``inst_glass`` (343 spheres, a twentieth glass: exit-mode sweeps whose
   exit is the winner row's own), built here (tests/torch_inst_helpers.py
   imports them); the kernels walk their sphere segments through 8-row
   sub-blocks (csrc/sph_walk.cuh). closest_hit in all three modes against
   its plain version, rows and t bit for bit, on 2^17 random rays, 2^17
   camera rays and the frame of ``inst_grid`` and on 2^17 rays of each
   kind of ``inst_glass``; the culled sweeps against the kernel's own
   dense sweeps, bit for bit, in every mode; on 2^17 camera rays of
   ``inst_glass`` the trace (phase 4's rule), its compacted render against
   the unsegmented one bit for bit, and the train instance (phase 7's
   rule); the trace (phase 4's rule), the train instance (bit for bit the
   render instance; residuals against ``trace_plain(want_resid=True)``)
   and the backward (phase 9's rule) on ``inst_grid``, on camera rays and
   at the frame; the render compacted at steps 2, 4 and 6 (the JAX
   package's cuts; the port renders this opaque grid whole) against the
   unsegmented one, bit for bit, as phases 9 and 12 do for each scene
   whose render compacts. Timed and bounded at the frame; the sphere rows
   the walk leaves and its block and sub-block slab tests are counted on
   N_WORK of the frame's rays (``sph_walk_work``, ``whole_walk_work``) and
   scaled, the lowest-first walk's bound (``hit3.sph_rows_tested``,
   ``trace_plain(work=...)``) beside them.
16. Instance-class main path: the CLI renders ``inst_grid`` from a JSON
   file at 1080x1080, bounce 8, 16 spp: one primary-hit launch per sample
   and one trace launch per segment of its render (``tracer.compact_cuts``)
   and no plain version; ten renders for the spread, one profiled; the
   HTTP service answers one ``inst_grid`` request.
17. Instance-class training: 3 steps of ``make_train_step`` on
   ``inst_grid`` as phase 8, from perturbed albedos, light power and
   sphere positions: non-zero ``inst_pos`` gradients on the sphere rows.

18. per-step kernels: the stand-ins of the per-step path, ``lights8`` (the
   Default class past 4 lights: a plane, 2 boxes, 4 spheres, one glass and
   one metal, under the sky and 8 lights, 5 point and 3 directional) and
   ``inst_grid3k`` (``inst_grid``'s generator at 15 x 15 x 15: 3,375
   spheres in 53 cull blocks and the plane, 3,384 rows, past the whole
   trace's 2,048), both routed to the per-step path (``step.route``).
   At the frame, the carry of each step from the render instance of
   step_fwd (each step timed); at steps 0 and 2 the render and train
   instances equal each other bit for bit and the plain step (hit equal,
   the carry by phase 4's rule, the residuals by phase 7's), and at step 0
   step_bwd matches autograd of the plain step (phase 7's rule); the
   per-step trace against the plain per-step trace on 2^17 camera rays
   (phase 4's rule). Timed and bounded at step 0 (every ray live).
19. per-step route: on the slice room, ``mesh_glass``, ``tex_blocks`` and
   ``inst_grid`` (2^15 camera rays, bounce 8) the per-step path equals the
   whole trace: A, B and first_live bit for bit, under a gradient d_oT
   and d_dT bit for bit and the table cotangents within rtol 1e-5, 1e-6 of
   each table's largest magnitude and ORDER_TOL of the entry's mass.
   Phases 3-17 launched no step kernel.
20. per-step main path: the CLI renders ``lights8`` and ``inst_grid3k``
   from JSON files at 1080x1080, bounce 8, 16 spp: BOUNCE + 1 step_fwd
   launches per sample and no trace_fwd or closest_hit launch, no plain
   version; STEP_RENDER_REPS renders for the spread, one profiled, the
   peak device memory of one render; the HTTP service answers one
   ``lights8`` request through the step kernel.
21. per-step training: 3 steps of ``make_train_step`` on ``lights8`` and
   on ``inst_grid3k`` as phase 8 (``mat_albedo`` from 0.5, ``light_pwr``
   x 0.3, against a 4-spp target; lr 1e-2, steps 2-3 timed; every leaf of
   ``lights8``, ``mat_albedo`` and ``light_pwr`` of ``inst_grid3k``,
   ``STEP_TRAIN_LEAVES``): BOUNCE + 1 launches each of step_fwd_train and
   step_bwd per step, no whole-trace kernel. Then ``lights_many``
   (``lights8``'s geometry under 2,051 lights, past the STEP_MAX_LIGHTS
   staged in shared memory) on 4,096 camera rays, bounce 1: the per-step
   render against the plain per-step trace, and at step 0, on 512 of the
   rays, step_fwd and step_fwd_train and step_bwd against their plain
   versions (phase 18's rules).

22. meshes past the staged cull blocks: ``mesh_big`` / ``mesh_big_glass``
   (``big_config``: the slice room at ten times its size with a torus of
   65,536 triangles, pallas_tri.MAX_PRIMS, in 1,024 cull blocks, diffuse /
   glass; the scene JSON names the mesh's OBJ file), routed to the
   per-step path with the triangle segment swept on its own: rows 6, 7 and
   8 (``tri_entry`` and ``tri_entry_exit``, the two-level walk through the
   cull blocks' superblocks, with every row's group exit and with half the
   rows marked to refract; ``tri_group_exit`` fed row 6's winner groups)
   against their plain versions on 2^17 random and 2^17 camera rays, rows
   and t bit for bit, row 7's entry equal to row 6's, and row 7's culled
   exit equal to row 8's unculled one where a triangle wins but on phantom
   exits (the unculled exit's hit point outside its block's AABB, at most
   PHANTOM_SHARE of the rays; also at each step of the glass frame); on
   2^15 of the camera rays step_fwd and step_fwd_train (their
   kTriIn instances) at steps 0 and 2 and step_bwd at step 0 by phase 18's
   rules, and the per-step trace against the plain per-step trace (phase
   4's rule). Timed at the frame: each kernel at step 0 (every ray live)
   and a sample's nine launches (the kTriIn step kernels fed the triangle
   sweep's result, swept beforehand), and on ``mesh_big`` row 7 with no
   row marked to refract (the opaque torus of ``mesh_big_mixed``); the
   plain versions only on the 2^17-ray sets; the work behind the bounds
   (superblock and block slab tests, rows the walk leaves, culled exit
   rows, shadow rows; beside them the one-level walk's: every block's slab
   test and the whole group's exit rows) counted at each step on a fixed
   2^17 of the frame's rays and scaled to the frame.
23. big mesh main path: the CLI renders ``mesh_big`` from its JSON and OBJ
   files at 1080x1080, bounce 8, 16 spp: one tri_entry and one step_fwd
   launch per step and sample, no whole-trace kernel and no plain version;
   BIG_RENDER_REPS renders for the spread, one profiled; ``mesh_big_glass``
   rendered once (BIG_GLASS_SAMPLES spp, tri_entry_exit counted), and
   ``mesh_big_mixed`` (the diffuse torus beside a glass sphere) once at 16
   spp, tri_entry_exit counted; the HTTP service answers one ``mesh_big``
   request.
24. big mesh training: 3 steps of ``make_train_step`` on ``mesh_big`` as
   phase 11 (albedos, light power and the torus' position perturbed):
   tri_entry, step_fwd_train and step_bwd BOUNCE + 1 times per step,
   finite gradients, non-zero on the torus rows.

25. the record path (``tracer.trace_radiance(fused=False)``,
   ``MRT_NO_FUSE=1``) and its differentiable closest hit: hit3_bwd (the
   closest hit's VJP, ``csrc/hit3_bwd.cu``) against its plain version
   (autograd of ``hit3.winner_t_plain``) on 2^17 camera rays of the room,
   ``mesh_glass``, ``tex_blocks`` and ``inst_grid``, real winners and
   seeded random cotangents (``check_hit_bwd``: per-ray d_o, d_d rtol 1e-6
   of the plain float32 version, the table cotangents within rtol 1e-5 of
   their terms' magnitudes, rays and terms that float64 shows
   ill-conditioned held to their float32 noise, at most ILL_BWD_SHARE of
   the rays; row and per-ray cotangents equal across two launches), the
   same on the full frame's rays of bounces REC_BWD_BOUNCES of the room and
   ``mesh_glass`` (rays that start on a surface or inside the glass), and
   timed at the room's frame with its byte bound (``wrapper_split``: the
   median of REC_BWD_ROUNDS rounds of CUDA-event means, the host's time to
   issue a call, a profiled round's device time, operations and kernel
   time, all on the kernels line); the
   closest hit's kWalk
   instance with a 64-bit block mask (``inst_grid3k``, 53 blocks) and its
   kGlobal instance (``box_grid``, 2,116 untextured boxes) against the
   plain sweep at the frame, rows and t bit for bit; the record path
   against the fused path on the same uniforms, one sample at the frame
   (the room and ``mesh_glass`` at bounce 8, ``inst_grid3k`` and
   ``mesh_big_glass`` at bounce REC_ROUTE_BOUNCE, which check their route
   only): radiance within rtol 1e-3 / atol 1e-4 on all but 0.5% of the
   pixels; the CLI with ``MRT_NO_FUSE=1`` renders the room at 16 spp
   (REC_RENDER_REPS renders, the median rays/s, closest-hit launches a
   sample, one profiled render's busy share; no whole-trace kernel, no
   plain version), and one room training step on the record path at the
   frame, 1 path a pixel, with and without ``remat`` (seconds, peak
   memory, BOUNCE + 1 hit3_bwd launches); ``tools/torch_grad_check.py`` on
   the room, ``tex_dof`` and ``mesh_glass`` (``--scene CornellBox``,
   ``dof``, ``Mesh``). ``--records`` runs phases 1, 2 and this one.

``--gate <tree> [runs]`` times every whole-trace kernel of the room, mesh,
textured and Instance-class stand-ins at the frame, hit3_bwd on the
room and ``mesh_glass`` (where the parent has it) and the per-step kernels of ``lights8`` and
``inst_grid3k`` in ``<tree>`` (the parent) and
in this script's own tree, a worker process each, in ``runs`` (GATE_RUNS)
interleaved runs (parent, change, change, parent, ...), each timing
spanning GATE_MS of launches, and fails a kernel whose median in this
tree exceeds both the parent's by more than GATE_TOL (2%) and the
parent's slowest run: a single run of a short launch spreads further
than 2%.

``--compaction`` renders ``inst_grid``, ``inst_glass``, ``mesh_opaque``
and ``mesh_glass`` through the CLI with the JAX package's compaction cuts
and without, in alternating order, for the medians that set
``tracer.compact_cuts``.

Every kernel's entry in the JSON line carries its bound: the larger of the
bytes it must move (inputs read once, outputs written once) over 3.35 TB/s
and the float32 operations this run's data needs over 67 TFLOP/s (the
H100 SXM's published rates), with operations counted by hand from the
sources (see ``ROW_TEST_OPS``, ``TRI_TEST_OPS`` and the step constants
below) and the data-dependent parts — live steps, occluded
lights, refract choices, the triangle rows the cull leaves — read from
this run's residuals and plain versions. A sweep counts the scene's valid
rows only: the kernels skip the invalid rows that pad each kind segment to
a multiple of 8. The block slab tests of the cull are not counted, but
for rows 6 and 7, whose work is mostly those tests. On a
textured scene the map ids, the atlas and its meta are read once, like
every other table, and each hit side's uv and each texel fetch count as
operations (``TEX_SIDE_OPS`` and the texture constants below). Where the
main path renders in segments, a render entry's ``ms`` is the segments'
summed kernel time (``segment_ms``), with the unsegmented instance's time
beside it (``unsegmented_ms``); its bound is that of the whole trace, the
same function of the same inputs. The whole-trace kernels' entries of the
room and of ``inst_grid`` (rows 1, 1t and 3) also carry the registers and
spilled bytes per thread ``nvcc`` gave their instance and the warps per SM
the card keeps resident of it (``step.instance_resources``).

It prints a JSON line of per-kernel results and the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. Without a
CUDA device, or without the package beside it, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

# the Mesh-class scenes: tests/torch_mesh_helpers.py holds the same torus
TORUS_POS = [-0.18, 0.12, -0.26]
TORUS_TILT = 0.45
MESH_MATS = {
    "mesh_opaque": {"rough": 0.6, "albedo": [0.8, 0.7, 0.3]},
    "mesh_glass": {"opacity": 0.0, "glass": 0.08},
}
MESH_NAMES = ("mesh_opaque", "mesh_glass")
N_MESH_BWD = 1 << 15
# the textured stand-ins (tests/torch_tex_helpers.py imports these builders)
TEX_NAMES = ("tex_dof", "tex_blocks")
TEX_CAMERAS = {
    "tex_dof": {"pos": [0, -1, 0.2], "fov": 60, "aprt": 0.05, "foc": 4.0},
    "tex_blocks": {"pos": [0, -1, 2], "dir": [0, 0, 1, -0.5], "fov": 70},
}
# (map slot, base material) of the eight block materials
BLOCK_MATS = (
    ("tex", {"rough": 0.9}),
    ("tex", {"rough": 0.7}),
    ("tex", {"rough": 0.5, "albedo": [0.8, 0.6, 0.4]}),
    ("rmap", {"albedo": [0.6, 0.6, 0.65]}),
    ("mmap", {"albedo": [0.9, 0.8, 0.3], "rough": 0.3}),
    ("gmap", {"opacity": 0.6, "glass": 0.1}),
    ("omap", {"albedo": [0.4, 0.7, 0.9], "glass": 0.05}),
    ("emap", {"albedo": [1.0, 0.5, 0.2]}),
)
BLOCK_BASES = ([0.3, 0.7, 0.2], [0.5, 0.5, 0.5], [0.6, 0.4, 0.2],
               [0.5, 0.5, 0.5], [0.5, 0.5, 0.5], [0.3, 0.3, 0.3],
               [0.7, 0.7, 0.7], [0.1, 0.1, 0.1])

# the Instance-class stand-ins (tests/torch_inst_helpers.py imports these
# builders): a grid of instanced spheres over a plane, seen from outside
INST_NAMES = ("inst_grid", "inst_glass")
INST_CAMERA = {"pos": [0, -2.6, 1.25], "fov": 60}
INST_DIMS = {"inst_grid": (10, 10, 10), "inst_glass": (7, 7, 7),
             "inst_grid3k": (15, 15, 15)}
INST_SMALL_DIMS = (6, 7, 7)
BOX_GRID_DIMS = (46, 46)
# the per-step path's stand-ins (tests/test_torch_steps.py imports their
# scene functions): lights8, an open scene under 8 lights, and inst_grid3k,
# the sphere grid past the whole-trace kernels' rows
STEP_NAMES = ("lights8", "inst_grid3k")
# the leaves phase 21 trains: every trainable leaf of lights8; the albedos
# and light power of inst_grid3k. There the cotangents grow ~20x per bounce
# step back through the grid of convex mirrors (inst_pos's gradient 4,871
# at the first step), so SGD at lr 1e-2 moves spheres by tens of units and
# the plane's inst_dir by 5-16. Trained on every leaf (--step-diagnosis),
# a run can push the plane's roll sine w past 1, where the packing's
# sqrt(1 - w^2) (linalg.rotate_y_mat, the reference's rotate_y) has no
# derivative: the packed tables' derivative is then not finite with no
# kernel run, while every step_bwd launch stays finite
# the meshes past the staged cull blocks (phases 22-24): the slice room at
# BIG_SCALE times its size with a torus of BIG_TORUS quads (big_config)
BIG_NAMES = ("mesh_big", "mesh_big_glass")
# phase 23 also renders the opaque torus beside a glass sphere
BIG_RENDER_NAMES = BIG_NAMES + ("mesh_big_mixed",)
BIG_SCALE = 10.0
BIG_TORUS = (256, 128)
BIG_RENDER_REPS = 3
BIG_GLASS_SAMPLES = 16
STEP_TRAIN_LEAVES = {"lights8": None,
                     "inst_grid3k": ("mat_albedo", "light_pwr")}
LIGHTS8_CAMERA = {"pos": [0, -0.6, -0.25], "fov": 60}

SLICE_ARGS = [
    "--obj", "box", "size:", "1", "1", "0.01", "pos:", "0", "0", "-0.5",
    "--obj", "box", "size:", "1", "1", "0.01", "pos:", "0", "0", "0.5",
    "--obj", "box", "size:", "1", "0.01", "1", "pos:", "0", "0.5", "0",
    "--obj", "box", "size:", "0.01", "1", "1", "pos:", "-0.5", "0", "0",
    "albedo:", "0.9", "0.15", "0.15",
    "--obj", "box", "size:", "0.01", "1", "1", "pos:", "0.5", "0", "0",
    "albedo:", "0.15", "0.9", "0.15",
    "--obj", "box", "size:", "0.3", "0.3", "0.01", "pos:", "0", "0", "0.49",
    "emit:", "1",
    "--obj", "sph", "r:", "0.15", "pos:", "-0.2", "0.1", "-0.35",
    "opacity:", "0", "glass:", "0.08",
    "--obj", "sph", "r:", "0.15", "pos:", "0.2", "-0.1", "-0.35",
    "metal:", "1", "rough:", "0.1",
    "--light", "point:", "0", "-0.1", "0.4", "pwr:", "0.5",
    "--cam", "pos:", "0", "-1.25", "0", "fov:", "60", "gamma:", "0.6",
    "exp:", "0.8",
]
RES = 1080
BOUNCE = 8
SAMPLES = 16
RENDER_REPS = 10
# renders of the per-step stand-ins for their spread (a sample of
# inst_grid3k takes nine launches over 3,384 rows)
STEP_RENDER_REPS = 5
N_CMP = 1 << 17
# the rays of the per-step checks that run a plain step nine times
# (phases 19 and 22: the per-step route and the big meshes' per-step trace)
N_STEP_CMP = 1 << 15
OUTLIER_SHARE = 0.001
# row 7's culled group exit may drop a phantom exit hit (outside its
# block's slacked AABB) that row 8's unculled exit finds: at most this share
# of the rays whose entry won, each shown to be such a phantom
PHANTOM_SHARE = 0.001
IN_ERR = 1e-3
TRAIN_STEPS = 3
# --step-diagnosis: independent runs of inst_grid3k's every-leaf training
# (its atomic sums make each run's path through the chaos its own)
CHAOS_RUNS = 8
TARGET_SPP = 4
G_RTOL, G_FLOOR = 2e-3, 1e-5
# a ray that meets a triangle is also held to this share of its own
# largest magnitude, and may differ from the plain version at most
# ILL_RATIO times as much as float64 moves the plain version (compare_bwd)
RAY_FLOOR, ILL_RATIO = 1e-3, 10.0
ILL_SHARE = 1e-4
# phase 18's step backward: a ray whose largest input-carry cotangent
# exceeds HEAVY times the median ray's (a grazing hit divides by d.n)
# is held per ray only, at most HEAVY_SHARE of the rays; the per-ray
# floors are taken within the carry's groups: o, d, and pwr, A, B
HEAVY, HEAVY_SHARE = 1e3, 1e-2
STEP_CARRY_GROUPS = ((0, 3), (3, 6), (6, 14))
SUM_TOL = 4e-4
# two float32 sums of the same terms in another order (the per-step path's
# table cotangents against the whole trace's) differ by a share of the
# terms' mass, taken over chunks of MASS_CHUNK rays: measured up to 4.5e-5
# of the mass over chunks of 8,192 rays on 2^17 rays of mesh_glass
ORDER_TOL, MASS_CHUNK = 1e-4, 1 << 12
PLAIN_CHUNK = 1 << 14

# The least time the card could take: bytes over the memory rate, float32
# operations over the peak rate outside the tensor cores (H100 SXM, NVIDIA's
# data sheet, at a 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Float operations counted by hand from the sources, rounded. One ray-row
# test of hit3.cuh row_hit: 36 to take the ray into the row's frame, about
# 33 for the kind's test (sphere quadratic, plane, or box slabs) and 4 for
# the validity checks.
ROW_TEST_OPS = 73
# One ray-triangle test of hit3.cuh tri_hit: 33 for o' = G o + h and d' =
# G d, 2 for the |d'_z| >= thr test, 2 for t, 4 for u and v, 6 for the
# barycentric and t bounds; tri_any: 33, 2, and 16 for the division-free
# bounds.
TRI_TEST_OPS, TRI_ANY_OPS = 47, 51
# One slab test of a 64-row block's AABB (hit3.cuh block_touch): per axis
# two differences, two products, a min and a max; then the interval's two
# maxima, a minimum and the two comparisons.
SLAB_OPS = 23
# One live step of trace_fwd.cu without its sweeps: hit point, normal,
# jittered normal and reflection, the fold (opaque scene); the refract side
# adds the exit normal, its jitter and the refraction; each light adds its
# shadow-ray origin and its direct-light term.
FWD_STEP_OPS, FWD_REFRACT_OPS, FWD_LIGHT_OPS = 140, 135, 70
# One live step of trace_bwd.cu: the primal recompute at the chosen hit and
# the transposes of the fold, the sampled direction, the normal and hit
# point and the winner t, with the accumulation; a refract choice adds the
# refraction's transpose; a visible light adds its term and transpose, an
# occluded one only the recompute.
BWD_STEP_OPS, BWD_REFRACT_OPS = 450, 100
BWD_LIGHT_OK_OPS, BWD_LIGHT_OCC_OPS = 160, 60


# Texture work (csrc/trace_step.cuh), counted by hand: a hit side's uv and
# map ids (the sphere map's normalize and atan2, the box's face tests), and
# one texel fetch (index and clip); the backward applies the saved texels
# of the chosen side and masks its cotangents.
TEX_SIDE_OPS, TEX_FETCH_OPS, TEX_BWD_OPS = 45, 8, 12
# shown texel flips (a texel coordinate within step.TEX_EDGE of an integer
# at a live step) may be dropped beside OUTLIER_SHARE: at most this share
# of the rays at a texel edge, rounded up (max_flips), so a kernel that is
# wrong at every texel edge fails
TEX_FLIP_SHARE = 0.25
# the plain forward over chunks of rays (a 257-row table's sweeps at the
# frame would hold (R, 256) float tensors of 1.2 GB each)
PLAIN_FWD_CHUNK = 1 << 18


def chunk_for(tables, base):
    """``base`` rays per chunk of a plain version, halved for every
    doubling of the dense rows past 511 (the plain sweeps hold (R, rows)
    float tensors)."""
    return base >> max(0, (tables.layout[1] // 256).bit_length() - 1)


def _buf(img):
    """(H, W, 3) float32 -> the inline buffer form of a texture."""
    h, w = img.shape[:2]
    return {"w": int(w), "h": int(h),
            "dat": [[float(c) for c in px] for px in img.reshape(-1, 3)]}


def _q(img):
    """Texels rounded to multiples of 1/255 (float32, as a PNG loads)."""
    import numpy as np

    k = np.clip(np.round(img * 255.0), 0, 255).astype(np.float32)
    return k / np.float32(255.0)


def checker(n, cells=8):
    """An n x n two-colour checker of cells x cells squares."""
    import numpy as np

    i = np.arange(n) * cells // n
    on = (i[:, None] + i[None, :]) % 2 == 1
    return _q(np.where(on[..., None], [0.9, 0.85, 0.7], [0.15, 0.2, 0.3]))


def sphere_map(w, h):
    """A w x h spherical map: bands of latitude, stripes of longitude."""
    import numpy as np

    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    r = 0.5 + 0.4 * np.cos(2 * np.pi * x / w)
    g = 0.5 + 0.4 * np.cos(np.pi * y / h)
    b = 0.3 + 0.3 * ((x // max(w // 8, 1) + y // max(h // 4, 1)) % 2)
    return _q(np.stack([r, g, b], -1))


def cross_atlas(rng, cell, base, spread=0.25):
    """A 4 cell x 3 cell cross atlas (the box uv layout): six face cells of
    ``base`` with per-texel noise and a darker rim."""
    import numpy as np

    img = np.zeros((3 * cell, 4 * cell, 3), np.float32)
    y, x = np.mgrid[0:cell, 0:cell]
    rim = (np.minimum(np.minimum(x, y), np.minimum(cell - 1 - x,
                                                   cell - 1 - y)) == 0)
    for cy, cx in ((0, 1), (1, 0), (1, 1), (1, 2), (1, 3), (2, 1)):
        face = np.asarray(base, np.float32) + spread * (
            rng.random((cell, cell, 3)) - 0.5)
        face[rim] *= 0.6
        img[cy * cell:(cy + 1) * cell, cx * cell:(cx + 1) * cell] = face
    return _q(np.clip(img, 0.0, 1.0))


def tex_dof(small=False):
    """``tex_dof`` (the class of dof.json): a checker-textured ground plane
    (64 x 64 texels), a metal, an emissive, a sphere-mapped (32 x 16) and a
    glass sphere, one point light, the sky; the camera has depth of
    field."""
    n, (sw, sh) = (8, (8, 4)) if small else (64, (32, 16))
    return {
        "renderer": [
            {"type": "plane", "n": [0, 0, 1], "pos": [0, 0, -0.5],
             "mat": {"tex": _buf(checker(n)), "rough": 0.8}},
            {"type": "sphere", "r": 0.5, "pos": [-1.2, 2.2, 0],
             "mat": {"metal": 1, "rough": 0.1}},
            {"type": "sphere", "r": 0.5, "pos": [0, 3.0, 0],
             "mat": {"tex": _buf(sphere_map(sw, sh)), "rough": 0.6}},
            {"type": "sphere", "r": 0.5, "pos": [1.3, 4.2, 0],
             "mat": {"emit": 1, "albedo": [1.0, 0.8, 0.5]}},
            {"type": "sphere", "r": 0.35, "pos": [0.5, 1.4, -0.15],
             "mat": {"glass": 0.08, "opacity": 0}},
        ],
        "light": [{"type": "point", "pos": [-2, 0, 3], "pwr": 0.6}],
        "sky": {"color": [0.5, 0.6, 0.8], "pwr": 0.6},
    }


def tex_blocks(small=False, grid=None):
    """``tex_blocks`` (the class of Minecraft.json): a 16 x 16 grid of unit
    boxes at stepped heights over a plane (257 rows), eight instanced box
    objects whose 64 x 48 cross-atlas textures use all six map slots
    (``small``: a 4 x 4 grid, 16 x 12 textures; ``grid``: a grid x grid
    one)."""
    import numpy as np

    grid, cell = ((4, 4) if small else (16, 16)) if grid is None \
        else (grid, 4 if small else 16)
    rng = np.random.default_rng(21)
    heights = rng.integers(0, 4, (grid, grid)) * 0.25
    which = rng.permutation(np.arange(grid * grid) % len(BLOCK_MATS))
    insts = [[] for _ in BLOCK_MATS]
    for k in range(grid * grid):
        i, j = divmod(k, grid)
        pos = [i - grid / 2 + 0.5, j + 1.0, -1.0 + float(heights[i, j])]
        rot = [0.3, 0.2, 1.0, 0.4] if k % 8 == 7 else [0, 0, 1, 0]
        insts[int(which[k])].append([pos, rot])
    objs = []
    for (slot, base), color, inst in zip(BLOCK_MATS, BLOCK_BASES, insts):
        img = cross_atlas(rng, cell, color)
        if slot in ("rmap", "mmap", "gmap", "omap", "emap"):
            red = {"rmap": img[..., 0],
                   "mmap": (img[..., 0] > 0.5).astype(np.float32),
                   "gmap": 0.2 * img[..., 0],
                   "omap": 0.3 + 0.7 * img[..., 0],
                   "emap": np.where(img[..., 0] > 0.15, 0.9, 0.0)}[slot]
            img = np.stack([_q(red)] + [img[..., 1], img[..., 2]], -1)
        objs.append({"type": "box", "sizes": [1, 1, 1], "inst": inst,
                     "mat": dict(base, **{slot: _buf(img)})})
    objs.append({"type": "plane", "n": [0, 0, 1], "pos": [0, 0, -1.5],
                 "mat": {"rough": 1.0, "albedo": [0.4, 0.35, 0.3]}})
    return {
        "renderer": objs,
        "light": [{"type": "point", "pos": [2, 4, 6], "pwr": 0.7}],
        "sky": {"color": [0.55, 0.7, 0.9], "pwr": 0.7},
    }


def lights8():
    """``lights8`` (the Default class, and more than 4 lights): a ground
    plane, 2 boxes and 4 spheres (one glass, one metal) under the sky, lit
    by 5 point and 3 directional lights. The scene is open, so that shadow
    rays escape: in a closed room an any-hit ray, which has no length,
    meets a wall and every light term is 0."""
    return {
        "renderer": [
            {"type": "plane", "n": [0, 0, 1], "pos": [0, 0, -1.0],
             "mat": {"rough": 0.8, "albedo": [0.55, 0.5, 0.45]}},
            {"type": "box", "sizes": [0.8, 0.8, 0.8],
             "pos": [-1.0, 2.6, -0.6],
             "mat": {"albedo": [0.8, 0.3, 0.25], "rough": 0.6}},
            {"type": "box", "sizes": [0.6, 1.0, 0.5],
             "pos": [1.0, 3.2, -0.75],
             "mat": {"albedo": [0.3, 0.6, 0.8], "rough": 0.4}},
            {"type": "sphere", "r": 0.45, "pos": [-0.25, 1.6, -0.55],
             "mat": {"opacity": 0, "glass": 0.08}},
            {"type": "sphere", "r": 0.4, "pos": [0.6, 2.0, -0.6],
             "mat": {"metal": 1, "rough": 0.1,
                     "albedo": [0.9, 0.85, 0.7]}},
            {"type": "sphere", "r": 0.35, "pos": [0.0, 3.4, -0.65],
             "mat": {"albedo": [0.9, 0.8, 0.3], "rough": 0.7}},
            {"type": "sphere", "r": 0.3, "pos": [-0.8, 1.3, -0.7],
             "mat": {"albedo": [0.4, 0.85, 0.5], "rough": 0.9}},
        ],
        "light": [
            {"type": "point", "pos": [-2, 0, 2], "pwr": 0.25},
            {"type": "point", "pos": [2, 1, 2.5], "pwr": 0.2,
             "color": [1.0, 0.8, 0.6]},
            {"type": "point", "pos": [0, 4, 1.5], "pwr": 0.15},
            {"type": "point", "pos": [-1, 2.5, 0.8], "pwr": 0.12,
             "color": [0.6, 0.7, 1.0]},
            {"type": "point", "pos": [1.5, 1.0, 0.5], "pwr": 0.1},
            {"type": "dir", "dir": [0.3, 0.5, -1], "pwr": 0.15},
            {"type": "dir", "dir": [-0.6, 0.2, -1], "pwr": 0.1,
             "color": [1.0, 0.9, 0.8]},
            {"type": "dir", "dir": [0.1, -0.8, -0.6], "pwr": 0.08},
        ],
        "sky": {"color": [0.55, 0.65, 0.85], "pwr": 0.4},
    }


def lights_many(n=2051):
    """``lights8``'s geometry under ``n`` lights, past the per-step
    kernels' STEP_MAX_LIGHTS staged ones (the rest read from global
    memory): point lights at seeded random places above the scene and
    every eighth a directional light, their powers summing to about 1."""
    import numpy as np

    rng = np.random.default_rng(n)
    lights = []
    for i in range(n):
        c = [float(v) for v in rng.uniform(0.5, 1.0, 3)]
        if i % 8 == 7:
            lights.append({"type": "dir", "pwr": 1.0 / n, "color": c,
                           "dir": [float(v) for v in rng.uniform(-1, 1, 2)]
                           + [-1.0]})
        else:
            lights.append({"type": "point", "pwr": 1.0 / n, "color": c,
                           "pos": [float(rng.uniform(-2.5, 2.5)),
                                   float(rng.uniform(0.0, 4.0)),
                                   float(rng.uniform(0.3, 2.5))]})
    return dict(lights8(), light=lights)


def lights8_json(res=None):
    """The render JSON of ``lights8`` at the main path's size."""
    res = RES if res is None else res
    return {"scene": lights8(),
            "frame": {"res": [res, res], "cam": LIGHTS8_CAMERA},
            "rt": {"bounce": BOUNCE, "sample": SAMPLES}}


def step_json(name, res=None):
    """The render JSON of a per-step stand-in at the main path's size."""
    return lights8_json(res) if name == "lights8" else inst_json(name, res)


def step_config(name):
    from micro_raytracer_tpu_torch.models import schema

    return schema.RenderConfig.from_json(step_json(name))


def inst_scene(name, small=False, dims=None):
    """``inst_grid`` (the class of Instance.json): a grid of spheres (r
    0.18, spacing 0.5; 10 x 10 x 10, or 6 x 7 x 7 with ``small``) over a
    ground plane, the sky, one point and one directional light. Every
    sphere is an instance of a renderer entry's ``inst`` list; the grammar
    gives an entry one material, so the grid is eight entries, one per
    material (seven diffuse, one metal for about a tenth of the spheres),
    albedo and roughness from a numpy seed. ``inst_glass``: a 7 x 7 x 7
    grid (or the small one) with a ninth entry, glass (opacity 0), for
    about a twentieth of the spheres: its entry sweeps take the group
    exit. ``inst_grid3k``: 15 x 15 x 15 spheres, as ``inst_grid``;
    ``dims`` sets another grid."""
    import numpy as np

    if dims is None:
        dims = INST_SMALL_DIMS if small else INST_DIMS[name]
    rng = np.random.default_rng(31)
    mats = [{"albedo": [float(x) for x in rng.uniform(0.2, 0.9, 3)],
             "rough": float(rng.uniform(0.3, 1.0))} for _ in range(7)]
    mats.append({"albedo": [0.9, 0.85, 0.7], "metal": 1,
                 "rough": float(rng.uniform(0.05, 0.3))})
    n = dims[0] * dims[1] * dims[2]
    which = rng.integers(0, 7, n)
    which[rng.random(n) < 0.1] = 7
    if name == "inst_glass":
        mats.append({"opacity": 0, "glass": 0.08})
        which[rng.random(n) < 0.05] = 8
    insts = [[] for _ in mats]
    for m, (i, j, k) in zip(which, np.ndindex(*dims)):
        pos = [(i - (dims[0] - 1) / 2) * 0.5, 1.5 + j * 0.5, k * 0.5 - 1.0]
        insts[int(m)].append([pos, [0, 0, 1, 0]])
    objs = [{"type": "sphere", "r": 0.18, "inst": inst, "mat": mat}
            for mat, inst in zip(mats, insts) if inst]
    objs.append({"type": "plane", "n": [0, 0, 1], "pos": [0, 0, -1.5],
                 "mat": {"rough": 0.9, "albedo": [0.5, 0.5, 0.45]}})
    return {
        "renderer": objs,
        "light": [{"type": "point", "pos": [-3, -1, 5], "pwr": 0.7},
                  {"type": "dir", "dir": [0.4, 0.6, -1], "pwr": 0.5}],
        "sky": {"color": [0.55, 0.65, 0.85], "pwr": 0.7},
    }


def box_grid(dims=BOX_GRID_DIMS):
    """``box_grid``: a grid of untextured unit-ish boxes (sizes 0.3, 0.3,
    0.2, spacing 0.4; 46 x 46 by default, 2,116 boxes, past the 2,048
    dense rows the closest-hit kernel stages, so the record path's hits run
    its kGlobal instance) over a ground plane, in the ``inst_grid``
    camera's view, four materials (three diffuse, one glass for about a
    tenth, so the sweeps take the group exit), the sky, one point and one
    directional light."""
    import numpy as np

    rng = np.random.default_rng(37)
    mats = [{"albedo": [float(x) for x in rng.uniform(0.2, 0.9, 3)],
             "rough": float(rng.uniform(0.4, 1.0))} for _ in range(3)]
    mats.append({"opacity": 0.2, "glass": 0.1})
    n = dims[0] * dims[1]
    which = rng.integers(0, 3, n)
    which[rng.random(n) < 0.1] = 3
    insts = [[] for _ in mats]
    for m, (i, j) in zip(which, np.ndindex(*dims)):
        pos = [(i - (dims[0] - 1) / 2) * 0.4, 1.0 + j * 0.4,
               float(rng.uniform(-1.4, -1.1))]
        insts[int(m)].append([pos, [0, 0, 1, float(rng.uniform(0, 0.3))]])
    objs = [{"type": "box", "sizes": [0.3, 0.3, 0.2], "inst": inst,
             "mat": mat} for mat, inst in zip(mats, insts) if inst]
    objs.append({"type": "plane", "n": [0, 0, 1], "pos": [0, 0, -1.5],
                 "mat": {"rough": 0.9, "albedo": [0.5, 0.5, 0.45]}})
    return {
        "renderer": objs,
        "light": [{"type": "point", "pos": [-3, -1, 5], "pwr": 0.7},
                  {"type": "dir", "dir": [0.4, 0.6, -1], "pwr": 0.5}],
        "sky": {"color": [0.55, 0.65, 0.85], "pwr": 0.7},
    }


def inst_json(name, res=None):
    """The render JSON of an Instance-class stand-in at the main path's
    size."""
    res = RES if res is None else res
    return {"scene": inst_scene(name),
            "frame": {"res": [res, res], "cam": INST_CAMERA},
            "rt": {"bounce": BOUNCE, "sample": SAMPLES}}


def inst_config(name):
    from micro_raytracer_tpu_torch.models import schema

    return schema.RenderConfig.from_json(inst_json(name))


def tex_scene(name, small=False):
    return {"tex_dof": tex_dof, "tex_blocks": tex_blocks}[name](small)


def tex_json(name, res=None):
    """The render JSON of a textured stand-in at the main path's size."""
    res = RES if res is None else res
    return {"scene": tex_scene(name),
            "frame": {"res": [res, res], "cam": TEX_CAMERAS[name]},
            "rt": {"bounce": BOUNCE, "sample": SAMPLES}}


def tex_config(name):
    from micro_raytracer_tpu_torch.models import schema

    return schema.RenderConfig.from_json(tex_json(name))


def fmt_bound(b: dict) -> str:
    return f"{b['bound_ms']:.4f} ms ({b['bound_by']})"


def bound(n_bytes: float, n_ops: float) -> dict:
    """bound_ms and what sets it."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return {"bound_ms": max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations"}


_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"chip_smoke [{time.perf_counter() - _T0:6.1f} s]: {msg}",
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def slice_config():
    from micro_raytracer_tpu_torch.frontends import cli

    return cli.parse_render(cli.build_parser().parse_args(SLICE_ARGS))


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def plain_ms(fn) -> float:
    """Milliseconds of one call of ``fn`` on the card (CUDA events), for a
    plain version that takes seconds at the frame (no warm-up run)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def outlier_rays(a, b, rtol, atol):
    """(R,) mask of rays whose (C, R) components are outside tolerance."""
    import torch

    return (~torch.isclose(a, b, rtol=rtol, atol=atol)).any(dim=0)


def frame_subset(R, device):
    """The fixed N_CMP rays of a frame of R rays (every ray for R <= N_CMP)
    on which a backward at the frame is held against its plain version:
    the plain backward of a whole frame takes 25-101 s."""
    import torch

    if R <= N_CMP:
        return None
    gen = torch.Generator().manual_seed(N_CMP)
    return torch.randperm(R, generator=gen)[:N_CMP].sort().values.to(device)


def phase_build():
    """One nvcc per source, all started together; then bind every entry
    point (entry points of one source share its library)."""
    from concurrent.futures import ThreadPoolExecutor

    from micro_raytracer_tpu_torch.ops import hit3, step, tri

    kernels = (hit3.KERNEL, step.KERNEL, step.TRAIN_KERNEL, step.BWD_KERNEL,
               step.STEP_KERNEL, step.STEP_TRAIN_KERNEL,
               step.STEP_BWD_KERNEL, tri.ENTRY_KERNEL, tri.ENTRY_EXIT_KERNEL,
               tri.EXIT_KERNEL,
               # the lights past the staged ones and the closest hit's VJP
               # (a parent tree timed by --gate may have no such library)
               *(k for k in (getattr(step, "STEP_MANY_KERNEL", None),
                             getattr(step, "STEP_MANY_TRAIN_KERNEL", None),
                             getattr(hit3, "BWD_KERNEL", None))
                 if k is not None))
    by_source = {k.source: k for k in kernels}
    t0 = time.perf_counter()

    def build(k):
        k.fn()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(by_source)) as pool:
        done = dict(zip(by_source, pool.map(build, by_source.values())))
    for src, k in by_source.items():
        log(f"built {src} in {done[src]:.2f} s")
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line \
                    or "Compiling entry" in line:
                log(f"  ptxas: {line.strip()}")
    for k in kernels:
        k.fn()


def random_rays(n, gen, device):
    """Rays from inside the room in uniformly random directions."""
    import torch

    o = (torch.rand((n, 3), generator=gen, device=device) - 0.5) * 0.9
    d = torch.randn((n, 3), generator=gen, device=device)
    return o, d / torch.linalg.vector_norm(d, dim=1, keepdim=True)


def camera_rays(cam, n, gen, device):
    """Primary rays: ``n`` random pixels, or for ``n = RES*RES`` the whole
    frame in the renderer's Morton order (the main path's trace input)."""
    import numpy as np
    import torch

    from micro_raytracer_tpu_torch.models import camera
    from micro_raytracer_tpu_torch.models.render import morton_ray_order

    if n == RES * RES:
        ys, xs = divmod(morton_ray_order(RES, RES), RES)
        coords = torch.from_numpy(np.stack([xs, ys], -1)).to(
            device, torch.float32)
    else:
        coords = torch.floor(
            torch.rand((n, 2), generator=gen, device=device) * RES)
    u_aprt = torch.rand((n, 2), generator=gen, device=device)
    return camera.gen_rays(cam, (RES, RES), coords, u_aprt)


def plain_hit(tables, o, d, mode):
    """``hit3.closest_hit_plain`` of the scene's tables, over chunks of
    rays (``chunk_for``) on a table of 512 dense rows or more."""
    import torch

    from micro_raytracer_tpu_torch.ops import hit3

    chunk = (chunk_for(tables, PLAIN_FWD_CHUNK) if tables.layout[1] >= 512
             else max(o.shape[0], 1))
    outs = [hit3.closest_hit_plain(tables.tab, tables.layout, o[s:s + chunk],
                                   d[s:s + chunk], mode, tables.tri,
                                   tables.tbb, tables.sbb, tables.box)
            for s in range(0, o.shape[0], chunk)]
    return tuple(torch.cat(x) for x in zip(*outs))


def compare_hit(tables, o, d, exact=False):
    """Kernel vs plain closest hit in every mode: rows equal, t within
    rtol 1e-5 / atol 1e-6 (bit for bit with ``exact``). Returns the max
    abs t error over hits."""
    import torch

    from micro_raytracer_tpu_torch.ops import hit3

    err = 0.0
    cull = (tables.tri, tables.tbb, tables.sbb)
    for mode in (hit3.MODE_EXIT, hit3.MODE_ENTRY, hit3.MODE_ANY):
        got = hit3.closest_hit(tables.tab, tables.layout, o, d, mode, *cull,
                               box=tables.box)
        ref = plain_hit(tables, o, d, mode)
        for name, g, r in zip(("te", "row", "tx", "xrow"), got, ref):
            if g.dtype == torch.int32 or exact:
                bad = g != r
            else:
                bad = ~torch.isclose(g, r, rtol=1e-5, atol=1e-6)
                fin = r.abs() < hit3.BIG * 0.5
                if bool(fin.any()):
                    err = max(err, float((g - r)[fin].abs().max()))
            if bool(bad.any()):
                raise AssertionError(f"closest_hit mode {mode}: {name} "
                                     f"differs on {int(bad.sum())} rays")
        hits = int((got[0] < hit3.BIG * 0.5).sum())
        tris = int((got[1] >= tables.layout[1]).sum())
        log(f"closest_hit mode {mode}, {o.shape[0]} rays: {hits} hit "
            f"({tris} on triangles), matches plain"
            f"{' bit for bit' if exact else ''}")
    return err


def main_path_rays(cfg, gen, dev):
    """The trace's input on the main path: camera rays of the whole frame
    in the renderer's Morton order, lane-major ``(3, R)``."""
    from micro_raytracer_tpu_torch.models.compiler import compile_camera

    o, d = camera_rays(compile_camera(cfg.frame.cam, dev), RES * RES, gen,
                       dev)
    return o.T.contiguous(), d.T.contiguous()


def valid_rows(scene, tables) -> int:
    """Dense rows a sweep must test: the valid sphere, plane and box rows
    (each kind segment of the row table is padded to a multiple of 8 with
    invalid rows)."""
    return int(scene.prim_valid[:tables.layout[1]].sum())


def table_bytes(scene, tables) -> int:
    """The row, light and triangle tables (and cull blocks) a kernel
    reads."""
    n = tables.tab.numel() + scene.n_lights * 11 + tables.tri.numel()
    for bb in (tables.tbb, tables.sbb,
               None if tables.box is None else tables.box.tab):
        n += 0 if bb is None else bb.numel()
    return 4 * n


def walked_rows(scene, tables) -> int:
    """The rows a walk tests in place of a dense sweep, counted from the
    plain versions instead: the valid sphere rows of a culled sphere
    segment and the boxes of a walked box segment (else 0)."""
    n = 0 if tables.box is None else tables.box.n
    if tables.sbb is None:
        return n
    return n + int(scene.prim_valid[scene.seg(0)].sum())


def sph_rows_tested(tables, o, d, mode):
    """``hit3.sph_rows_tested`` summed over chunks of rays."""
    from micro_raytracer_tpu_torch.ops import hit3

    chunk = chunk_for(tables, PLAIN_FWD_CHUNK)
    return sum(int(hit3.sph_rows_tested(tables.tab, tables.layout,
                                        o[s:s + chunk], d[s:s + chunk], mode,
                                        tables.sbb).sum())
               for s in range(0, o.shape[0], chunk))


def work_subset(R, device):
    """N_WORK fixed rays of a frame of R on which a walk's per-ray work
    is counted and scaled to the frame."""
    import torch

    gen = torch.Generator().manual_seed(N_WORK)
    return torch.randperm(R, generator=gen)[:N_WORK].to(device)


def whole_walk_work(scene, tables, resid, n_live):
    """What the whole trace's walks of a culled sphere segment
    (``csrc/sph_walk.cuh``) test over a trace whose train instance wrote
    ``resid`` and ``n_live``, counted on N_WORK of its rays
    (``sph_walk_work``, each live step's closest hit after step 0 and each
    light's shadow ray from the entry point) and scaled to the frame:
    ``{"sph_sweep", "sph_shadow"}`` rows and ``"sph_slabs"`` block and
    sub-block slab tests."""
    import torch

    from micro_raytracer_tpu_torch.ops import step

    K, _CR, R = resid.shape
    sub = work_subset(R, resid.device)
    n = n_live[sub].long()
    lights = tables.lights
    out = {"sph_sweep": 0.0, "sph_shadow": 0.0, "sph_slabs": 0.0}
    for k in range(K):
        on = k < n
        if not bool(on.any()):
            break
        r = resid[k][:, sub]
        o, d = r[step.RES_O:step.RES_O + 3].T, r[step.RES_D:step.RES_D + 3].T
        te = torch.where(on, r[step.RES_TE], 0.0)
        if k:
            slabs, rows = sph_walk_work(tables, o, d, on, False)
            out["sph_sweep"] += float(rows.sum())
            out["sph_slabs"] += float(slabs.sum())
        p = o + d * te[:, None]
        for li in range(scene.n_lights):
            lt = lights[li]
            lv = torch.where(lt[6] > 0.5, lt[3:6].expand_as(p), lt[0:3] - p)
            ln = lv / torch.sqrt((lv * lv).sum(1, keepdim=True))
            so = p + ln * 1e-4
            slabs, rows = sph_walk_work(tables, so, ln, on, True)
            out["sph_shadow"] += float(rows.sum())
            out["sph_slabs"] += float(slabs.sum())
    scale = R / sub.numel()
    return {k: v * scale for k, v in out.items()}


# the spin kernel (torch.cuda._sleep cycles, tens of ms) that holds the
# device while wrapper_split issues the calls it times
QUEUE_CYCLES = 50_000_000


def wrapper_split(fn, reps, names):
    """A wrapper ``fn`` split into host and device time: REC_BWD_ROUNDS
    CUDA-event means of ``reps`` calls (``ms``, their median; ``rounds``);
    ``reps`` calls issued behind a spin kernel that holds the device, so
    that the host's time to issue a call (``host_ms``) and the device's
    time for a call run back to back (``device_ms``, None where the host
    took longer than the spin) are measured apart; and from one profiled
    round of ``reps`` calls a call's device operations (``ops``) and the
    device time of the kernels whose name holds one of ``names``
    (``kernel_ms``), both None where the profiler kept fewer operations
    than calls (it drops records late in a long process)."""
    import numpy as np
    import torch

    rounds = [cuda_ms(fn, reps) for _ in range(REC_BWD_ROUNDS)]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    torch.cuda._sleep(QUEUE_CYCLES)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    ev[2].record()
    torch.cuda.synchronize()
    held = ev[0].elapsed_time(ev[1]) > host * 1e3

    def run():
        for _ in range(reps):
            fn()

    _o, _wall, _busy, n_ops, by_name = _busy_share(run)
    kern = sum(v for k, v in by_name.items() if any(n in k for n in names))
    kept = n_ops >= reps
    return {"ms": float(np.median(rounds)), "rounds": rounds,
            "host_ms": host * 1e3 / reps,
            "device_ms": ev[1].elapsed_time(ev[2]) / reps if held else None,
            "ops": n_ops / reps if kept else None,
            "kernel_ms": kern * 1e3 / reps if kept else None}


def fmt_split(t: dict) -> str:
    def f(x, form):
        return "not measured" if x is None else format(x, form)

    return (f"event mean {t['ms']:.4f} ms (median of "
            f"{[f'{x:.4f}' for x in t['rounds']]}), host {t['host_ms']:.4f} "
            f"ms a call, device {f(t['device_ms'], '.4f')} ms a call back to "
            f"back, {f(t['ops'], '.1f')} operations, the kernel "
            f"{f(t['kernel_ms'], '.4f')} ms (profiled)")


def time_hit(scene, tables, oT, dT, reps=20, plain_reps=5):
    """The primary-hit pass (``step.primary_hits``, the closest_hit kernel
    through its wrapper) split into host and device time
    (:func:`wrapper_split`) and its plain version timed on the main
    path's input (lane-major primaries as (R, 3) views), and the bound of
    that input:
    every valid dense row tested on the entry side, the triangle rows the
    cull leaves (the plain version counts them), and on refractive scenes
    with triangles the winner's group on the exit side (one row for a
    dense winner, the mesh's rows for a triangle winner, counted with the
    triangles; without triangles every group is one row and the winner's
    entry test gives its t1); a culled sphere segment counts the rows the
    cull leaves, a walked box segment the rows and slab tests of its
    walk. Returns the result and the
    triangle and sphere (or box) rows tested per ray."""
    import torch

    from micro_raytracer_tpu_torch.ops import hit3, step

    mode = step.primary_mode(scene)
    args = (tables.tab, tables.layout, oT.T, dT.T, mode, tables.tri,
            tables.tbb, tables.sbb)
    walk = None if tables.sbb is None else (tables.srows, tables.ssb)
    box = tables.box
    split = wrapper_split(lambda: step.primary_hits(scene, tables, oT, dT),
                          reps, ("closest_hit",))
    plain_ms = cuda_ms(lambda: plain_hit(tables, oT.T, dT.T, mode),
                       plain_reps)
    R = oT.shape[1]
    P = valid_rows(scene, tables) - walked_rows(scene, tables)
    te, row = hit3.closest_hit(*args, walk, box)[:2]
    dense_hits = (te < hit3.BIG * 0.5) & (row < tables.layout[1])
    exits = int(dense_hits.sum()) if scene.any_refract else 0
    tri_rows = int(hit3.tri_rows_tested(*args[:-1]).sum())
    sph, slabs, extra = 0, 0, {}
    if tables.sbb is not None:
        # the kernel's walk (sub-blocks, csrc/sph_walk.cuh) counted on
        # N_WORK of the frame's rays and scaled; the parent's lowest-first
        # walk of whole 64-row blocks beside it (its bound)
        sub = work_subset(R, oT.device)
        o, d = oT.T[sub], dT.T[sub]
        on = torch.ones(sub.numel(), dtype=torch.bool, device=oT.device)
        w_slabs, w_rows = sph_walk_work(tables, o, d, on, False)
        scale = R / sub.numel()
        sph = float(w_rows.sum()) * scale
        slabs = float(w_slabs.sum()) * scale
        old = sph_rows_tested(tables, o, d, mode) * scale
        extra = {"lowest_first_bound_ms": bound(
            R * (24 + 16) + table_bytes(scene, tables),
            (R * P + old + exits) * ROW_TEST_OPS)["bound_ms"],
            "sph_rows_per_ray": sph / R, "slabs_per_ray": slabs / R,
            "lowest_first_rows_per_ray": old / R}
    if box is not None:
        # the walk's box rows and slab tests (hit3.box_walk_work) on
        # N_WORK of the frame's rays, scaled; the dense sweep's bound
        # beside it
        sub = work_subset(R, oT.device)
        b_rows, b_slabs = hit3.box_walk_work(tables.tab, tables.layout,
                                             oT.T[sub], dT.T[sub], mode, box)
        scale = R / sub.numel()
        sph = float(b_rows.sum()) * scale
        slabs = float(b_slabs.sum()) * scale
        extra = {"dense_bound_ms": bound(
            R * (24 + 16) + table_bytes(scene, tables),
            (R * (P + box.n) + exits) * ROW_TEST_OPS)["bound_ms"],
            "box_rows_per_ray": sph / R, "slabs_per_ray": slabs / R}
    if not tables.layout[2]:
        # every group is one row: a dense winner's exit is its own t1 from
        # its entry test (the kTri instances sweep the dense rows again)
        exits = 0
    b = bound(R * (24 + 16) + table_bytes(scene, tables),
              (R * P + sph + exits) * ROW_TEST_OPS + tri_rows * TRI_TEST_OPS
              + slabs * SLAB_OPS)
    return ({**split, "plain_ms": plain_ms, **b, **extra}, tri_rows / R,
            sph / R)


def phase_hit(cfg, results):
    import torch

    from micro_raytracer_tpu_torch.models.compiler import compile_scene
    from micro_raytracer_tpu_torch.ops import step

    dev = torch.device("cuda")
    scene = compile_scene(cfg.scene, dev)
    tables = step.pack_step(scene)
    gen = torch.Generator(device=dev).manual_seed(1)
    err = compare_hit(tables, *random_rays(N_CMP, gen, dev))
    # the main path's input: the trace's row table and the primaries as
    # (R, 3) views of lane-major rays
    oT, dT = main_path_rays(cfg, gen, dev)
    err = max(err, compare_hit(tables, oT.T, dT.T))
    res, _rows, _sph = time_hit(scene, tables, oT, dT)
    log(f"closest_hit {oT.shape[1]} rays: {fmt_split(res)}, plain "
        f"{res['plain_ms']:.3f} ms, bound {fmt_bound(res)}")
    results["closest_hit"] = {"max_abs_err": err, **res,
                              "library_ms": None}


def plain_trace(scene, tables, decay, oT, dT, u8s, want_resid=False,
                work=None):
    """``step.trace_plain`` over chunks of PLAIN_FWD_CHUNK rays (each ray's
    trace is its own, so the result is the unchunked one's); ``work``
    gains the chunks' counts and, on a textured scene, their texel-edge
    rays."""
    import torch

    from micro_raytracer_tpu_torch.ops import step

    R = oT.shape[1]
    outs, edges = [], []
    chunk = chunk_for(tables, PLAIN_FWD_CHUNK)
    for s in range(0, R, chunk):
        sl = slice(s, min(R, s + chunk))
        w = None if work is None else {"sweep": 0, "shadow": 0}
        outs.append(step.trace_plain(
            scene, tables, decay, *(t[..., sl].contiguous()
                                    for t in (oT, dT, u8s)),
            want_resid=want_resid, work=w))
        if w is not None:
            for k in ("sweep", "shadow", "sph_sweep", "sph_shadow",
                      "box_sweep", "box_shadow", "box_slabs", "tex_fetch"):
                work[k] = work.get(k, 0) + w.get(k, 0)
            edges.append(w.get("tex_edge", torch.zeros(
                sl.stop - sl.start, dtype=torch.bool, device=oT.device)))
    if work is not None:
        work["tex_edge"] = torch.cat(edges)
    return tuple(torch.cat(x, -1) for x in zip(*outs))


def max_flips(n_edge: int) -> int:
    """The shown texel flips allowed among ``n_edge`` rays at a texel
    edge."""
    return math.ceil(TEX_FLIP_SHARE * n_edge)


def split_flips(bad, work, what):
    """Rays outside tolerance (``bad``): those shown to be texel flips (a
    texel coordinate within step.TEX_EDGE of an integer at a live step,
    ``work["tex_edge"]``), at most ``max_flips`` of the edge rays, and the
    rest,
    at most OUTLIER_SHARE. Returns (share of the rest, flips)."""
    import torch

    edge = (work or {}).get("tex_edge")
    flips = bad & edge if edge is not None else torch.zeros_like(bad)
    R = bad.shape[0]
    n_flip = int(flips.sum())
    n_edge = 0 if edge is None else int(edge.sum())
    if n_flip > max_flips(n_edge):
        raise AssertionError(f"{what}: {n_flip} shown texel flips exceed "
                             f"{TEX_FLIP_SHARE} of {n_edge} rays at a texel "
                             f"edge")
    return float((bad & ~flips).float().mean()), flips


def compare_trace(scene, tables, decay, oT, dT, u8s, work=None):
    """Kernels (primary-hit pass, then trace) vs the plain whole trace:
    first_live equal; A, B and radiance within rtol 1e-4 / atol 1e-5 on
    all but OUTLIER_SHARE of the rays besides shown texel flips (with
    ``work``, see ``split_flips``), and A and B within IN_ERR on the rest.
    Returns the max abs error of A and B over all rays."""
    import torch

    from micro_raytracer_tpu_torch.ops import step

    R = oT.shape[1]
    A, B, fl = step.trace_packed(scene, tables, decay, oT, dT, u8s)
    if work is None:
        A_r, B_r, fl_r = step.trace_plain(scene, tables, decay, oT, dT, u8s)
    else:
        A_r, B_r, fl_r = plain_trace(scene, tables, decay, oT, dT, u8s,
                                     work=work)
    n_fl = int((fl != fl_r).sum())
    if n_fl:
        raise AssertionError(f"trace_fwd: first_live differs on {n_fl} rays")
    sky = scene.sky_color[:, None]
    rad = torch.where(fl > 0.5, B + A * (sky * scene.sky_pwr), sky)
    rad_r = torch.where(fl_r > 0.5, B_r + A_r * (sky * scene.sky_pwr), sky)
    bad = torch.zeros(R, dtype=torch.bool, device=oT.device)
    for g, r in ((A, A_r), (B, B_r), (rad, rad_r)):
        bad |= outlier_rays(g, r, 1e-4, 1e-5)
    share, flips = split_flips(bad, work, "trace_fwd")
    err = float(max((A - A_r).abs().max(), (B - B_r).abs().max()))
    good = ~bad
    err_in = float(max((A - A_r)[:, good].abs().max(),
                       (B - B_r)[:, good].abs().max()))
    tex = (f"; {int(flips.sum())} of them shown texel flips (of "
           f"{int(work['tex_edge'].sum())} rays at a texel edge, "
           f"{work['tex_fetch']} texel fetches)"
           if scene.has_maps and work else "")
    log(f"trace_fwd {R} rays: {int(bad.sum())} rays outside rtol 1e-4{tex} "
        f"(share of the rest {share:.5f}, bound {OUTLIER_SHARE}); max abs "
        f"err of A/B {err:.3g} over all rays, {err_in:.3g} over the rest "
        f"(bound {IN_ERR})")
    if share > OUTLIER_SHARE or err_in > IN_ERR:
        raise AssertionError("trace_fwd disagrees with its plain version")
    return err


def phase_trace(cfg, results):
    import torch

    from micro_raytracer_tpu_torch.models import tracer
    from micro_raytracer_tpu_torch.models.compiler import (compile_camera,
                                                           compile_scene)
    from micro_raytracer_tpu_torch.ops import hit3, step

    dev = torch.device("cuda")
    scene = compile_scene(cfg.scene, dev)
    cam = compile_camera(cfg.frame.cam, dev)
    tables = step.pack_step(scene)
    decay = tracer.decay_of(cfg.rt.loss)
    gen = torch.Generator(device=dev).manual_seed(2)
    nu = step.n_uni(scene.any_refract)

    def uniforms(n):
        return torch.rand((BOUNCE + 1, nu, n), generator=gen, device=dev)

    o, d = camera_rays(cam, N_CMP, gen, dev)
    err = compare_trace(scene, tables, decay, o.T.contiguous(),
                        d.T.contiguous(), uniforms(N_CMP))
    oT, dT = main_path_rays(cfg, gen, dev)   # the main path's shape
    u8s = uniforms(RES * RES)
    err = max(err, compare_trace(scene, tables, decay, oT, dT, u8s))
    hit0 = step.primary_hits(scene, tables, oT, dT)
    ms = cuda_ms(lambda: step.trace_fwd(scene, tables, decay, oT, dT, u8s,
                                        hit0), 5)
    plain_ms = cuda_ms(lambda: step.trace_plain(scene, tables, decay, oT, dT,
                                                u8s), 2)
    log(f"trace_fwd {RES * RES} rays x {BOUNCE + 1} steps: kernel "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms")
    results["trace_fwd"] = {"max_abs_err": err, "ms": ms,
                            "plain_ms": plain_ms, "library_ms": None}
    # phase 7 runs the train instance on the same inputs and counts this
    # kernel's work from its residuals
    results["main_inputs"] = (scene, tables, decay, oT, dT, u8s, hit0)

    # the whole radiance function on a small frame: the CUDA kernel path
    # against the CPU path, fed the same uniforms
    xs, ys = torch.meshgrid(torch.arange(64.0), torch.arange(64.0),
                            indexing="xy")
    coords = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1)
    cpu_gen = torch.Generator().manual_seed(3)
    u_aprt, u8 = tracer.draw_uniforms(cpu_gen, coords.shape[0], BOUNCE,
                                      scene.any_refract, "cpu")
    rad_gpu = tracer.trace_radiance_u(
        scene, cam, (64, 64), BOUNCE, cfg.rt.loss, coords.to(dev),
        u_aprt.to(dev), u8.to(dev), tables).cpu()
    rad_cpu = tracer.trace_radiance_u(
        compile_scene(cfg.scene, "cpu"), compile_camera(cfg.frame.cam, "cpu"),
        (64, 64), BOUNCE, cfg.rt.loss, coords, u_aprt, u8)
    if not bool(torch.isfinite(rad_gpu).all()):
        raise AssertionError("non-finite radiance")
    share_f = float(outlier_rays(rad_gpu.T, rad_cpu.T, 1e-4,
                                 1e-5).float().mean())
    log(f"trace_radiance_u 64x64 cuda vs cpu: outlier share {share_f:.5f}")
    if share_f > OUTLIER_SHARE:
        raise AssertionError("CUDA radiance disagrees with the CPU path")


class _NoSceneEcho(logging.Filter):
    """Drops the CLI's and the HTTP service's echo of the scene they
    render (``cli:render``, ``http:render``): a 65,536-triangle mesh makes
    each one a line of megabytes."""

    def filter(self, record):
        return not str(record.msg).startswith(("cli:render", "http:render"))


class _SampleLog(logging.Handler):
    """The CLI's ``cli:sample:<last sample>: <seconds>`` lines, one per
    pass of up to 64 samples."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.seconds = []
        self.last = -1

    def emit(self, record):
        if str(record.msg).startswith("cli:sample:"):
            self.last = int(record.args[0])
            self.seconds.append(float(record.args[1]))


def render_cli(out, scene_args=SLICE_ARGS, samples=SAMPLES):
    """One CLI render of the main path (the slice scene's flags, or a
    scene JSON file) at ``samples`` spp: (render loop seconds, wall
    seconds). The loop's seconds are the sum of the CLI's per-sample
    times, each taken after a synchronize."""
    from micro_raytracer_tpu_torch.frontends import cli

    handler = _SampleLog()
    logging.getLogger("raytrace").addHandler(handler)
    t0 = time.perf_counter()
    try:
        rc = cli.main(list(scene_args) + [
            "--res", str(RES), str(RES), "--ssaa", "1", "--bounce",
            str(BOUNCE), "--sample", str(samples), "--device", "cuda",
            "-v", "-o", out])
    finally:
        logging.getLogger("raytrace").removeHandler(handler)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"CLI render failed: rc={rc}")
    if handler.last != samples - 1:
        raise AssertionError(f"CLI logged samples up to {handler.last}")
    return sum(handler.seconds), wall


def render_spread(render_s, card):
    """Median, quartiles and range of render-loop rays/s over renders."""
    import numpy as np

    rate = RES * RES * SAMPLES / np.asarray(render_s)
    q1, med, q3 = (float(x) for x in np.percentile(rate, [25, 50, 75]))
    log(f"render loop over {len(rate)} renders on {card}: median "
        f"{med / 1e6:.2f}M rays/s, quartiles {q1 / 1e6:.2f}M / "
        f"{q3 / 1e6:.2f}M, range {rate.min() / 1e6:.2f}M-"
        f"{rate.max() / 1e6:.2f}M; seconds "
        f"{[f'{x:.4f}' for x in render_s]}")
    return {"renders": len(rate), "median_rays_per_s": med,
            "q1_rays_per_s": q1, "q3_rays_per_s": q3,
            "render_s": list(render_s)}


def phase_main(card, counts):
    """The CLI render, counted and checked; then RENDER_REPS - 1 more
    renders for the render loop's spread."""
    import numpy as np
    from PIL import Image

    from micro_raytracer_tpu_torch.ops import hit3, step

    kernels = (hit3.KERNEL, step.KERNEL)
    for k in kernels:
        k.launches = 0
        k.plain_calls = 0
    out = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_"), "slice.png")
    render_s, wall = render_cli(out)
    for k in kernels:
        counts[k.name] = k.launches
        if k.plain_calls:
            raise AssertionError(f"main path ran the plain version of "
                                 f"{k.name} {k.plain_calls} times")
    if step.KERNEL.launches <= 0 or hit3.KERNEL.launches <= 0:
        raise AssertionError(f"main path skipped a kernel: {counts}")
    img = np.asarray(Image.open(out))
    if img.shape != (RES, RES, 3):
        raise AssertionError(f"image shape {img.shape}")
    if float(img.std()) < 5.0:
        raise AssertionError("image is (nearly) constant")
    # the ceiling light (emit 1) projects to rows ~150-200, columns ~480-600
    emitter = img[140:210, 470:610].min(axis=2)
    if int(emitter.max()) < 250:
        raise AssertionError("the emitter is not lit in the image")
    rays = RES * RES * SAMPLES
    log(f"main path: {RES}x{RES} x {SAMPLES} spp, bounce {BOUNCE}: render "
        f"loop {render_s:.3f} s = {rays / render_s / 1e6:.2f}M rays/s, CLI "
        f"wall {wall:.3f} s = {rays / wall / 1e6:.2f}M rays/s on {card}; "
        f"launches {counts}")
    loops = [render_s] + [render_cli(out)[0] for _ in range(RENDER_REPS - 1)]
    return {"render_s": render_s, "wall_s": wall,
            "rays_per_s": rays / render_s, "wall_rays_per_s": rays / wall,
            "spread": render_spread(loops, card)}


def render_only(card):
    """``--render-only``: one warm-up render (it builds the kernels), then
    RENDER_REPS timed renders, through the CLI of the package beside this
    file. Copied beside another tree's package, it times that tree's
    render loop the same way."""
    out = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_"), "slice.png")
    render_cli(out)
    return render_spread([render_cli(out)[0] for _ in range(RENDER_REPS)],
                         card)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port: int, body: bytes) -> bytes:
    raw = (b"POST /render HTTP/1.1\r\nContent-Type: application/json\r\n"
           + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    with socket.create_connection(("127.0.0.1", port), timeout=300) as s:
        s.sendall(raw)
        out = b""
        while True:
            chunk = s.recv(1 << 20)
            if not chunk:
                return out
            out += chunk


def phase_server(cfg, requests=3):
    """The HTTP service answers ``requests`` render requests of ``cfg``
    with JPEGs, through the kernels of its route alone (``step.route``:
    the primary-hit and trace kernels, or the step kernel)."""
    from micro_raytracer_tpu_torch.frontends.http import HttpServer
    from micro_raytracer_tpu_torch.models.compiler import compile_scene
    from micro_raytracer_tpu_torch.ops import hit3, step

    steps = step.route(compile_scene(cfg.scene, "cpu"), False) == "steps"
    kernels = (step.STEP_KERNEL,) if steps else (hit3.KERNEL, step.KERNEL)
    for k in kernels:
        k.launches = 0
        k.plain_calls = 0

    port = _free_port()
    srv = HttpServer(f"127.0.0.1:{port}", device="cuda")
    th = threading.Thread(target=srv.start, daemon=True)
    th.start()
    deadline = time.time() + 60
    while True:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            break
        except OSError:
            if time.time() > deadline or not th.is_alive():
                raise AssertionError("HTTP server did not start")
            time.sleep(0.1)
    try:
        req = cfg.to_json()
        req["rt"] = {"bounce": BOUNCE, "sample": 4, "loss": cfg.rt.loss}
        req["frame"]["res"] = [256, 256]
        body = json.dumps(req).encode()
        for i in range(requests):
            t0 = time.perf_counter()
            res = _post(port, body)
            head, _, jpg = res.partition(b"\r\n\r\n")
            if not head.startswith(b"HTTP/1.1 200 OK") \
                    or b"Content-Type: image/jpeg" not in head \
                    or jpg[:2] != b"\xff\xd8":
                raise AssertionError(f"request {i}: {res[:80]!r}")
            log(f"http request {i}: 200 image/jpeg, {len(jpg)} bytes, "
                f"{time.perf_counter() - t0:.3f} s")
    finally:
        srv.stop()
        th.join(timeout=30)
    if th.is_alive():
        raise AssertionError("HTTP server did not stop")
    if any(k.launches == 0 or k.plain_calls for k in kernels):
        raise AssertionError(f"HTTP requests: launches "
                             f"{[k.launches for k in kernels]}, plain calls "
                             f"{[k.plain_calls for k in kernels]}")


def trace_work(scene, tables, u8s, resid, n_live, tri_work=None):
    """Bounds of the render instance, the train instance and the backward
    kernel on these inputs, from the work their data asks for (read from
    the train instance's residuals; ``tri_work``, from
    ``trace_plain(work=...)``, holds the triangle rows the sweeps test and,
    where the sphere segment is culled, the sphere rows)."""
    import torch

    from micro_raytracer_tpu_torch.ops import step

    K, NU, R = u8s.shape
    # a culled sphere segment's rows are counted by the plain version
    L = scene.n_lights
    P = valid_rows(scene, tables) - walked_rows(scene, tables)
    n = n_live.long()
    idx = torch.arange(R, device=n.device)
    live = torch.arange(K, device=n.device)[:, None] < n[None]     # (K, R)
    S = int(live.sum())
    # the emit draw ended the path at its last live step, read at the
    # chosen side's row
    last = (n - 1).clamp(min=0)
    rl = resid[last, :, idx]                                      # (R, CR)
    # (the exit row is saved on scenes with triangles, else it is the row)
    crow = rl[:, step.RES_ROW]
    chose = rl[:, step.RES_CHOOSE] > 0.5
    if tables.layout[3]:
        crow = torch.where(chose, rl[:, step.res_xrow(L)], crow)
    row = torch.where(n > 0, crow, 0.0).long()
    emit = tables.tab[row, step._C_EMI]
    if scene.has_maps and scene.map_slots[5]:
        # a mapped emit is the chosen side's saved texel (the last slot
        # of its side's texel rows)
        side = step.tex_side_rows(scene.map_slots)
        r5 = (step.res_rows(L, tables.layout[3]) + side - 1
              + torch.where(chose, side, 0))
        emit = torch.where(tables.maps[row, 5] >= 0, rl[idx, r5], emit)
    killed = (n > 0) & (u8s[last, NU - 1, idx] < emit)
    # closest-hit sweeps (of the P valid rows) after step 0: each later
    # live step, and the step whose sweep missed; on refractive scenes each
    # hit also tests its group's exit (one row here)
    later = int((n - 1).clamp(min=0).sum())
    sweeps = later + int(((n > 0) & (n < K) & ~killed).sum())
    # (the box walk's exit is the winner's own t1, from its entry test)
    exits = later if scene.any_refract and tables.box is None else 0
    # shadow sweeps: a visible light tests every row, an occluded one at
    # least one
    lok = resid[:, step.RES_LOK:step.RES_LOK + L] > 0.5            # (K, L, R)
    vis = int((lok & live[:, None]).sum())
    occ = S * L - vis
    sph = 0
    if tables.sbb is not None:
        # the sphere rows the sweeps test (a shadow ray's to its first
        # hit); an occluded light's row past them is left out
        sph = (tri_work["sph_sweep"] + tri_work["sph_shadow"]
               + tri_work.get("sph_slabs", 0) * SLAB_OPS / ROW_TEST_OPS)
        occ = 0
    if tables.box is not None:
        # the box rows the walk tests and its node and leaf slab tests
        # (trace_plain's counts; a shadow ray's rows to its first hit)
        sph += (tri_work["box_sweep"] + tri_work["box_shadow"]
                + tri_work["box_slabs"] * SLAB_OPS / ROW_TEST_OPS)
        occ = 0
    chosen = (int(((resid[:, step.RES_CHOOSE] > 0.5) & live).sum())
              if scene.any_refract else 0)
    # the live steps whose exit side (its point, normal, refraction and
    # texels) is computed: every one on a refractive scene, but in the
    # walked box segment's render (ray_step) only where the draw can
    # choose it, u6 < min(1 - opacity, 0.85) at the entry side (its
    # texel where the opacity is mapped); its train instance computes all
    x_train = live if scene.any_refract else torch.zeros_like(live)
    x_fwd = x_train
    if tables.box is not None and scene.any_refract:
        row_e = torch.where(live, resid[:, step.RES_ROW].long(), 0)
        opa = tables.tab[row_e, step._C_OPA]
        if scene.has_maps and scene.map_slots[4]:
            r4 = step.res_rows(L, tables.layout[3]) + sum(
                3 if s == 0 else 1 for s in range(4) if scene.map_slots[s])
            opa = torch.where(tables.maps[row_e, 4] >= 0, resid[:, r4], opa)
        x_fwd = live & (u8s[:, 6] < torch.clamp(1.0 - opa, max=0.85))
    fwd_ops = ((sweeps * P + exits + vis * P + occ + sph) * ROW_TEST_OPS
               + S * (FWD_STEP_OPS + L * FWD_LIGHT_OPS))
    if tri_work is not None:
        fwd_ops += (tri_work["sweep"] * TRI_TEST_OPS
                    + tri_work["shadow"] * TRI_ANY_OPS)
    train_ops = fwd_ops + int(x_train.sum()) * FWD_REFRACT_OPS
    fwd_ops += int(x_fwd.sum()) * FWD_REFRACT_OPS
    tables_b = table_bytes(scene, tables)
    # primaries, hits and outputs per ray; uniforms per live step
    fwd_b = R * (24 + 16 + 28) + S * NU * 4 + tables_b
    CR = step.scene_res_rows(scene, tables.layout)
    train_b = fwd_b + S * CR * 4 + R * 4
    bwd_ops = (S * BWD_STEP_OPS + chosen * BWD_REFRACT_OPS
               + vis * BWD_LIGHT_OK_OPS + occ * BWD_LIGHT_OCC_OPS)
    # n_live, ctA/ctB in, d_o/d_d out per ray; residuals and uniforms per
    # live step; tables in, their cotangents (every row) out
    d_tables_b = table_bytes(scene, tables)
    bwd_b = (R * (4 + 24 + 24) + S * (CR + NU) * 4 + tables_b
             + d_tables_b)
    fetches = 0
    if scene.has_maps:
        # operations per live step and hit side (the exit side on the
        # steps that compute it, above): the uv and the map ids, and each
        # texel fetch; bytes: the map ids, the atlas and its meta read once
        # (a few hundred KB, held in L2), the backward the map ids only
        r_e = resid[:, step.RES_ROW].long()
        r_x = (resid[:, step.res_xrow(L)].long() if tables.layout[3]
               else r_e)
        fetch_e, fetch_x = ((tables.maps[torch.where(live, r, 0)] >= 0)
                            .sum(-1) * live for r in (r_e, r_x))
        fetches = int(fetch_e.sum()) + int((fetch_x * x_fwd).sum())
        fetches_t = int(fetch_e.sum()) + int((fetch_x * x_train).sum())
        maps_b = 4 * tables.maps.numel()
        tex_b = maps_b + 4 * (tables.atlas.numel() + tables.tmeta.numel())
        fwd_ops += ((S + int(x_fwd.sum())) * TEX_SIDE_OPS
                    + fetches * TEX_FETCH_OPS)
        train_ops += ((S + int(x_train.sum())) * TEX_SIDE_OPS
                      + fetches_t * TEX_FETCH_OPS)
        fwd_b += tex_b
        train_b += tex_b
        bwd_ops += S * TEX_BWD_OPS
        bwd_b += maps_b
    return {"trace_fwd": bound(fwd_b, fwd_ops),
            "trace_fwd_train": bound(train_b, train_ops),
            "trace_bwd": bound(bwd_b, bwd_ops), "live_steps": S,
            "texel_fetches": fetches,
            "exit_side_steps": int(x_fwd.sum())}


def compare_train_fwd(scene, tables, decay, oT, dT, u8s, hit0, work=None):
    """The train instance against the render instance (bit for bit) and
    against ``trace_plain(want_resid=True)``, on a textured scene (with
    ``work``) in chunks with the shown-flip rule (``split_flips``); the
    residuals, texel rows included, are compared on the other rays (rays
    at a texel edge left out). Returns the max abs error of A/B, the
    off-path mask, the kernel's and the plain residuals."""
    import torch

    from micro_raytracer_tpu_torch.ops import step

    K, _nu, R = u8s.shape
    A, B, fl, res, nl = step.trace_fwd_train(scene, tables, decay, oT, dT,
                                             u8s, hit0)
    for name, g, r in zip(("A", "B", "first_live"), (A, B, fl),
                          step.trace_fwd(scene, tables, decay, oT, dT, u8s,
                                         hit0)):
        if not torch.equal(g, r):
            raise AssertionError(f"trace_fwd_train: {name} differs from the "
                                 f"render instance")
    if work is None:
        A_r, B_r, fl_r, res_r, nl_r = step.trace_plain(
            scene, tables, decay, oT, dT, u8s, want_resid=True)
    else:
        A_r, B_r, fl_r, res_r, nl_r = plain_trace(
            scene, tables, decay, oT, dT, u8s, want_resid=True, work=work)
    if not torch.equal(fl, fl_r):
        raise AssertionError("trace_fwd_train: first_live differs")
    bad = (outlier_rays(A, A_r, 1e-4, 1e-5) | outlier_rays(B, B_r, 1e-4, 1e-5)
           | (nl != nl_r))
    share, flips = split_flips(bad, work, "trace_fwd_train")
    err = float(max((A - A_r).abs().max(), (B - B_r).abs().max()))
    good = ~bad
    err_in = float(max((A - A_r)[:, good].abs().max(),
                       (B - B_r)[:, good].abs().max()))
    if work is not None and scene.has_maps:
        good = good & ~work["tex_edge"]
    live = (torch.arange(K, device=oT.device)[:, None] < nl[None]) & good
    floats = [step.RES_O + c for c in range(9)] + [step.RES_TE]
    exact = [step.RES_ROW] + [step.RES_LOK + li
                              for li in range(scene.n_lights)]
    if scene.any_refract:
        floats.append(step.RES_TX)
        exact.append(step.RES_CHOOSE)
    if tables.layout[3]:
        exact.append(step.res_xrow(scene.n_lights))
    # the texel rows
    exact += list(range(step.res_rows(scene.n_lights, tables.layout[3]),
                        res.shape[1]))
    res_err = 0.0
    for r in floats:
        g, w = res[:, r][live], res_r[:, r][live]
        res_err = max(res_err, float((g - w).abs().max()))
        if not bool(torch.isclose(g, w, rtol=1e-4, atol=1e-4).all()):
            raise AssertionError(f"trace_fwd_train: residual row {r} differs")
    for r in exact:
        if not torch.equal(res[:, r][live], res_r[:, r][live]):
            raise AssertionError(f"trace_fwd_train: residual row {r} differs")
    tex = (f", {int(flips.sum())} of them shown texel flips"
           if scene.has_maps and work else "")
    log(f"trace_fwd_train {R} rays: equals trace_fwd bit for bit; "
        f"{int(bad.sum())} rays off the plain path{tex} (share of the rest "
        f"{share:.5f}, bound {OUTLIER_SHARE}); max abs err of A/B {err:.3g} "
        f"over all rays, {err_in:.3g} over the rest; residuals of "
        f"{int(live.sum())} live steps within {res_err:.3g}")
    if share > OUTLIER_SHARE or err_in > IN_ERR:
        raise AssertionError("trace_fwd_train disagrees with its plain "
                             "version")
    return err, bad, (res, nl), (res_r, nl_r)


def trace_bwd_plain_chunked(scene, tables, decay, oT, dT, u8s, ctA, ctB,
                            chunk=None):
    """``step.trace_bwd_plain`` over chunks of PLAIN_CHUNK rays (the
    autograd graph of a whole frame does not fit the card), or of
    ``chunk``. The table cotangents are summed over the chunks in float64,
    beside the sums of their absolute values (the mass that bounds a
    float32 sum's rounding; the finer the chunks, the closer it comes to
    the sum of the terms' magnitudes): ``(d_tab, d_lights, d_oT, d_dT,
    d_tri, mass_tab, mass_lights, mass_tri)``."""
    import torch

    from micro_raytracer_tpu_torch.ops import step

    R = oT.shape[1]
    f64 = torch.float64
    d_tab, m_tab = (torch.zeros_like(tables.tab, dtype=f64) for _ in "ab")
    d_lt, m_lt = (torch.zeros_like(tables.lights, dtype=f64) for _ in "ab")
    d_tri, m_tri = (torch.zeros_like(tables.tri, dtype=f64) for _ in "ab")
    d_o, d_d = torch.empty_like(oT), torch.empty_like(dT)
    chunk = chunk or chunk_for(tables, PLAIN_CHUNK)
    for s in range(0, R, chunk):
        sl = slice(s, min(R, s + chunk))
        g = step.trace_bwd_plain(scene, tables, decay,
                                 *(t[..., sl].contiguous()
                                   for t in (oT, dT, u8s, ctA, ctB)))
        d_tab += g[0].to(f64)
        m_tab += g[0].to(f64).abs()
        d_lt += g[1].to(f64)
        m_lt += g[1].to(f64).abs()
        d_tri += g[4].to(f64)
        m_tri += g[4].to(f64).abs()
        d_o[:, sl], d_d[:, sl] = g[2], g[3]
    return d_tab, d_lt, d_o, d_d, d_tri, m_tab, m_lt, m_tri


def ill_conditioned(scene, tables, decay, oT, dT, u8s, ctA, ctB, idx, got,
                    want):
    """Show that each ray of ``idx`` is ill-conditioned: the kernel's d_oT
    and d_dT (``got``) lie within ILL_RATIO times the plain float32
    version's (``want``) own distance from the plain trace run in float64,
    at their largest component. Raises otherwise."""
    import torch

    from micro_raytracer_tpu_torch.ops import step

    f64 = torch.float64
    t64 = tables._replace(tab=tables.tab.to(f64),
                          lights=tables.lights.to(f64),
                          tri=tables.tri.to(f64))
    ins = [t[..., idx].to(f64).contiguous() for t in (oT, dT, u8s, ctA, ctB)]
    w64 = [torch.cat(x, 1) for x in zip(*(
        step.trace_bwd_plain(scene, t64, decay,
                             *(t[..., s:s + PLAIN_CHUNK] for t in ins))[2:4]
        for s in range(0, idx.numel(), PLAIN_CHUNK)))]
    off = [(got[a][:, idx].to(f64) - want[a][:, idx]).abs().amax(0)
           for a in (2, 3)]
    own = [(want[a][:, idx] - w64[a - 2]).abs().amax(0) for a in (2, 3)]
    ratio = torch.maximum(*off) / torch.maximum(*own)
    if not bool((ratio <= ILL_RATIO).all()):
        k = int(torch.argmax(ratio))
        j = int(idx[k])
        raise AssertionError(
            f"trace_bwd: ray {j} disagrees with autograd of the plain trace "
            f"{float(ratio[k]):.3g} times as far as float64 moves the plain "
            f"version: d_dT kernel {got[3][:, j].tolist()}, plain "
            f"{want[3][:, j].tolist()}, float64 {w64[1][:, k].tolist()}")
    return float(ratio.max())


def compare_bwd(scene, tables, decay, oT, dT, u8s, resid, n_live, bad, gen):
    """The backward kernel on the plain residuals against autograd through
    the plain trace, for random output cotangents that are zero on the
    off-path rays.

    Per ray, d_oT and d_dT within rtol G_RTOL and G_FLOOR of the frame's
    largest magnitude. A ray outside is ill-conditioned, not wrong: a step
    that starts inside a thin box wall and runs nearly parallel to it
    takes its t as the difference of two slab terms ~1e4 times larger, so
    float32 rounding decides its gradient, and two float32 programs
    disagree there (float64 gives yet another value). A ray that meets a
    triangle is also held to RAY_FLOOR of its own largest magnitude: the
    raw normal of a torus triangle is ~1e-3 long, so the ray's normal
    cotangent is ~1e3 times its ray cotangents, and an error of 0.2% on
    them moves its row's sum. A ray outside only that must be shown
    ill-conditioned by float64 (``ill_conditioned``). At most ILL_SHARE of
    the rays may be outside; both sides drop them: their ctA, ctB are
    zeroed and the kernel and the plain version run again. The table
    cotangents, sums over millions of steps whose order differs, are then
    held within G_RTOL, G_FLOOR and SUM_TOL of the entry's mass. An entry
    outside is traced to the rays that carry the difference
    (``table_culprits``); each must be shown ill-conditioned by float64 on
    its own term of the entry (``ill_term``), and then both sides drop it
    as above and every entry is held again, at the same tolerances (at
    most ILL_SHARE of the rays dropped in all).
    At the frame (more than N_CMP rays) the kernel runs on the whole frame
    and its per-ray cotangents of ``frame_subset``'s rays are held; the
    table cotangents come from a launch over that subset, whose per-ray
    cotangents must equal the frame launch's, and the plain version runs
    on the subset alone.
    Returns the max abs error, the plain version's ms (on at most N_CMP
    rays) and the cotangents of all the rays.
    """
    import numpy as np
    import torch

    from micro_raytracer_tpu_torch.ops import step

    R = oT.shape[1]
    ctA, ctB = (torch.randn((3, R), generator=gen, device=oT.device)
                for _ in range(2))
    ctA[:, bad] = 0.0
    ctB[:, bad] = 0.0
    out_ct = (ctA, ctB)
    sub = frame_subset(R, oT.device)
    if sub is not None:
        frame = step.trace_bwd(scene, tables, decay, u8s, resid, n_live, ctA,
                               ctB)
        oT, dT, u8s, resid, ctA, ctB = (t[..., sub].contiguous() for t in (
            oT, dT, u8s, resid, ctA, ctB))
        n_live, bad = n_live[sub].contiguous(), bad[sub]
        R = N_CMP
    got = step.trace_bwd(scene, tables, decay, u8s, resid, n_live, ctA, ctB)
    if sub is not None:
        for name, g, f in (("d_oT", got[2], frame[2]),
                           ("d_dT", got[3], frame[3])):
            if not torch.equal(g, f[:, sub]):
                raise AssertionError(f"trace_bwd: {name} of the frame's "
                                     f"subset differs from the frame "
                                     f"launch's")
        del frame
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = trace_bwd_plain_chunked(scene, tables, decay, oT, dT, u8s, ctA,
                                   ctB)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    # the absolute floors are those of every compared ray, the ones
    # dropped below included
    scales = [float(w.abs().max()) if w.numel() else 0.0 for w in want[:5]]
    ill = torch.zeros(R, dtype=torch.bool, device=oT.device)
    tri_ill = torch.zeros_like(ill)
    for g, w, scale in zip(got[2:4], want[2:4], scales[2:4]):
        e, rt = (g - w).abs(), G_RTOL * w.abs()
        ill |= (e > rt + G_FLOOR * scale).any(0)
        tri_ill |= (e > rt + RAY_FLOOR * w.abs().amax(0)).any(0)
    if tables.layout[3]:
        # rays that meet a triangle (entry or exit row) at a live step
        live = (torch.arange(u8s.shape[0], device=oT.device)[:, None]
                < n_live[None])
        rows = torch.maximum(resid[:, step.RES_ROW],
                             resid[:, step.res_xrow(scene.n_lights)])
        tri_ill &= ((rows >= tables.layout[1]) & live).any(0) & ~ill
    else:
        tri_ill[:] = False
    share = float((ill | tri_ill).float().mean())
    log(f"trace_bwd {R} rays: {int(ill.sum())} ill-conditioned rays and "
        f"{int(tri_ill.sum())} more on triangles (share {share:.2e}, bound "
        f"{ILL_SHARE})")
    if share > ILL_SHARE:
        raise AssertionError("trace_bwd: too many rays disagree with "
                             "autograd of the plain trace")
    if bool(tri_ill.any()):
        worst = ill_conditioned(scene, tables, decay, oT, dT, u8s, ctA, ctB,
                                tri_ill.nonzero()[:, 0], got, want)
        log(f"trace_bwd: the rays on triangles differ from the plain "
            f"version at most {worst:.3g} times as much as float64 moves it")
        ill |= tri_ill
    args = (scene, tables, decay, oT, dT, u8s, resid, n_live)
    for attempt in range(2):
        if bool(ill.any()):
            # both sides without the dropped rays
            ctA[:, ill] = 0.0
            ctB[:, ill] = 0.0
            got = step.trace_bwd(scene, tables, decay, u8s, resid, n_live,
                                 ctA, ctB)
            want = trace_bwd_plain_chunked(scene, tables, decay, oT, dT, u8s,
                                           ctA, ctB)
            want = want[:2] + tuple(torch.where(ill, 0.0, w)
                                    for w in want[2:4]) + want[4:]
        err, msg, outside = 0.0, [], []
        masses = (want[5], want[6], None, None, want[7])
        for which, (name, g, w, m, scale) in enumerate(zip(
                ("d_tab", "d_lights", "d_oT", "d_dT", "d_tri"), got, want,
                masses, scales)):
            if not w.numel():
                continue
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"trace_bwd: non-finite {name}")
            g = g.to(w.dtype)
            e = (g - w).abs()
            tol = G_RTOL * w.abs() + G_FLOOR * scale
            if m is not None:
                tol = tol + SUM_TOL * m
            err = max(err, float(e.max()))
            msg.append(f"{name} {float(e.max()):.3g} of {scale:.3g} (worst "
                       f"{float((e / tol).max()):.3f} of its tolerance)")
            if bool((e <= tol).all()):
                continue
            worst = torch.topk((e / tol).flatten(), min(4, e.numel()))[1]
            at = [tuple(int(x) for x in np.unravel_index(int(i), e.shape))
                  for i in worst]
            what = (f"trace_bwd: {name} differs from autograd on "
                    f"{int((e > tol).sum())} entries; worst (index: kernel, "
                    f"plain, tolerance): " + ", ".join(
                        f"{ix}: {float(g[ix]):.6g}, {float(w[ix]):.6g}, "
                        f"{float(tol[ix]):.3g}" for ix in at))
            if m is None or attempt or int((e > tol).sum()) > 4:
                raise AssertionError(what)
            log(what)
            outside += [(which, ix, float(e[ix])) for ix in at
                        if bool(e[ix] > tol[ix])]
        if not outside:
            break
        for which, ix, diff in outside:
            for j, k, p in table_culprits(*args, ctA, ctB, which, ix, diff):
                ratio = ill_term(scene, tables, decay, oT, dT, u8s, ctA, ctB,
                                 j, which, ix, k, p)
                log(f"trace_bwd: ray {j} carries the kernel's difference at "
                    f"{ix}: kernel {k:.6g}, plain {p:.6g}, {ratio:.3g} times "
                    f"as far as float64 moves the plain term")
                ill[j] = True
        if float(ill.float().mean()) > ILL_SHARE:
            raise AssertionError("trace_bwd: too many rays disagree with "
                                 "autograd of the plain trace")
    log(f"trace_bwd {R} rays{' of the frame' if sub is not None else ''}: "
        f"matches autograd of the plain trace; max abs err "
        f"{', '.join(msg)}")
    return (err, plain_ms) + out_ct


def table_culprits(scene, tables, decay, oT, dT, u8s, resid, n_live, ctA,
                   ctB, which, ix, diff):
    """The rays that carry the kernel's difference ``diff`` from the
    plain version at entry ``ix`` of table cotangent ``which`` (0: d_tab,
    1: d_lights, 4: d_tri): among the rays whose cotangents reach the entry
    (a row's terms come from the steps that enter or exit it; a light's
    from every ray), halved again and again, a half is searched on where
    the kernel launched on it alone differs from the plain version on it
    by a quarter of ``diff`` or more. Returns ``[(ray, kernel term, plain
    term)]``; raises where the difference is spread over more rays than
    ILL_SHARE allows."""
    import torch

    from micro_raytracer_tpu_torch.ops import step

    def terms(idx):
        sel = [t[..., idx].contiguous() for t in (oT, dT, u8s, resid, ctA,
                                                   ctB)]
        g = step.trace_bwd(scene, tables, decay, sel[2], sel[3],
                           n_live[idx].contiguous(), sel[4], sel[5])
        w = trace_bwd_plain_chunked(scene, tables, decay, sel[0], sel[1],
                                    sel[2], sel[4], sel[5])
        return float(g[which][ix]), float(w[which][ix])

    cap = max(1, int(ILL_SHARE * oT.shape[1]))
    reach = ((ctA != 0) | (ctB != 0)).any(0)
    if which != 1:
        row = ix[0] + (tables.layout[1] if which == 4 else 0)
        live = (torch.arange(u8s.shape[0], device=oT.device)[:, None]
                < n_live[None])
        # the exit row is kept where a group has more rows than one
        cols = [step.RES_ROW] + ([step.res_xrow(scene.n_lights)]
                                 if tables.layout[3] else [])
        rows = torch.stack([resid[:, c] for c in cols])
        reach &= ((rows == row) & live).any(0).any(0)
    work, found = [reach.nonzero()[:, 0]], []
    while work:
        idx = work.pop()
        if idx.numel() == 1:
            found.append((int(idx[0]), *terms(idx)))
            continue
        half = idx.numel() // 2
        for part in (idx[:half], idx[half:]):
            k, p = terms(part)
            if abs(k - p) >= 0.25 * diff:
                work.append(part)
        if len(work) + len(found) > cap:
            raise AssertionError(f"trace_bwd: the difference at {ix} is "
                                 f"spread over more than {cap} rays")
    if not found:
        raise AssertionError(f"trace_bwd: no ray carries the difference at "
                             f"{ix}")
    return found


def ill_term(scene, tables, decay, oT, dT, u8s, ctA, ctB, j, which, ix, k,
             p):
    """Show that ray ``j``'s term at entry ``ix`` of table cotangent
    ``which`` is ill-conditioned: the kernel's term ``k`` lies within
    ILL_RATIO times the plain float32 term ``p``'s own distance from the
    plain trace run in float64 on the ray. Returns that ratio; raises
    otherwise."""
    import torch

    from micro_raytracer_tpu_torch.ops import step

    f64 = torch.float64
    t64 = tables._replace(tab=tables.tab.to(f64),
                          lights=tables.lights.to(f64),
                          tri=tables.tri.to(f64))
    g = step.trace_bwd_plain(scene, t64, decay, *(
        t[..., j:j + 1].to(f64).contiguous()
        for t in (oT, dT, u8s, ctA, ctB)))
    p64 = float(g[which][ix])
    ratio = abs(k - p) / abs(p - p64) if p != p64 else float("inf")
    if not ratio <= ILL_RATIO:
        raise AssertionError(
            f"trace_bwd: ray {j}'s term at {ix} differs from the plain "
            f"version {ratio:.3g} times as far as float64 moves it: kernel "
            f"{k:.6g}, plain {p:.6g}, float64 {p64:.6g}")
    return ratio


def phase_train_kernels(cfg, results):
    import torch

    from micro_raytracer_tpu_torch.models.compiler import compile_camera
    from micro_raytracer_tpu_torch.ops import hit3, step

    scene, tables, decay, oT, dT, u8s, hit0 = results.pop("main_inputs")
    dev = oT.device
    gen = torch.Generator(device=dev).manual_seed(5)
    o, d = camera_rays(compile_camera(cfg.frame.cam, dev), N_CMP, gen, dev)
    o, d = o.T.contiguous(), d.T.contiguous()
    u = torch.rand((BOUNCE + 1, step.n_uni(scene.any_refract), N_CMP),
                   generator=gen, device=dev)
    errs_f, errs_b = [], []
    for oT_, dT_, u_ in ((o, d, u), (oT, dT, u8s)):
        h = step.primary_hits(scene, tables, oT_, dT_)
        e, bad, (res, nl), (res_r, nl_r) = compare_train_fwd(
            scene, tables, decay, oT_, dT_, u_, h)
        errs_f.append(e)
        e, plain_b, ctA, ctB = compare_bwd(scene, tables, decay, oT_, dT_,
                                           u_, res_r, nl_r, bad, gen)
        errs_b.append(e)
    del res_r, nl_r
    # times and bounds at the main path's shape (the frame, its residuals)
    work = trace_work(scene, tables, u8s, res, nl)
    ms_f = cuda_ms(lambda: step.trace_fwd_train(scene, tables, decay, oT, dT,
                                                u8s, hit0), 5)
    plain_f = cuda_ms(lambda: step.trace_plain(scene, tables, decay, oT, dT,
                                               u8s, want_resid=True), 2)
    ms_b = cuda_ms(lambda: step.trace_bwd(scene, tables, decay, u8s, res, nl,
                                          ctA, ctB), 5)
    log(f"trace_fwd_train {RES * RES} rays x {BOUNCE + 1} steps "
        f"({work['live_steps']} live steps): kernel {ms_f:.3f} ms, plain "
        f"{plain_f:.3f} ms, bound {fmt_bound(work['trace_fwd_train'])}")
    log(f"trace_bwd {RES * RES} rays: kernel {ms_b:.3f} ms, plain "
        f"{plain_b:.3f} ms, bound {fmt_bound(work['trace_bwd'])}")
    log(f"trace_fwd bound {fmt_bound(work['trace_fwd'])}")
    use = resources(scene, tables)
    results["trace_fwd"].update(work["trace_fwd"], **use["trace_fwd"])
    results["trace_fwd_train"] = {"max_abs_err": max(errs_f), "ms": ms_f,
                                  "plain_ms": plain_f,
                                  **work["trace_fwd_train"],
                                  "library_ms": None,
                                  **use["trace_fwd_train"]}
    results["trace_bwd"] = {"max_abs_err": max(errs_b), "ms": ms_b,
                            "plain_ms": plain_b, **work["trace_bwd"],
                            "library_ms": None, **use["trace_bwd"]}


def resources(scene, tables, name="room", kernels=("trace_fwd",
                                                   "trace_fwd_train",
                                                   "trace_bwd")):
    """Registers, spilled bytes and resident warps per SM of the render,
    train and backward instances of the whole trace (or of ``kernels``,
    such as the per-step ones) on this scene
    (``step.instance_resources``), logged."""
    from micro_raytracer_tpu_torch.ops import step

    use = {w: step.instance_resources(scene, tables, w) for w in kernels}
    log(f"{name} instances: {json.dumps(use)}")
    return use


def _busy_share(step_fn):
    """Run ``step_fn`` under torch.profiler: (its result, host wall
    seconds, device busy seconds, device operations launched, {kernel
    name: device seconds})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = step_fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) * 1e-6
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):     # union of the device's busy intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    return out, wall, busy * 1e-6, len(spans), by_name


def step_alone_ms(scene, tables, c, fn):
    """CUDA-event ms of ``fn``, a ``step_fwd`` / ``step_fwd_train`` call on
    the carry ``c`` of a scene past the staged triangle blocks, without the
    triangle sweep it launches first: the sweep runs once beforehand and
    ``step.tri_hits`` hands its result to the timed calls (the step kernel
    alone; torch.profiler's kernel records on the card left out launches of
    the long glass sweeps)."""
    from micro_raytracer_tpu_torch.ops import step

    hits = step.tri_hits(scene, tables, c)
    sweep = step.tri_hits
    step.tri_hits = lambda *_a, **_k: hits
    try:
        return cuda_ms(fn, 3)
    finally:
        step.tri_hits = sweep


def train_setup(cfg, moved=None, leaves=None):
    """The training main path's inputs at full width: the target (a
    4-spp render of the scene through the render kernels) and the leaves
    perturbed from it: albedos 0.5, light power x 0.3, and the positions of
    the rows of kind ``moved`` (the mesh's triangles, or the grid's
    spheres); every trainable leaf, or ``leaves`` alone (the rest fixed).
    Returns (params, scene, cam, coords, target, gen, rows), ``rows`` the
    leaves whose gradient must not vanish and on which rows."""
    import numpy as np
    import torch

    from micro_raytracer_tpu_torch.models import tracer
    from micro_raytracer_tpu_torch.models.compiler import (compile_camera,
                                                           compile_scene)
    from micro_raytracer_tpu_torch.models.render import morton_ray_order
    from micro_raytracer_tpu_torch.ops import step
    from micro_raytracer_tpu_torch.parallel import shard

    dev = torch.device("cuda")
    truth = compile_scene(cfg.scene, dev)
    cam = compile_camera(cfg.frame.cam, dev)
    ys, xs = divmod(morton_ray_order(RES, RES), RES)
    coords = torch.from_numpy(np.stack([xs, ys], -1)).to(dev, torch.float32)
    gen = torch.Generator(device=dev).manual_seed(6 if moved is None else 12)
    tables = step.pack_step(truth)
    with torch.no_grad():      # the target, through the render kernels
        target = sum(tracer.trace_radiance(truth, cam, (RES, RES), BOUNCE,
                                           cfg.rt.loss, coords, gen, tables)
                     for _ in range(TARGET_SPP)) / TARGET_SPP
    params, scene = shard.split_params(truth)
    params = {k: v.detach().clone() for k, v in params.items()}
    params["mat_albedo"] = torch.full_like(params["mat_albedo"], 0.5)
    params["light_pwr"] = params["light_pwr"] * 0.3
    if leaves is not None:
        params = {k: params[k] for k in leaves}
    rows = {k: slice(None) for k in ("mat_albedo", "light_pwr", "inst_pos")
            if k in params}
    if moved is not None:
        seg = scene.seg(moved)
        params["inst_pos"][seg] += torch.tensor([0.02, 0.0, 0.01],
                                                device=dev)
        # a sphere's turn moves nothing
        rows = {"inst_pos": seg, "inst_dir": seg} if moved == 3 \
            else {"inst_pos": seg}
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    return params, scene, cam, coords, target, gen, rows


def phase_train(cfg, card, counts, name="slice room", moved=None,
                leaves=None):
    """The training main path: 3 steps of make_train_step at full width
    from ``train_setup``'s leaves."""
    import numpy as np
    import torch

    from micro_raytracer_tpu_torch.models import schema
    from micro_raytracer_tpu_torch.ops import hit3, step, tri
    from micro_raytracer_tpu_torch.parallel import shard

    dev = torch.device("cuda")
    loss_cfg = cfg.rt.loss
    params, scene, cam, coords, target, gen, rows = train_setup(cfg, moved,
                                                                leaves)
    start = params
    ts = shard.make_train_step((RES, RES), BOUNCE, device=dev)
    kernels = (hit3.KERNEL, step.KERNEL, step.TRAIN_KERNEL, step.BWD_KERNEL,
               step.STEP_KERNEL, step.STEP_TRAIN_KERNEL,
               step.STEP_BWD_KERNEL, tri.ENTRY_KERNEL, tri.ENTRY_EXIT_KERNEL,
               tri.EXIT_KERNEL)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
        k.plain_calls = 0
    secs, losses = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss, new = ts.step(params, scene, cam, loss_cfg, coords, target, gen)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
        if not np.isfinite(losses[-1]):
            raise AssertionError(f"{name} training: loss {losses[-1]}")
        for k, p in params.items():
            if p.grad is None or not bool(torch.isfinite(p.grad).all()):
                raise AssertionError(f"{name} training: gradient of {k} is "
                                     f"missing or not finite")
        for k, r in rows.items():
            if not bool((params[k].grad[r] != 0).any()):
                raise AssertionError(f"{name} training: gradient of {k} is "
                                     f"zero")
        params = new
    launched = {k.name: k.launches for k in kernels}
    plain = {k.name: k.plain_calls for k in kernels if k.plain_calls}
    peak = torch.cuda.max_memory_allocated()
    counts.update(launched)
    want = {k.name: 0 for k in kernels}
    if step.route(scene, True) == "steps":
        # one step launch of each kind per bounce step and training step
        want.update({step.STEP_TRAIN_KERNEL.name: TRAIN_STEPS * (BOUNCE + 1),
                     step.STEP_BWD_KERNEL.name: TRAIN_STEPS * (BOUNCE + 1)})
        if step.tri_split(scene.kind_counts[schema.KIND_TRIANGLE]):
            # the triangle segment's sweep before each step
            sweep = tri.ENTRY_EXIT_KERNEL if scene.any_refract \
                else tri.ENTRY_KERNEL
            want[sweep.name] = TRAIN_STEPS * (BOUNCE + 1)
    else:
        want.update({hit3.KERNEL.name: TRAIN_STEPS,
                     step.TRAIN_KERNEL.name: TRAIN_STEPS,
                     step.BWD_KERNEL.name: TRAIN_STEPS})
    if launched != want or plain:
        raise AssertionError(f"{name} training launches {launched} (want "
                             f"{want}), plain calls {plain}")
    step_s = sum(secs[1:]) / (TRAIN_STEPS - 1)
    rays = RES * RES
    lr = ts.lr
    drift = {k: float((params[k] - start[k]).detach().abs().max())
             for k in ("inst_pos", "inst_dir", "mat_albedo", "light_pwr")
             if k in params}
    log(f"{name} training: {RES}x{RES}, bounce {BOUNCE}, 1 path per "
        f"pixel, {TRAIN_STEPS} SGD steps at lr {lr} (timed: steps 2-"
        f"{TRAIN_STEPS}): seconds {[f'{s:.4f}' for s in secs]}, "
        f"losses {[f'{x:.6g}' for x in losses]}; {step_s:.4f} s per step "
        f"after the first = {rays / step_s / 1e6:.3f}M fwd+bwd rays/s; peak "
        f"device memory {peak / 2**30:.3f} GiB on {card}; launches "
        f"{launched}; largest change of a leaf over the steps "
        f"{ {k: f'{v:.3g}' for k, v in drift.items()} }")
    # one more step from the starting parameters, whose paths are those of
    # the scene the kernel phases timed; an error of the step raises
    (loss, _new), wall, busy, n_ops, by_name = _busy_share(
        lambda: ts.step(start, scene, cam, loss_cfg, coords, target, gen))
    if not np.isfinite(float(loss)):
        raise AssertionError(f"profiled training step: loss {float(loss)}")
    # the busy share is of the profiled step's wall; the profiler slows
    # the host (a host-bound step's wall grows 2-3x under it) and lengthens
    # kernels a little, so the busy time is also given over the timed
    # steps' mean, an estimate that can pass 1 on a device-bound step
    log(f"{name} training profile, one step from the starting parameters: "
        f"wall {wall:.4f} s under the profiler, device busy {busy:.4f} s = "
        f"{busy / wall:.3f} of that wall ({busy / step_s:.3f} of an "
        f"unprofiled step, {step_s:.4f} s), {n_ops} device operations "
        f"(kernels, copies, fills)")
    for kname, t in sorted(by_name.items(), key=lambda x: -x[1])[:8]:
        log(f"  {t * 1e3:9.3f} ms  {kname[:90]}")
    return {"step_s": step_s, "steps_s": secs,
            "fwd_bwd_rays_per_s": rays / step_s, "peak_bytes": peak,
            "busy_share": busy / wall, "busy_s": busy,
            "profiled_wall_s": wall, "busy_of_step": busy / step_s,
            "lr": lr, "losses": losses}
def torus(n_major=30, n_minor=16, R=0.16, r=0.06, tilt=TORUS_TILT):
    """(2 * n_major * n_minor, 3, 3) vertices of a closed torus in object
    space (the formula of tests/torch_mesh_helpers.py)."""
    import numpy as np

    u = 2.0 * np.pi * np.arange(n_major) / n_major
    v = 2.0 * np.pi * np.arange(n_minor) / n_minor
    uu, vv = np.meshgrid(u, v, indexing="ij")
    ring = R + r * np.cos(vv)
    a, b, c = ring * np.cos(uu), ring * np.sin(uu), r * np.sin(vv)
    ct, st = np.cos(tilt), np.sin(tilt)
    pts = np.stack([a, b * ct - c * st, b * st + c * ct], -1)
    i1 = (np.arange(n_major) + 1) % n_major
    j1 = (np.arange(n_minor) + 1) % n_minor
    quads = [np.stack([pts, pts[i1], pts[i1][:, j1]], -2),
             np.stack([pts, pts[i1][:, j1], pts[:, j1]], -2)]
    return np.stack(quads, 2).reshape(-1, 3, 3).astype(np.float32)


def mesh_config(name):
    """The slice scene with its glass sphere replaced by the torus, glass
    (``mesh_glass``) or diffuse (``mesh_opaque``)."""
    from micro_raytracer_tpu_torch.models import schema

    cfg = slice_config()
    objs = [o for o in cfg.scene.objects
            if not (o.kind == "sphere" and o.mat.glass > 0)]
    if len(objs) != len(cfg.scene.objects) - 1:
        raise AssertionError("the slice scene's glass sphere is missing")
    cfg.scene.objects = objs + [schema.ObjectConfig.from_json({
        "type": "mesh", "mesh": torus().tolist(), "pos": TORUS_POS,
        "mat": MESH_MATS[name]})]
    return cfg


def mesh_inputs(name, dev, seed):
    """(cfg, scene, tables, decay, cam) of a mesh scene on the card."""
    import torch  # noqa: F401

    from micro_raytracer_tpu_torch.models import tracer
    from micro_raytracer_tpu_torch.models.compiler import (compile_camera,
                                                           compile_scene)
    from micro_raytracer_tpu_torch.ops import step

    cfg = mesh_config(name)
    scene = compile_scene(cfg.scene, dev)
    tables = step.pack_step(scene)
    if scene.kind_sweep[3] != 960 or tables.tbb is None:
        raise AssertionError(f"{name}: {scene.kind_sweep[3]} triangle rows")
    return (cfg, scene, tables, tracer.decay_of(cfg.rt.loss),
            compile_camera(cfg.frame.cam, dev))


def phase_mesh_kernels(results):
    """Phase 9: every kernel on both mesh scenes against its plain version,
    timed and bounded at the full frame."""
    import torch

    from micro_raytracer_tpu_torch.ops import step

    from micro_raytracer_tpu_torch.models.compiler import compile_scene

    dev = torch.device("cuda")
    for name in MESH_NAMES:
        cfg, scene, tables, decay, cam = mesh_inputs(name, dev, 0)
        gen = torch.Generator(device=dev).manual_seed(11)
        nu = step.n_uni(scene.any_refract)
        # closest_hit: random rays in the room, camera rays, the frame
        err = compare_hit(tables, *random_rays(N_CMP, gen, dev))
        o, d = camera_rays(cam, N_CMP, gen, dev)
        err = max(err, compare_hit(tables, o, d))
        if name == MESH_NAMES[0]:
            # the torus alone: shadow-like rays that reach the triangle
            # segment (in the room an any-hit sweep meets a wall first)
            alone = dataclasses.replace(cfg.scene, objects=[
                ob for ob in cfg.scene.objects if ob.kind == "mesh"])
            err = max(err, compare_hit(
                step.pack_step(compile_scene(alone, dev)),
                *random_rays(N_CMP, gen, dev)))
        if scene.any_refract:
            # the culled exit-mode sweep against the unculled one
            for where, (o_, d_) in (("camera", (o, d)),
                                    ("random", random_rays(N_CMP, gen, dev))):
                check_culled_exit(tables, o_, d_, f"{name}, {where} rays")
        oT, dT = main_path_rays(cfg, gen, dev)   # the main path's input
        err = max(err, compare_hit(tables, oT.T, dT.T))
        res, rows, _sph = time_hit(scene, tables, oT, dT, plain_reps=1)
        log(f"{name} closest_hit {oT.shape[1]} rays: kernel "
            f"{res['ms']:.3f} ms, plain {res['plain_ms']:.3f} ms, "
            f"{rows:.1f} triangle rows tested per ray (of 960), bound "
            f"{fmt_bound(res)}")
        results[f"closest_hit/{name}"] = {"max_abs_err": err, **res,
                                          "library_ms": None}
        # the trace on 2^17 camera rays, then the frame
        u = torch.rand((BOUNCE + 1, nu, N_CMP), generator=gen, device=dev)
        err_f = compare_trace(scene, tables, decay, o.T.contiguous(),
                              d.T.contiguous(), u)
        u8s = torch.rand((BOUNCE + 1, nu, RES * RES), generator=gen,
                         device=dev)
        err_f = max(err_f, compare_trace(scene, tables, decay, oT, dT, u8s))
        hit0 = step.primary_hits(scene, tables, oT, dT)
        ms = cuda_ms(lambda: step.trace_fwd(scene, tables, decay, oT, dT,
                                            u8s, hit0), 5)
        seg = check_segmented(name, scene, tables, decay, cfg.rt.loss, oT,
                              dT, u8s, hit0, ms)
        plain_ms = cuda_ms(lambda: step.trace_plain(scene, tables, decay, oT,
                                                    dT, u8s), 1)
        work = {"sweep": 0, "shadow": 0}
        step.trace_plain(scene, tables, decay, oT, dT, u8s, work=work)
        # the train instance and the backward on 2^15 camera rays, then the
        # frame (the backward's plain version in chunks); the frame's
        # kernel residuals and cotangents are kept for the timing
        n = N_MESH_BWD
        ob, db = (t[:n].T.contiguous() for t in (o, d))
        errs_t, errs_b = [], []
        for oT_, dT_, u_ in ((ob, db, u[..., :n].contiguous()),
                             (oT, dT, u8s)):
            e, bad, (resid, nl), (res_r, nl_r) = compare_train_fwd(
                scene, tables, decay, oT_, dT_, u_,
                step.primary_hits(scene, tables, oT_, dT_))
            errs_t.append(e)
            e, plain_b, ctA, ctB = compare_bwd(scene, tables, decay, oT_,
                                               dT_, u_, res_r, nl_r, bad, gen)
            errs_b.append(e)
        del res_r, nl_r
        ms_t = cuda_ms(lambda: step.trace_fwd_train(scene, tables, decay, oT,
                                                    dT, u8s, hit0), 5)
        plain_t = cuda_ms(lambda: step.trace_plain(
            scene, tables, decay, oT, dT, u8s, want_resid=True), 1)
        ms_b = cuda_ms(lambda: step.trace_bwd(scene, tables, decay, u8s,
                                              resid, nl, ctA, ctB), 5)
        bw = trace_work(scene, tables, u8s, resid, nl, work)
        S = bw["live_steps"]
        log(f"{name} trace_fwd {RES * RES} rays x {BOUNCE + 1} steps ({S} "
            f"live steps): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"bound {fmt_bound(bw['trace_fwd'])}; triangle rows tested per "
            f"live step: {work['sweep'] / S:.1f} in the closest-hit sweeps, "
            f"{work['shadow'] / S:.1f} in the shadow sweeps")
        log(f"{name} trace_fwd_train: kernel {ms_t:.3f} ms, plain "
            f"{plain_t:.3f} ms, bound {fmt_bound(bw['trace_fwd_train'])}; "
            f"trace_bwd: kernel {ms_b:.3f} ms, plain {plain_b:.3f} ms, bound "
            f"{fmt_bound(bw['trace_bwd'])}")
        results[f"trace_fwd/{name}"] = {
            "max_abs_err": err_f, "ms": ms, "plain_ms": plain_ms,
            **bw["trace_fwd"], "library_ms": None, **seg}
        results[f"trace_fwd_train/{name}"] = {
            "max_abs_err": max(errs_t), "ms": ms_t, "plain_ms": plain_t,
            **bw["trace_fwd_train"], "library_ms": None}
        results[f"trace_bwd/{name}"] = {
            "max_abs_err": max(errs_b), "ms": ms_b, "plain_ms": plain_b,
            **bw["trace_bwd"], "library_ms": None}
        del resid


def check_culled_exit(tables, o, d, where):
    """The exit-mode closest-hit kernel, whose triangle entry and group
    exit cull per block, against the unculled plain sweep (the JAX
    package's: ``hit3.sweep_plain`` without the cull blocks), on rays
    ``o``, ``d``: the entry equal but on phantom entries (the unculled
    winner's hit point outside its block's slacked AABB), and where a
    triangle wins, the exit equal but on phantom exits
    (``check_phantoms``, phase 22's rule); at most PHANTOM_SHARE of the
    rays. Returns the phantoms' count."""
    import torch

    from micro_raytracer_tpu_torch.ops import hit3

    got = hit3.closest_hit(tables.tab, tables.layout, o, d, hit3.MODE_EXIT,
                           tables.tri, tables.tbb)
    chunk = chunk_for(tables, PLAIN_FWD_CHUNK)
    with torch.no_grad():
        full = [torch.cat(x) for x in zip(*(
            hit3.sweep_plain(tables.tab, tables.layout, o[s:s + chunk],
                             d[s:s + chunk], hit3.MODE_EXIT, tables.tri,
                             None) for s in range(0, o.shape[0], chunk)))]
    s0 = tables.layout[1]
    same = (got[0] == full[0]) & (got[1] == full[1])
    k = (full[1].long() - s0)
    tri_won = (full[0] < hit3.BIG * 0.5) & (k >= 0)
    b = (k.clamp(min=0) // hit3.CB).clamp(max=tables.tbb.shape[0] - 1)
    p = o.double() + full[0].double()[:, None] * d.double()
    box = tables.tbb[b].double()
    outside = tri_won & ((p < box[:, :3]) | (p > box[:, 3:6])).any(1)
    n_entry = int((~same).sum())
    if bool((~same & ~outside).any()):
        raise AssertionError(f"the culled exit-mode entry differs from the "
                             f"unculled one on {n_entry} rays ({where}), "
                             f"{int((~same & outside).sum())} of them "
                             f"phantoms")
    won = same & tri_won
    n_ph = check_phantoms(tables, o[won], d[won],
                          (got[2][won], got[3][won] - s0),
                          (full[2][won], full[3][won] - s0), where)
    if n_entry + n_ph > PHANTOM_SHARE * o.shape[0]:
        raise AssertionError(f"{n_entry} phantom entries and {n_ph} phantom "
                             f"exits of {o.shape[0]} rays ({where})")
    log(f"culled exit-mode closest_hit ({where}, {o.shape[0]} rays, "
        f"{int(won.sum())} triangle winners): equal to the unculled sweep "
        f"but on {n_entry} phantom entries and {n_ph} phantom exits")
    return n_entry + n_ph


def segments(cfg) -> int:
    """Trace launches per sample of a render of ``cfg`` (one per segment
    between the compaction cuts, ``tracer.compact_cuts``)."""
    from micro_raytracer_tpu_torch.models import tracer
    from micro_raytracer_tpu_torch.models.compiler import compile_scene

    scene = compile_scene(cfg.scene, "cpu")
    return len(tracer.compact_cuts(scene, BOUNCE + 1, True)) + 1


def check_segmented(name, scene, tables, decay, loss, oT, dT, u8s, hit0,
                    ms):
    """Where the render of ``scene`` runs in segments
    (``tracer.compact_cuts``), the render instance that the main path
    launches: the default render of the frame against the unsegmented one
    (``cuts=[]``), radiance bit for bit, and the segments' kernel time,
    each launch timed alone on the carry and ray ids the render hands it
    and summed (the primary-hit pass and the gathers left out). Returns
    the keys that replace the unsegmented instance's ``ms`` (``{}`` where
    the render is whole)."""
    import torch

    from micro_raytracer_tpu_torch.models import tracer
    from micro_raytracer_tpu_torch.ops import step

    K = u8s.shape[0]
    cuts = tracer.compact_cuts(scene, K, True)
    if not cuts:
        return {}
    flat, split = (tracer.trace_fused(scene, tables, K - 1, oT.T, dT.T,
                                      loss, u8s, cuts=c) for c in ([], None))
    if not torch.equal(flat, split):
        n = int((flat != split).any(1).sum())
        raise AssertionError(f"{name}: the compacted render (cuts {cuts}) "
                             f"differs from the unsegmented one on {n} rays")
    del flat, split
    bounds = [0, *cuts, K]
    seg_ms, carry, rid = [], None, None
    for k0, k1 in zip(bounds[:-1], bounds[1:]):
        seg = step.Segment(k0, k1, carry, rid)
        h0 = hit0 if k0 == 0 else None

        def launch(seg=seg, h0=h0):
            return step.trace_fwd(scene, tables, decay, oT, dT, u8s, h0, seg)

        seg_ms.append(cuda_ms(launch, 5))
        carry = launch()[3]
        if k1 < K:
            perm = tracer.compact_perm(carry[step.C_LIVE] > 0.5)
            carry = carry[:, perm]
            rid = (perm if rid is None else rid[perm]).to(torch.int32)
    log(f"{name} compacted render (cuts {cuts}) equals the unsegmented one "
        f"bit for bit at the frame; trace_fwd segments "
        f"{' + '.join(f'{t:.3f}' for t in seg_ms)} = {sum(seg_ms):.3f} ms, "
        f"the unsegmented instance {ms:.3f} ms")
    return {"ms": sum(seg_ms), "unsegmented_ms": ms, "segment_ms": seg_ms,
            "cuts": cuts}


def write_mesh_json(name, tmp):
    path = os.path.join(tmp, f"{name}.json")
    with open(path, "w") as f:
        json.dump(mesh_config(name).to_json(), f)
    return path


def phase_mesh_main(card, counts):
    """Phase 10: the CLI renders both mesh scenes from JSON files (counted,
    checked, ten timed renders each, one profiled), and the HTTP service
    answers one mesh_glass request."""
    import numpy as np
    from PIL import Image

    from micro_raytracer_tpu_torch.ops import hit3, step

    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    out_res = {}
    for name in MESH_NAMES:
        scene_args = [write_mesh_json(name, tmp)]
        out = os.path.join(tmp, f"{name}.png")
        for k in (hit3.KERNEL, step.KERNEL):
            k.launches = 0
            k.plain_calls = 0
        render_s, wall = render_cli(out, scene_args)
        launched = {k.name: k.launches for k in (hit3.KERNEL, step.KERNEL)}
        counts[name] = launched
        segs = segments(mesh_config(name))
        if launched != {hit3.KERNEL.name: SAMPLES,
                        step.KERNEL.name: SAMPLES * segs} \
                or hit3.KERNEL.plain_calls or step.KERNEL.plain_calls:
            raise AssertionError(f"{name} render: launches {launched} "
                                 f"({segs} segments per sample), plain calls "
                                 f"{hit3.KERNEL.plain_calls}, "
                                 f"{step.KERNEL.plain_calls}")
        img = np.asarray(Image.open(out))
        if img.shape != (RES, RES, 3) or float(img.std()) < 5.0:
            raise AssertionError(f"{name}: image {img.shape}, std "
                                 f"{float(img.std()):.2f}")
        loops = [render_s] + [render_cli(out, scene_args)[0]
                              for _ in range(RENDER_REPS - 1)]
        spread = render_spread(loops, card)
        ((loop_p, _w), wall_p, busy, n_ops, by_name) = _busy_share(
            lambda: render_cli(out, scene_args))
        med = float(np.median(loops))
        log(f"{name} render profile: the CLI's wall {wall_p:.4f} s (render "
            f"loop {loop_p:.4f} s under the profiler), device busy "
            f"{busy:.4f} s = {busy / med:.3f} of the unprofiled loop's "
            f"median {med:.4f} s; {n_ops} device operations "
            f"({n_ops / SAMPLES:.1f} per sample)")
        for kname, t in sorted(by_name.items(), key=lambda x: -x[1])[:4]:
            log(f"  {t * 1e3:9.3f} ms  {kname[:90]}")
        out_res[name] = {"render_s": render_s, "wall_s": wall,
                         "spread": spread, "busy_s": busy,
                         "busy_share": busy / med,
                         "ops_per_sample": n_ops / SAMPLES}
    phase_server(mesh_config("mesh_glass"), requests=1)
    return out_res


def tex_inputs(name, dev):
    """(cfg, scene, tables, decay, cam) of a textured stand-in on the
    card."""
    from micro_raytracer_tpu_torch.models import tracer
    from micro_raytracer_tpu_torch.models.compiler import (compile_camera,
                                                           compile_scene)
    from micro_raytracer_tpu_torch.ops import step

    cfg = tex_config(name)
    scene = compile_scene(cfg.scene, dev)
    tables = step.pack_step(scene)
    want = {"tex_dof": (5, (True,) + (False,) * 5),
            "tex_blocks": (257, (True,) * 6)}[name]
    got = (int(scene.prim_valid.sum()), tuple(scene.map_slots))
    if got != want or not scene.any_refract:
        raise AssertionError(f"{name}: rows and map slots {got}")
    return (cfg, scene, tables, tracer.decay_of(cfg.rt.loss),
            compile_camera(cfg.frame.cam, dev))


def compare_box_walk(scene, tables, o, d):
    """The box walk's instance of closest_hit against the dense instance
    (the same tables without the walk) in every mode, rows and t bit for
    bit; the dense winners outside the walk's grown boxes
    (``hit3.box_walk_phantoms``), at most PHANTOM_SHARE of the hits (none
    expected). Returns the phantoms."""
    from micro_raytracer_tpu_torch.ops import hit3

    n_ph = 0
    for mode in (hit3.MODE_ENTRY, hit3.MODE_EXIT, hit3.MODE_ANY):
        args = (tables.tab, tables.layout, o, d, mode)
        walk = hit3.closest_hit(*args, box=tables.box)
        dense = hit3.closest_hit(*args)
        n = sum(int((w != f).sum()) for w, f in zip(walk, dense))
        if mode != hit3.MODE_ANY:
            n_ph += int(hit3.box_walk_phantoms(*args[:4], dense[0], dense[1],
                                               tables.box).sum())
        if n:
            raise AssertionError(f"the box walk changes {n} outputs of "
                                 f"mode {mode}")
    hits = int((dense[0] < hit3.BIG * 0.5).sum())
    if n_ph > PHANTOM_SHARE * max(hits, 1):
        raise AssertionError(f"{n_ph} box winners outside the walk's boxes")
    log(f"closest_hit {o.shape[0]} rays: the box walk equals the dense "
        f"sweep bit for bit (entry, exit, any-hit); {n_ph} phantoms")
    return n_ph


def phase_tex_kernels(results):
    """Phase 12: every textured kernel (the closest-hit pass, the render
    and train instances of the trace, the backward) on both stand-ins
    against its plain version, on 2^17 camera rays and at the full frame,
    where it is timed and bounded; on tex_blocks, whose box segment is
    walked (csrc/box_walk.cuh), the walk's instances against the dense
    ones too (closest_hit in every mode, the render instance at the
    frame, bit for bit), with the rows and slab tests per sweep, the
    dense instances' times and bounds beside, registers and warps per
    SM."""
    import torch

    from micro_raytracer_tpu_torch.ops import step

    dev = torch.device("cuda")
    for name in TEX_NAMES:
        cfg, scene, tables, decay, cam = tex_inputs(name, dev)
        gen = torch.Generator(device=dev).manual_seed(13)
        nu = step.n_uni(scene.any_refract)
        o, d = camera_rays(cam, N_CMP, gen, dev)
        oT, dT = main_path_rays(cfg, gen, dev)
        err = max(compare_hit(tables, o, d), compare_hit(tables, oT.T, dT.T))
        walked = tables.box is not None
        if walked != (name == "tex_blocks"):
            raise AssertionError(f"{name}: box walk tables {walked}")
        dense = tables._replace(box=None)
        if walked:
            compare_box_walk(scene, tables, oT.T, dT.T)
        res_h, _rows, _sph = time_hit(scene, tables, oT, dT, plain_reps=1)
        results[f"closest_hit/{name}"] = {"max_abs_err": err, **res_h,
                                          "library_ms": None}
        u = torch.rand((BOUNCE + 1, nu, N_CMP), generator=gen, device=dev)
        u8s = torch.rand((BOUNCE + 1, nu, RES * RES), generator=gen,
                         device=dev)
        ob, db = o.T.contiguous(), d.T.contiguous()
        err_f = compare_trace(scene, tables, decay, ob, db, u, work={})
        work = {}
        err_f = max(err_f, compare_trace(scene, tables, decay, oT, dT, u8s,
                                         work=work))
        hit0 = step.primary_hits(scene, tables, oT, dT)
        ms = cuda_ms(lambda: step.trace_fwd(scene, tables, decay, oT, dT,
                                            u8s, hit0), 5)
        extra, extra_t = {}, {}
        if walked:
            # the walk's render instance against the dense one at the
            # frame, bit for bit, and the dense instances' times
            out = step.trace_fwd(scene, tables, decay, oT, dT, u8s, hit0)
            h_d = step.primary_hits(scene, dense, oT, dT)
            ref = step.trace_fwd(scene, dense, decay, oT, dT, u8s, h_d)
            n = sum(int((a != b).sum()) for a, b in zip(out, ref))
            if n or not all(torch.equal(a, b) for a, b in zip(hit0, h_d)):
                raise AssertionError(f"{name}: the box walk's render "
                                     f"differs from the dense one ({n})")
            del out, ref
            extra = {"dense_ms": cuda_ms(lambda: step.trace_fwd(
                scene, dense, decay, oT, dT, u8s, hit0), 3)}
            extra_t = {"dense_ms": cuda_ms(lambda: step.trace_fwd_train(
                scene, dense, decay, oT, dT, u8s, hit0), 3)}
            res_h["dense_ms"] = cuda_ms(lambda: step.primary_hits(
                scene, dense, oT, dT), 10)
            log(f"{name} the box walk's render instance equals the dense one "
                f"bit for bit at the frame")
        seg = check_segmented(name, scene, tables, decay, cfg.rt.loss, oT,
                              dT, u8s, hit0, ms)
        plain_ms = cuda_ms(lambda: plain_trace(scene, tables, decay, oT, dT,
                                               u8s), 1)
        errs_t, errs_b = [], []
        for oT_, dT_, u_ in ((ob, db, u), (oT, dT, u8s)):
            e, bad, (resid, nl), (res_r, nl_r) = compare_train_fwd(
                scene, tables, decay, oT_, dT_, u_,
                step.primary_hits(scene, tables, oT_, dT_), work={})
            errs_t.append(e)
            e, plain_b, ctA, ctB = compare_bwd(scene, tables, decay, oT_,
                                               dT_, u_, res_r, nl_r, bad, gen)
            errs_b.append(e)
        del res_r, nl_r
        ms_t = cuda_ms(lambda: step.trace_fwd_train(scene, tables, decay, oT,
                                                    dT, u8s, hit0), 5)
        plain_t = cuda_ms(lambda: plain_trace(
            scene, tables, decay, oT, dT, u8s, want_resid=True), 1)
        ms_b = cuda_ms(lambda: step.trace_bwd(scene, tables, decay, u8s,
                                              resid, nl, ctA, ctB), 5)
        bw = trace_work(scene, tables, u8s, resid, nl, work)
        S = bw["live_steps"]
        if walked:
            # the dense sweep's bound beside the walk's, and the walk's rows
            # and slab tests per sweep (closest hits after step 0, shadow
            # rays), with the instances' registers and warps per SM
            bw_d = trace_work(scene, dense, u8s, resid, nl, {
                k: v for k, v in work.items() if not k.startswith("box")})
            later = int((nl.long() - 1).clamp(min=0).sum())
            L = scene.n_lights
            walk = {"box_rows_per_sweep": work["box_sweep"] / max(later, 1),
                    "box_rows_per_shadow": work["box_shadow"] / max(S * L, 1),
                    "slabs_per_sweep": work["box_slabs"]
                    / max(later + S * L, 1)}
            use = resources(scene, tables, name)
            log(f"{name} box walk: {walk['box_rows_per_sweep']:.2f} box rows "
                f"a closest hit after step 0, "
                f"{walk['box_rows_per_shadow']:.2f} a shadow ray (of "
                f"{tables.box.n}), "
                f"{walk['slabs_per_sweep']:.2f} node and leaf slab tests a "
                f"sweep; closest_hit {res_h['box_rows_per_ray']:.2f} box rows "
                f"and {res_h['slabs_per_ray']:.2f} slab tests a ray, dense "
                f"instance {res_h['dense_ms']:.3f} ms; trace_fwd dense "
                f"instance {extra['dense_ms']:.3f} ms, train "
                f"{extra_t['dense_ms']:.3f} ms; dense bounds: trace "
                f"{fmt_bound(bw_d['trace_fwd'])}, closest_hit "
                f"{res_h['dense_bound_ms']:.4f} ms")
            extra = {**extra, **use["trace_fwd"], **walk,
                     "dense_bound_ms": bw_d["trace_fwd"]["bound_ms"]}
            extra_t = {**extra_t, **use["trace_fwd_train"],
                       "dense_bound_ms": bw_d["trace_fwd_train"]["bound_ms"]}
        log(f"{name} closest_hit {RES * RES} rays: kernel "
            f"{res_h['ms']:.3f} ms, plain {res_h['plain_ms']:.3f} ms, bound "
            f"{fmt_bound(res_h)}")
        log(f"{name} trace_fwd {RES * RES} rays x {BOUNCE + 1} steps ({S} "
            f"live steps, {bw['exit_side_steps']} with the exit side, "
            f"{bw['texel_fetches']} texel fetches): kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms (chunks of "
            f"{PLAIN_FWD_CHUNK} rays), bound {fmt_bound(bw['trace_fwd'])}")
        log(f"{name} trace_fwd_train: kernel {ms_t:.3f} ms, plain "
            f"{plain_t:.3f} ms, bound {fmt_bound(bw['trace_fwd_train'])}; "
            f"trace_bwd: kernel {ms_b:.3f} ms, plain {plain_b:.3f} ms, bound "
            f"{fmt_bound(bw['trace_bwd'])}")
        results[f"trace_fwd/{name}"] = {
            "max_abs_err": err_f, "ms": ms, "plain_ms": plain_ms,
            **bw["trace_fwd"], "library_ms": None, **seg, **extra}
        results[f"trace_fwd_train/{name}"] = {
            "max_abs_err": max(errs_t), "ms": ms_t, "plain_ms": plain_t,
            **bw["trace_fwd_train"], "library_ms": None, **extra_t}
        results[f"trace_bwd/{name}"] = {
            "max_abs_err": max(errs_b), "ms": ms_b, "plain_ms": plain_b,
            **bw["trace_bwd"], "library_ms": None}
        del resid


def phase_tex_main(card, counts):
    """Phase 13: the CLI renders both textured stand-ins from JSON files
    (counted, the box walk's launches too, checked, ten timed renders
    each, one profiled); the HTTP
    service answers one tex_dof request."""
    import numpy as np
    from PIL import Image

    from micro_raytracer_tpu_torch.ops import hit3, step

    tmp = tempfile.mkdtemp(prefix="chip_smoke_tex_")
    out_res = {}
    for name in TEX_NAMES:
        path = os.path.join(tmp, f"{name}.json")
        with open(path, "w") as f:
            json.dump(tex_json(name), f)
        out = os.path.join(tmp, f"{name}.png")
        for k in (hit3.KERNEL, step.KERNEL):
            k.launches = 0
            k.variants = {}
            k.plain_calls = 0
        render_s, wall = render_cli(out, [path])
        launched = {k.name: k.launches for k in (hit3.KERNEL, step.KERNEL)}
        counts[name] = launched
        if launched != {hit3.KERNEL.name: SAMPLES,
                        step.KERNEL.name: SAMPLES * segments(
                            tex_config(name))} \
                or hit3.KERNEL.plain_calls or step.KERNEL.plain_calls:
            raise AssertionError(f"{name} render: launches {launched}, "
                                 f"plain calls {hit3.KERNEL.plain_calls}, "
                                 f"{step.KERNEL.plain_calls}")
        # tex_blocks's every launch runs the box walk's instances (the
        # wrappers count them at the launch), tex_dof's none
        walked = {k.name: k.variants.get("box_walk", 0)
                  for k in (hit3.KERNEL, step.KERNEL)}
        want = launched if name == "tex_blocks" else dict.fromkeys(walked, 0)
        if walked != want:
            raise AssertionError(f"{name} render: box walk launches "
                                 f"{walked}, want {want}")
        log(f"{name} CLI render: launches {launched}, of them the box "
            f"walk's {walked}, no plain calls")
        img = np.asarray(Image.open(out))
        if img.shape != (RES, RES, 3) or float(img.std()) < 5.0:
            raise AssertionError(f"{name}: image {img.shape}, std "
                                 f"{float(img.std()):.2f}")
        loops = [render_s] + [render_cli(out, [path])[0]
                              for _ in range(RENDER_REPS - 1)]
        spread = render_spread(loops, card)
        ((loop_p, _w), wall_p, busy, n_ops, by_name) = _busy_share(
            lambda: render_cli(out, [path]))
        med = float(np.median(loops))
        log(f"{name} render profile: the CLI's wall {wall_p:.4f} s (render "
            f"loop {loop_p:.4f} s under the profiler), device busy "
            f"{busy:.4f} s = {busy / med:.3f} of the unprofiled loop's "
            f"median {med:.4f} s; {n_ops} device operations "
            f"({n_ops / SAMPLES:.1f} per sample)")
        for kname, t in sorted(by_name.items(), key=lambda x: -x[1])[:4]:
            log(f"  {t * 1e3:9.3f} ms  {kname[:90]}")
        out_res[name] = {"render_s": render_s, "wall_s": wall,
                         "spread": spread, "busy_s": busy,
                         "busy_share": busy / med,
                         "ops_per_sample": n_ops / SAMPLES}
    phase_server(tex_config("tex_dof"), requests=1)
    return out_res


def inst_inputs(name, dev):
    """(cfg, scene, tables, decay, cam) of an Instance-class stand-in on the
    card: 1,000 sphere rows in 16 cull blocks and the plane's 8 rows
    (``inst_grid``), or 343 spheres, a twentieth of them glass
    (``inst_glass``)."""
    from micro_raytracer_tpu_torch.models import tracer
    from micro_raytracer_tpu_torch.models.compiler import (compile_camera,
                                                           compile_scene)
    from micro_raytracer_tpu_torch.ops import step

    cfg = inst_config(name)
    scene = compile_scene(cfg.scene, dev)
    tables = step.pack_step(scene)
    want = {"inst_grid": (1000, 1008, 16, False),
            "inst_glass": (343, 352, 6, True)}[name]
    got = (scene.kind_sweep[0], scene.n_prims,
           0 if tables.sbb is None else tables.sbb.shape[0],
           scene.any_refract)
    if got != want:
        raise AssertionError(f"{name}: sphere rows, rows, cull blocks, "
                             f"refract {got}, want {want}")
    return (cfg, scene, tables, tracer.decay_of(cfg.rt.loss),
            compile_camera(cfg.frame.cam, dev))


def grid_rays(n, gen, device):
    """Rays from inside and around the sphere grid, uniformly random
    directions."""
    import torch

    box = torch.tensor([6.0, 6.0, 6.0], device=device)
    mid = torch.tensor([0.0, 3.75, 1.25], device=device)
    o = (torch.rand((n, 3), generator=gen, device=device) - 0.5) * box + mid
    d = torch.randn((n, 3), generator=gen, device=device)
    return o, d / torch.linalg.vector_norm(d, dim=1, keepdim=True)


def compare_cull(tables, o, d):
    """The closest-hit kernel with the sphere cull blocks (its walk
    through the sub-blocks, csrc/sph_walk.cuh) against itself without them
    (the dense sweep): rows and t bit for bit in every mode (the exit, the
    winner row's own t1, against the dense sweep over its group)."""
    from micro_raytracer_tpu_torch.ops import hit3

    for mode in (hit3.MODE_ENTRY, hit3.MODE_EXIT, hit3.MODE_ANY):
        args = (tables.tab, tables.layout, o, d, mode, tables.tri,
                tables.tbb)
        culled = hit3.closest_hit(*args, tables.sbb)
        dense = hit3.closest_hit(*args, None)
        n = sum(int((c != f).sum()) for c, f in zip(culled, dense))
        if n:
            raise AssertionError(f"the sphere cull changes {n} outputs of "
                                 f"mode {mode}")
    log(f"closest_hit {o.shape[0]} rays: the culled sweeps equal the dense "
        f"ones bit for bit (entry, exit, any-hit)")


def phase_inst_kernels(results):
    """Phase 15: every kernel on ``inst_grid`` against its plain version —
    closest_hit bit for bit on 2^17 random and 2^17 camera rays and at the
    frame (and ``inst_glass`` on 2^17 rays of each), the trace (phase 4's
    rule), the train instance and the backward (phase 9's rule) on 2^15
    camera rays and at the frame, the compacted render against the
    unsegmented one — timed and bounded at the frame."""
    import torch

    from micro_raytracer_tpu_torch.models import tracer
    from micro_raytracer_tpu_torch.ops import step

    dev = torch.device("cuda")
    g_cfg, g_scene, tables, g_decay, cam = inst_inputs("inst_glass", dev)
    gen = torch.Generator(device=dev).manual_seed(15)
    compare_hit(tables, *grid_rays(N_CMP, gen, dev), exact=True)
    compare_hit(tables, *camera_rays(cam, N_CMP, gen, dev), exact=True)
    compare_cull(tables, *camera_rays(cam, N_CMP, gen, dev))
    # the exit-mode walk's trace instances on 2^17 camera rays: the render
    # (phase 4's rule), its segments (the main path compacts this scene)
    # against it bit for bit, the train instance (phase 7's rule)
    o, d = camera_rays(cam, N_CMP, gen, dev)
    ob, db = o.T.contiguous(), d.T.contiguous()
    u = torch.rand((BOUNCE + 1, step.n_uni(True), N_CMP), generator=gen,
                   device=dev)
    compare_trace(g_scene, tables, g_decay, ob, db, u, work={})
    h0 = step.primary_hits(g_scene, tables, ob, db)
    check_segmented("inst_glass", g_scene, tables, g_decay, g_cfg.rt.loss,
                    ob, db, u, h0, cuda_ms(lambda: step.trace_fwd(
                        g_scene, tables, g_decay, ob, db, u, h0), 2))
    n = N_MESH_BWD
    compare_train_fwd(g_scene, tables, g_decay, ob[:, :n].contiguous(),
                      db[:, :n].contiguous(), u[..., :n].contiguous(),
                      step.primary_hits(g_scene, tables,
                                        ob[:, :n].contiguous(),
                                        db[:, :n].contiguous()), work={})
    del u, h0
    name = "inst_grid"
    cfg, scene, tables, decay, cam = inst_inputs(name, dev)
    nu = step.n_uni(scene.any_refract)
    o, d = grid_rays(N_CMP, gen, dev)
    err = compare_hit(tables, o, d, exact=True)
    compare_cull(tables, o, d)
    o, d = camera_rays(cam, N_CMP, gen, dev)
    err = max(err, compare_hit(tables, o, d, exact=True))
    oT, dT = main_path_rays(cfg, gen, dev)
    err = max(err, compare_hit(tables, oT.T, dT.T, exact=True))
    compare_cull(tables, oT.T, dT.T)
    res_h, _rows, sph = time_hit(scene, tables, oT, dT, plain_reps=1)
    dense = tables._replace(sbb=None)          # the kernels without the cull
    dense_hit = cuda_ms(lambda: step.primary_hits(scene, dense, oT, dT), 10)
    log(f"{name} closest_hit {oT.shape[1]} rays: kernel {res_h['ms']:.3f} "
        f"ms (without the cull {dense_hit:.3f} ms), plain "
        f"{res_h['plain_ms']:.3f} ms, {sph:.1f} sphere rows tested per ray "
        f"(of {scene.kind_sweep[0]}), bound {fmt_bound(res_h)}")
    results[f"closest_hit/{name}"] = {"max_abs_err": err, **res_h,
                                      "library_ms": None}
    # the trace on 2^17 camera rays, then the frame
    u = torch.rand((BOUNCE + 1, nu, N_CMP), generator=gen, device=dev)
    ob, db = o.T.contiguous(), d.T.contiguous()
    err_f = compare_trace(scene, tables, decay, ob, db, u, work={})
    u8s = torch.rand((BOUNCE + 1, nu, RES * RES), generator=gen, device=dev)
    work = {}
    err_f = max(err_f, compare_trace(scene, tables, decay, oT, dT, u8s,
                                     work=work))
    hit0 = step.primary_hits(scene, tables, oT, dT)
    ms = cuda_ms(lambda: step.trace_fwd(scene, tables, decay, oT, dT, u8s,
                                        hit0), 5)
    dense_ms = cuda_ms(lambda: step.trace_fwd(scene, dense, decay, oT, dT,
                                              u8s, hit0), 2)
    plain_ms = cuda_ms(lambda: plain_trace(scene, tables, decay, oT, dT,
                                           u8s), 1)
    # where the main path compacts, the compacted render against the
    # unsegmented one and the segments' kernel time (none: inst_grid
    # renders whole); then the render compacted at the JAX package's cuts
    # against the whole one, radiance bit for bit, both timed from the
    # primaries
    seg = check_segmented(name, scene, tables, decay, cfg.rt.loss, oT, dT,
                          u8s, hit0, ms)
    cuts = tracer.jax_cuts(scene, BOUNCE + 1)

    def render(c):
        return tracer.trace_fused(scene, tables, BOUNCE, oT.T, dT.T,
                                  cfg.rt.loss, u8s, cuts=c)

    if not torch.equal(render([]), render(cuts)):
        raise AssertionError(f"{name}: the render compacted at {cuts} "
                             f"differs from the whole one")
    ms_flat, ms_split = cuda_ms(lambda: render([]), 3), \
        cuda_ms(lambda: render(cuts), 3)
    log(f"{name} render of {RES * RES} rays x {BOUNCE + 1} steps: "
        f"unsegmented {ms_flat:.3f} ms, compacted {ms_split:.3f} ms "
        f"(primary-hit pass, trace launches, compaction and radiance)")
    results["compaction/inst_grid"] = {"flat_ms": ms_flat,
                                       "compacted_ms": ms_split,
                                       "cuts": cuts}
    errs_t, errs_b = [], []
    n = N_MESH_BWD
    for oT_, dT_, u_ in ((ob[:, :n].contiguous(), db[:, :n].contiguous(),
                          u[..., :n].contiguous()), (oT, dT, u8s)):
        e, bad, (resid, nl), (res_r, nl_r) = compare_train_fwd(
            scene, tables, decay, oT_, dT_, u_,
            step.primary_hits(scene, tables, oT_, dT_), work={})
        errs_t.append(e)
        e, plain_b, ctA, ctB = compare_bwd(scene, tables, decay, oT_, dT_,
                                           u_, res_r, nl_r, bad, gen)
        errs_b.append(e)
    del res_r, nl_r
    ms_t = cuda_ms(lambda: step.trace_fwd_train(scene, tables, decay, oT, dT,
                                                u8s, hit0), 5)
    plain_t = cuda_ms(lambda: plain_trace(scene, tables, decay, oT, dT, u8s,
                                          want_resid=True), 1)
    ms_b = cuda_ms(lambda: step.trace_bwd(scene, tables, decay, u8s, resid,
                                          nl, ctA, ctB), 5)
    # the bound of the walks through sub-blocks (csrc/sph_walk.cuh), and
    # beside it the parent's lowest-first walk of 64-row blocks
    # (trace_plain's counts)
    bw_old = trace_work(scene, tables, u8s, resid, nl, work)
    walk = whole_walk_work(scene, tables, resid, nl)
    bw = trace_work(scene, tables, u8s, resid, nl, {**work, **walk})
    S = bw["live_steps"]
    L = scene.n_lights
    later = int((nl.long() - 1).clamp(min=0).sum())
    log(f"{name} trace_fwd {RES * RES} rays x {BOUNCE + 1} steps ({S} live "
        f"steps): kernel {ms:.3f} ms (without the cull {dense_ms:.3f} ms), "
        f"plain {plain_ms:.3f} ms, bound "
        f"{fmt_bound(bw['trace_fwd'])} (lowest-first walk "
        f"{fmt_bound(bw_old['trace_fwd'])}); sphere rows tested (of "
        f"{scene.kind_sweep[0]}): {walk['sph_sweep'] / max(later, 1):.1f} "
        f"per closest-hit sweep after step 0 "
        f"({work['sph_sweep'] / max(later, 1):.1f} lowest first), "
        f"{walk['sph_shadow'] / max(S * L, 1):.1f} per shadow sweep "
        f"({work['sph_shadow'] / max(S * L, 1):.1f}), "
        f"{walk['sph_slabs'] / max(later + S * L, 1):.1f} slab tests per "
        f"sweep")
    log(f"{name} trace_fwd_train: kernel {ms_t:.3f} ms, plain "
        f"{plain_t:.3f} ms, bound {fmt_bound(bw['trace_fwd_train'])}; "
        f"trace_bwd: kernel {ms_b:.3f} ms, plain {plain_b:.3f} ms, bound "
        f"{fmt_bound(bw['trace_bwd'])}")
    use = resources(scene, tables, name)
    results[f"trace_fwd/{name}"] = {
        "max_abs_err": err_f, "ms": ms, "plain_ms": plain_ms,
        **bw["trace_fwd"], "library_ms": None, **seg, **use["trace_fwd"],
        "lowest_first_bound_ms": bw_old["trace_fwd"]["bound_ms"]}
    results[f"trace_fwd_train/{name}"] = {
        "max_abs_err": max(errs_t), "ms": ms_t, "plain_ms": plain_t,
        **bw["trace_fwd_train"], "library_ms": None,
        **use["trace_fwd_train"],
        "lowest_first_bound_ms": bw_old["trace_fwd_train"]["bound_ms"]}
    results[f"trace_bwd/{name}"] = {
        "max_abs_err": max(errs_b), "ms": ms_b, "plain_ms": plain_b,
        **bw["trace_bwd"], "library_ms": None, **use["trace_bwd"]}
    results["sph_rows/inst_grid"] = {
        "dense_closest_hit_ms": dense_hit, "dense_trace_fwd_ms": dense_ms,
        "closest_hit_per_ray": sph,
        "sweep_per_step": walk["sph_sweep"] / max(later, 1),
        "shadow_per_sweep": walk["sph_shadow"] / max(S * L, 1),
        "slabs_per_sweep": walk["sph_slabs"] / max(later + S * L, 1),
        "lowest_first_sweep_per_step": work["sph_sweep"] / max(later, 1),
        "lowest_first_shadow_per_sweep": work["sph_shadow"]
        / max(S * L, 1)}
    del resid


def write_json(path, cfg_json):
    with open(path, "w") as f:
        json.dump(cfg_json, f)
    return path


def phase_inst_main(card, counts):
    """Phase 16: the CLI renders ``inst_grid`` from a JSON file (counted:
    one primary-hit launch per sample, one trace launch per segment of the
    sample's compacted render, no plain version; ten timed renders, one
    profiled), and the HTTP service answers one ``inst_grid`` request."""
    import numpy as np
    from PIL import Image

    from micro_raytracer_tpu_torch.ops import hit3, step

    name = "inst_grid"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_inst_")
    path = write_json(os.path.join(tmp, f"{name}.json"), inst_json(name))
    out = os.path.join(tmp, f"{name}.png")
    segs = segments(inst_config(name))
    for k in (hit3.KERNEL, step.KERNEL):
        k.launches = 0
        k.plain_calls = 0
    render_s, wall = render_cli(out, [path])
    launched = {k.name: k.launches for k in (hit3.KERNEL, step.KERNEL)}
    counts[name] = launched
    if launched != {hit3.KERNEL.name: SAMPLES,
                    step.KERNEL.name: SAMPLES * segs} \
            or hit3.KERNEL.plain_calls or step.KERNEL.plain_calls:
        raise AssertionError(f"{name} render: launches {launched} ({segs} "
                             f"segments per sample), plain calls "
                             f"{hit3.KERNEL.plain_calls}, "
                             f"{step.KERNEL.plain_calls}")
    img = np.asarray(Image.open(out))
    if img.shape != (RES, RES, 3) or float(img.std()) < 5.0:
        raise AssertionError(f"{name}: image {img.shape}, std "
                             f"{float(img.std()):.2f}")
    loops = [render_s] + [render_cli(out, [path])[0]
                          for _ in range(RENDER_REPS - 1)]
    spread = render_spread(loops, card)
    ((loop_p, _w), wall_p, busy, n_ops, by_name) = _busy_share(
        lambda: render_cli(out, [path]))
    med = float(np.median(loops))
    log(f"{name} render profile: the CLI's wall {wall_p:.4f} s (render "
        f"loop {loop_p:.4f} s under the profiler), device busy "
        f"{busy:.4f} s = {busy / med:.3f} of the unprofiled loop's "
        f"median {med:.4f} s; {n_ops} device operations "
        f"({n_ops / SAMPLES:.1f} per sample); {segs} trace segments per "
        f"sample")
    for kname, t in sorted(by_name.items(), key=lambda x: -x[1])[:4]:
        log(f"  {t * 1e3:9.3f} ms  {kname[:90]}")
    phase_server(inst_config(name), requests=1)
    return {"render_s": render_s, "wall_s": wall, "spread": spread,
            "busy_s": busy, "busy_share": busy / med,
            "ops_per_sample": n_ops / SAMPLES, "segments": segs}


# --- the per-step path (phases 18-21) ---------------------------------------

def step_inputs(name, dev):
    """(cfg, scene, tables, decay, cam) of a per-step stand-in on the card:
    ``lights8`` (24 rows, 7 valid, 8 lights, refractive) or ``inst_grid3k``
    (3,375 sphere rows in 53 cull blocks and the plane: 3,384 rows); both
    routed to the per-step path, rendering and training."""
    from micro_raytracer_tpu_torch.models import tracer
    from micro_raytracer_tpu_torch.models.compiler import (compile_camera,
                                                           compile_scene)
    from micro_raytracer_tpu_torch.ops import step

    cfg = step_config(name)
    scene = compile_scene(cfg.scene, dev)
    tables = step.pack_step(scene)
    want = {"lights8": (24, 8, 0, True), "inst_grid3k": (3384, 2, 53, False)}
    got = (scene.n_prims, scene.n_lights,
           0 if tables.sbb is None else tables.sbb.shape[0],
           scene.any_refract)
    if got != want[name]:
        raise AssertionError(f"{name}: rows, lights, cull blocks, refract "
                             f"{got}, want {want[name]}")
    if (step.route(scene, False), step.route(scene, True)) \
            != ("steps", "steps"):
        raise AssertionError(f"{name}: not routed to the per-step path")
    return (cfg, scene, tables, tracer.decay_of(cfg.rt.loss),
            compile_camera(cfg.frame.cam, dev))


def plain_step_chunked(scene, tables, decay, c0, u8, want_resid=False):
    """``step.step_plain`` over chunks of rays (``chunk_for``)."""
    import torch

    from micro_raytracer_tpu_torch.ops import step

    R = c0.shape[1]
    outs = []
    chunk = chunk_for(tables, PLAIN_FWD_CHUNK)
    for s in range(0, R, chunk):
        c = c0[:, s:s + chunk].contiguous()
        u = u8[:, s:s + chunk].contiguous()
        outs.append(step.step_plain(scene, tables, decay, c, u, want_resid))
    return tuple(torch.cat(x, -1) for x in zip(*outs))


def step_bwd_plain_chunked(scene, tables, decay, c0, u8, ct1):
    """``step.step_bwd_plain`` over chunks of PLAIN_CHUNK rays (halved for
    long tables), the table cotangents summed in float64 beside their
    masses: ``(d_tab, d_lights, d_c0, d_tri, mass_tab, mass_lights,
    mass_tri)``."""
    import torch

    from micro_raytracer_tpu_torch.ops import step

    R = c0.shape[1]
    f64 = torch.float64
    d_tab, m_tab = (torch.zeros_like(tables.tab, dtype=f64) for _ in "ab")
    d_lt, m_lt = (torch.zeros_like(tables.lights, dtype=f64) for _ in "ab")
    d_tri, m_tri = (torch.zeros_like(tables.tri, dtype=f64) for _ in "ab")
    d_c0 = torch.empty_like(c0)
    chunk = PLAIN_CHUNK         # one step's graph of 2^14 rays fits the card
    for s in range(0, R, chunk):
        sl = slice(s, min(R, s + chunk))
        g = step.step_bwd_plain(scene, tables, decay,
                                *(t[:, sl].contiguous()
                                  for t in (c0, u8, ct1)))
        for acc, m, x in ((d_tab, m_tab, g[0]), (d_lt, m_lt, g[1]),
                          (d_tri, m_tri, g[3])):
            acc += x.to(f64)
            m += x.to(f64).abs()
        d_c0[:, sl] = g[2]
    return d_tab, d_lt, d_c0, d_tri, m_tab, m_lt, m_tri


def compare_step_fwd(name, scene, tables, decay, c0, u8, k):
    """The render and train instances of the step kernel at step ``k`` of
    the frame: equal to each other bit for bit (carry and hit), and
    against the plain step: hit equal (the sweeps are exact), the carry
    within rtol 1e-4 / atol 1e-5 on all but OUTLIER_SHARE of the rays, A
    and B within IN_ERR on the rest, and the residuals of the rest that
    hit as phase 7 holds them. Returns (max abs err, off-path rays, the
    kernel's carry, the plain residuals and hit, the plain step's ms)."""
    import torch

    from micro_raytracer_tpu_torch.ops import step

    R = c0.shape[1]
    c1, hit = step.step_fwd(scene, tables, decay, c0, u8)
    c1_t, hit_t, res = step.step_fwd_train(scene, tables, decay, c0, u8)
    if not (torch.equal(c1, c1_t) and torch.equal(hit, hit_t)):
        raise AssertionError(f"{name} step {k}: the train instance differs "
                             f"from the render instance")
    box = []
    plain = plain_ms(lambda: box.append(plain_step_chunked(
        scene, tables, decay, c0, u8, want_resid=True)))
    c1_p, hit_p, res_p = box[0]
    n_hit = int((hit != hit_p).sum())
    if n_hit:
        raise AssertionError(f"{name} step {k}: hit differs on {n_hit} "
                             f"rays")
    bad = outlier_rays(c1, c1_p, 1e-4, 1e-5)
    share = float(bad.float().mean())
    good = ~bad
    err = float((c1 - c1_p)[8:14].abs().max())
    err_in = float((c1 - c1_p)[8:14][:, good].abs().max())
    live = (hit[0] > 0.5) & good
    floats = [step.RES_O + c for c in range(9)] + [step.RES_TE]
    exact = [step.RES_ROW] + [step.RES_LOK + li
                              for li in range(scene.n_lights)]
    if scene.any_refract:
        floats.append(step.RES_TX)
        exact.append(step.RES_CHOOSE)
    res_err = 0.0
    for r in floats:
        g, w = res[r][live], res_p[r][live]
        res_err = max(res_err, float((g - w).abs().max()))
        if not bool(torch.isclose(g, w, rtol=1e-4, atol=1e-4).all()):
            raise AssertionError(f"{name} step {k}: residual row {r} "
                                 f"differs")
    for r in exact:
        if not torch.equal(res[r][live], res_p[r][live]):
            raise AssertionError(f"{name} step {k}: residual row {r} "
                                 f"differs")
    log(f"{name} step_fwd step {k}, {R} rays ({int(hit.sum())} hit): the "
        f"train instance equals the render instance bit for bit; hit equals "
        f"the plain step's; {int(bad.sum())} rays outside rtol 1e-4 (share "
        f"{share:.5f}, bound {OUTLIER_SHARE}); max abs err of A/B {err:.3g}, "
        f"{err_in:.3g} over the rest (bound {IN_ERR}); residuals of "
        f"{int(live.sum())} rays within {res_err:.3g}")
    if share > OUTLIER_SHARE or err_in > IN_ERR:
        raise AssertionError(f"{name} step_fwd disagrees with the plain "
                             f"step")
    return err, bad, c1, res_p, hit_p, plain


def step_bwd_ray_tol(w):
    """Per-ray tolerance of a step's input-carry cotangent ``w`` (14, R):
    G_RTOL of each entry and G_FLOOR of the ray's own largest magnitude in
    the entry's group (o, d, and the fold's pwr, A and B), so that a ray
    whose o or d cotangent a grazing hit blows up sets no floor for the
    others."""
    wa = w.abs()
    tol = G_RTOL * wa
    for a, b in STEP_CARRY_GROUPS:
        tol[a:b] += G_FLOOR * wa[a:b].amax(0)
    return tol


def compare_step_bwd(name, scene, tables, decay, c0, u8, res, hit, bad,
                     gen):
    """The step's backward kernel on the plain residuals against autograd
    of the plain step, for random output cotangents on every carry row,
    zero on the off-path rays.

    Per ray, d_c0 within ``step_bwd_ray_tol`` (rtol G_RTOL, G_FLOOR of the
    ray's own group magnitude); a ray outside must be shown ill-conditioned
    by float64 (``ill_conditioned``'s rule), at most ILL_SHARE of them. A
    grazing hit divides the o and d cotangents by d.n (up to ~1e15), so
    the rays whose largest cotangent exceeds HEAVY times the median ray's
    (at most HEAVY_SHARE of them) and the ill-conditioned ones are held per
    ray only: both sides drop them (the cotangents are linear in ct1) and
    the table cotangents of the rest are held within G_RTOL, G_FLOOR of
    the table's largest entry and SUM_TOL of the entry's mass. At the
    frame the per-ray cotangents of ``frame_subset``'s rays are held from
    the frame's launch, the rest on that subset (``compare_bwd``).
    Returns (max abs err, plain ms on at most N_CMP rays, ct1)."""
    import torch

    from micro_raytracer_tpu_torch.ops import step

    R = c0.shape[1]
    ct1 = torch.randn((step.CARRY_ROWS, R), generator=gen, device=c0.device)
    ct1[:, bad] = 0.0
    out_ct = ct1
    sub = frame_subset(R, c0.device)
    if sub is not None:
        frame = step.step_bwd(scene, tables, decay, c0, u8, res, hit, ct1)[2]
        c0, u8, res, hit, ct1 = (t[:, sub].contiguous()
                                 for t in (c0, u8, res, hit, ct1))
        bad = bad[sub]
        R = N_CMP
    got = step.step_bwd(scene, tables, decay, c0, u8, res, hit, ct1)
    if sub is not None:
        if not torch.equal(got[2], frame[:, sub]):
            raise AssertionError(f"{name} step_bwd: d_c0 of the frame's "
                                 f"subset differs from the frame launch's")
        del frame
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = step_bwd_plain_chunked(scene, tables, decay, c0, u8, ct1)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    if not bool(torch.isfinite(got[2]).all()):
        raise AssertionError(f"{name} step_bwd: non-finite d_c0")
    ill = ((got[2] - want[2]).abs() > step_bwd_ray_tol(want[2])).any(0)
    n_ill = int(ill.sum())
    if n_ill > ILL_SHARE * R:
        raise AssertionError(f"{name} step_bwd: {n_ill} rays disagree with "
                             f"autograd of the plain step (bound "
                             f"{ILL_SHARE * R:.0f})")
    worst = 0.0
    if n_ill:
        idx = ill.nonzero()[:, 0]
        f64 = torch.float64
        t64 = tables._replace(tab=tables.tab.to(f64),
                              lights=tables.lights.to(f64),
                              tri=tables.tri.to(f64))
        w64 = step.step_bwd_plain(scene, t64, decay,
                                  *(t[:, idx].to(f64) for t in (c0, u8, ct1)))
        off = (got[2][:, idx].to(f64) - want[2][:, idx]).abs().amax(0)
        own = (want[2][:, idx] - w64[2]).abs().amax(0)
        ratio = off / own
        worst = float(ratio.max())
        if not bool((ratio <= ILL_RATIO).all()):
            raise AssertionError(f"{name} step_bwd: a ray disagrees with the "
                                 f"plain step {worst:.3g} times as far as "
                                 f"float64 moves it")
    mag = want[2].abs().amax(0)
    typical = float(mag[~bad].median())
    heavy = mag > HEAVY * typical
    n_heavy = int(heavy.sum())
    if n_heavy > HEAVY_SHARE * R:
        raise AssertionError(f"{name} step_bwd: {n_heavy} rays have "
                             f"cotangents over {HEAVY:g} times the median "
                             f"ray's (bound {HEAVY_SHARE * R:.0f})")
    err_ray = float((got[2] - want[2]).abs().max())
    drop = ill | heavy
    if bool(drop.any()):
        ct1[:, drop] = 0.0
        got = step.step_bwd(scene, tables, decay, c0, u8, res, hit, ct1)
        want = step_bwd_plain_chunked(scene, tables, decay, c0, u8, ct1)
    err, msg = err_ray, []
    masses = (want[4], want[5], None, want[6])
    for gname, g, w, m in zip(("d_tab", "d_lights", "d_c0", "d_tri"), got,
                              want, masses):
        if not w.numel():
            continue
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name} step_bwd: non-finite {gname}")
        g = g.to(w.dtype)
        e = (g - w).abs()
        if m is None:       # per ray, the dropped rays now zero on both
            tol = step_bwd_ray_tol(w)
        else:
            tol = (G_RTOL * w.abs() + G_FLOOR * float(w.abs().max())
                   + SUM_TOL * m)
        share = torch.where(e > 0, e / tol, 0.0)
        msg.append(f"{gname} {float(e.max()):.3g} of {float(w.abs().max()):.3g}"
                   f" (worst {float(share.max()):.3f} of its tolerance)")
        if not bool((e <= tol).all()):
            raise AssertionError(f"{name} step_bwd: {gname} differs from "
                                 f"autograd on {int((e > tol).sum())} "
                                 f"entries")
        if m is not None:
            err = max(err, float(e.max()))
    log(f"{name} step_bwd {R} rays: per ray, {n_ill} shown ill-conditioned "
        f"(at most {worst:.3g} times float64's move), max abs err {err_ray:.3g}"
        f"; {n_heavy} rays over {HEAVY:g} times the median ray's largest "
        f"cotangent ({typical:.3g}) held per ray only; over the other "
        f"{R - int(drop.sum())}: {', '.join(msg)}")
    return err, plain_ms, out_ct


def sph_walk_work(tables, o, d, on, shadow):
    """Per ray (m,) float64, what ``csrc/step_fwd.cu``'s walks of a culled
    sphere segment test for the rays ``o``, ``d`` ``(m, 3)`` where ``on``:
    ``slabs`` block and sub-block slab tests, ``rows`` sphere rows. The
    closest hit (``sph_entry_nearest``): every block's slab test, then the
    touched blocks nearest first (an origin inside the blocks' AABB) or
    lowest first while their entry t is at or before the best, each
    block's sub-blocks tested (their boxes grown, ``sub_touch``) at the
    best then and a passing sub-block's rows swept; a shadow walk
    (``shadow``, ``sph_any_sub``): the touched blocks lowest first, each
    block's sub-blocks tested and a touched sub-block's rows up to the
    first hit, which ends the walk. From the plain row and slab tests, in
    the kernel's order."""
    import torch

    from micro_raytracer_tpu_torch.models import schema
    from micro_raytracer_tpu_torch.ops import hit3

    BIG, f64 = hit3.BIG, torch.float64
    sbb, ssb, SUB, CB = tables.sbb, tables.ssb, hit3.SPH_SUB, hit3.CB
    _kind, s0, c, n = tables.layout[0][0]
    nb, nsub, m = sbb.shape[0], -(-n // SUB), o.shape[0]
    fr, ipos, pa, pr, valid, _gid = hit3.split_sweep(tables.tab.detach())
    t0, _t1, ok = hit3._kind_block(schema.KIND_SPHERE, s0, s0 + n, fr, ipos,
                                   pa, pr, valid, o, d)
    pad = nsub * SUB - n
    ok = torch.nn.functional.pad(ok, (0, pad)).view(m, nsub, SUB)
    t = torch.where(ok, torch.nn.functional.pad(t0, (0, pad)).view(
        m, nsub, SUB), BIG)
    sub_min, sub_any = t.amin(-1), ok.any(-1)
    first = torch.where(sub_any, ok.to(torch.int8).argmax(-1) + 1,
                        SUB).to(f64)
    cnt = torch.clamp(n - torch.arange(nsub, device=o.device) * SUB,
                      max=SUB).to(f64)
    invd = hit3._inv_dir(d)
    b_min, b_max = _slabs(sbb, o, invd)
    # the sub-blocks' boxes grown by g (1 + |o - centre|^2) (sub_touch)
    sb = ssb[:nsub]
    q = o[:, None] - 0.5 * (sb[None, :, :3] + sb[None, :, 3:6])
    grow = sb[None, :, 6] * (1.0 + (q * q).sum(-1))
    t1 = (sb[None, :, :3] - grow[..., None] - o[:, None]) * invd[:, None]
    t2 = (sb[None, :, 3:6] + grow[..., None] - o[:, None]) * invd[:, None]
    s_min = torch.minimum(t1, t2).amax(-1)
    s_max = torch.maximum(t1, t2).amin(-1)
    del q, grow, t1, t2
    touch = (b_max >= torch.clamp(b_min, min=0.0)) & (b_min <= BIG) \
        & on[:, None]
    s_near = s_max >= torch.clamp(s_min, min=0.0)
    seg = torch.cat([sbb[:, :3].amin(0), sbb[:, 3:6].amax(0)])
    inside = ((o >= seg[:3]) & (o <= seg[3:])).all(1)
    slabs = on.to(f64) * nb
    rows = torch.zeros(m, dtype=f64, device=o.device)
    subs = [(k, min(k + CB // SUB, nsub)) for k in range(0, nsub, CB // SUB)]

    def take(idx, a):
        return a.gather(1, idx[:, None])[:, 0]

    if not shadow:
        key = torch.where(touch, b_min, float("inf"))
        # nearest first from inside the blocks' box, else lowest first
        order = torch.where(inside[:, None],
                            torch.argsort(key, dim=1, stable=True),
                            torch.arange(nb, device=o.device)[None])
        best = torch.full((m,), BIG, device=o.device)
        active = on.clone()
        for j in range(nb):
            b = order[:, j]
            go_b = take(b, key) <= best
            # nearest first stops at the first block beyond the best
            active = active & (go_b | ~inside)
            visit = active & go_b
            for k in range(CB // SUB):
                si = torch.clamp(b * (CB // SUB) + k, max=nsub - 1)
                inb = visit & (b * (CB // SUB) + k < nsub)
                slabs += inb.to(f64)
                go = inb & take(si, s_near) & (take(si, s_min) <= best)
                rows += torch.where(go, take(si, cnt[None].expand(m, -1)),
                                    0.0)
                best = torch.where(go, torch.minimum(best, take(si, sub_min)),
                                   best)
        return slabs, rows
    found = ~on
    for b, (lo, hi) in enumerate(subs):
        visit = touch[:, b] & ~found
        for sb in range(lo, hi):
            slabs += visit.to(f64)
            go = visit & s_near[:, sb]
            rows += torch.where(go, torch.where(sub_any[:, sb], first[:, sb],
                                                cnt[sb]), 0.0)
            found = found | (go & sub_any[:, sb])
            visit = visit & ~found
    return slabs, rows


def tri_any_work(tables, o, d, on):
    """Per ray (m,) float64, what the kTriIn shadow walk
    (``tri_walk.cuh tri_any_walk``) tests for the rays where ``on``:
    ``slabs`` the chunk bound, the superblocks of a met chunk, the blocks
    of each met superblock up to the first hit; ``rows`` the triangle rows
    of each met block up to the first hit, which ends the walk. Assumes
    one staged chunk (at most 64 superblocks, ``mesh_big``'s 64)."""
    import torch

    from micro_raytracer_tpu_torch.ops import hit3, tri

    BIG, f64, SB, CB = hit3.BIG, torch.float64, tri.SUPER, hit3.CB
    t, tbb, tsb, n = (tables.tri.detach(), tables.tbb, tables.tsb,
                      tables.layout[3])
    nb, ns, m = -(-n // CB), tsb.shape[0], o.shape[0]
    assert ns <= 64
    invd = hit3._inv_dir(d)

    def met(box):
        lo, hi = _slabs(box, o, invd)
        return (hi >= torch.clamp(lo, min=0.0)) & (lo <= BIG)

    chunk = torch.cat([tsb[:, :3].amin(0), tsb[:, 3:6].amax(0)])[None]
    walk = on & met(chunk)[:, 0]
    slabs = on.to(f64) + walk.to(f64) * ns
    rows = torch.zeros(m, dtype=f64, device=o.device)
    idx = torch.nonzero(walk).flatten()
    if not idx.numel():
        return slabs, rows
    o, d, invd = o[idx], d[idx], invd[idx]
    s_met = met(tsb)
    b_met = met(tbb[:nb])
    found = torch.zeros(idx.numel(), dtype=torch.bool, device=o.device)
    s_tests = torch.zeros(idx.numel(), dtype=f64, device=o.device)
    r_cnt = torch.zeros_like(s_tests)
    for sp in range(ns):
        visit = s_met[:, sp] & ~found
        if not bool(visit.any()):
            continue
        b0, b1 = sp * SB, min(sp * SB + SB, nb)
        s_tests += visit.to(f64) * (b1 - b0)
        for b in range(b0, b1):
            go = visit & b_met[:, b] & ~found
            if not bool(go.any()):
                continue
            lo, hi = b * CB, min(b * CB + CB, n)
            hits = hit3._tri_block_any(t[lo:hi], o, d)
            h_any = hits.any(1)
            f = torch.where(h_any, hits.to(torch.int8).argmax(1) + 1,
                            hi - lo).to(f64)
            r_cnt += torch.where(go, f, 0.0)
            found = found | (go & h_any)
    slabs[idx] += s_tests
    rows[idx] = r_cnt
    return slabs, rows


def step_walk_work(scene, tables, c, res, hit, sub):
    """The walks' work of one step launch on the carry ``c`` with the
    train instance's residuals ``res`` and hit ``hit``, counted on the
    rays ``sub`` of the frame and scaled to it: ``sph_sweep`` /
    ``sph_shadow`` the sphere rows of the closest-hit and the shadow walks
    (:func:`sph_walk_work`), ``shadow`` the triangle rows of the kTriIn
    shadow walks (:func:`tri_any_work`; the dense rows sweep first, and a
    ray they occlude walks no triangle), ``slabs`` the block, sub-block
    and superblock slab tests of both. A shadow ray leaves its entry point
    toward each light, as the train instance (every ray that hits)."""
    import torch

    from micro_raytracer_tpu_torch.ops import hit3, step

    work = {"sph_sweep": 0.0, "sph_shadow": 0.0, "shadow": 0.0,
            "slabs": 0.0, "sweep": 0.0}
    tri_in = step.tri_split(tables.layout[2])
    if tables.sbb is None and not tri_in:
        return work
    R = c.shape[1]
    scale = R / sub.numel()
    cs = c[:, sub]
    live = cs[step.C_LIVE] > 0.5
    h = hit[0, sub] > 0.5
    r = res[:, sub]
    o, d = cs[0:3].T.contiguous(), cs[3:6].T.contiguous()
    chunk = 1 << 12

    def add(key, fn, *args):
        sl = torch.zeros(0, dtype=torch.float64, device=c.device)
        rw = torch.zeros_like(sl)
        for k in range(0, o.shape[0], chunk):
            a, b = fn(tables, *(x[k:k + chunk] for x in args))
            sl, rw = torch.cat([sl, a]), torch.cat([rw, b])
        work["slabs"] += float(sl.sum()) * scale
        work[key] += float(rw.sum()) * scale

    if tables.sbb is not None:
        add("sph_sweep", lambda t, a, b, m: sph_walk_work(t, a, b, m, False),
            o, d, live)
    ro = r[step.RES_O:step.RES_O + 3].T
    rd = r[step.RES_D:step.RES_D + 3].T
    p_e = ro + rd * r[step.RES_TE][:, None]
    dense = (tables.layout[0], tables.layout[1], 0, 0)
    for li in range(scene.n_lights):
        lv = step._light_vec(tables.lights[li].detach(), p_e)
        ln = lv * (1.0 / torch.sqrt((lv * lv).sum(1, keepdim=True)))
        so = (p_e + ln * hit3.EPS).contiguous()
        ln = ln.contiguous()
        if tables.sbb is not None:
            add("sph_shadow",
                lambda t, a, b, m: sph_walk_work(t, a, b, m, True), so, ln,
                h)
        if tri_in:
            occ = torch.cat([hit3.sweep_plain(
                tables.tab.detach(), dense, so[k:k + chunk],
                ln[k:k + chunk], hit3.MODE_ANY)[0] < 0.0
                for k in range(0, so.shape[0], chunk)])
            add("shadow", tri_any_work, so, ln, h & ~occ)
    return work


def step_work(scene, tables, c0, u8, res, hit, work):
    """Bounds of one launch of step_fwd, step_fwd_train and step_bwd on
    these inputs, from the work their data asks for: every ray live on
    entry sweeps the rows (a culled sphere segment: the rows ``work``
    counts), a ray that hits tests its group's exit row on a refractive
    scene and sweeps once per light (a visible light every row, an
    occluded one at least one), then shades; the walks' slab tests
    (``work["slabs"]``, :func:`step_walk_work`); the backward transposes
    the step of every ray that hit."""
    from micro_raytracer_tpu_torch.ops import step

    R = c0.shape[1]
    NU = u8.shape[0]
    L = scene.n_lights
    P = valid_rows(scene, tables) - walked_rows(scene, tables)
    live_in = int((c0[step.C_LIVE] > 0.5).sum())
    h = hit[0] > 0.5
    S = int(h.sum())
    lok = res[step.RES_LOK:step.RES_LOK + L][:, h] > 0.5
    vis = int(lok.sum())
    occ = S * L - vis
    sph = 0
    if tables.sbb is not None:
        sph = work["sph_sweep"] + work["sph_shadow"]
        occ = 0
    exits = S if scene.any_refract else 0
    chosen = (int((res[step.RES_CHOOSE][h] > 0.5).sum())
              if scene.any_refract else 0)
    fwd_ops = ((live_in * P + exits + vis * P + occ + sph) * ROW_TEST_OPS
               + S * (FWD_STEP_OPS + L * FWD_LIGHT_OPS)
               + (S * FWD_REFRACT_OPS if scene.any_refract else 0)
               + work["sweep"] * TRI_TEST_OPS + work["shadow"] * TRI_ANY_OPS
               + work.get("slabs", 0) * SLAB_OPS)
    tables_b = table_bytes(scene, tables)
    CR = step.scene_res_rows(scene, tables.layout)
    # carry in and out, hit out, uniforms per ray
    fwd_b = R * (56 + 56 + 4 + NU * 4) + tables_b
    train_b = fwd_b + S * CR * 4
    bwd_ops = (S * BWD_STEP_OPS + chosen * BWD_REFRACT_OPS
               + vis * BWD_LIGHT_OK_OPS + occ * BWD_LIGHT_OCC_OPS)
    # ct1 in, ct0 out, hit in per ray; residuals, uniforms and pwr per ray
    # that hit; tables in, their cotangents out
    bwd_b = R * (56 + 56 + 4) + S * (CR + NU + 1) * 4 + 2 * tables_b
    return {"step_fwd": bound(fwd_b, fwd_ops),
            "step_fwd_train": bound(train_b, fwd_ops),
            "step_bwd": bound(bwd_b, bwd_ops), "hits": S,
            "live_in": live_in}


# the rays of a frame on which a sample's walks are counted for its bound
N_WORK = 1 << 14
STEP_KERNELS = ("step_fwd", "step_fwd_train", "step_bwd")


def step_sample(scene, tables, decay, carries, u8s, gen, alone=False):
    """A sample's nine steps of the frame from its ``carries``: each step's
    train instance (its residuals), step_bwd timed on them (CUDA-event ms,
    random output cotangents), the walks' work counted on ``N_WORK`` of the
    frame's rays (:func:`step_walk_work`) and each launch's bounds
    (:func:`step_work`); ``alone``: the train instance without the
    triangle sweep before it (a kTriIn scene). Returns the per-step bwd ms,
    work and bounds, and the summed bounds of a sample's nine step_fwd
    and step_bwd launches."""
    import torch

    from micro_raytracer_tpu_torch.ops import step

    R = carries[0].shape[1]
    sub = frame_subset(R, carries[0].device)
    sub = torch.arange(R, device=carries[0].device) if sub is None \
        else sub[:N_WORK]
    out = {"bwd_ms": [], "work": [], "bounds": []}
    ct1 = torch.randn((step.CARRY_ROWS, R), generator=gen,
                      device=carries[0].device)
    for k, c in enumerate(carries):
        _c1, hit, res = step.step_fwd_train(scene, tables, decay, c, u8s[k])
        out["bwd_ms"].append(cuda_ms(lambda: step.step_bwd(
            scene, tables, decay, c, u8s[k], res, hit, ct1), 3))
        work = step_walk_work(scene, tables, c, res, hit, sub)
        out["work"].append(work)
        out["bounds"].append(step_work(scene, tables, c, u8s[k], res, hit,
                                       work))
        del res
    out["fwd_bound"] = sum(b["step_fwd"]["bound_ms"] for b in out["bounds"])
    out["bwd_bound"] = sum(b["step_bwd"]["bound_ms"] for b in out["bounds"])
    return out


def per_ray(work, R):
    """A step's work counts (:func:`step_walk_work`) per ray of R."""
    return {k: round(v / R, 2) for k, v in work.items()}


def log_sample(name, fwd_ms, sample):
    """Log a sample's nine step_fwd and step_bwd launches beside their
    bounds (:func:`step_sample`)."""
    log(f"{name} a sample's nine steps: step_fwd "
        f"{' + '.join(f'{t:.3f}' for t in fwd_ms)} = {sum(fwd_ms):.3f} ms, "
        f"bound {sample['fwd_bound']:.4f} ms; step_bwd "
        f"{' + '.join(f'{t:.3f}' for t in sample['bwd_ms'])} = "
        f"{sum(sample['bwd_ms']):.3f} ms, bound {sample['bwd_bound']:.4f} "
        f"ms; live rays "
        f"{[b['live_in'] for b in sample['bounds']]}")


def phase_step_kernels(results, names=STEP_NAMES):
    """Phase 18: the per-step kernels on ``lights8`` and ``inst_grid3k``
    at the frame (camera rays in Morton order, bounce 8): the render and
    train instances of step_fwd against each other and against the plain
    step at steps 0 and 2 (from the kernel's carry), step_bwd against
    autograd of the plain step at step 0; the per-step trace's
    radiance against the plain per-step trace's (phase 4's rule). Timed
    and bounded at step 0, a launch with every ray live, and over a
    sample's nine launches of step_fwd and of step_bwd (fed each step's
    train residuals), each beside the sum of its nine bounds, counted
    from each step's work (:func:`step_sample`)."""
    import torch

    from micro_raytracer_tpu_torch.ops import step

    dev = torch.device("cuda")
    for name in names:
        cfg, scene, tables, decay, cam = step_inputs(name, dev)
        gen = torch.Generator(device=dev).manual_seed(18)
        oT, dT = main_path_rays(cfg, gen, dev)
        nu = step.n_uni(scene.any_refract)
        u8s = torch.rand((BOUNCE + 1, nu, RES * RES), generator=gen,
                         device=dev)
        c = step.primary_carry(oT, dT)
        carries, step_ms = [], []
        for k in range(BOUNCE + 1):
            carries.append(c)
            step_ms.append(cuda_ms(
                lambda c=c, k=k: step.step_fwd(scene, tables, decay, c,
                                               u8s[k]), 3))
            c = step.step_fwd(scene, tables, decay, c, u8s[k])[0]
        A, B, _fl = step.trace_steps(scene, tables, decay, oT, dT, u8s)
        if not (torch.equal(A, c[8:11]) and torch.equal(B, c[11:14])):
            raise AssertionError(f"{name}: trace_steps differs from its "
                                 f"launches")
        log(f"{name} step_fwd at the frame, per step "
            f"{' + '.join(f'{t:.3f}' for t in step_ms)} = "
            f"{sum(step_ms):.3f} ms a sample")
        # the per-step trace against the plain per-step trace on 2^17
        # camera rays (phase 4's rule)
        o, d = camera_rays(cam, N_CMP, gen, dev)
        oc, dc = o.T.contiguous(), d.T.contiguous()
        u = u8s[..., :N_CMP].contiguous()
        A, B, fl = step.trace_steps(scene, tables, decay, oc, dc, u)
        cp = step.primary_carry(oc, dc)
        for k in range(BOUNCE + 1):
            cp, hit_p = plain_step_chunked(scene, tables, decay, cp, u[k])
            if k == 0:
                fl_p = hit_p
        if not torch.equal(fl, fl_p):
            raise AssertionError(f"{name}: first_live differs from the plain "
                                 f"per-step trace")
        sky = scene.sky_color[:, None]
        rad = B + A * (sky * scene.sky_pwr)
        rad_p = cp[11:14] + cp[8:11] * (sky * scene.sky_pwr)
        bad = outlier_rays(A, cp[8:11], 1e-4, 1e-5) \
            | outlier_rays(B, cp[11:14], 1e-4, 1e-5) \
            | outlier_rays(rad, rad_p, 1e-4, 1e-5)
        share = float(bad.float().mean())
        err_in = float(max((A - cp[8:11])[:, ~bad].abs().max(),
                           (B - cp[11:14])[:, ~bad].abs().max()))
        log(f"{name} per-step trace {N_CMP} rays x {BOUNCE + 1} steps: "
            f"{int(bad.sum())} rays outside rtol 1e-4 of the plain per-step "
            f"trace (share {share:.5f}, bound {OUTLIER_SHARE}), {err_in:.3g} "
            f"over the rest (bound {IN_ERR})")
        if share > OUTLIER_SHARE or err_in > IN_ERR:
            raise AssertionError(f"{name}: the per-step trace disagrees with "
                                 f"the plain one")
        del cp
        # step 0 (the times and bounds below) and step 2 against the plain
        # step; the backward at step 0, on the plain residuals
        errs_f = []
        for k in (2, 0):
            e, bad, _c1, res0, hit0, plain_t = compare_step_fwd(
                name, scene, tables, decay, carries[k], u8s[k], k)
            errs_f.append(e)
        c0, u8 = carries[0], u8s[0]
        err_b, plain_b, ct1 = compare_step_bwd(name, scene, tables, decay,
                                               c0, u8, res0, hit0, bad, gen)
        plain_f = plain_ms(lambda: plain_step_chunked(scene, tables, decay,
                                                      c0, u8))
        ms_f = cuda_ms(lambda: step.step_fwd(scene, tables, decay, c0, u8),
                       5)
        ms_t = cuda_ms(lambda: step.step_fwd_train(scene, tables, decay, c0,
                                                   u8), 5)
        ms_b = cuda_ms(lambda: step.step_bwd(scene, tables, decay, c0, u8,
                                             res0, hit0, ct1), 5)
        del res0
        sample = step_sample(scene, tables, decay, carries, u8s, gen)
        bw = sample["bounds"][0]
        log(f"{name} at step 0 ({bw['live_in']} rays, {bw['hits']} hit): "
            f"step_fwd {ms_f:.3f} ms (plain {plain_f:.1f}), bound "
            f"{fmt_bound(bw['step_fwd'])}; step_fwd_train {ms_t:.3f} ms "
            f"(plain {plain_t:.1f}), bound {fmt_bound(bw['step_fwd_train'])}"
            f"; step_bwd {ms_b:.3f} ms (plain {plain_b:.1f}), bound "
            f"{fmt_bound(bw['step_bwd'])}; walks per ray at step 0 "
            f"{per_ray(sample['work'][0], RES * RES)}")
        log_sample(name, step_ms, sample)
        use = resources(scene, tables, name, STEP_KERNELS)
        shape = {"at": "step 0 of the 1080x1080 frame, bounce 8"}
        results[f"step_fwd/{name}"] = {
            "max_abs_err": max(errs_f), "ms": ms_f, "plain_ms": plain_f,
            **bw["step_fwd"], "library_ms": None, **shape,
            "step_ms": step_ms, "sample_ms": sum(step_ms),
            "sample_bound_ms": sample["fwd_bound"], **use["step_fwd"]}
        results[f"step_fwd_train/{name}"] = {
            "max_abs_err": max(errs_f), "ms": ms_t, "plain_ms": plain_t,
            **bw["step_fwd_train"], "library_ms": None, **shape,
            **use["step_fwd_train"]}
        results[f"step_bwd/{name}"] = {
            "max_abs_err": err_b, "ms": ms_b, "plain_ms": plain_b,
            **bw["step_bwd"], "library_ms": None, **shape,
            "step_ms": sample["bwd_ms"], "sample_ms": sum(sample["bwd_ms"]),
            "sample_bound_ms": sample["bwd_bound"], **use["step_bwd"]}
        del carries


def phase_many_lights(results):
    """Past the staged lights (``lights_many``: 2,051 lights, the first
    ``step.STEP_MAX_LIGHTS`` staged in shared memory, the rest read from
    global memory) on 4,096 camera rays (a 64 x 64 frame's worth), bounce
    1 (the plain step walks the lights one at a time: about 12 s a step
    here): the per-step render (``trace_steps``, 2 launches of
    ``step_fwd_many.cu``)
    against the plain per-step trace (phase 4's rule); at step 0 the
    render and train instances of step_fwd against each other and the
    plain step, and step_bwd against autograd of the plain step on 512
    of the rays (phase 18's rules): a training step's kernels."""
    import torch

    from micro_raytracer_tpu_torch.models import schema
    from micro_raytracer_tpu_torch.models.compiler import (compile_camera,
                                                           compile_scene)
    from micro_raytracer_tpu_torch.ops import step

    dev = torch.device("cuda")
    name = "lights_many"
    scene = compile_scene(schema.SceneConfig.from_json(lights_many()), dev)
    tables = step.pack_step(scene)
    if scene.n_lights <= step.STEP_MAX_LIGHTS or \
            step.route(scene, True) != "steps":
        raise AssertionError(f"{name}: {scene.n_lights} lights")
    cam = compile_camera(schema.CameraConfig.from_json(LIGHTS8_CAMERA), dev)
    gen = torch.Generator(device=dev).manual_seed(25)
    n = 64 * 64
    o, d = camera_rays(cam, n, gen, dev)
    oT, dT = o.T.contiguous(), d.T.contiguous()
    K = 2
    u8s = torch.rand((K, step.n_uni(scene.any_refract), n), generator=gen,
                     device=dev)
    decay = 0.85
    before = step.STEP_MANY_KERNEL.launches
    A, B, fl = step.trace_steps(scene, tables, decay, oT, dT, u8s)
    if step.STEP_MANY_KERNEL.launches != before + K:
        raise AssertionError(f"{name}: "
                             f"{step.STEP_MANY_KERNEL.launches - before} "
                             f"launches of step_fwd_many.cu, want {K}")
    cp, carries = step.primary_carry(oT, dT), []
    for k in range(K):
        carries.append(cp)
        cp, hit_p = plain_step_chunked(scene, tables, decay, cp, u8s[k])
        if k == 0:
            fl_p = hit_p
    if not torch.equal(fl, fl_p):
        raise AssertionError(f"{name}: first_live differs from the plain "
                             f"per-step trace")
    bad = outlier_rays(A, cp[8:11], 1e-4, 1e-5) \
        | outlier_rays(B, cp[11:14], 1e-4, 1e-5)
    share = float(bad.float().mean())
    err_in = float(max((A - cp[8:11])[:, ~bad].abs().max(),
                       (B - cp[11:14])[:, ~bad].abs().max()))
    if share > OUTLIER_SHARE or err_in > IN_ERR or \
            float(B.abs().max()) <= 0.0:
        raise AssertionError(f"{name}: the per-step trace disagrees with "
                             f"the plain one ({share}, {err_in})")
    m = 512
    c0, u0 = carries[0][:, :m].contiguous(), u8s[0][:, :m].contiguous()
    e, bad0, _c1, res0, hit0, _ms = compare_step_fwd(name, scene, tables,
                                                     decay, c0, u0, 0)
    err_b, _plain_b, _ct = compare_step_bwd(name, scene, tables, decay, c0,
                                            u0, res0, hit0, bad0, gen)
    errs = [e]
    log(f"{name}: {scene.n_lights} lights ({step.STEP_MAX_LIGHTS} staged), "
        f"{n} rays x {K} steps: the per-step trace matches the "
        f"plain one ({int(bad.sum())} rays outside rtol 1e-4, {err_in:.3g} "
        f"over the rest); step_fwd, step_fwd_train and step_bwd match "
        f"their plain versions")
    results["many_lights"] = {"lights": scene.n_lights, "rays": n,
                              "max_abs_err": max(errs), "bwd_err": err_b}


def phase_step_route(results):
    """Phase 19: the per-step path against the whole trace on the scenes
    the whole trace takes — the slice room, ``mesh_glass``, ``tex_blocks``
    and ``inst_grid`` — on 2^17 camera rays, bounce 8: A, B and first_live
    bit for bit; under a gradient d_oT and d_dT bit for bit (the same
    transposes per ray) and the table cotangents within rtol 1e-5, 1e-6 of
    each table's largest magnitude and ORDER_TOL of the entry's mass (the
    sum of the magnitudes of its sums over chunks of MASS_CHUNK rays, from
    the plain backward): both sum the
    same terms in float32 in another order, and an entry whose terms
    cancel can differ by more than 1e-5 of itself. This holds the
    kRefract, kTri and kTex instances of the step kernels against the
    whole-trace kernels."""
    import torch

    from micro_raytracer_tpu_torch.models.compiler import (compile_camera,
                                                           compile_scene)
    from micro_raytracer_tpu_torch.ops import step

    dev = torch.device("cuda")
    cfgs = {"slice room": slice_config(), "mesh_glass":
            mesh_config("mesh_glass"), "tex_blocks": tex_config("tex_blocks"),
            "inst_grid": inst_config("inst_grid")}
    gen = torch.Generator(device=dev).manual_seed(19)
    out = {}
    for name, cfg in cfgs.items():
        scene = compile_scene(cfg.scene, dev)
        tables = step.pack_step(scene)
        if step.route(scene, True) != "trace":
            raise AssertionError(f"{name} is not on the whole-trace route")
        cam = compile_camera(cfg.frame.cam, dev)
        o, d = camera_rays(cam, N_STEP_CMP, gen, dev)
        oT, dT = o.T.contiguous(), d.T.contiguous()
        u8s = torch.rand((BOUNCE + 1, step.n_uni(scene.any_refract),
                          N_STEP_CMP), generator=gen, device=dev)
        whole = step.trace_packed(scene, tables, 0.85, oT, dT, u8s)
        steps = step.trace_steps(scene, tables, 0.85, oT, dT, u8s)
        for what, a, b in zip(("A", "B", "first_live"), whole, steps):
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: the per-step {what} differs "
                                     f"from the whole trace's on "
                                     f"{int((a != b).any(0).sum())} rays")
        ctA, ctB = (torch.randn((3, N_STEP_CMP), generator=gen, device=dev)
                    for _ in "ab")

        def grads(fn):
            ins = [t.detach().clone().requires_grad_(True)
                   for t in (tables.tab, tables.lights, tables.tri, oT, dT)]
            t = tables._replace(tab=ins[0], lights=ins[1], tri=ins[2])
            A, B, _fl = fn(scene, t, 0.85, ins[3], ins[4], u8s)
            torch.autograd.backward((A, B), (ctA, ctB))
            return [x.grad for x in ins]

        gw, gs = grads(step.trace_packed), grads(step.trace_steps)
        if not (torch.equal(gw[3], gs[3]) and torch.equal(gw[4], gs[4])):
            raise AssertionError(f"{name}: the per-step d_oT / d_dT differ "
                                 f"from the whole trace's")
        # the terms' mass of each table entry, from the plain backward in
        # chunks of MASS_CHUNK rays
        mass = trace_bwd_plain_chunked(scene, tables, 0.85, oT, dT, u8s,
                                       ctA, ctB, MASS_CHUNK)[5:]
        worst = {}
        for tname, a, b, m in zip(("d_tab", "d_lights", "d_tri"), gs[:3],
                                  gw[:3], mass):
            if b is None or not b.numel():
                continue
            tol = (1e-5 * b.abs() + 1e-6 * float(b.abs().max())
                   + ORDER_TOL * m.to(b.dtype))
            r = float(((a - b).abs() / tol).max())
            worst[tname] = r
            if r > 1.0:
                raise AssertionError(f"{name}: the per-step {tname} differs "
                                     f"from the whole trace's ({r:.3g} of "
                                     f"its tolerance)")
        log(f"{name} per-step route on {N_STEP_CMP} rays: A, B, first_live, "
            f"d_oT and d_dT equal the whole trace's bit for bit; table "
            f"cotangents within {worst} of their tolerance")
        out[name] = worst
    # the two routes' kernel time at inst_grid's frame: the primary-hit
    # pass and the whole trace (uncompacted) against the step launches
    cfg = cfgs["inst_grid"]
    scene = compile_scene(cfg.scene, dev)
    tables = step.pack_step(scene)
    oT, dT = main_path_rays(cfg, gen, dev)
    u8s = torch.rand((BOUNCE + 1, step.n_uni(scene.any_refract), RES * RES),
                     generator=gen, device=dev)
    whole_ms = cuda_ms(lambda: step.trace_packed(scene, tables, 0.85, oT,
                                                 dT, u8s), 3)
    steps_ms = cuda_ms(lambda: step.trace_steps(scene, tables, 0.85, oT, dT,
                                                u8s), 3)
    log(f"inst_grid at the frame: the whole trace (closest_hit, trace_fwd) "
        f"{whole_ms:.3f} ms, the per-step path {steps_ms:.3f} ms")
    out["inst_grid_frame_ms"] = {"whole": whole_ms, "steps": steps_ms}
    results["step_route"] = out


def phase_step_main(card, counts):
    """Phases 20-21: the CLI renders ``lights8`` and ``inst_grid3k`` from
    JSON files at 1080x1080, bounce 8, 16 spp through the per-step path
    (counted: BOUNCE + 1 step launches per sample, no whole-trace or
    primary-hit launch, no plain version; renders for the spread, one
    profiled, peak device memory of one render); the HTTP service answers
    one ``lights8`` request."""
    import numpy as np
    import torch
    from PIL import Image

    from micro_raytracer_tpu_torch.ops import hit3, step

    tmp = tempfile.mkdtemp(prefix="chip_smoke_step_")
    out_res = {}
    kernels = (hit3.KERNEL, step.KERNEL, step.STEP_KERNEL)
    for name in STEP_NAMES:
        path = write_json(os.path.join(tmp, f"{name}.json"), step_json(name))
        out = os.path.join(tmp, f"{name}.png")
        for k in kernels:
            k.launches = 0
            k.plain_calls = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        render_s, wall = render_cli(out, [path])
        peak = torch.cuda.max_memory_allocated()
        launched = {k.name: k.launches for k in kernels}
        counts[name] = launched
        want = {hit3.KERNEL.name: 0, step.KERNEL.name: 0,
                step.STEP_KERNEL.name: SAMPLES * (BOUNCE + 1)}
        if launched != want or any(k.plain_calls for k in kernels):
            raise AssertionError(f"{name} render: launches {launched} (want "
                                 f"{want}), plain calls "
                                 f"{[k.plain_calls for k in kernels]}")
        img = np.asarray(Image.open(out))
        if img.shape != (RES, RES, 3) or float(img.std()) < 5.0:
            raise AssertionError(f"{name}: image {img.shape}, std "
                                 f"{float(img.std()):.2f}")
        loops = [render_s] + [render_cli(out, [path])[0]
                              for _ in range(STEP_RENDER_REPS - 1)]
        spread = render_spread(loops, card)
        ((loop_p, _w), wall_p, busy, n_ops, by_name) = _busy_share(
            lambda: render_cli(out, [path]))
        med = float(np.median(loops))
        log(f"{name} render: {launched[step.STEP_KERNEL.name] / SAMPLES:.0f} "
            f"step_fwd and {launched[step.KERNEL.name] / SAMPLES:.0f} "
            f"trace_fwd launches per sample; peak device memory "
            f"{peak / 2**30:.3f} GiB; profile: the CLI's wall {wall_p:.4f} s "
            f"(render loop {loop_p:.4f} s under the profiler), device busy "
            f"{busy:.4f} s = {busy / med:.3f} of the unprofiled loop's "
            f"median {med:.4f} s; {n_ops} device operations "
            f"({n_ops / SAMPLES:.1f} per sample)")
        for kname, t in sorted(by_name.items(), key=lambda x: -x[1])[:4]:
            log(f"  {t * 1e3:9.3f} ms  {kname[:90]}")
        out_res[name] = {"render_s": render_s, "wall_s": wall,
                         "spread": spread, "busy_s": busy,
                         "busy_share": busy / med,
                         "ops_per_sample": n_ops / SAMPLES,
                         "step_fwd_per_sample":
                             launched[step.STEP_KERNEL.name] / SAMPLES,
                         "trace_fwd_per_sample":
                             launched[step.KERNEL.name] / SAMPLES,
                         "peak_bytes": peak}
    phase_server(step_config("lights8"), requests=1)
    return out_res


# --- meshes past the staged cull blocks (phases 22-24) -----------------------

def big_config(name):
    """``mesh_big`` / ``mesh_big_glass``: the slice room at BIG_SCALE times
    its size (every position, size, radius and the camera scaled; light
    power is unchanged, as the direct light has no falloff) with its glass
    sphere replaced by the torus at BIG_TORUS quads, 65,536 triangles
    (pallas_tri.MAX_PRIMS) in 1,024 cull blocks, diffuse or glass
    (MESH_MATS); ``mesh_big_mixed``: the diffuse torus, and the metal
    sphere made of the glass sphere's material. The reference's |det| >=
    E = 1e-4 window rejects a triangle whose edge cross product is shorter
    than 1e-4 from every direction: 65,536 triangles on the room-sized
    torus are 1.6e-5, so the room is scaled until they are 7e-4 to
    1.6e-3."""
    from micro_raytracer_tpu_torch.frontends import cli
    from micro_raytracer_tpu_torch.models import schema

    k = BIG_SCALE

    def scaled(x):
        return [float(v) * k for v in x]

    cfg = cli.parse_render(cli.build_parser().parse_args(SLICE_ARGS)).to_json()
    objs, glass = [], None
    for o in cfg["scene"]["renderer"]:
        if o["type"] == "sphere" and o["mat"]["glass"] > 0:
            glass = o["mat"]
            continue
        o = dict(o, inst=[[scaled(p), q] for p, q in o["inst"]])
        if "sizes" in o:
            o["sizes"] = scaled(o["sizes"])
        if "r" in o:
            o["r"] = float(o["r"]) * k
        objs.append(o)
    if len(objs) != len(cfg["scene"]["renderer"]) - 1:
        raise AssertionError("the slice scene's glass sphere is missing")
    if name == "mesh_big_mixed":
        objs = [dict(o, mat=glass) if o["type"] == "sphere" else o
                for o in objs]
    objs.append({"type": "mesh", "mesh": "torus.obj",
                 "pos": scaled(TORUS_POS), "mat": MESH_MATS[
                     "mesh_glass" if name == "mesh_big_glass"
                     else "mesh_opaque"]})
    cfg["scene"]["renderer"] = objs
    cfg["scene"]["light"] = [dict(lt, pos=scaled(lt["pos"]))
                             if "pos" in lt else lt
                             for lt in cfg["scene"]["light"]]
    cfg["frame"]["cam"] = dict(cfg["frame"]["cam"],
                               pos=scaled(cfg["frame"]["cam"]["pos"]))
    return cfg


def big_torus():
    """The (65,536, 3, 3) vertices of the big scenes' torus."""
    return torus(*BIG_TORUS, R=0.16 * BIG_SCALE, r=0.06 * BIG_SCALE)


def write_big(name, tmp):
    """The scene JSON of ``name`` and its mesh as the OBJ file beside it
    (the JSON names it by its path); returns the JSON's path."""
    obj = os.path.join(tmp, "torus.obj")
    if not os.path.exists(obj):
        tris = big_torus().reshape(-1, 3)
        with open(obj, "w") as f:
            f.write("".join(f"v {x:.7g} {y:.7g} {z:.7g}\n"
                            for x, y, z in tris))
            f.write("".join(f"f {3 * i + 1} {3 * i + 2} {3 * i + 3}\n"
                            for i in range(len(tris) // 3)))
    cfg = big_config(name)
    cfg["scene"]["renderer"][-1]["mesh"] = obj
    path = os.path.join(tmp, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def big_render_config(name, tmp):
    """The render config of ``name`` from its JSON file, timed: (cfg, the
    host seconds of reading it, OBJ included, and of compiling its
    scene)."""
    from micro_raytracer_tpu_torch.models.compiler import compile_scene
    from micro_raytracer_tpu_torch.models import schema

    path = write_big(name, tmp)
    t0 = time.perf_counter()
    with open(path) as f:
        cfg = schema.RenderConfig.from_json(json.load(f))
    t1 = time.perf_counter()
    compile_scene(cfg.scene, "cpu")
    t2 = time.perf_counter()
    return cfg, t1 - t0, t2 - t1


def big_inputs(cfg, dev):
    """(scene, tables, decay, cam) of a big scene on the card, checked:
    65,536 triangles in 1,024 cull blocks, on the per-step path."""
    from micro_raytracer_tpu_torch.models import tracer
    from micro_raytracer_tpu_torch.models.compiler import (compile_camera,
                                                           compile_scene)
    from micro_raytracer_tpu_torch.ops import step

    scene = compile_scene(cfg.scene, dev)
    tables = step.pack_step(scene)
    n_tri = tables.layout[2]
    if (n_tri, tables.tbb.shape[0]) != (65536, 1024) \
            or not step.tri_split(n_tri) \
            or (step.route(scene, False), step.route(scene, True)) \
            != ("steps", "steps"):
        raise AssertionError(f"big scene: {n_tri} triangles, "
                             f"{tables.tbb.shape[0]} blocks, not split")
    return (scene, tables, tracer.decay_of(cfg.rt.loss),
            compile_camera(cfg.frame.cam, dev))


def compare_tri(tables, o, d, live=None):
    """Rows 6, 7 (also with half the rows marked to refract, as the step
    passes them) and 8 (tri_entry, tri_entry_exit, tri_group_exit fed row
    6's winner groups) against their plain versions on rays ``o``, ``d``
    (R, 3): rows and t bit for bit; row 7's entry equal to row 6's; row 7's
    culled exit equal to row 8's unculled one wherever a triangle wins,
    but on phantom exits (``check_phantoms``). Returns (hits, the plain
    versions' ms, the phantom exits)."""
    import torch

    from micro_raytracer_tpu_torch.ops import hit3, tri

    t, tbb, n = tables.tri.detach(), tables.tbb, tables.layout[3]
    tsb = tables.tsb
    got, want, ms = {}, {}, {}
    got["entry"] = tri.tri_entry(t, o, d, tbb, n, live, tsb=tsb)
    box = []
    ms["entry"] = plain_ms(lambda: box.append(tri.entry_plain(t, o, d, tbb, n,
                                                              live)))
    want["entry"] = box.pop()
    got["entry_exit"] = tri.tri_entry_exit(t, o, d, tbb, n, live, tsb=tsb)
    ms["entry_exit"] = plain_ms(lambda: box.append(
        tri.entry_exit_plain(t, o, d, tbb, n, live)))
    want["entry_exit"] = box.pop()
    refr = (torch.rand(t.shape[0], generator=torch.Generator(
        device=o.device).manual_seed(7), device=o.device) < 0.5).float()
    got["refracting"] = tri.tri_entry_exit(t, o, d, tbb, n, live, refr,
                                           tsb=tsb)
    want["refracting"] = tri.entry_exit_plain(t, o, d, tbb, n, live, refr)
    te, row = got["entry"]
    won = te < tri.BIG * 0.5
    wg = torch.where(won, t[row.long(), hit3._T_GID], -5.0).contiguous()
    got["exit"] = tri.tri_group_exit(t, o, d, wg, n, live)
    ms["exit"] = plain_ms(lambda: box.append(
        tri.group_exit_plain(t, o, d, wg, n, live)))
    want["exit"] = box.pop()
    for what in got:
        for g, w in zip(got[what], want[what]):
            if not torch.equal(g, w):
                raise AssertionError(f"tri {what}: differs from the plain "
                                     f"version on {int((g != w).sum())} rays")
    ee, gx = got["entry_exit"], got["exit"]
    if not (torch.equal(ee[0], te) and torch.equal(ee[1], row)):
        raise AssertionError("tri_entry_exit's entry differs from tri_entry")
    phantoms = check_phantoms(tables, o[won], d[won],
                              (ee[2][won], ee[3][won]),
                              (gx[0][won], gx[1][won]), "2^17 rays")
    hits = int(won.sum())
    log(f"tri kernels on {o.shape[0]} rays ({hits} hit the mesh): rows 6, 7 "
        f"and 8 equal their plain versions bit for bit, row 7's entry row "
        f"6; row 7's culled exit row 8's unculled one but on {phantoms} "
        f"phantom exits (plain "
        f"{ {k: round(v, 1) for k, v in ms.items()} } ms)")
    return hits, ms, phantoms


def check_phantoms(tables, o, d, culled, full, where):
    """Row 7's culled group exit ``culled`` (tx, xrow) against row 8's
    unculled ``full`` on the rays ``o``, ``d`` whose entry won: every ray
    where they differ must be a phantom exit (its unculled exit hit point
    outside its block's slacked AABB, ``tri.culled_exit_phantoms``), and
    the phantoms at most PHANTOM_SHARE of those rays. Returns their
    count."""
    from micro_raytracer_tpu_torch.ops import tri

    differs, phantom = tri.culled_exit_phantoms(tables.tbb, o, d, culled,
                                                full)
    n_diff, n_ph = int(differs.sum()), int(phantom.sum())
    if n_diff != n_ph or n_ph > PHANTOM_SHARE * max(o.shape[0], 1):
        raise AssertionError(
            f"row 7's culled exit differs from row 8's on {n_diff} of "
            f"{o.shape[0]} rays ({where}), {n_ph} of them phantom exits "
            f"(cap {PHANTOM_SHARE} of the rays)")
    return n_ph


def _slabs(boxes, o, invd):
    """``(tmin, tmax)`` ``(m, k)`` of rays ``o`` (m, 3) against ``k``
    AABBs ``boxes`` (k, 8): ``hit3._slab``'s operations, broadcast."""
    import torch

    tmin = tmax = None
    for k in range(3):
        t1 = (boxes[None, :, k] - o[:, None, k]) * invd[:, None, k]
        t2 = (boxes[None, :, 3 + k] - o[:, None, k]) * invd[:, None, k]
        near, far = torch.minimum(t1, t2), torch.maximum(t1, t2)
        tmin = near if tmin is None else torch.maximum(tmin, near)
        tmax = far if tmax is None else torch.minimum(tmax, far)
    return tmin, tmax


def _pair_blocks(t, n, o, d, ray, blk, wg=None):
    """For (ray, block) pairs: the block's smallest valid t (BIG where
    none), or with the group ids ``wg`` (per ray) its largest t over rows
    of the ray's group (-BIG where none), by ``hit3._tri_block``'s
    operations on each pair's rows."""
    import torch

    from micro_raytracer_tpu_torch.ops import hit3

    out = []
    for a in range(0, ray.shape[0], 1 << 15):
        r, b = ray[a:a + (1 << 15)], blk[a:a + (1 << 15)]
        idx = b[:, None] * hit3.CB + torch.arange(hit3.CB, device=b.device)
        rows = t[idx.clamp(max=n - 1)]                     # (P, CB, 16)
        g = [rows[..., k] for k in range(9)]
        h = [rows[..., hit3._T_H + k] for k in range(3)]
        oc = [o[r][:, None, k] for k in range(3)]
        dc = [d[r][:, None, k] for k in range(3)]

        def prod(k, v):
            return g[3 * k] * v[0] + g[3 * k + 1] * v[1] + g[3 * k + 2] * v[2]

        oxt, oyt, ozt = (prod(k, oc) + h[k] for k in range(3))
        dxt, dyt, dzt = (prod(k, dc) for k in range(3))
        ok = torch.abs(dzt) >= rows[..., hit3._T_THR]
        tt = -ozt / torch.where(ok, dzt, 1.0)
        u = oxt + tt * dxt
        v = oyt + tt * dyt
        ok = ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) \
            & (tt >= 0.0) & (idx < n)
        if wg is None:
            out.append(torch.where(ok, tt, hit3.BIG).amin(1))
        else:
            ok = ok & (rows[..., hit3._T_GID] == wg[r][:, None])
            out.append(torch.where(ok, tt, -hit3.BIG).amax(1))
    return torch.cat(out) if out else torch.zeros(0, device=ray.device)


def tri_work(tables, o, d, refr=None):
    """Per ray (R,) float64, the work of rows 6 / 7 on rays ``o``, ``d``
    by the two-level walk of ``csrc/tri.cu`` (``tri_walk``), simulated in
    its order: ``sup`` superblock tests (a staged run of 64's bound, then
    its superblocks into the mask, a set bit again), ``blocks`` block slab
    tests (a passing superblock's blocks into the mask, a set bit again),
    ``rows`` the entry rows swept, and for the winners on ``refr``'s rows
    (None: every row; no exit where ``refr`` is False) the culled group
    exit's ``exit_sup``, ``exit_blocks`` and ``exit_rows``; beside them the
    one-level walk's ``slabs_one_level`` (every block) and
    ``exit_rows_unculled`` (the winner group's rows). The slab intervals of
    every ray and box are taken at once, and each block's best t for the
    rays that meet it at all; the walk then steps through the blocks in
    order."""
    import torch

    from micro_raytracer_tpu_torch.ops import hit3, tri

    t, tbb, tsb, n = (tables.tri.detach(), tables.tbb, tables.tsb,
                      tables.layout[3])
    R, dev, BIG, f64 = o.shape[0], o.device, hit3.BIG, torch.float64
    SB, CB, nb = tri.SUPER, hit3.CB, -(-n // hit3.CB)
    n_sup = -(-nb // SB)
    staged = min(n_sup, 256)       # tri.cu kSupStaged
    chunks = torch.stack([torch.cat([tsb[c:c + 64, :3].amin(0),
                                     tsb[c:c + 64, 3:6].amax(0)])
                          for c in range(0, n_sup, 64)])
    bnum = torch.arange(nb, device=dev)

    def walk(o, d, leave, b_lo, b_hi, wg=None, gs=None, ge=None):
        """The walk of rays ``o``, ``d`` over blocks [b_lo, b_hi) (per
        ray): (superblock tests, block tests, rows swept)."""
        m = o.shape[0]
        invd = hit3._inv_dir(d)
        sup = torch.zeros(m, dtype=f64, device=dev)
        blk = torch.zeros_like(sup)
        rows = torch.zeros_like(sup)
        best = torch.full((m,), -BIG if leave else BIG, device=dev)

        def test(tmin, tmax, bst):
            bst = bst if tmin.dim() == 1 else bst[:, None]
            near = tmax >= torch.maximum(tmin, torch.zeros_like(tmin))
            return near & ((tmax >= bst) if leave else (tmin <= bst))

        inb = (bnum[None] >= b_lo[:, None]) & (bnum[None] < b_hi[:, None])
        bt = _slabs(tbb[:nb], o, invd)
        st = _slabs(tsb, o, invd)
        ct = _slabs(chunks, o, invd)
        # each block's best t for the rays that meet it at all
        ray, bk = torch.nonzero(test(*bt, best) & inb, as_tuple=True)
        res = torch.full((m, nb), -BIG if leave else BIG, device=dev)
        res[ray, bk] = _pair_blocks(t, n, o, d, ray, bk, wg)
        lo_r = torch.clamp(bnum * CB, max=n)
        hi_r = torch.clamp(bnum * CB + CB, max=n)
        if gs is not None:
            lo_r = torch.maximum(lo_r[None], gs[:, None])
            hi_r = torch.minimum(hi_r[None], ge[:, None])
        cnt = torch.clamp(hi_r - lo_r, min=0).to(f64)
        cnt = cnt.expand(m, nb) if cnt.dim() == 2 else cnt[None].expand(m, nb)
        s_lo, s_hi = b_lo // SB, (b_hi - 1) // SB + 1
        for c in range(0, n_sup, 64):
            span = torch.arange(c, min(c + 64, n_sup), device=dev)
            ins = (span[None] >= s_lo[:, None]) & (span[None] < s_hi[:, None])
            if c + 64 <= staged or staged == n_sup:
                # the run's bound (tri.cu chunk_bounds), tested first
                any_in = ins.any(1)
                sup += any_in.double()
                ok = test(ct[0][:, c // 64], ct[1][:, c // 64], best)
                ins = ins & (ok & any_in)[:, None]
            mask = test(st[0][:, span], st[1][:, span], best) & ins
            sup += ins.sum(1).double()
            for j, s in enumerate(range(c, c + span.numel())):
                sup += mask[:, j].double()
                s_ok = mask[:, j] & test(st[0][:, s], st[1][:, s], best)
                b0, b1 = s * SB, min((s + 1) * SB, nb)
                b_in = s_ok[:, None] & inb[:, b0:b1]
                blk += b_in.sum(1).double()
                bmask = test(bt[0][:, b0:b1], bt[1][:, b0:b1], best) & b_in
                for k, b in enumerate(range(b0, b1)):
                    blk += bmask[:, k].double()
                    touch = bmask[:, k] & test(bt[0][:, b], bt[1][:, b], best)
                    rows += torch.where(touch, cnt[:, b], 0.0)
                    best = torch.where(touch, (torch.maximum if leave else
                                               torch.minimum)(best,
                                                              res[:, b]),
                                       best)
        return sup, blk, rows

    zero = torch.zeros(R, dtype=torch.int64, device=dev)
    work = dict(zip(("sup", "blocks", "rows"),
                    walk(o, d, False, zero, zero + nb)))
    te, row = tri.entry_plain(t, o, d, tbb, n)
    won = te < BIG * 0.5
    if refr is not None:
        won = won & (refr[row.long()] > 0.5)
    w = row.long()
    gs = t[w, hit3._T_GS].long()
    ge = torch.clamp(t[w, hit3._T_GE].long(), max=n)
    for k in ("exit_sup", "exit_blocks", "exit_rows"):
        work[k] = torch.zeros(R, dtype=f64, device=dev)
    # the exit walks the winners only
    wi = torch.nonzero(won).flatten()
    if wi.numel():
        ex = walk(o[wi], d[wi], True, gs[wi] // CB, (ge[wi] - 1) // CB + 1,
                  t[w[wi], hit3._T_GID], gs[wi], ge[wi])
        for k, v in zip(("exit_sup", "exit_blocks", "exit_rows"), ex):
            work[k][wi] = v
    work["slabs_one_level"] = torch.full((R,), float(nb), dtype=f64,
                                         device=dev)
    work["exit_rows_unculled"] = torch.where(won, ge - gs, 0).double()
    return work


def tri_bounds(tables, R, live, work, which="walk", group_exit=False):
    """Bounds of one launch of row 6 or 7 (``group_exit``: row 8) over R
    rays, ``live`` of them live, with ``work`` the summed counts of
    ``tri_work`` (scaled to the R rays): ``which`` "walk" counts the
    two-level walk's superblock and block tests, rows and culled exit rows,
    "one_level" the parent design's work (every block's slab test, the
    rows, the whole group's exit rows)."""
    table_b = tables.tri.numel() * 4 + tables.tbb.numel() * 4
    if group_exit:
        # rays (o, d), live, the group id in; tx, row out
        return bound(R * (24 + 4 + 4 + 8) + table_b,
                     work["exit_rows_unculled"] * TRI_TEST_OPS)
    exit_b = work["exit_rows_unculled"] > 0
    out_b = 16 if exit_b else 8
    if which == "walk":
        slabs = work["sup"] + work["blocks"] + work["exit_sup"] \
            + work["exit_blocks"]
        rows = work["rows"] + work["exit_rows"]
        table_b += tables.tsb.numel() * 4
    else:
        slabs = work["slabs_one_level"]
        rows = work["rows"] + work["exit_rows_unculled"]
    return bound(R * (24 + 4 + out_b) + table_b,
                 live * 3 + slabs * SLAB_OPS + rows * TRI_TEST_OPS)


def phase_big_kernels(results):
    """Phase 22: on ``mesh_big`` and ``mesh_big_glass``, rows 6-8 against
    their plain versions on 2^17 random and 2^17 camera rays (rows and t
    bit for bit); step_fwd and step_fwd_train (the kTriIn instances) and
    step_bwd against the plain step on 2^17 camera rays with phase 18's
    rules, and the per-step trace against the plain per-step trace. Timed
    at the frame: each kernel's launch at step 0 (every ray live) and a
    sample's nine, step_fwd's and step_bwd's beside the sum of their nine
    bounds (:func:`step_sample`). Plain versions run only on the 2^17-ray
    sets."""
    import torch

    from micro_raytracer_tpu_torch.ops import hit3, step, tri

    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_big_")
    for name in BIG_NAMES:
        cfg, t_read, t_compile = big_render_config(name, tmp)
        scene, tables, decay, cam = big_inputs(cfg, dev)
        log(f"{name}: read (OBJ of 65,536 triangles) {t_read:.3f} s, "
            f"compiled on the host {t_compile:.3f} s")
        glass = scene.any_refract
        gen = torch.Generator(device=dev).manual_seed(22)
        o, d = random_rays(N_CMP, gen, dev)
        phantoms = compare_tri(tables, o * BIG_SCALE, d)[2]
        o, d = camera_rays(cam, N_CMP, gen, dev)
        hits, plain_tri, ph = compare_tri(tables, o, d)
        phantoms += ph
        # the step kernels on 2^15 of the camera rays (phase 18's rules)
        oc = o[:N_STEP_CMP].T.contiguous()
        dc = d[:N_STEP_CMP].T.contiguous()
        nu = step.n_uni(glass)
        u = torch.rand((BOUNCE + 1, nu, N_STEP_CMP), generator=gen,
                       device=dev)
        c, carries = step.primary_carry(oc, dc), []
        for k in range(BOUNCE + 1):
            carries.append(c)
            c = step.step_fwd(scene, tables, decay, c, u[k])[0]
        cp = step.primary_carry(oc, dc)
        for k in range(BOUNCE + 1):
            cp, hit_p = plain_step_chunked(scene, tables, decay, cp, u[k])
        bad = outlier_rays(c[8:14], cp[8:14], 1e-4, 1e-5)
        share = float(bad.float().mean())
        err_in = float((c - cp)[8:14][:, ~bad].abs().max())
        log(f"{name} per-step trace {N_STEP_CMP} rays x {BOUNCE + 1} steps: "
            f"{int(bad.sum())} rays outside rtol 1e-4 of the plain per-step "
            f"trace (share {share:.5f}, bound {OUTLIER_SHARE}), {err_in:.3g} "
            f"over the rest (bound {IN_ERR})")
        if share > OUTLIER_SHARE or err_in > IN_ERR:
            raise AssertionError(f"{name}: the per-step trace disagrees with "
                                 f"the plain one")
        del cp
        errs_f = []
        for k in (2, 0):
            e, bad, _c1, res0, hit0, plain_t = compare_step_fwd(
                name, scene, tables, decay, carries[k], u[k], k)
            errs_f.append(e)
        err_b, plain_b, _ct = compare_step_bwd(name, scene, tables, decay,
                                               carries[0], u[0], res0, hit0,
                                               bad, gen)
        plain_f = plain_ms(lambda: plain_step_chunked(scene, tables, decay,
                                                      carries[0], u[0]))
        del carries
        # the frame: the kernels at step 0 and over a sample's nine steps
        oT, dT = main_path_rays(cfg, gen, dev)
        R = oT.shape[1]
        u8s = torch.rand((BOUNCE + 1, nu, R), generator=gen, device=dev)
        cs = [step.primary_carry(oT, dT)]
        for k in range(BOUNCE):
            cs.append(step.step_fwd(scene, tables, decay, cs[-1], u8s[k])[0])
        tri_ms = [cuda_ms(lambda c=c: step.tri_hits(scene, tables, c), 3)
                  for c in cs]
        t, tbb, n = tables.tri.detach(), tables.tbb, tables.layout[3]
        refr = step.tri_refracts(tables)
        # the work at each step, counted on a fixed 2^17 of the frame's
        # rays and scaled to the frame; on the glass torus row 7's culled
        # exit against row 8's unculled one at each step of the frame
        sub = frame_subset(R, dev)
        works, frame_ph, won_rays = [], 0, 0
        for c in cs:
            cs_ = c[:, sub]
            live_s = cs_[step.C_LIVE] > 0.5
            o_s, d_s = cs_[0:3].T[live_s], cs_[3:6].T[live_s]
            w = tri_work(tables, o_s, d_s, refr if glass else refr * 0.0)
            works.append({k: float(v.sum()) * R / N_CMP for k, v in w.items()}
                         | {"live": float(live_s.sum()) * R / N_CMP})
            if glass:
                ee = step.tri_hits(scene, tables, c)
                won = ee[0] < tri.BIG * 0.5
                wg = torch.where(won, t[ee[1].long(), hit3._T_GID],
                                 -5.0).contiguous()
                gx = tri.tri_group_exit(t, c[0:3].T, c[3:6].T, wg, n,
                                        c[step.C_LIVE])
                frame_ph += check_phantoms(
                    tables, c[0:3].T[won], c[3:6].T[won],
                    (ee[2][won], ee[3][won]), (gx[0][won], gx[1][won]),
                    "the frame")
                won_rays += int(won.sum())
        if glass:
            log(f"{name} at the frame: row 7's culled exit equals row 8's "
                f"unculled one at every step but on {frame_ph} phantom "
                f"exits of {won_rays} winning rays")
        step_ms = [step_alone_ms(scene, tables, c, lambda c=c, k=k:
                                 step.step_fwd(scene, tables, decay, c,
                                               u8s[k]))
                   for k, c in enumerate(cs)]
        sample = step_sample(scene, tables, decay, cs, u8s, gen)
        c0 = cs[0]
        del cs
        sweep = "tri_entry_exit" if glass else "tri_entry"
        log(f"{name} at the frame, per step: {sweep} "
            f"{' + '.join(f'{t:.3f}' for t in tri_ms)} = {sum(tri_ms):.3f} "
            f"ms, step_fwd {' + '.join(f'{t:.3f}' for t in step_ms)} = "
            f"{sum(step_ms):.3f} ms a sample")
        c1_t, hit_t, res_t = step.step_fwd_train(scene, tables, decay, c0,
                                                 u8s[0])
        ms_t = step_alone_ms(scene, tables, c0, lambda: step.step_fwd_train(
            scene, tables, decay, c0, u8s[0]))
        ct1 = torch.randn((step.CARRY_ROWS, R), generator=gen, device=dev)
        ms_b = cuda_ms(lambda: step.step_bwd(scene, tables, decay, c0, u8s[0],
                                             res_t, hit_t, ct1), 3)
        th0 = step.tri_hits(scene, tables, c0)
        wg = torch.where(th0[0] < tri.BIG * 0.5,
                         t[th0[1].long(), hit3._T_GID], -5.0).contiguous()
        ms_x = cuda_ms(lambda: tri.tri_group_exit(t, oT.T, dT.T, wg, n), 3)
        # the opaque mesh in a refractive scene (mesh_big_mixed): row 7
        # with no row marked to refract sweeps no group exit
        ms_own = None
        if not glass:
            none = torch.zeros(t.shape[0], device=dev)
            ms_own = cuda_ms(lambda: tri.tri_entry_exit(
                t, c0[0:3].T, c0[3:6].T, tbb, n, c0[step.C_LIVE],
                refr=none, tsb=tables.tsb), 3)
        work = sample["work"][0]
        bw = sample["bounds"][0]
        w0 = works[0]
        b_sweep = tri_bounds(tables, R, R, w0)
        b_old = tri_bounds(tables, R, R, w0, "one_level")
        b_sample = sum(tri_bounds(tables, R, w["live"], w)["bound_ms"]
                       for w in works)
        b_sample_old = sum(tri_bounds(tables, R, w["live"], w,
                                      "one_level")["bound_ms"]
                           for w in works)
        b_exit = tri_bounds(tables, R, R, w0, group_exit=True)
        per_ray = {k: v / R for k, v in w0.items() if k != "live"}
        log(f"{name} at step 0 ({R} rays, {bw['hits']} hit, {hits} of "
            f"{N_CMP} camera rays on the mesh): {sweep} {tri_ms[0]:.3f} ms "
            f"(plain {plain_tri['entry_exit' if glass else 'entry']:.1f} on "
            f"{N_CMP} rays), bound {fmt_bound(b_sweep)} (the one-level "
            f"walk's {fmt_bound(b_old)}); a sample's nine {sum(tri_ms):.3f} "
            f"ms, bound {b_sample:.4f} ms (one-level {b_sample_old:.4f}); "
            f"per ray at step 0 "
            f"{ {k: round(v, 3) for k, v in per_ray.items()} }; "
            f"tri_exit {ms_x:.3f} ms, bound {fmt_bound(b_exit)}; "
            + (f"tri_entry_exit with no refracting row {ms_own:.3f} ms; "
               if ms_own is not None else "")
            + f"step_fwd {step_ms[0]:.3f} ms "
            f"(plain {plain_f:.1f} on {N_CMP} rays), bound "
            f"{fmt_bound(bw['step_fwd'])}; step_fwd_train {ms_t:.3f} ms "
            f"(plain {plain_t:.1f}), bound "
            f"{fmt_bound(bw['step_fwd_train'])}; step_bwd {ms_b:.3f} ms "
            f"(plain {plain_b:.1f}), bound {fmt_bound(bw['step_bwd'])}; "
            f"shadow walk per hit: triangle rows "
            f"{work['shadow'] / max(bw['hits'], 1):.2f}, slab tests "
            f"{work['slabs'] / max(bw['hits'], 1):.2f}")
        log_sample(name, step_ms, sample)
        use = resources(scene, tables, name, STEP_KERNELS)
        shape = {"at": "step 0 of the 1080x1080 frame, bounce 8",
                 "plain_at": f"{N_CMP} camera rays"}
        results[f"{sweep}/{name}"] = {
            "max_abs_err": 0.0, "ms": tri_ms[0],
            "plain_ms": plain_tri["entry_exit" if glass else "entry"],
            **b_sweep, "library_ms": None, **shape, "step_ms": tri_ms,
            "sample_ms": sum(tri_ms), "sample_bound_ms": b_sample,
            "bound_ms_one_level": b_old["bound_ms"],
            "sample_bound_ms_one_level": b_sample_old,
            "per_ray_step0": per_ray, "phantom_exits": phantoms
            + frame_ph}
        if ms_own is not None:
            results[f"{sweep}/{name}"]["entry_exit_no_refract_ms"] = ms_own
        if glass:
            results[f"tri_exit/{name}"] = {
                "max_abs_err": 0.0, "ms": ms_x, "plain_ms": plain_tri["exit"],
                **b_exit, "library_ms": None, **shape}
        results[f"step_fwd/{name}"] = {
            "max_abs_err": max(errs_f), "ms": step_ms[0], "plain_ms": plain_f,
            **bw["step_fwd"], "library_ms": None, **shape,
            "step_ms": step_ms, "sample_ms": sum(step_ms),
            "sample_bound_ms": sample["fwd_bound"], **use["step_fwd"]}
        results[f"step_fwd_train/{name}"] = {
            "max_abs_err": max(errs_f), "ms": ms_t, "plain_ms": plain_t,
            **bw["step_fwd_train"], "library_ms": None, **shape,
            **use["step_fwd_train"]}
        results[f"step_bwd/{name}"] = {
            "max_abs_err": err_b, "ms": ms_b, "plain_ms": plain_b,
            **bw["step_bwd"], "library_ms": None, **shape,
            "step_ms": sample["bwd_ms"], "sample_ms": sum(sample["bwd_ms"]),
            "sample_bound_ms": sample["bwd_bound"], **use["step_bwd"]}


def phase_big_main(card, counts):
    """Phase 23: the CLI renders ``mesh_big`` from its JSON and OBJ files
    at 1080x1080, bounce 8, 16 spp: one tri_entry and one step_fwd launch
    per step and sample, no whole-trace kernel, no plain version; renders
    for the spread (BIG_RENDER_REPS), one profiled; ``mesh_big_glass``
    rendered once (BIG_GLASS_SAMPLES spp, tri_entry_exit counted);
    ``mesh_big_mixed`` rendered once at 16 spp (tri_entry_exit counted,
    sweeping the group exit of no torus row); the HTTP service answers one
    ``mesh_big`` request."""
    import numpy as np
    import torch
    from PIL import Image

    from micro_raytracer_tpu_torch.ops import hit3, step, tri

    tmp = tempfile.mkdtemp(prefix="chip_smoke_big_main_")
    kernels = (hit3.KERNEL, step.KERNEL, step.STEP_KERNEL, tri.ENTRY_KERNEL,
               tri.ENTRY_EXIT_KERNEL, tri.EXIT_KERNEL)
    out_res = {}
    for name in BIG_RENDER_NAMES:
        path = write_big(name, tmp)
        out = os.path.join(tmp, f"{name}.png")
        spp = BIG_GLASS_SAMPLES if name == "mesh_big_glass" else SAMPLES
        for k in kernels:
            k.launches = 0
            k.plain_calls = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        render_s, wall = render_cli(out, [path], samples=spp)
        peak = torch.cuda.max_memory_allocated()
        launched = {k.name: k.launches for k in kernels}
        counts[name] = launched
        sweep = tri.ENTRY_EXIT_KERNEL if name != "mesh_big" \
            else tri.ENTRY_KERNEL
        want = {k.name: 0 for k in kernels}
        want.update({step.STEP_KERNEL.name: spp * (BOUNCE + 1),
                     sweep.name: spp * (BOUNCE + 1)})
        if launched != want or any(k.plain_calls for k in kernels):
            raise AssertionError(f"{name} render: launches {launched} (want "
                                 f"{want}), plain calls "
                                 f"{[k.plain_calls for k in kernels]}")
        img = np.asarray(Image.open(out))
        if img.shape != (RES, RES, 3) or float(img.std()) < 5.0:
            raise AssertionError(f"{name}: image {img.shape}, std "
                                 f"{float(img.std()):.2f}")
        rate = RES * RES * spp / render_s
        log(f"{name} render ({spp} spp): render loop {render_s:.4f} s = "
            f"{rate / 1e6:.3f}M rays/s, the CLI's wall {wall:.3f} s (reading "
            f"the JSON and OBJ, compiling 65,536 triangles, writing the PNG "
            f"included); peak device memory {peak / 2**30:.3f} GiB on {card}")
        res = {"samples": spp, "render_s": render_s, "wall_s": wall,
               "rays_per_s": rate, "peak_bytes": peak}
        if name == "mesh_big":
            loops = [render_s] + [render_cli(out, [path])[0]
                                  for _ in range(BIG_RENDER_REPS - 1)]
            res["spread"] = render_spread(loops, card)
            ((loop_p, _w), wall_p, busy, n_ops, by_name) = _busy_share(
                lambda: render_cli(out, [path]))
            med = float(np.median(loops))
            log(f"{name} render profile: the CLI's wall {wall_p:.4f} s "
                f"(render loop {loop_p:.4f} s under the profiler), device "
                f"busy {busy:.4f} s = {busy / med:.3f} of the unprofiled "
                f"loop's median {med:.4f} s; {n_ops} device operations "
                f"({n_ops / SAMPLES:.1f} per sample)")
            for kname, t in sorted(by_name.items(), key=lambda x: -x[1])[:4]:
                log(f"  {t * 1e3:9.3f} ms  {kname[:90]}")
            res.update({"busy_s": busy, "busy_share": busy / med,
                        "ops_per_sample": n_ops / SAMPLES})
        out_res[name] = res
    with open(write_big("mesh_big", tmp)) as f:
        from micro_raytracer_tpu_torch.models import schema
        phase_server(schema.RenderConfig.from_json(json.load(f)), requests=1)
    return out_res


def phase_big(card, results):
    """Phases 22-24 on ``mesh_big`` and ``mesh_big_glass``: the kernels
    (phase 22), the main path (23) and 3 training steps of ``mesh_big``
    (24, as phase 11 trains mesh_glass: albedos, light power and the
    torus' position perturbed). Returns (render results, render launch
    counts, training launch counts, training results)."""
    from micro_raytracer_tpu_torch.models import schema

    phase_big_kernels(results)
    counts, train_counts = {}, {}
    res = phase_big_main(card, counts)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_big_train_")
    cfg = big_render_config("mesh_big", tmp)[0]
    train = phase_train(cfg, card, train_counts, "mesh_big",
                        moved=schema.KIND_TRIANGLE)
    return res, counts, train_counts, train


def big_entries(results, counts, train_counts):
    """The kernels line's entries of phases 22-24."""
    from micro_raytracer_tpu_torch.ops import step, tri

    tri_src = "micro_raytracer_tpu_torch/csrc/tri.cu"
    step_src = "micro_raytracer_tpu_torch/csrc/step_fwd.cu"
    pt = "micro_raytracer_tpu/ops/pallas_tri.py"
    ps = "micro_raytracer_tpu/ops/pallas_step.py"
    rows = [
        ("tri_entry/mesh_big", tri_src, f"{pt}:207",
         counts["mesh_big"][tri.ENTRY_KERNEL.name]),
        ("tri_entry_exit/mesh_big_glass", tri_src, f"{pt}:226",
         counts["mesh_big_glass"][tri.ENTRY_EXIT_KERNEL.name]),
        ("tri_exit/mesh_big_glass", tri_src, f"{pt}:274",
         counts["mesh_big_glass"][tri.EXIT_KERNEL.name]),
        ("step_fwd/mesh_big", step_src, f"{ps}:1110",
         counts["mesh_big"][step.STEP_KERNEL.name]),
        ("step_fwd/mesh_big_glass", step_src, f"{ps}:1110",
         counts["mesh_big_glass"][step.STEP_KERNEL.name]),
        ("step_fwd_train/mesh_big", step_src, f"{ps}:1110",
         train_counts[step.STEP_TRAIN_KERNEL.name]),
        ("step_bwd/mesh_big", "micro_raytracer_tpu_torch/csrc/step_bwd.cu",
         f"{ps}:3139", train_counts[step.STEP_BWD_KERNEL.name])]
    return [{"name": n, "route": "cuda", "source": src, "replaces": rep_,
             "launches": launches, **results[n]}
            for n, src, rep_, launches in rows]


def step_kernels_alone():
    """``--step-kernels``: phase 18 alone, each scene on its own, so that a
    kernel at fault shows on both (the mutation checks). Returns the number
    of scenes that failed."""
    phase_build()
    failed = 0
    for name in STEP_NAMES:
        try:
            phase_step_kernels({}, (name,))
            log(f"phase 18 on {name}: passed")
        except AssertionError as e:
            failed += 1
            log(f"phase 18 on {name}: FAILED: {e}")
    return failed


def step_bwd_rows_ab(pairs=2, reps=10):
    """``--step-diagnosis``, first part: ``lights8``'s step_bwd at each of
    the nine steps of the frame (the train instance's residuals, random
    output cotangents), its dense rows summed in float64 per block in
    shared memory (the wrapper's choice, ``step._step_shared_rows``) and
    straight into the global float64 sums, interleaved
    (shared, global, global, shared per pair; CUDA-event means of ``reps``
    launches). The two agree: ct0 bit for bit, the tables within rtol 1e-5
    and 1e-6 of the table's largest entry. Returns {mode: [ms per pass,
    each the sum over the nine steps]} and the per-step ms of each mode."""
    import torch

    from micro_raytracer_tpu_torch.ops import step

    dev = torch.device("cuda")
    cfg, scene, tables, decay, _cam = step_inputs("lights8", dev)
    gen = torch.Generator(device=dev).manual_seed(18)
    oT, dT = main_path_rays(cfg, gen, dev)
    u8s = torch.rand((BOUNCE + 1, step.n_uni(scene.any_refract), RES * RES),
                     generator=gen, device=dev)
    c = step.primary_carry(oT, dT)
    launches = []
    for k in range(BOUNCE + 1):
        c1, hit, res = step.step_fwd_train(scene, tables, decay, c, u8s[k])
        ct1 = torch.randn((step.CARRY_ROWS, RES * RES), generator=gen,
                          device=dev)
        launches.append((c, u8s[k], res, hit, ct1))
        c = c1
    rule = step._step_shared_rows
    modes = {"shared": rule, "global": lambda n_dense, L: False}
    if not rule(tables.layout[1], scene.n_lights):
        raise AssertionError("lights8: the step backward's rows are not in "
                             "shared memory")

    def run(mode, fn):
        step._step_shared_rows = modes[mode]
        try:
            return fn()
        finally:
            step._step_shared_rows = rule

    for a in launches:
        s, g = (run(m, lambda: step.step_bwd(scene, tables, decay, *a))
                for m in ("shared", "global"))
        if not torch.equal(s[2], g[2]):
            raise AssertionError("lights8 step_bwd: d_c0 differs between "
                                 "shared and global rows")
        for x, y in ((s[0], g[0]), (s[1], g[1])):
            if not bool(torch.isclose(x, y, rtol=1e-5, atol=1e-6 * float(
                    y.abs().max())).all()):
                raise AssertionError("lights8 step_bwd: the table "
                                     "cotangents differ between shared and "
                                     "global rows")
    sums, per_step = {"shared": [], "global": []}, {}
    for _ in range(pairs):
        for mode in ("shared", "global", "global", "shared"):
            ms = run(mode, lambda: [cuda_ms(
                lambda a=a: step.step_bwd(scene, tables, decay, *a), reps)
                for a in launches])
            sums[mode].append(sum(ms))
            per_step[mode] = ms
    log(f"lights8 step_bwd over the nine steps of a training step, shared "
        f"rows {[f'{t:.3f}' for t in sums['shared']]} ms, global rows "
        f"{[f'{t:.3f}' for t in sums['global']]} ms (interleaved); per step, "
        f"last pass: shared {[f'{t:.3f}' for t in per_step['shared']]}, "
        f"global {[f'{t:.3f}' for t in per_step['global']]}")
    return {"sum_ms": sums, "step_ms": per_step}


def _finite_max(x):
    """(all finite, the largest finite magnitude) of a tensor."""
    import torch

    fin = torch.isfinite(x)
    big = torch.where(fin, x.abs(), torch.zeros_like(x)).max() \
        if x.numel() else x.new_zeros(())
    return bool(fin.all()), float(big)


def inst3k_chaos():
    """``--step-diagnosis``, second part: ``inst_grid3k`` trained on every
    leaf (phase 21 without its two-leaf restriction) for TRAIN_STEPS steps
    or until a leaf's gradient is not finite, every step_bwd launch
    checked: a launch whose outputs are not finite on finite inputs raises.
    For a leaf whose gradient is not finite: its rows and values, and the
    derivative of the packed tables (``step.pack_step``) in that leaf, for
    a cotangent of ones, with no kernel run. Returns the records."""
    import torch

    from micro_raytracer_tpu_torch.ops import step
    from micro_raytracer_tpu_torch.parallel import shard

    dev = torch.device("cuda")
    cfg = step_config("inst_grid3k")
    params, scene, cam, coords, target, gen, _rows = train_setup(cfg)
    ts = shard.make_train_step((RES, RES), BOUNCE, device=dev)
    orig = step.step_bwd
    out = {"steps": []}
    names = ("d_tab", "d_lights", "d_c0", "d_tri")

    def checked(scene_, tables, decay, c0, u8, resid, hit, ct1):
        res = orig(scene_, tables, decay, c0, u8, resid, hit, ct1)
        rec = {"k": BOUNCE - len(launches), "ct1": _finite_max(ct1),
               **{n: _finite_max(x) for n, x in zip(names, res)}}
        launches.append(rec)
        if rec["ct1"][0] and not all(rec[n][0] for n in names):
            raise AssertionError(f"inst_grid3k: step_bwd at bounce step "
                                 f"{rec['k']} is not finite on finite "
                                 f"inputs: {rec}")
        return res

    step.step_bwd = checked
    nonfinite = {}
    try:
        for it in range(TRAIN_STEPS):
            launches = []
            loss, new = ts.step(params, scene, cam, cfg.rt.loss, coords,
                                target, gen)
            torch.cuda.synchronize()
            grads = {k: _finite_max(p.grad) for k, p in params.items()
                     if p.grad is not None}
            moved = {k: float((new[k] - params[k]).detach().abs().max())
                     for k in params}
            out["steps"].append({"loss": float(loss), "grads": grads,
                                 "moved": moved, "launches": launches})
            log(f"inst_grid3k, every leaf, step {it + 1}: loss "
                f"{float(loss):.6g}; gradients (finite, largest) {grads}; "
                f"largest move of each leaf {moved}; step_bwd (bounce "
                f"step: largest ct1, d_c0) "
                f"{[(r['k'], r['ct1'][1], r['d_c0'][1]) for r in launches]}")
            nonfinite = {k: p.grad for k, p in params.items()
                         if p.grad is not None
                         and not bool(torch.isfinite(p.grad).all())}
            if nonfinite:
                break
            params = new
    finally:
        step.step_bwd = orig
    for k, g in nonfinite.items():
        bad_rows = (~torch.isfinite(g)).reshape(g.shape[0], -1).any(1)
        rows = bad_rows.nonzero()[:, 0]
        p = params[k].detach()
        leaf = p.clone().requires_grad_(True)
        tables = step.pack_step(shard.merge_params(scene, {
            **{n: v.detach() for n, v in params.items()}, k: leaf}))
        outs = [t for t in (tables.tab, tables.lights, tables.tri)
                if t.requires_grad]
        jac = torch.autograd.grad(outs, leaf, [torch.ones_like(t)
                                              for t in outs],
                                  allow_unused=True)[0] if outs else None
        jac_bad = torch.zeros_like(bad_rows) if jac is None else \
            (~torch.isfinite(jac)).reshape(g.shape[0], -1).any(1)
        rec = {"leaf": k, "rows": rows[:8].tolist(),
               "values": p[rows[:8]].tolist(),
               "pack_rows": jac_bad.nonzero()[:8, 0].tolist(),
               "same_rows": bool(torch.equal(jac_bad, bad_rows))}
        out.setdefault("nonfinite", []).append(rec)
        log(f"inst_grid3k: the gradient of {k} is not finite on "
            f"{int(bad_rows.sum())} rows {rec['rows']} (values "
            f"{rec['values'][:3]}); the packed tables' derivative in {k}, "
            f"no kernel run, is not finite on {int(jac_bad.sum())} rows, "
            f"the same: {rec['same_rows']}")
    return out


def compaction_ab(card, pairs=5):
    """``--compaction``: the CLI's render loop of ``inst_grid``,
    ``inst_glass``, ``mesh_opaque`` and ``mesh_glass`` (1080x1080, bounce
    8, 16 spp) with the JAX package's compaction cuts (steps 2, 4, 6 on a
    culled sphere grid, 3, 6 on a mesh) and without, in alternating order
    (off, on, on, off, ...) after one warm-up render of each: the median
    and range of rays/s of each side. The cuts are set by replacing
    ``tracer.compact_cuts`` in this process."""
    import numpy as np

    from micro_raytracer_tpu_torch.models import tracer

    rule = tracer.compact_cuts
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ab_")
    out_res = {}
    try:
        for name in ("inst_grid", "inst_glass", "mesh_opaque", "mesh_glass"):
            cfg = inst_json(name) if name.startswith("inst") \
                else mesh_config(name).to_json()
            cuts = [2, 4, 6] if name.startswith("inst") else [3, 6]
            path = write_json(os.path.join(tmp, f"{name}.json"), cfg)
            out = os.path.join(tmp, f"{name}.png")
            loops = {"off": [], "on": []}

            def run(side):
                tracer.compact_cuts = (
                    (lambda scene, steps, inference:
                     [c for c in cuts if c < steps] if inference else [])
                    if side == "on" else
                    (lambda scene, steps, inference: []))
                return render_cli(out, [path])[0]

            run("off")
            run("on")
            for i in range(pairs):
                order = ("off", "on") if i % 2 == 0 else ("on", "off")
                for side in order:
                    loops[side].append(run(side))
            res = {}
            for side, secs in loops.items():
                rate = RES * RES * SAMPLES / np.asarray(secs)
                res[side] = {"median_rays_per_s": float(np.median(rate)),
                             "min_rays_per_s": float(rate.min()),
                             "max_rays_per_s": float(rate.max()),
                             "render_s": secs}
            wins = sum(a < b for a, b in zip(loops["on"], loops["off"]))
            log(f"{name} compaction on {card}: median "
                f"{res['on']['median_rays_per_s'] / 1e6:.2f}M rays/s with, "
                f"{res['off']['median_rays_per_s'] / 1e6:.2f}M without; "
                f"faster with in {wins} of {pairs} pairs")
            out_res[name] = res
    finally:
        tracer.compact_cuts = rule
    return out_res


# the timing gate against another tree (``--gate``): interleaved runs of
# each tree, a kernel's median held to within GATE_TOL of the other's
GATE_RUNS = 7
GATE_TOL = 0.02
# each timing of a kernel spans at least this much device time (ms): a
# timing of a few launches of a short kernel spread 4% over runs of one
# tree
GATE_MS = 25.0


def _segment_launches(scene, tables, decay, oT, dT, u8s, hit0):
    """The trace launches of a render that compacts (tracer.compact_cuts),
    each on the carry and ray ids the render hands it, as one function
    (None where the render is whole)."""
    import torch

    from micro_raytracer_tpu_torch.models import tracer
    from micro_raytracer_tpu_torch.ops import step

    K = u8s.shape[0]
    cuts = tracer.compact_cuts(scene, K, True)
    if not cuts:
        return None
    bounds = [0, *cuts, K]
    segs, carry, rid = [], None, None
    for k0, k1 in zip(bounds[:-1], bounds[1:]):
        seg = step.Segment(k0, k1, carry, rid)
        segs.append((seg, hit0 if k0 == 0 else None))
        carry = step.trace_fwd(scene, tables, decay, oT, dT, u8s,
                               segs[-1][1], seg)[3]
        if k1 < K:
            perm = tracer.compact_perm(carry[step.C_LIVE] > 0.5)
            carry = carry[:, perm]
            rid = (perm if rid is None else rid[perm]).to(torch.int32)

    def run():
        for seg, h0 in segs:
            step.trace_fwd(scene, tables, decay, oT, dT, u8s, h0, seg)

    return run


# --- phase 25: the record path and its differentiable closest hit ----------

REC_HIT_NAMES = ("room", "mesh_glass", "tex_blocks", "inst_grid")
# the route checks of the scenes past the whole-trace bounds: bounce
REC_ROUTE_BOUNCE = 2
REC_RENDER_REPS = 3
# hit3_bwd's timing at the frame: rounds of CUDA-event means of
# REC_BWD_REPS calls (the median reported), then one profiled round
REC_BWD_ROUNDS = 5
REC_BWD_REPS = 20
# the bounces of the record path's frame whose closest-hit inputs hit3_bwd
# is also checked on (rays that start on a surface or inside glass)
REC_BWD_BOUNCES = (1, 3)
REC_PROFILE_SPP = 2
# rays of a hit3_bwd check whose float32 cotangents float64 shows
# ill-conditioned (grazing sphere hits): at most this share (check_hit_bwd)
ILL_BWD_SHARE = 0.05
# a table cotangent's terms from an ill-conditioned ray (check_hit_bwd):
# within this many times the plain float32 version's distance from float64
# on that ray, at the ray's scale
WITNESS_FACTOR = 16.0
GRAD_CHECK_SCENES = ("CornellBox", "dof", "Mesh")
# one transposed winner row of csrc/hit3_bwd.cu (trace_bwd.cuh
# winner_t_bwd): the row's o' and d' (33), the kind's t and its cotangents
# (about 40 for a sphere, the dearest), the transposes through the frame
# (30) and the frame's outer products (36)
HIT_BWD_OPS = 139


def rec_config(name):
    """The render config of a stand-in by name (the room, the mesh,
    textured, Instance-class and per-step stand-ins, ``box_grid``)."""
    from micro_raytracer_tpu_torch.models import schema

    if name == "room":
        return slice_config()
    if name in MESH_NAMES:
        return mesh_config(name)
    if name in TEX_NAMES:
        return tex_config(name)
    if name in INST_NAMES or name in STEP_NAMES:
        return step_config(name) if name in STEP_NAMES \
            else inst_config(name)
    if name == "box_grid":
        return schema.RenderConfig.from_json({
            "scene": box_grid(), "frame": {"res": [RES, RES],
                                           "cam": INST_CAMERA},
            "rt": {"bounce": BOUNCE, "sample": SAMPLES}})
    raise ValueError(name)


def rec_inputs(name, dev):
    """(cfg, scene, tables, cam) of a stand-in on the card."""
    from micro_raytracer_tpu_torch.models.compiler import (compile_camera,
                                                           compile_scene)
    from micro_raytracer_tpu_torch.ops import step

    cfg = rec_config(name)
    scene = compile_scene(cfg.scene, dev)
    return cfg, scene, step.pack_step(scene), compile_camera(cfg.frame.cam,
                                                              dev)


def hit_bwd_args(scene, tables, o, d, gen):
    """The closest hit of rays ``o``, ``d`` in the scene's mode and random
    cotangents of its te and tx (a seeded generator): the VJP's inputs."""
    import torch

    from micro_raytracer_tpu_torch.ops import hit3, step

    mode = step.primary_mode(scene)
    tri = tables.tri if tables.layout[2] else None
    te, row, tx, xrow = hit3.closest_hit(
        tables.tab, tables.layout, o, d, mode, tri, tables.tbb, tables.sbb,
        step._walk(tables), tables.box)
    cts = torch.randn((2, o.shape[0]), generator=gen, device=o.device)
    return (tables.tab, tables.layout, o, d, mode, te, row, tx, xrow,
            cts[0], cts[1], tri)


def hit_bwd_terms(tab, layout, o, d, mode, te, row, tx, xrow, ct_te, ct_tx,
                  tri):
    """The per-ray terms of the plain VJP's table cotangents (the
    arithmetic of ``hit3.closest_hit_bwd_plain``, whose table cotangents
    are their sums): a list of ``("tab" | "tri", rows (R,), terms (R,
    k))``, one for each gather of ``hit3._row_t``, its rows and the
    cotangent of their first k columns from each ray."""
    import torch

    from micro_raytracer_tpu_torch.ops import hit3

    ce, cx = hit3._masked_cts(mode, te, tx, ct_te, ct_tx)
    gathered = []
    with torch.enable_grad():
        tab = tab.detach().requires_grad_(True)
        tri = None if tri is None else tri.detach().requires_grad_(True)
        outs = [hit3._row_t(tab, layout, o, d, row, False, tri, gathered)]
        cts = [ce]
        if mode != hit3.MODE_ENTRY:
            outs.append(hit3._row_t(tab, layout, o, d, xrow, True, tri,
                                    gathered))
            cts.append(cx)
        grads = torch.autograd.grad(outs, [g[2] for g in gathered], cts,
                                    allow_unused=True)
    return [(what, rows, torch.zeros_like(w) if gw is None else gw)
            for (what, rows, w), gw in zip(gathered, grads)]


def input_spread(args, rays, j):
    """The sensitivity of the rays ``rays`` of hit_bwd_args' ``args`` to
    one float32 rounding of their inputs: per component of the plain VJP's
    output ``j`` (2: d_o, 3: d_d), the largest move of the float64 plain
    version when ``o`` or ``d`` is scaled by 1 +- 2^-24. A ray that leaves
    a box face nearly along it takes its slab t as a difference of
    coordinates a rounding apart, divided by a direction component of
    1e-4: its d_d moves by 1e-3 of itself with the last bit of ``o``."""
    import torch

    from micro_raytracer_tpu_torch.ops import hit3

    tab, layout, o, d, mode, te, row, tx, xrow, ce, cx, tri = args

    def plain64(o_, d_):
        sub = [t[rays].double() for t in (te, tx, ce, cx)]
        return hit3.closest_hit_bwd_plain(
            tab.double(), layout, o_, d_, mode, sub[0], row[rays], sub[1],
            xrow[rays], sub[2], sub[3],
            None if tri is None else tri.double())[j]

    o64, d64 = o[rays].double(), d[rays].double()
    ref = plain64(o64, d64)
    moves = [(plain64(o64 * f, d64) - ref).abs() for f in
             (1.0 + 2.0 ** -24, 1.0 - 2.0 ** -24)]
    moves += [(plain64(o64, d64 * f) - ref).abs() for f in
              (1.0 + 2.0 ** -24, 1.0 - 2.0 ** -24)]
    return torch.stack(moves).amax(0)


def check_hit_bwd(name, args):
    """hit3_bwd (``hit3.closest_hit_bwd``) against its plain version
    (``hit3.closest_hit_bwd_plain``, autograd of ``winner_t_plain``) on the
    same inputs: per-ray d_o, d_d within rtol 1e-6 of the plain float32
    version, with a floor of 1e-6 of the array's largest magnitude over
    the rays whose float32 values float64 does not show far off (by more
    than 1e-3 of the ray's largest component: a grazing ray's 1e15 does
    not set the floor). A grazing sphere hit differentiates through
    1/sqrt(disc), so a few rays' float32 cotangents depend on the order of
    their operations: a ray outside the tolerance must be shown
    ill-conditioned, the plain version run in float64 moving its float32
    values by more than the tolerance and the kernel's lying within twice
    that move of them (the rule of the whole-trace backward's check), or
    one float32 rounding of the ray's o or d moving the float64 values by
    more than the tolerance and the kernel's lying within twice that move
    of float64 (:func:`input_spread`: bounced rays that leave a box face
    nearly along it, where the plain float32 version can land closer to
    float64 by chance);
    those and the far rays, at most ILL_BWD_SHARE of the rays, are left
    out of the next check. From a launch where the left-out rays'
    cotangents are 0: the row and triangle-table cotangents (float64 sums
    of float32 terms in the kernel) against the plain version's float32
    per-ray terms summed in float64 (:func:`hit_bwd_terms`),
    each entry within the sum over its rays of the ray's largest term on
    that row times the larger of rtol 1e-5 and WITNESS_FACTOR times the
    ray's float32 noise (the plain float32 version's distance from float64
    on that ray, relative to its scale): a term is a difference of
    products as large as the ray's largest, which two float32 programs
    round differently on an ill-conditioned ray, and a sum's terms of
    either sign cancel, so the limit follows their magnitudes, not the
    sum's. Two launches give the same row cotangents and
    per-ray cotangents bit for bit. Returns each array's largest error
    over its limit on the kept rays (at most 1 passes), the largest
    absolute error and the left-out share."""
    import torch

    from micro_raytracer_tpu_torch.ops import hit3

    k1 = hit3.closest_hit_bwd(*args)
    k2 = hit3.closest_hit_bwd(*args)
    for what, a, b in (("d_tab", k1[0], k2[0]), ("d_o", k1[2], k2[2]),
                       ("d_d", k1[3], k2[3])):
        if not torch.equal(a, b):
            raise AssertionError(f"hit3_bwd/{name}: {what} differs between "
                                 f"two runs")
    tab, layout, o, d, mode, te, row, tx, xrow, ce, cx, tri = args

    def as64(ce, cx):
        return (tab.double(), layout, o.double(), d.double(), mode,
                te.double(), row, tx.double(), xrow, ce.double(),
                cx.double(), None if tri is None else tri.double())

    def plain64(ce, cx):
        return hit3.closest_hit_bwd_plain(*as64(ce, cx))

    def term_sums(terms, ref=None, fn=torch.abs):
        """Per table entry, the float64 sum of ``fn`` of its per-ray terms
        (or of their distances from ``ref``'s)."""
        sums = {"tab": torch.zeros(tab.shape, dtype=torch.float64,
                                   device=tab.device),
                "tri": None if tri is None else torch.zeros(
                    tri.shape, dtype=torch.float64, device=tab.device)}
        for i, (what, rows, t) in enumerate(terms):
            v = t.double() if ref is None else t.double() - ref[i][2]
            sums[what][:, :t.shape[1]].index_add_(0, rows, fn(v))
        return sums["tab"], sums["tri"]

    def off(got, want, rtol, scale=None, top=None):
        """(beyond the limit, error over the limit, error): the limit is
        rtol times ``scale`` (default each value's magnitude plus 1e-6 /
        rtol of ``top``: per ray, the ray's largest component)."""
        got, want = got.double(), want.double()
        if scale is None:
            top = want.abs().amax(1, keepdim=True) if top is None else top
            scale = want.abs() + 1e-6 / rtol * top
        err = (got - want).abs()
        lim = rtol * scale
        return err > lim, err / (lim + 1e-30), err

    p32 = hit3.closest_hit_bwd_plain(*args)
    p64 = plain64(ce, cx)
    # rays whose float32 values float64 shows far off (by more than 1e-3
    # of the ray's largest component) do not set the floor
    far = torch.zeros_like(te, dtype=torch.bool)
    for j in (2, 3):
        w = p64[j].abs()
        far |= off(p32[j], p64[j], 1e-3,
                   w + w.amax(1, keepdim=True))[0].any(1)
    abs_err = 0.0
    ill = far.clone()
    errs = {}
    for what, j in (("d_o", 2), ("d_d", 3)):
        top = float(p32[j][~far].abs().max()) if bool((~far).any()) \
            else 0.0
        bad, rel, err = off(k1[j], p32[j], 1e-6, top=top)
        # outside the tolerance: shown ill-conditioned where the float64
        # plain version moves the float32 one by more than the tolerance
        # and the kernel lies within twice that move of it, or where one
        # float32 rounding of the ray does so (input_spread) and the
        # kernel lies within twice that of float64
        move = (p32[j].double() - p64[j]).abs()
        lim = err / rel.clamp(min=1e-300)
        shown = (move > lim) & (err <= 2.0 * move)
        bad = bad & ~shown
        rays = bad.any(1).nonzero().flatten()
        if rays.numel():
            spread = input_spread(args, rays, j)
            e64 = (k1[j][rays].double() - p64[j][rays]).abs()
            bad[rays] &= ~((spread > lim[rays]) & (e64 <= 2.0 * spread))
        ill |= (rel > 1.0).any(1)
        kept = ~ill
        if bool(kept.any()):
            errs[what] = float(rel[kept].max())
            abs_err = max(abs_err, float(err[kept].max()))
        if bool(bad.any()):
            raise AssertionError(f"hit3_bwd/{name}: {what} outside rtol 1e-6 "
                                 f"on {int(bad.any(1).sum())} rays not shown "
                                 f"ill-conditioned")
    share = float(ill.float().mean())
    errs["ill_share"] = share
    if share > ILL_BWD_SHARE:
        raise AssertionError(f"hit3_bwd/{name}: {share:.4f} of the rays "
                             f"ill-conditioned")
    keep = (~ill).to(ce.dtype)
    args_k = args[:9] + (ce * keep, cx * keep, tri)
    k3 = hit3.closest_hit_bwd(*args_k)
    t64 = hit_bwd_terms(*as64(ce * keep, cx * keep))
    t32 = hit_bwd_terms(*args_k)
    # each ray's float32 noise, relative to its scale: the plain float32
    # version's distance from float64 over its d_o, d_d and row terms
    kap = torch.zeros_like(te, dtype=torch.float64)
    for j in (2, 3):
        w = p64[j].abs().amax(1)
        kap = torch.maximum(kap, (p32[j].double() - p64[j]).abs().amax(1)
                            / (w + 1e-300))
    for (_w, _r, a32), (_w2, _r2, a64) in zip(t32, t64):
        w = a64.abs().amax(1)
        kap = torch.maximum(kap, (a32.double() - a64).abs().amax(1)
                            / (w + 1e-300))
    # the reference: the plain version's float32 terms summed in float64,
    # the kernel's arithmetic (float32 terms, float64 sums); each entry's
    # limit: every ray's largest term on its row times the larger of
    # 1e-5 and WITNESS_FACTOR times the ray's float32 noise (a term is a
    # difference of products as large as the ray's largest term, which two
    # float32 programs round differently where the ray is ill-conditioned)
    ref = term_sums(t32, fn=lambda v: v)
    rel_scale = torch.clamp(kap * WITNESS_FACTOR, min=1e-5)
    lims = term_sums([(w, r, a.abs().amax(1, keepdim=True).expand_as(a)
                       * rel_scale[:, None]) for w, r, a in t64])
    for what, j in (("d_tab", 0), ("d_tri", 1)):
        if ref[j] is None:
            continue
        bad, rel, err = off(k3[j], ref[j], 1.0, lims[j])
        if rel.numel():
            errs[what] = float(rel.max())
            abs_err = max(abs_err, float(err.max()))
        if bool(bad.any()):
            worst = [(divmod(int(i), rel.shape[1]), float(err.flatten()[i]),
                      float(ref[j].flatten()[i]), float(lims[j].flatten()[i]))
                     for i in torch.argsort(rel.flatten(),
                                            descending=True)[:4].tolist()]
            raise AssertionError(f"hit3_bwd/{name}: {what} outside its limit "
                                 f"on {int(bad.sum())} entries; worst ((row, "
                                 f"column), error, value, limit): {worst}")
    if not float(k1[0][:, :16].abs().max()) > 0:
        raise AssertionError(f"hit3_bwd/{name}: no row cotangent")
    hit = te < hit3.BIG * 0.5
    hits, apart = int(hit.sum()), int((hit & (xrow != row)).sum())
    log(f"hit3_bwd/{name}: {o.shape[0]} rays ({hits} hit, {apart} with an "
        f"exit row other than the entry row), matches the "
        f"plain version: largest error over its limit "
        f"{ {k: f'{v:.2e}' for k, v in errs.items()} } ({share:.4f} of the "
        f"rays shown ill-conditioned by float64 and left out); row and "
        f"per-ray cotangents equal across two runs")
    errs["max_abs_err"] = abs_err
    return errs


def hit_bwd_bound(scene, tables, R):
    """The VJP's bound at R rays: each ray's o and d (12 + 12 bytes), its
    t, winner rows and cotangents (8 + 8 + 8: te and tx decide which
    cotangents reach the rows) read and d_o, d_d written (24); a dense
    row's sweep columns read (16 floats) and its cotangents written (26), a
    triangle row's Woop g, h read and their cotangents written (4 + 4); at
    HIT_BWD_OPS a transposed row (one a ray: the room's exit row is its
    entry row)."""
    return bound(R * (12 + 12 + 8 + 8 + 8 + 24)
                 + tables.layout[1] * (16 + 26) * 4
                 + tables.layout[2] * (4 + 4) * 4, R * HIT_BWD_OPS)


def time_hit_bwd(args):
    """hit3_bwd's wrapper (``hit3.closest_hit_bwd``) on ``args`` split into
    host and device time (:func:`wrapper_split` over REC_BWD_REPS calls;
    the kernel time is csrc/hit3_bwd.cu's kernels')."""
    from micro_raytracer_tpu_torch.ops import hit3

    # finish_kernel: the second kernel of a tree before the last-block
    # finish
    return wrapper_split(lambda: hit3.closest_hit_bwd(*args), REC_BWD_REPS,
                         ("hit3_bwd", "finish_kernel"))


SPLIT_NAMES = ("room", "tex_dof")


def hit_split_only(card):
    """``--hit-split [tree]``: the closest hit's and its VJP's wrappers
    split into host and device time (:func:`wrapper_split`) at the frame,
    without the other phases: ``step.primary_hits`` on the room and
    ``tex_dof``, ``hit3.closest_hit_bwd`` on the room's and
    ``mesh_glass``'s primaries (the latter the triangle instance), with
    the registers of csrc/hit3.cu's and csrc/hit3_bwd.cu's kernels."""
    import torch

    from micro_raytracer_tpu_torch.ops import hit3, step
    from micro_raytracer_tpu_torch.utils.kernels import ptxas_table

    for k in (hit3.KERNEL, hit3.BWD_KERNEL):
        k.fn()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    out = {}
    for name in SPLIT_NAMES + ("mesh_glass",):
        cfg, scene, tables, _cam = rec_inputs(name, dev)
        oT, dT = main_path_rays(cfg, gen, dev)
        if name in SPLIT_NAMES:
            t = wrapper_split(lambda: step.primary_hits(scene, tables, oT,
                                                        dT),
                              REC_BWD_REPS, ("closest_hit",))
            out[f"closest_hit/{name}"] = t
            log(f"closest_hit/{name}: {fmt_split(t)}")
        if name != "tex_dof":
            t = time_hit_bwd(hit_bwd_args(scene, tables, oT.T, dT.T, gen))
            out[f"hit3_bwd/{name}"] = t
            log(f"hit3_bwd/{name}: {fmt_split(t)}")
        if hasattr(hit3, "resident_warps"):
            # warps per SM of the dense schedule and of the VJP's instance
            # at this scene's rows (a parent tree may have no query)
            P, tri = tables.layout[1], bool(tables.layout[2])
            out[f"warps/{name}"] = {
                "closest_hit": None if tri else hit3.resident_warps(P),
                "hit3_bwd": hit3.resident_warps(P, True, tri)}
            log(f"{name}: warps per SM {json.dumps(out[f'warps/{name}'])}")
    for k in (hit3.KERNEL, hit3.BWD_KERNEL):
        out[f"registers/{k.name}"] = ptxas_table(k.build_log)
    log(f"on {card}")
    return out


def check_new_hit_paths(dev, gen):
    """The closest hit's two instances past the staged rows against the
    plain sweep at the frame, every mode, rows equal and t bit for bit:
    the kWalk instance with a 64-bit block mask on ``inst_grid3k`` (3,384
    rows, 53 blocks) and the kGlobal instance on ``box_grid`` (2,116
    boxes)."""
    out = {}
    for name in ("inst_grid3k", "box_grid"):
        cfg, scene, tables, _cam = rec_inputs(name, dev)
        if tables.layout[1] <= 2048:
            raise AssertionError(f"{name}: {tables.layout[1]} dense rows")
        walked = tables.sbb is not None
        if walked != (name == "inst_grid3k"):
            raise AssertionError(f"{name}: sphere walk {walked}")
        oT, dT = main_path_rays(cfg, gen, dev)
        compare_hit(tables, oT.T, dT.T, exact=True)
        log(f"{name}: the {'kWalk (64 blocks)' if walked else 'kGlobal'} "
            f"closest hit, {tables.layout[1]} dense rows, equals the plain "
            f"sweep at the frame")
        out[name] = tables.layout[1]
    return out


def record_vs_fused(name, dev, gen, bounce, bwd_bounces=(), errs=None):
    """One sample of the record path against the fused path on the same
    uniforms at the frame: radiance within rtol 1e-3 / atol 1e-4 on all
    but 0.5% of the pixels. At each bounce of ``bwd_bounces`` also
    hit3_bwd against its plain version (check_hit_bwd) on the rays the
    record path's closest hit took there, with random cotangents; their
    errors go into ``errs``. Returns the outlier share."""
    import torch

    from micro_raytracer_tpu_torch.models import tracer

    import numpy as np

    from micro_raytracer_tpu_torch.models.render import morton_ray_order

    cfg, scene, tables, cam = rec_inputs(name, dev)
    ys, xs = divmod(morton_ray_order(RES, RES), RES)
    coords = torch.from_numpy(np.stack([xs, ys], -1)).to(dev, torch.float32)
    u_aprt, u8s = tracer.draw_uniforms(gen, coords.shape[0], bounce,
                                       scene.any_refract, dev)
    rays = []
    hits = tracer._hits

    def seen(scene, tables, o, d):
        rays.append((o, d))
        return hits(scene, tables, o, d)

    tracer._hits = seen
    try:
        with torch.no_grad():
            rad = {f: tracer.trace_radiance_u(scene, cam, (RES, RES), bounce,
                                              cfg.rt.loss, coords, u_aprt,
                                              u8s, tables, fused=f)
                   for f in (True, False)}
    finally:
        tracer._hits = hits
    if not bool(torch.isfinite(rad[False]).all()):
        raise AssertionError(f"record path/{name}: radiance not finite")
    if len(rays) != bounce + 1:
        raise AssertionError(f"record path/{name}: {len(rays)} closest "
                             f"hits for bounce {bounce}")
    for k in bwd_bounces:
        errs[f"{name}@{k}"] = check_hit_bwd(
            f"{name} bounce {k}", hit_bwd_args(scene, tables, *rays[k], gen))
    del rays
    bad = outlier_rays(rad[False].T, rad[True].T, 1e-3, 1e-4)
    share = float(bad.float().mean())
    if share > 0.005:
        raise AssertionError(f"record path/{name}: {int(bad.sum())} pixels "
                             f"off the fused path")
    log(f"record path/{name}: one sample at {RES}x{RES}, bounce {bounce}: "
        f"{share:.5f} of the pixels outside rtol 1e-3 / atol 1e-4 of the "
        f"fused path")
    return share


def record_cli(card):
    """The CLI renders the room with MRT_NO_FUSE=1 at 16 spp: launches
    per sample (hit3 and hit3_bwd, no whole-trace kernel, no plain
    version), REC_RENDER_REPS renders for the median rays/s, one profiled
    for the device's busy share."""
    import numpy as np

    from micro_raytracer_tpu_torch.ops import hit3, step

    kernels = (hit3.KERNEL, hit3.BWD_KERNEL, step.KERNEL, step.TRAIN_KERNEL,
               step.STEP_KERNEL)
    for k in kernels:
        k.launches = 0
        k.plain_calls = 0
    out = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_"), "rec.png")
    os.environ["MRT_NO_FUSE"] = "1"
    try:
        secs = [render_cli(out)[0]]
        launched = {k.name: k.launches for k in kernels}
        plain = {k.name: k.plain_calls for k in kernels if k.plain_calls}
        if plain or launched[step.KERNEL.name] \
                or launched[step.STEP_KERNEL.name] \
                or launched[hit3.KERNEL.name] < SAMPLES * (BOUNCE + 1):
            raise AssertionError(f"record path CLI: launches {launched}, "
                                 f"plain calls {plain}")
        secs += [render_cli(out)[0] for _ in range(REC_RENDER_REPS - 1)]
        # profiled at REC_PROFILE_SPP (the profiler's events of 16 samples
        # take tens of seconds to read back)
        _o, wall, busy, n_ops, _n = _busy_share(
            lambda: render_cli(out, samples=REC_PROFILE_SPP))
    finally:
        del os.environ["MRT_NO_FUSE"]
    rate = RES * RES * SAMPLES / np.asarray(secs)
    med = float(np.median(rate))
    per_sample = launched[hit3.KERNEL.name] / SAMPLES
    log(f"record path CLI (MRT_NO_FUSE=1), room {RES}x{RES} x {SAMPLES} "
        f"spp, bounce {BOUNCE}: median {med / 1e6:.2f}M rays/s over "
        f"{len(secs)} renders (seconds {[f'{x:.3f}' for x in secs]}); "
        f"{per_sample:.1f} closest-hit launches a sample; profiled render "
        f"({REC_PROFILE_SPP} spp) wall {wall:.3f} s, device busy {busy:.3f} "
        f"s = {busy / wall:.3f}, {n_ops / REC_PROFILE_SPP:.0f} device "
        f"operations a sample, on {card}")
    return {"median_rays_per_s": med, "render_s": secs,
            "hit3_launches_per_sample": per_sample,
            "busy_share": busy / wall,
            "ops_per_sample": n_ops / REC_PROFILE_SPP}


def record_train(card):
    """One room training step on the record path (MRT_NO_FUSE=1) at the
    frame, 1 path a pixel, with and without ``remat``: seconds of the
    second step, peak memory, the VJP's launches a step (one a bounce)."""
    import torch

    from micro_raytracer_tpu_torch.ops import hit3, step
    from micro_raytracer_tpu_torch.parallel import shard

    dev = torch.device("cuda")
    cfg = slice_config()
    params, scene, cam, coords, target, gen, _rows = train_setup(cfg)
    out = {}
    os.environ["MRT_NO_FUSE"] = "1"
    try:
        for remat in (False, True):
            ts = shard.make_train_step((RES, RES), BOUNCE, device=dev,
                                       remat=remat)
            p = {k: v.detach().clone().requires_grad_(True)
                 for k, v in params.items()}
            ts.step(p, scene, cam, cfg.rt.loss, coords, target, gen)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for k in (hit3.KERNEL, hit3.BWD_KERNEL, step.TRAIN_KERNEL):
                k.launches = 0
            t0 = time.perf_counter()
            loss, _new = ts.step(p, scene, cam, cfg.rt.loss, coords, target,
                                 gen)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            bwd = hit3.BWD_KERNEL.launches
            if bwd != BOUNCE + 1 or step.TRAIN_KERNEL.launches \
                    or not bool(torch.isfinite(loss)):
                raise AssertionError(f"record path training: {bwd} hit3_bwd "
                                     f"launches, loss {float(loss)}")
            for k, v in p.items():
                if v.grad is None or not bool(torch.isfinite(v.grad).all()):
                    raise AssertionError(f"record path training: gradient "
                                         f"of {k}")
            out["remat" if remat else "plain"] = {
                "step_s": sec, "peak_bytes": peak,
                "fwd_bwd_rays_per_s": RES * RES / sec,
                "hit3_bwd_launches": bwd,
                "hit3_launches": hit3.KERNEL.launches}
            log(f"record path training (remat {remat}): {sec:.4f} s a step "
                f"= {RES * RES / sec / 1e6:.3f}M fwd+bwd rays/s, peak "
                f"{peak / 2**30:.3f} GiB, launches hit3 "
                f"{hit3.KERNEL.launches}, hit3_bwd {bwd}, on {card}")
    finally:
        del os.environ["MRT_NO_FUSE"]
    return out


def run_grad_check(scene):
    """tools/torch_grad_check.py on ``scene`` on the card, in this process
    (its JSON lines kept out of this script's output, the failing ones
    logged): its summary line; raises if a gate failed."""
    import contextlib
    import importlib.util
    import io

    tool = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "torch_grad_check.py")
    spec = importlib.util.spec_from_file_location("torch_grad_check", tool)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(["--scene", scene])
    lines = buf.getvalue().strip().splitlines()
    summary = json.loads(lines[-1]) if lines else {}
    for line in lines[:-1]:
        if json.loads(line).get("pass") is False:
            log(f"  grad_check {scene}: {line}")
    if rc != 0 or not summary.get("ok"):
        raise AssertionError(f"torch_grad_check {scene} failed (rc {rc}): "
                             f"{buf.getvalue()[-3000:]}")
    log(f"torch_grad_check {scene}: worst rel {summary['worst_rel']:.3g} "
        f"(gate excess {summary['worst_gate_excess']:.3g}), finite "
        f"differences {summary['fd_worst_rel']}")
    return summary


def phase_records(card, results):
    """25. The record path (``MRT_NO_FUSE=1``) and its differentiable
    closest hit: hit3_bwd against its plain version on 2^17 camera rays of
    the room, ``mesh_glass``, ``tex_blocks`` and ``inst_grid`` and timed
    at the room's frame; the closest hit's kWalk (64-bit mask) and kGlobal
    instances against the plain sweep at the frame; the record path
    against the fused path, one sample at the frame (the room and
    ``mesh_glass`` at bounce 8, with hit3_bwd checked on the frame's rays
    of bounces REC_BWD_BOUNCES, ``inst_grid3k`` and ``mesh_big_glass`` at
    bounce REC_ROUTE_BOUNCE, their route only); the CLI and one training
    step on it; tools/torch_grad_check.py on the room, tex_dof and
    mesh_glass."""
    import torch

    from micro_raytracer_tpu_torch.ops import hit3

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(25)
    t0 = time.perf_counter()
    errs = {}
    for name in REC_HIT_NAMES:
        cfg, scene, tables, cam = rec_inputs(name, dev)
        o, d = camera_rays(cam, N_CMP, gen, dev)
        errs[name] = check_hit_bwd(name, hit_bwd_args(scene, tables, o, d,
                                                      gen))
    cfg, scene, tables, cam = rec_inputs("room", dev)
    oT, dT = main_path_rays(cfg, gen, dev)
    args = hit_bwd_args(scene, tables, oT.T, dT.T, gen)
    timing = time_hit_bwd(args)
    ms = timing["ms"]
    p_ms = plain_ms(lambda: hit3.closest_hit_bwd_plain(*args))
    b = hit_bwd_bound(scene, tables, oT.shape[1])
    # the room's errors (the timed scene's; the Instance grid's grazing
    # rays reach 1e17, so absolute errors across scenes do not compare)
    results["hit3_bwd"] = {"ms": ms, "plain_ms": p_ms, **b,
                           "library_ms": None,
                           "max_abs_err": errs["room"]["max_abs_err"],
                           **{k: timing[k] for k in ("host_ms", "device_ms",
                                                     "ops", "kernel_ms")}}
    log(f"hit3_bwd at the room's frame ({oT.shape[1]} rays): "
        f"{fmt_split(timing)}; plain {p_ms:.3f} ms, bound {fmt_bound(b)} on "
        f"{card}")
    del oT, dT, args
    new_paths = check_new_hit_paths(dev, gen)
    shares = {n: record_vs_fused(n, dev, gen, BOUNCE, REC_BWD_BOUNCES,
                                 errs)
              for n in ("room", "mesh_glass")}
    shares.update({n: record_vs_fused(n, dev, gen, REC_ROUTE_BOUNCE)
                   for n in ("inst_grid3k",)})
    shares["mesh_big_glass"] = record_vs_fused_big(dev, gen)
    t1 = time.perf_counter()
    cli_res = record_cli(card)
    train_res = record_train(card)
    t2 = time.perf_counter()
    checks = {s: run_grad_check(s) for s in GRAD_CHECK_SCENES}
    log(f"phase 25: kernels and routes {t1 - t0:.1f} s, CLI and training "
        f"{t2 - t1:.1f} s, grad checks {time.perf_counter() - t2:.1f} s")
    return {"hit_bwd_errors": errs, "hit_bwd_timing": timing,
            "new_paths": new_paths,
            "record_vs_fused_outliers": shares, "cli": cli_res,
            "train": train_res,
            "grad_check": {k: {"worst_rel": v["worst_rel"],
                               "worst_gate_excess": v["worst_gate_excess"],
                               "fd_worst_rel": v["fd_worst_rel"]}
                           for k, v in checks.items()}}


def record_vs_fused_big(dev, gen):
    """``mesh_big_glass`` (65,536 glass triangles in 1,024 cull blocks):
    the record path's closest hits through tri_entry_exit and the dense
    rows' closest hit, its shadows through the kGlobal instance, against
    the fused (per-step) path, one sample at the frame, bounce
    REC_ROUTE_BOUNCE."""
    import numpy as np
    import torch

    from micro_raytracer_tpu_torch.models import tracer
    from micro_raytracer_tpu_torch.models.render import morton_ray_order
    from micro_raytracer_tpu_torch.ops import tri

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    cfg = big_render_config("mesh_big_glass", tmp)[0]
    scene, tables, _decay, cam = big_inputs(cfg, dev)
    ys, xs = divmod(morton_ray_order(RES, RES), RES)
    coords = torch.from_numpy(np.stack([xs, ys], -1)).to(dev, torch.float32)
    u_aprt, u8s = tracer.draw_uniforms(gen, coords.shape[0],
                                       REC_ROUTE_BOUNCE, scene.any_refract,
                                       dev)
    tri.ENTRY_EXIT_KERNEL.launches = 0
    with torch.no_grad():
        rad = {f: tracer.trace_radiance_u(scene, cam, (RES, RES),
                                          REC_ROUTE_BOUNCE, cfg.rt.loss,
                                          coords, u_aprt, u8s, tables,
                                          fused=f)
               for f in (True, False)}
    if tri.ENTRY_EXIT_KERNEL.launches < 2 * (REC_ROUTE_BOUNCE + 1):
        raise AssertionError("mesh_big_glass: the record path skipped "
                             "tri_entry_exit")
    bad = outlier_rays(rad[False].T, rad[True].T, 1e-3, 1e-4)
    share = float(bad.float().mean())
    if share > 0.005 or not bool(torch.isfinite(rad[False]).all()):
        raise AssertionError(f"record path/mesh_big_glass: {int(bad.sum())} "
                             f"pixels off the fused path")
    log(f"record path/mesh_big_glass: one sample at {RES}x{RES}, bounce "
        f"{REC_ROUTE_BOUNCE}: {share:.5f} of the pixels outside rtol 1e-3 / "
        f"atol 1e-4 of the fused path")
    return share


def _gate_kernels():
    """``{key: (function, reps)}``: every whole-trace kernel at the main
    path's frame on the room, the mesh, textured and Instance-class
    stand-ins (closest_hit, trace_fwd, the segments of a compacting render,
    trace_fwd_train, trace_bwd), and the per-step kernels on lights8 and
    inst_grid3k (step_fwd and step_bwd at step 0, step_fwd over a sample's
    nine launches); and ``{key: registers and warps per SM}`` of the
    whole-trace instances."""
    import torch

    from micro_raytracer_tpu_torch.models import tracer
    from micro_raytracer_tpu_torch.models.compiler import compile_scene
    from micro_raytracer_tpu_torch.ops import hit3, step

    dev = torch.device("cuda")
    fns, info = {}, {}
    gen = torch.Generator(device=dev).manual_seed(2)
    cfgs = [("room", slice_config())] \
        + [(n, mesh_config(n)) for n in MESH_NAMES] \
        + [(n, tex_config(n)) for n in TEX_NAMES] \
        + [(n, inst_config(n)) for n in INST_NAMES]
    for name, cfg in cfgs:
        scene = compile_scene(cfg.scene, dev)
        tables = step.pack_step(scene)
        decay = tracer.decay_of(cfg.rt.loss)
        oT, dT = main_path_rays(cfg, gen, dev)
        u8s = torch.rand((BOUNCE + 1, step.n_uni(scene.any_refract),
                          oT.shape[1]), generator=gen, device=dev)
        hit0 = step.primary_hits(scene, tables, oT, dT)
        res = step.trace_fwd_train(scene, tables, decay, oT, dT, u8s, hit0)
        ct = torch.randn((3, oT.shape[1]), generator=gen, device=dev)
        a = (scene, tables, decay, oT, dT, u8s)
        fns[f"closest_hit/{name}"] = (
            lambda a=a: step.primary_hits(a[0], a[1], a[3], a[4]), 20)
        fns[f"trace_fwd/{name}"] = (
            lambda a=a, h=hit0: step.trace_fwd(*a, h), 5)
        seg = _segment_launches(*a, hit0)
        if seg is not None:
            fns[f"trace_fwd_segments/{name}"] = (seg, 5)
        if name in ("room", "mesh_glass", "tex_blocks", "inst_grid",
                    "inst_glass"):
            fns[f"trace_fwd_train/{name}"] = (
                lambda a=a, h=hit0: step.trace_fwd_train(*a, h), 5)
            fns[f"trace_bwd/{name}"] = (
                lambda a=a, r=res, c=ct: step.trace_bwd(
                    *a[:3], a[5], r[3], r[4], c, c), 5)
        for w in ("trace_fwd", "trace_fwd_train"):
            info[f"{w}/{name}"] = step.instance_resources(scene, tables, w)
        if name in ("room", "mesh_glass") \
                and hasattr(hit3, "closest_hit_bwd"):
            # the record path's closest-hit VJP, its dense and triangle
            # instances (a parent tree may have none)
            h = hit_bwd_args(scene, tables, oT.T, dT.T, gen)
            fns[f"hit3_bwd/{name}"] = (
                lambda h=h: hit3.closest_hit_bwd(*h), 20)
    for name in STEP_NAMES:
        cfg, scene, tables, decay, _cam = step_inputs(name, dev)
        oT, dT = main_path_rays(cfg, gen, dev)
        u8s = torch.rand((BOUNCE + 1, step.n_uni(scene.any_refract),
                          oT.shape[1]), generator=gen, device=dev)
        c = step.primary_carry(oT, dT)
        carries = [c]
        for k in range(BOUNCE):
            carries.append(step.step_fwd(scene, tables, decay, carries[-1],
                                         u8s[k])[0])
        _c1, hit, res = step.step_fwd_train(scene, tables, decay, c, u8s[0])
        ct1 = torch.randn(c.shape, generator=gen, device=dev)
        a = (scene, tables, decay)
        fns[f"step_fwd/{name}@0"] = (
            lambda a=a, c=c, u=u8s: step.step_fwd(*a, c, u[0]), 10)
        fns[f"step_fwd/{name}/sample"] = (
            lambda a=a, cs=carries, u=u8s: [step.step_fwd(*a, c, u[k])
                                           for k, c in enumerate(cs)], 2)
        fns[f"step_bwd/{name}@0"] = (
            lambda a=a, c=c, u=u8s, r=res, h=hit, g=ct1: step.step_bwd(
                *a, c, u[0], r, h, g), 10)
        for w in ("step_fwd", "step_bwd"):
            info[f"{w}/{name}"] = step.instance_resources(scene, tables, w)
    return fns, info


def _gate_worker(tree):
    """A worker of ``--gate``: builds ``tree``'s kernels, sets up
    ``_gate_kernels``, prints ``ready``; then answers ``probe`` with one
    JSON line of each kernel's ms over one launch, ``reps <JSON>`` by
    taking those launches per timing, and each ``run`` with one JSON line
    of every kernel's CUDA-event ms; at the end of its input, one line of
    the instances' registers and warps."""
    phase_build()
    fns, info = _gate_kernels()
    print("ready", flush=True)
    for line in sys.stdin:
        cmd = line.strip()
        if cmd == "probe":
            print(json.dumps({k: cuda_ms(f, 1) for k, (f, _r)
                              in fns.items()}), flush=True)
        elif cmd.startswith("reps "):
            reps = json.loads(cmd[5:])
            fns = {k: (f, reps.get(k, r)) for k, (f, r) in fns.items()}
        elif cmd == "run":
            print(json.dumps({k: cuda_ms(f, reps) for k, (f, reps)
                              in fns.items()}), flush=True)
        else:
            break
    print(json.dumps(info), flush=True)
    return 0


def gate(other, runs=GATE_RUNS, tol=GATE_TOL):
    """``--gate <tree>``: every kernel of ``_gate_kernels`` in ``<tree>``
    (the parent) and in this script's own tree, a worker process each on
    the one card, timed in ``runs`` interleaved runs (parent, change,
    change, parent, ...), each timing spanning GATE_MS. A kernel passes
    where the change's median is at most ``1 + tol`` times the parent's or
    at most the parent's slowest run (inside its spread); prints each
    kernel's medians, ranges and ratio, the instances' registers and warps
    per SM, and the keys that failed; returns 1 if any did. A single run of
    a short launch spreads more than 2%, and two worker processes of one
    tree can differ by 4% on a 0.27 ms kernel (PERF.md): the
    median of interleaved runs against the parent's range decides."""
    import numpy as np

    me = os.path.abspath(__file__)
    trees = {"parent": os.path.abspath(other),
             "change": os.path.dirname(me)}
    procs = {t: subprocess.Popen(
        [sys.executable, me, "--gate-worker", path], stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, text=True) for t, path in trees.items()}
    try:
        for t, p in procs.items():
            while True:
                line = p.stdout.readline()
                if not line:
                    raise RuntimeError(f"gate: the {t} worker ended")
                if line.strip() == "ready":
                    break
        # the launches per timing: as many as span GATE_MS in the faster
        # tree, the same in both
        probe = {}
        for t, p in procs.items():
            p.stdin.write("probe\n")
            p.stdin.flush()
            probe[t] = json.loads(p.stdout.readline())
        reps = {k: max(1, math.ceil(GATE_MS / max(min(
            probe["parent"][k], probe["change"][k]), 1e-3)))
            for k in probe["change"] if k in probe["parent"]}
        for p in procs.values():
            p.stdin.write("reps " + json.dumps(reps) + "\n")
            p.stdin.flush()
        times = {t: [] for t in trees}
        for r in range(runs):
            for t in (("parent", "change") if r % 2 == 0
                      else ("change", "parent")):
                procs[t].stdin.write("run\n")
                procs[t].stdin.flush()
                times[t].append(json.loads(procs[t].stdout.readline()))
        info = {}
        for t, p in procs.items():
            p.stdin.close()
            info[t] = json.loads(p.stdout.readline())
            p.wait(timeout=120)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    out, failed = {}, []
    for key in times["change"][0]:
        if key not in times["parent"][0]:
            continue
        rec = {}
        for t in trees:
            v = [run[key] for run in times[t]]
            rec[t] = {"median_ms": float(np.median(v)), "min_ms": min(v),
                      "max_ms": max(v)}
        rec["ratio"] = rec["change"]["median_ms"] / rec["parent"]["median_ms"]
        # within tol of the parent's median, or inside its runs' range
        rec["pass"] = rec["ratio"] <= 1.0 + tol or \
            rec["change"]["median_ms"] <= rec["parent"]["max_ms"]
        if not rec["pass"]:
            failed.append(key)
        out[key] = rec
        log(f"gate {key}: parent {rec['parent']['median_ms']:.4f} ms "
            f"[{rec['parent']['min_ms']:.4f}, {rec['parent']['max_ms']:.4f}]"
            f", change {rec['change']['median_ms']:.4f} ms "
            f"[{rec['change']['min_ms']:.4f}, {rec['change']['max_ms']:.4f}]"
            f", ratio {rec['ratio']:.4f}{'' if rec['pass'] else ' FAIL'}")
    print(json.dumps({"gate": out, "runs": runs, "tol": tol, "reps": reps,
                      "instances": info, "failed": failed}))
    return 1 if failed else 0


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # a worker of --gate, and --hit-split <tree>, import the package of
    # the tree they time
    worker = sys.argv[1:2] == ["--gate-worker"] and len(sys.argv) == 3
    other = worker or (sys.argv[1:2] == ["--hit-split"]
                       and len(sys.argv) == 3)
    sys.path.insert(0, os.path.abspath(sys.argv[2]) if other
                    else os.path.dirname(os.path.abspath(__file__)))
    try:
        import micro_raytracer_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is missing: {e}",
              file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    logging.getLogger("raytrace").addFilter(_NoSceneEcho())
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    if worker:
        return _gate_worker(sys.argv[2])
    if sys.argv[1:2] == ["--gate"] and len(sys.argv) in (3, 4):
        rc = gate(sys.argv[2], *(int(a) for a in sys.argv[3:]))
        print(card)
        return rc
    if sys.argv[1:] == ["--render-only"]:
        print(json.dumps({"render": render_only(card)}))
        print(card)
        return 0
    if sys.argv[1:] == ["--train-only"]:
        phase_build()
        print(json.dumps({"train": phase_train(slice_config(), card, {})}))
        print(card)
        return 0
    if sys.argv[1:] == ["--compaction"]:
        phase_build()
        print(json.dumps({"compaction": compaction_ab(card)}))
        print(card)
        return 0
    if sys.argv[1:] == ["--step-kernels"]:
        failed = step_kernels_alone()
        print(card)
        return 1 if failed else 0
    if sys.argv[1:] == ["--step-diagnosis"]:
        phase_build()
        rows = step_bwd_rows_ab()
        chaos = []
        for _ in range(CHAOS_RUNS):
            chaos.append(inst3k_chaos())
            if "nonfinite" in chaos[-1]:
                break
        log(f"inst_grid3k trained on every leaf: {len(chaos)} runs of "
            f"{TRAIN_STEPS} steps, "
            f"{sum('nonfinite' not in c for c in chaos)} finite throughout")
        print(json.dumps({"step_bwd_rows": rows, "inst_grid3k": chaos}))
        print(card)
        return 0
    if sys.argv[1:2] == ["--hit-split"] and len(sys.argv) <= 3:
        print(json.dumps({"hit_split": hit_split_only(card)}))
        print(card)
        return 0
    if sys.argv[1:] == ["--records"]:
        phase_build()
        results = {}
        rec = phase_records(card, results)
        print(json.dumps({"records": rec, "hit3_bwd": results["hit3_bwd"]}))
        print(card)
        return 0
    if sys.argv[1:] == ["--big"]:
        phase_build()
        results = {}
        big_res, counts, train_counts, big_train = phase_big(card, results)
        log(f"big mesh render: {json.dumps(big_res)}")
        log(f"big mesh training: {json.dumps(big_train)}")
        print(json.dumps({"kernels": big_entries(results, counts,
                                                  train_counts)}))
        print(card)
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    phase_build()
    from micro_raytracer_tpu_torch.ops import step as step_mod

    step_kernels = (step_mod.STEP_KERNEL, step_mod.STEP_TRAIN_KERNEL,
                    step_mod.STEP_BWD_KERNEL)
    for k in step_kernels:
        k.launches = 0
    cfg = slice_config()
    results = {}
    counts, train_counts = {}, {}
    phase_hit(cfg, results)
    phase_trace(cfg, results)
    main_res = phase_main(card, counts)
    phase_server(cfg)
    phase_train_kernels(cfg, results)
    train_res = phase_train(cfg, card, train_counts)
    phase_mesh_kernels(results)
    mesh_counts, mesh_train_counts = {}, {}
    mesh_res = phase_mesh_main(card, mesh_counts)
    mesh_train = phase_train(mesh_config("mesh_glass"), card,
                             mesh_train_counts, "mesh_glass", moved=3)
    phase_tex_kernels(results)
    tex_counts, tex_train_counts = {}, {}
    tex_res = phase_tex_main(card, tex_counts)
    tex_train = phase_train(tex_config("tex_blocks"), card, tex_train_counts,
                            "tex_blocks")
    phase_inst_kernels(results)
    inst_counts, inst_train_counts = {}, {}
    inst_res = phase_inst_main(card, inst_counts)
    inst_train = phase_train(inst_config("inst_grid"), card,
                             inst_train_counts, "inst_grid", moved=0)
    # the whole-trace scenes never took the per-step path
    if any(k.launches for k in step_kernels):
        raise AssertionError(f"the room, mesh, textured and Instance phases "
                             f"launched the step kernels "
                             f"{[k.launches for k in step_kernels]} times")
    log(f"phases 3-17: 0 step kernel launches; "
        f"{time.perf_counter() - t_start:.1f} s so far")
    phase_step_kernels(results)
    phase_step_route(results)
    step_counts = {}
    step_res = phase_step_main(card, step_counts)
    step_train, step_train_counts = {}, {}
    for name in STEP_NAMES:
        step_train_counts[name] = {}
        step_train[name] = phase_train(step_config(name), card,
                                       step_train_counts[name], name,
                                       leaves=STEP_TRAIN_LEAVES[name])
    phase_many_lights(results)
    log(f"phases 18-21 and the lights past the staged ones: "
        f"{time.perf_counter() - t_start:.1f} s so far")
    big_res, big_counts, big_train_counts, big_train = phase_big(card,
                                                                 results)
    log(f"phases 22-24: {time.perf_counter() - t_start:.1f} s so far")
    rec_res = phase_records(card, results)
    log(f"phase 25: {time.perf_counter() - t_start:.1f} s so far")

    from micro_raytracer_tpu_torch.ops import hit3, step

    fwd_src = "micro_raytracer_tpu_torch/csrc/trace_fwd.cu"
    hit_src = "micro_raytracer_tpu_torch/csrc/hit3.cu"
    bwd_src = "micro_raytracer_tpu_torch/csrc/trace_bwd.cu"
    box_src = "micro_raytracer_tpu_torch/csrc/box_walk.cuh"
    mesh_kernels = [
        {"name": f"closest_hit/{name}", "route": "cuda", "source": hit_src,
         "replaces": "micro_raytracer_tpu/ops/pallas_hit3.py:399",
         "launches": mesh_counts[name][hit3.KERNEL.name],
         **results[f"closest_hit/{name}"]} for name in MESH_NAMES]
    mesh_kernels += [
        {"name": f"trace_fwd/{name}", "route": "cuda", "source": fwd_src,
         "replaces": "micro_raytracer_tpu/ops/pallas_step.py:1313",
         "launches": mesh_counts[name][step.KERNEL.name],
         **results[f"trace_fwd/{name}"]} for name in MESH_NAMES]
    mesh_kernels += [
        {"name": "trace_fwd_train/mesh_glass", "route": "cuda",
         "source": fwd_src,
         "replaces": "micro_raytracer_tpu/ops/pallas_step.py:1313",
         "launches": mesh_train_counts[step.TRAIN_KERNEL.name],
         **results["trace_fwd_train/mesh_glass"]},
        {"name": "trace_bwd/mesh_glass", "route": "cuda", "source": bwd_src,
         "replaces": "micro_raytracer_tpu/ops/pallas_step.py:3428",
         "launches": mesh_train_counts[step.BWD_KERNEL.name],
         **results["trace_bwd/mesh_glass"]}]
    tex_kernels = []
    for name in TEX_NAMES:
        tex_kernels += [
            {"name": f"closest_hit/{name}", "route": "cuda",
             "source": hit_src,
             "replaces": "micro_raytracer_tpu/ops/pallas_hit3.py:803",
             "launches": tex_counts[name][hit3.KERNEL.name],
             **results[f"closest_hit/{name}"]},
            {"name": f"trace_fwd/{name}", "route": "cuda", "source": fwd_src,
             "replaces": "micro_raytracer_tpu/ops/pallas_step.py:1313",
             "launches": tex_counts[name][step.KERNEL.name],
             **results[f"trace_fwd/{name}"]}]
        if name == "tex_blocks":
            # the box walk's instances (csrc/box_walk.cuh)
            for k in tex_kernels[-2:]:
                k["walk_source"] = box_src
    tex_kernels += [
        {"name": "trace_fwd_train/tex_blocks", "route": "cuda",
         "source": fwd_src, "walk_source": box_src,
         "replaces": "micro_raytracer_tpu/ops/pallas_step.py:1313",
         "launches": tex_train_counts[step.TRAIN_KERNEL.name],
         **results["trace_fwd_train/tex_blocks"]},
        {"name": "trace_bwd/tex_blocks", "route": "cuda", "source": bwd_src,
         "replaces": "micro_raytracer_tpu/ops/pallas_step.py:3428",
         "launches": tex_train_counts[step.BWD_KERNEL.name],
         **results["trace_bwd/tex_blocks"]}]
    inst_kernels = [
        {"name": "closest_hit/inst_grid", "route": "cuda", "source": hit_src,
         "replaces": "micro_raytracer_tpu/ops/pallas_hit3.py:227",
         "launches": inst_counts["inst_grid"][hit3.KERNEL.name],
         **results["closest_hit/inst_grid"]},
        {"name": "trace_fwd/inst_grid", "route": "cuda", "source": fwd_src,
         "replaces": "micro_raytracer_tpu/ops/pallas_step.py:1313",
         "launches": inst_counts["inst_grid"][step.KERNEL.name],
         **results["trace_fwd/inst_grid"]},
        {"name": "trace_fwd_train/inst_grid", "route": "cuda",
         "source": fwd_src,
         "replaces": "micro_raytracer_tpu/ops/pallas_step.py:1313",
         "launches": inst_train_counts[step.TRAIN_KERNEL.name],
         **results["trace_fwd_train/inst_grid"]},
        {"name": "trace_bwd/inst_grid", "route": "cuda", "source": bwd_src,
         "replaces": "micro_raytracer_tpu/ops/pallas_step.py:3428",
         "launches": inst_train_counts[step.BWD_KERNEL.name],
         **results["trace_bwd/inst_grid"]}]
    step_src = "micro_raytracer_tpu_torch/csrc/step_fwd.cu"
    step_bwd_src = "micro_raytracer_tpu_torch/csrc/step_bwd.cu"
    step_entries = []
    for name in STEP_NAMES:
        tc = step_train_counts[name]
        step_entries += [
            {"name": f"step_fwd/{name}", "route": "cuda",
             "source": step_src,
             "replaces": "micro_raytracer_tpu/ops/pallas_step.py:1110",
             "launches": step_counts[name][step.STEP_KERNEL.name],
             **results[f"step_fwd/{name}"]},
            {"name": f"step_fwd_train/{name}", "route": "cuda",
             "source": step_src,
             "replaces": "micro_raytracer_tpu/ops/pallas_step.py:1110",
             "launches": tc[step.STEP_TRAIN_KERNEL.name],
             **results[f"step_fwd_train/{name}"]},
            {"name": f"step_bwd/{name}", "route": "cuda",
             "source": step_bwd_src,
             "replaces": "micro_raytracer_tpu/ops/pallas_step.py:3139",
             "launches": tc[step.STEP_BWD_KERNEL.name],
             **results[f"step_bwd/{name}"]}]
    log(f"big mesh render: {json.dumps(big_res)}")
    log(f"big mesh training: {json.dumps(big_train)}")
    log(f"per-step render: {json.dumps(step_res)}")
    log(f"per-step training: {json.dumps(step_train)}")
    log(f"per-step route against the whole trace: "
        f"{json.dumps(results['step_route'])}")
    log(f"instance render: {json.dumps(inst_res)}")
    log(f"instance training: {json.dumps(inst_train)}; closest_hit "
        f"launches {inst_train_counts[hit3.KERNEL.name]}")
    log(f"instance sphere rows tested: "
        f"{json.dumps(results['sph_rows/inst_grid'])}; compaction at the "
        f"frame: {json.dumps(results['compaction/inst_grid'])}")
    log(f"textured render: {json.dumps(tex_res)}")
    log(f"textured training: {json.dumps(tex_train)}; closest_hit launches "
        f"{tex_train_counts[hit3.KERNEL.name]}")
    log(f"tex_dof train kernels (phase 12 only): "
        f"{json.dumps(results['trace_fwd_train/tex_dof'])}, "
        f"{json.dumps(results['trace_bwd/tex_dof'])}")
    log(f"mesh render: {json.dumps(mesh_res)}")
    log(f"mesh training: {json.dumps(mesh_train)}; closest_hit launches "
        f"{mesh_train_counts[hit3.KERNEL.name]}")
    log(f"mesh_opaque train kernels (phase 9 only): "
        f"{json.dumps(results['trace_fwd_train/mesh_opaque'])}, "
        f"{json.dumps(results['trace_bwd/mesh_opaque'])}")
    kernels = [
        {"name": "trace_fwd", "route": "cuda", "source": fwd_src,
         "replaces": "micro_raytracer_tpu/ops/pallas_step.py:1313",
         "launches": counts[step.KERNEL.name], **results["trace_fwd"]},
        {"name": "closest_hit", "route": "cuda", "source": hit_src,
         "replaces": "micro_raytracer_tpu/ops/pallas_hit3.py:803",
         "launches": counts[hit3.KERNEL.name], **results["closest_hit"]},
        {"name": "trace_fwd_train", "route": "cuda", "source": fwd_src,
         "replaces": "micro_raytracer_tpu/ops/pallas_step.py:1313",
         "launches": train_counts[step.TRAIN_KERNEL.name],
         **results["trace_fwd_train"]},
        {"name": "trace_bwd", "route": "cuda", "source": bwd_src,
         "replaces": "micro_raytracer_tpu/ops/pallas_step.py:3428",
         "launches": train_counts[step.BWD_KERNEL.name],
         **results["trace_bwd"]},
    ] + mesh_kernels + tex_kernels + inst_kernels + step_entries \
        + big_entries(results, big_counts, big_train_counts) + [
        {"name": "hit3_bwd", "route": "cuda",
         "source": "micro_raytracer_tpu_torch/csrc/hit3_bwd.cu",
         "replaces": "micro_raytracer_tpu/ops/pallas_hit3.py:1164",
         "launches": rec_res["train"]["plain"]["hit3_bwd_launches"],
         **results["hit3_bwd"]}]
    log(f"record path: {json.dumps(rec_res)}")
    log(f"render main path: {json.dumps(main_res)}")
    log(f"training main path: {json.dumps(train_res)}; closest_hit "
        f"launches {train_counts[hit3.KERNEL.name]}")
    total = time.perf_counter() - t_start
    log(f"all phases passed in {total:.1f} s")
    print(f"chip_smoke: all phases passed in {total:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
