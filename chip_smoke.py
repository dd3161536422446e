#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                # from the repository root
    python3 chip_smoke.py --render-only  # phase 1 and the render timing

Phases, each of which raises on failure:

1. card: CUDA present; name and power limit from nvidia-smi; TF32 off.
2. build: nvcc builds every kernel source of ``micro_raytracer_tpu_torch/csrc``
   (``hit3.cu``, ``trace_fwd.cu`` with its render and train instances,
   ``trace_bwd.cu``), one nvcc process per source, all started together.
3. closest_hit kernel against its plain PyTorch version on the slice
   scene's row table, on 2^17 random rays and on the main path's input
   (the primary rays of the whole 1080x1080 frame in Morton order, as
   views of lane-major rays): closest (entry + exit), entry-only and
   any-hit; rows equal, t within rtol 1e-5 / atol 1e-6.
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
   through the plain trace (run in chunks of 2^17 rays at the frame's size)
   within rtol 2e-3 and an absolute floor of 1e-5 of each array's largest
   magnitude. Both kernels and both plain versions are timed.
8. training main path: a target rendered with the true slice scene (the
   render kernels, 4 spp), ``mat_albedo`` and ``light_pwr`` perturbed,
   then 3 steps of ``make_train_step`` at 1080x1080, bounce 8, one path
   per pixel: the loss and every gradient finite, ``mat_albedo``,
   ``light_pwr`` and ``inst_pos`` with non-zero gradients, and the launch
   counters at one ``closest_hit``, ``trace_fwd_train`` and ``trace_bwd``
   per step and no plain version. It prints the seconds per step, fwd+bwd
   rays/s and peak device memory, then profiles one more step from the
   starting parameters for the device's busy share, its operation count
   and its kernel times.
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
   ``trace_plain(work=...)``).
10. mesh main path: the CLI renders ``mesh_opaque`` and ``mesh_glass``,
   written as scene JSON files, at 1080x1080, bounce 8, 16 spp: both
   kernels once per sample and no plain version (launch counters), a
   non-constant image; ten renders of each for the median, quartiles and
   range of rays/s, and one profiled render for the device's busy share.
   The HTTP service answers one ``mesh_glass`` request.
11. mesh training: 3 steps of ``make_train_step`` on ``mesh_glass`` at
   1080x1080, bounce 8, one path per pixel, from perturbed ``mat_albedo``,
   ``light_pwr`` and torus ``inst_pos``: finite loss and gradients,
   non-zero ``inst_pos`` / ``inst_dir`` gradients on the torus rows, one
   ``closest_hit``, ``trace_fwd_train`` and ``trace_bwd`` per step; seconds
   per step, fwd+bwd rays/s, peak memory and one profiled step.

Every kernel's entry in the JSON line carries its bound: the larger of the
bytes it must move (inputs read once, outputs written once) over 3.35 TB/s
and the float32 operations this run's data needs over 67 TFLOP/s (the
H100 SXM's published rates), with operations counted by hand from the
sources (see ``ROW_TEST_OPS``, ``TRI_TEST_OPS`` and the step constants
below) and the data-dependent parts — live steps, occluded
lights, refract choices, the triangle rows the cull leaves — read from
this run's residuals and plain versions. A sweep counts the scene's valid
rows only: the kernels skip the invalid rows that pad each kind segment to
a multiple of 8. The block slab tests of the cull are not counted.

It prints a JSON line of per-kernel results and the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. Without a
CUDA device, or without the package beside it, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import dataclasses
import json
import logging
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
N_CMP = 1 << 17
OUTLIER_SHARE = 0.001
IN_ERR = 1e-3
TRAIN_STEPS = 3
TARGET_SPP = 4
G_RTOL, G_FLOOR = 2e-3, 1e-5
# a ray that meets a triangle is also held to this share of its own
# largest magnitude, and may differ from the plain version at most
# ILL_RATIO times as much as float64 moves the plain version (compare_bwd)
RAY_FLOOR, ILL_RATIO = 1e-3, 10.0
ILL_SHARE = 1e-4
SUM_TOL = 4e-4
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


def fmt_bound(b: dict) -> str:
    return f"{b['bound_ms']:.4f} ms ({b['bound_by']})"


def bound(n_bytes: float, n_ops: float) -> dict:
    """bound_ms and what sets it."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return {"bound_ms": max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations"}


def log(msg: str) -> None:
    print(f"chip_smoke: {msg}", flush=True)


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


def outlier_rays(a, b, rtol, atol):
    """(R,) mask of rays whose (C, R) components are outside tolerance."""
    import torch

    return (~torch.isclose(a, b, rtol=rtol, atol=atol)).any(dim=0)


def phase_build():
    """One nvcc per source, all started together; then bind every entry
    point (entry points of one source share its library)."""
    from concurrent.futures import ThreadPoolExecutor

    from micro_raytracer_tpu_torch.ops import hit3, step

    kernels = (hit3.KERNEL, step.KERNEL, step.TRAIN_KERNEL, step.BWD_KERNEL)
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
            if "registers" in line or "spill" in line:
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


def compare_hit(tables, o, d):
    """Kernel vs plain closest hit in every mode: rows equal, t within
    rtol 1e-5 / atol 1e-6. Returns the max abs t error over hits."""
    import torch

    from micro_raytracer_tpu_torch.ops import hit3

    err = 0.0
    tri = (tables.tri, tables.tbb)
    for mode in (hit3.MODE_EXIT, hit3.MODE_ENTRY, hit3.MODE_ANY):
        got = hit3.closest_hit(tables.tab, tables.layout, o, d, mode, *tri)
        ref = hit3.closest_hit_plain(tables.tab, tables.layout, o, d, mode,
                                     *tri)
        for name, g, r in zip(("te", "row", "tx", "xrow"), got, ref):
            if g.dtype == torch.int32:
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
            f"({tris} on triangles), matches plain")
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
    return 4 * (n + (0 if tables.tbb is None else tables.tbb.numel()))


def time_hit(scene, tables, oT, dT, reps=20, plain_reps=5):
    """closest_hit and its plain version timed on the main path's input
    (lane-major primaries as (R, 3) views), and the bound of that input:
    every valid dense row tested on the entry side, the triangle rows the
    cull leaves (the plain version counts them), and on refractive scenes
    the winner's group on the exit side (one row for a dense winner, the
    mesh's rows for a triangle winner, counted with the triangles)."""
    from micro_raytracer_tpu_torch.ops import hit3, step

    mode = step.primary_mode(scene)
    args = (tables.tab, tables.layout, oT.T, dT.T, mode, tables.tri,
            tables.tbb)
    ms = cuda_ms(lambda: hit3.closest_hit(*args), reps)
    plain_ms = cuda_ms(lambda: hit3.closest_hit_plain(*args), plain_reps)
    R, P = oT.shape[1], valid_rows(scene, tables)
    te, row = hit3.closest_hit(*args)[:2]
    dense_hits = (te < hit3.BIG * 0.5) & (row < tables.layout[1])
    exits = int(dense_hits.sum()) if scene.any_refract else 0
    tri_rows = int(hit3.tri_rows_tested(*args).sum())
    b = bound(R * (24 + 16) + table_bytes(scene, tables),
              (R * P + exits) * ROW_TEST_OPS + tri_rows * TRI_TEST_OPS)
    return {"ms": ms, "plain_ms": plain_ms, **b}, tri_rows / R


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
    res, _rows = time_hit(scene, tables, oT, dT)
    log(f"closest_hit {oT.shape[1]} rays: kernel {res['ms']:.3f} ms, plain "
        f"{res['plain_ms']:.3f} ms, bound {fmt_bound(res)}")
    results["closest_hit"] = {"max_abs_err": err, **res,
                              "library_ms": None}


def compare_trace(scene, tables, decay, oT, dT, u8s):
    """Kernels (primary-hit pass, then trace) vs the plain whole trace:
    first_live equal; A, B and radiance within rtol 1e-4 / atol 1e-5 on
    all but OUTLIER_SHARE of the rays, and A and B within IN_ERR on the
    rest. Returns the max abs error of A and B over all rays."""
    import torch

    from micro_raytracer_tpu_torch.ops import step

    R = oT.shape[1]
    A, B, fl = step.trace_packed(scene, tables, decay, oT, dT, u8s)
    A_r, B_r, fl_r = step.trace_plain(scene, tables, decay, oT, dT, u8s)
    n_fl = int((fl != fl_r).sum())
    if n_fl:
        raise AssertionError(f"trace_fwd: first_live differs on {n_fl} rays")
    sky = scene.sky_color[:, None]
    rad = torch.where(fl > 0.5, B + A * (sky * scene.sky_pwr), sky)
    rad_r = torch.where(fl_r > 0.5, B_r + A_r * (sky * scene.sky_pwr), sky)
    bad = torch.zeros(R, dtype=torch.bool, device=oT.device)
    for g, r in ((A, A_r), (B, B_r), (rad, rad_r)):
        bad |= outlier_rays(g, r, 1e-4, 1e-5)
    share = float(bad.float().mean())
    err = float(max((A - A_r).abs().max(), (B - B_r).abs().max()))
    good = ~bad
    err_in = float(max((A - A_r)[:, good].abs().max(),
                       (B - B_r)[:, good].abs().max()))
    log(f"trace_fwd {R} rays: {int(bad.sum())} rays outside rtol 1e-4 "
        f"(share {share:.5f}, bound {OUTLIER_SHARE}); max abs err of A/B "
        f"{err:.3g} over all rays, {err_in:.3g} over the rest (bound "
        f"{IN_ERR})")
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


def render_cli(out, scene_args=SLICE_ARGS):
    """One CLI render of the main path (the slice scene's flags, or a
    scene JSON file): (render loop seconds, wall seconds). The loop's
    seconds are the sum of the CLI's per-sample times, each taken after a
    synchronize."""
    from micro_raytracer_tpu_torch.frontends import cli

    handler = _SampleLog()
    logging.getLogger("raytrace").addHandler(handler)
    t0 = time.perf_counter()
    try:
        rc = cli.main(list(scene_args) + [
            "--res", str(RES), str(RES), "--ssaa", "1", "--bounce",
            str(BOUNCE), "--sample", str(SAMPLES), "--device", "cuda",
            "-v", "-o", out])
    finally:
        logging.getLogger("raytrace").removeHandler(handler)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"CLI render failed: rc={rc}")
    if handler.last != SAMPLES - 1:
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
    with JPEGs, through the kernels alone."""
    from micro_raytracer_tpu_torch.frontends.http import HttpServer
    from micro_raytracer_tpu_torch.ops import hit3, step

    kernels = (hit3.KERNEL, step.KERNEL)
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
    ``trace_plain(work=...)``, holds the triangle rows the sweeps test)."""
    import torch

    from micro_raytracer_tpu_torch.ops import step

    K, NU, R = u8s.shape
    L, P = scene.n_lights, valid_rows(scene, tables)
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
    if tables.layout[3]:
        crow = torch.where(rl[:, step.RES_CHOOSE] > 0.5,
                           rl[:, step.res_xrow(L)], crow)
    row = torch.where(n > 0, crow, 0.0).long()
    killed = (n > 0) & (u8s[last, NU - 1, idx]
                        < tables.tab[row, step._C_EMI])
    # closest-hit sweeps (of the P valid rows) after step 0: each later
    # live step, and the step whose sweep missed; on refractive scenes each
    # hit also tests its group's exit (one row here)
    later = int((n - 1).clamp(min=0).sum())
    sweeps = later + int(((n > 0) & (n < K) & ~killed).sum())
    exits = later if scene.any_refract else 0
    # shadow sweeps: a visible light tests every row, an occluded one at
    # least one
    lok = resid[:, step.RES_LOK:step.RES_LOK + L] > 0.5            # (K, L, R)
    vis = int((lok & live[:, None]).sum())
    occ = S * L - vis
    chosen = (int(((resid[:, step.RES_CHOOSE] > 0.5) & live).sum())
              if scene.any_refract else 0)
    fwd_ops = ((sweeps * P + exits + vis * P + occ) * ROW_TEST_OPS
               + S * (FWD_STEP_OPS + L * FWD_LIGHT_OPS)
               + (S * FWD_REFRACT_OPS if scene.any_refract else 0))
    if tri_work is not None:
        fwd_ops += (tri_work["sweep"] * TRI_TEST_OPS
                    + tri_work["shadow"] * TRI_ANY_OPS)
    tables_b = table_bytes(scene, tables)
    # primaries, hits and outputs per ray; uniforms per live step
    fwd_b = R * (24 + 16 + 28) + S * NU * 4 + tables_b
    CR = step.res_rows(L, tables.layout[3])
    train_b = fwd_b + S * CR * 4 + R * 4
    bwd_ops = (S * BWD_STEP_OPS + chosen * BWD_REFRACT_OPS
               + vis * BWD_LIGHT_OK_OPS + occ * BWD_LIGHT_OCC_OPS)
    # n_live, ctA/ctB in, d_o/d_d out per ray; residuals and uniforms per
    # live step; tables in, their cotangents (every row) out
    d_tables_b = table_bytes(scene, tables)
    bwd_b = (R * (4 + 24 + 24) + S * (CR + NU) * 4 + tables_b
             + d_tables_b)
    return {"trace_fwd": bound(fwd_b, fwd_ops),
            "trace_fwd_train": bound(train_b, fwd_ops),
            "trace_bwd": bound(bwd_b, bwd_ops), "live_steps": S}


def compare_train_fwd(scene, tables, decay, oT, dT, u8s, hit0):
    """The train instance against the render instance (bit for bit) and
    against ``trace_plain(want_resid=True)``. Returns the max abs error of
    A/B, the off-path mask, the kernel's and the plain residuals."""
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
    A_r, B_r, fl_r, res_r, nl_r = step.trace_plain(
        scene, tables, decay, oT, dT, u8s, want_resid=True)
    if not torch.equal(fl, fl_r):
        raise AssertionError("trace_fwd_train: first_live differs")
    bad = (outlier_rays(A, A_r, 1e-4, 1e-5) | outlier_rays(B, B_r, 1e-4, 1e-5)
           | (nl != nl_r))
    share = float(bad.float().mean())
    err = float(max((A - A_r).abs().max(), (B - B_r).abs().max()))
    good = ~bad
    err_in = float(max((A - A_r)[:, good].abs().max(),
                       (B - B_r)[:, good].abs().max()))
    live = (torch.arange(K, device=oT.device)[:, None] < nl[None]) & good
    floats = [step.RES_O + c for c in range(9)] + [step.RES_TE]
    exact = [step.RES_ROW] + [step.RES_LOK + li
                              for li in range(scene.n_lights)]
    if scene.any_refract:
        floats.append(step.RES_TX)
        exact.append(step.RES_CHOOSE)
    if tables.layout[3]:
        exact.append(step.res_xrow(scene.n_lights))
    res_err = 0.0
    for r in floats:
        g, w = res[:, r][live], res_r[:, r][live]
        res_err = max(res_err, float((g - w).abs().max()))
        if not bool(torch.isclose(g, w, rtol=1e-4, atol=1e-4).all()):
            raise AssertionError(f"trace_fwd_train: residual row {r} differs")
    for r in exact:
        if not torch.equal(res[:, r][live], res_r[:, r][live]):
            raise AssertionError(f"trace_fwd_train: residual row {r} differs")
    log(f"trace_fwd_train {R} rays: equals trace_fwd bit for bit; "
        f"{int(bad.sum())} rays off the plain path (share {share:.5f}, "
        f"bound {OUTLIER_SHARE}); max abs err of A/B {err:.3g} over all "
        f"rays, {err_in:.3g} over the rest; residuals of "
        f"{int(live.sum())} live steps within {res_err:.3g}")
    if share > OUTLIER_SHARE or err_in > IN_ERR:
        raise AssertionError("trace_fwd_train disagrees with its plain "
                             "version")
    return err, bad, (res, nl), (res_r, nl_r)


def trace_bwd_plain_chunked(scene, tables, decay, oT, dT, u8s, ctA, ctB):
    """``step.trace_bwd_plain`` over chunks of PLAIN_CHUNK rays (the
    autograd graph of a whole frame does not fit the card). The table
    cotangents are summed over the chunks in float64, beside the sums of
    their absolute values (the mass that bounds a float32 sum's rounding):
    ``(d_tab, d_lights, d_oT, d_dT, d_tri, mass_tab, mass_lights,
    mass_tri)``."""
    import torch

    from micro_raytracer_tpu_torch.ops import step

    R = oT.shape[1]
    f64 = torch.float64
    d_tab, m_tab = (torch.zeros_like(tables.tab, dtype=f64) for _ in "ab")
    d_lt, m_lt = (torch.zeros_like(tables.lights, dtype=f64) for _ in "ab")
    d_tri, m_tri = (torch.zeros_like(tables.tri, dtype=f64) for _ in "ab")
    d_o, d_d = torch.empty_like(oT), torch.empty_like(dT)
    for s in range(0, R, PLAIN_CHUNK):
        sl = slice(s, min(R, s + PLAIN_CHUNK))
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
    the rays may be outside; both sides drop them (the cotangents are
    linear in ctA, ctB). The table cotangents, sums over millions of steps
    whose order differs, are then held within G_RTOL, G_FLOOR and SUM_TOL
    of the entry's mass.
    Returns the max abs error, the plain version's ms and the cotangents.
    """
    import numpy as np
    import torch

    from micro_raytracer_tpu_torch.ops import step

    R = oT.shape[1]
    ctA, ctB = (torch.randn((3, R), generator=gen, device=oT.device)
                for _ in range(2))
    ctA[:, bad] = 0.0
    ctB[:, bad] = 0.0
    got = step.trace_bwd(scene, tables, decay, u8s, resid, n_live, ctA, ctB)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = trace_bwd_plain_chunked(scene, tables, decay, oT, dT, u8s, ctA,
                                   ctB)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    # the absolute floors of the sums stay those of the whole frame
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
    if bool(ill.any()):
        idx = ill.nonzero()[:, 0]
        sub = trace_bwd_plain_chunked(
            scene, tables, decay, *(t[..., idx] for t in (oT, dT, u8s, ctA,
                                                          ctB)))
        ctA[:, ill] = 0.0
        ctB[:, ill] = 0.0
        got = step.trace_bwd(scene, tables, decay, u8s, resid, n_live, ctA,
                             ctB)
        want = (want[0] - sub[0], want[1] - sub[1],
                torch.where(ill, 0.0, want[2]),
                torch.where(ill, 0.0, want[3]), want[4] - sub[4]) + want[5:]
    err, msg = 0.0, []
    masses = (want[5], want[6], None, None, want[7])
    for name, g, w, m, scale in zip(("d_tab", "d_lights", "d_oT", "d_dT",
                                     "d_tri"), got, want, masses, scales):
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
        if not bool((e <= tol).all()):
            worst = torch.topk((e / tol).flatten(), min(4, e.numel()))[1]
            at = [tuple(int(x) for x in np.unravel_index(int(i), e.shape))
                  for i in worst]
            raise AssertionError(
                f"trace_bwd: {name} differs from autograd on "
                f"{int((e > tol).sum())} entries; worst (index: kernel, "
                f"plain, tolerance): " + ", ".join(
                    f"{ix}: {float(g[ix]):.6g}, {float(w[ix]):.6g}, "
                    f"{float(tol[ix]):.3g}" for ix in at))
    log(f"trace_bwd {R} rays: matches autograd of the plain trace; max abs "
        f"err {', '.join(msg)}")
    return err, plain_ms, ctA, ctB


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
    results["trace_fwd"].update(work["trace_fwd"])
    results["trace_fwd_train"] = {"max_abs_err": max(errs_f), "ms": ms_f,
                                  "plain_ms": plain_f,
                                  **work["trace_fwd_train"],
                                  "library_ms": None}
    results["trace_bwd"] = {"max_abs_err": max(errs_b), "ms": ms_b,
                            "plain_ms": plain_b, **work["trace_bwd"],
                            "library_ms": None}


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


def phase_train(cfg, card, counts, name="slice room", mesh=False):
    """The training main path: 3 steps of make_train_step at full width,
    from perturbed albedos and light power (and, on a mesh scene, the
    mesh's position)."""
    import numpy as np
    import torch

    from micro_raytracer_tpu_torch.models import tracer
    from micro_raytracer_tpu_torch.models.compiler import (compile_camera,
                                                           compile_scene)
    from micro_raytracer_tpu_torch.models.render import morton_ray_order
    from micro_raytracer_tpu_torch.ops import hit3, step
    from micro_raytracer_tpu_torch.parallel import shard

    dev = torch.device("cuda")
    truth = compile_scene(cfg.scene, dev)
    cam = compile_camera(cfg.frame.cam, dev)
    loss_cfg = cfg.rt.loss
    ys, xs = divmod(morton_ray_order(RES, RES), RES)
    coords = torch.from_numpy(np.stack([xs, ys], -1)).to(dev, torch.float32)
    gen = torch.Generator(device=dev).manual_seed(12 if mesh else 6)
    tables = step.pack_step(truth)
    with torch.no_grad():      # the target, through the render kernels
        target = sum(tracer.trace_radiance(truth, cam, (RES, RES), BOUNCE,
                                           loss_cfg, coords, gen, tables)
                     for _ in range(TARGET_SPP)) / TARGET_SPP
    params, scene = shard.split_params(truth)
    params = {k: v.detach().clone() for k, v in params.items()}
    params["mat_albedo"] = torch.full_like(params["mat_albedo"], 0.5)
    params["light_pwr"] = params["light_pwr"] * 0.3
    # the leaves whose gradient must not vanish, and on which rows
    rows = {k: slice(None) for k in ("mat_albedo", "light_pwr", "inst_pos")}
    if mesh:
        tri = scene.seg(3)
        params["inst_pos"][tri] += torch.tensor([0.02, 0.0, 0.01],
                                                device=dev)
        rows = {"inst_pos": tri, "inst_dir": tri}
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    start = params
    ts = shard.make_train_step((RES, RES), BOUNCE, device=dev)
    kernels = (hit3.KERNEL, step.KERNEL, step.TRAIN_KERNEL, step.BWD_KERNEL)
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
    want = {hit3.KERNEL.name: TRAIN_STEPS, step.KERNEL.name: 0,
            step.TRAIN_KERNEL.name: TRAIN_STEPS,
            step.BWD_KERNEL.name: TRAIN_STEPS}
    if launched != want or plain:
        raise AssertionError(f"{name} training launches {launched} (want "
                             f"{want}), plain calls {plain}")
    step_s = sum(secs[1:]) / (TRAIN_STEPS - 1)
    rays = RES * RES
    drift = {k: float((params[k] - start[k]).abs().max())
             for k in ("inst_pos", "inst_dir", "mat_albedo", "light_pwr")}
    log(f"{name} training: {RES}x{RES}, bounce {BOUNCE}, 1 path per "
        f"pixel, {TRAIN_STEPS} steps: seconds {[f'{s:.4f}' for s in secs]}, "
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
    log(f"{name} training profile, one step from the starting parameters: "
        f"wall {wall:.4f} s, device busy {busy:.4f} s = {busy / wall:.3f} of "
        f"the step, {n_ops} device operations (kernels, copies, fills)")
    for kname, t in sorted(by_name.items(), key=lambda x: -x[1])[:8]:
        log(f"  {t * 1e3:9.3f} ms  {kname[:90]}")
    return {"step_s": step_s, "steps_s": secs,
            "fwd_bwd_rays_per_s": rays / step_s, "peak_bytes": peak,
            "busy_share": busy / wall}
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
        oT, dT = main_path_rays(cfg, gen, dev)   # the main path's input
        err = max(err, compare_hit(tables, oT.T, dT.T))
        res, rows = time_hit(scene, tables, oT, dT, plain_reps=1)
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
            **bw["trace_fwd"], "library_ms": None}
        results[f"trace_fwd_train/{name}"] = {
            "max_abs_err": max(errs_t), "ms": ms_t, "plain_ms": plain_t,
            **bw["trace_fwd_train"], "library_ms": None}
        results[f"trace_bwd/{name}"] = {
            "max_abs_err": max(errs_b), "ms": ms_b, "plain_ms": plain_b,
            **bw["trace_bwd"], "library_ms": None}
        del resid


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
        if launched != {hit3.KERNEL.name: SAMPLES, step.KERNEL.name: SAMPLES} \
                or hit3.KERNEL.plain_calls or step.KERNEL.plain_calls:
            raise AssertionError(f"{name} render: launches {launched}, "
                                 f"plain calls {hit3.KERNEL.plain_calls}, "
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


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import micro_raytracer_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is missing: {e}",
              file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    if sys.argv[1:] == ["--render-only"]:
        print(json.dumps({"render": render_only(card)}))
        print(card)
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}",
              file=sys.stderr)
        return 2
    phase_build()
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
                             mesh_train_counts, "mesh_glass", mesh=True)

    from micro_raytracer_tpu_torch.ops import hit3, step

    fwd_src = "micro_raytracer_tpu_torch/csrc/trace_fwd.cu"
    hit_src = "micro_raytracer_tpu_torch/csrc/hit3.cu"
    bwd_src = "micro_raytracer_tpu_torch/csrc/trace_bwd.cu"
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
    ] + mesh_kernels
    log(f"render main path: {json.dumps(main_res)}")
    log(f"training main path: {json.dumps(train_res)}; closest_hit "
        f"launches {train_counts[hit3.KERNEL.name]}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
