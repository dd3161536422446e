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

Every kernel's entry in the JSON line carries its bound: the larger of the
bytes it must move (inputs read once, outputs written once) over 3.35 TB/s
and the float32 operations this run's data needs over 67 TFLOP/s (the
H100 SXM's published rates), with operations counted by hand from the
sources (see ``ROW_TEST_OPS`` and the step constants below) and the
data-dependent parts — live steps, occluded lights, refract choices — read
from this run's residuals. A sweep counts the scene's valid rows only: the
kernels skip the invalid rows that pad each kind segment to a multiple of
8.

It prints a JSON line of per-kernel results and the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. Without a
CUDA device, or without the package beside it, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

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
    for mode in (hit3.MODE_EXIT, hit3.MODE_ENTRY, hit3.MODE_ANY):
        got = hit3.closest_hit(tables.tab, tables.layout, o, d, mode)
        ref = hit3.closest_hit_plain(tables.tab, tables.layout, o, d, mode)
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
        log(f"closest_hit mode {mode}, {o.shape[0]} rays: {hits} hit, "
            f"matches plain")
    return err


def main_path_rays(cfg, gen, dev):
    """The trace's input on the main path: camera rays of the whole frame
    in the renderer's Morton order, lane-major ``(3, R)``."""
    from micro_raytracer_tpu_torch.models.compiler import compile_camera

    o, d = camera_rays(compile_camera(cfg.frame.cam, dev), RES * RES, gen,
                       dev)
    return o.T.contiguous(), d.T.contiguous()


def valid_rows(scene) -> int:
    """Rows a sweep must test: the valid ones (each kind segment of the
    row table is padded to a multiple of 8 with invalid rows)."""
    return int(scene.prim_valid.sum())


def phase_hit(cfg, results):
    import torch

    from micro_raytracer_tpu_torch.models.compiler import compile_scene
    from micro_raytracer_tpu_torch.ops import hit3, step

    dev = torch.device("cuda")
    scene = compile_scene(cfg.scene, dev)
    tables = step.pack_step(scene)
    gen = torch.Generator(device=dev).manual_seed(1)
    err = compare_hit(tables, *random_rays(N_CMP, gen, dev))
    # the main path's input: the trace's row table and the primaries as
    # (R, 3) views of lane-major rays
    oT, dT = main_path_rays(cfg, gen, dev)
    err = max(err, compare_hit(tables, oT.T, dT.T))
    mode = step.primary_mode(scene)
    ms = cuda_ms(lambda: hit3.closest_hit(tables.tab, tables.layout, oT.T,
                                          dT.T, mode), 20)
    plain_ms = cuda_ms(lambda: hit3.closest_hit_plain(
        tables.tab, tables.layout, oT.T, dT.T, mode), 5)
    # the work of this input: every valid row tested on the entry side,
    # and the winner's group (one row in this scene) on the exit side of a
    # hit
    R, P = oT.shape[1], valid_rows(scene)
    te = hit3.closest_hit(tables.tab, tables.layout, oT.T, dT.T, mode)[0]
    exits = int((te < hit3.BIG * 0.5).sum()) if scene.any_refract else 0
    b = bound(R * (24 + 16) + P * step.ROW_COLS * 4,
              (R * P + exits) * ROW_TEST_OPS)
    log(f"closest_hit {R} rays: kernel {ms:.3f} ms, plain {plain_ms:.3f} "
        f"ms, bound {fmt_bound(b)}")
    results["closest_hit"] = {"max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms, **b,
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
    hit0 = hit3.closest_hit(tables.tab, tables.layout, oT.T, dT.T,
                            step.primary_mode(scene))
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


def render_cli(out):
    """One CLI render of the main path: (render loop seconds, wall
    seconds). The loop's seconds are the sum of the CLI's per-sample
    times, each taken after a synchronize."""
    from micro_raytracer_tpu_torch.frontends import cli

    handler = _SampleLog()
    logging.getLogger("raytrace").addHandler(handler)
    t0 = time.perf_counter()
    try:
        rc = cli.main(SLICE_ARGS + [
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


def phase_server(cfg):
    from micro_raytracer_tpu_torch.frontends.http import HttpServer

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
        for i in range(3):
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


def trace_work(scene, tables, u8s, resid, n_live):
    """Bounds of the render instance, the train instance and the backward
    kernel on these inputs, from the work their data asks for (read from
    the train instance's residuals)."""
    import torch

    from micro_raytracer_tpu_torch.ops import step

    K, NU, R = u8s.shape
    L, P = scene.n_lights, valid_rows(scene)
    n = n_live.long()
    idx = torch.arange(R, device=n.device)
    live = torch.arange(K, device=n.device)[:, None] < n[None]     # (K, R)
    S = int(live.sum())
    # the emit draw ended the path at its last live step (the chosen row is
    # the entry row: these scenes have no triangles)
    last = (n - 1).clamp(min=0)
    row = torch.where(n > 0, resid[last, step.RES_ROW, idx], 0.0).long()
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
    tables_b = (P * step.ROW_COLS + L * step.LIGHT_COLS) * 4
    # primaries, hits and outputs per ray; uniforms per live step
    fwd_b = R * (24 + 16 + 28) + S * NU * 4 + tables_b
    train_b = fwd_b + S * step.res_rows(L) * 4 + R * 4
    bwd_ops = (S * BWD_STEP_OPS + chosen * BWD_REFRACT_OPS
               + vis * BWD_LIGHT_OK_OPS + occ * BWD_LIGHT_OCC_OPS)
    # n_live, ctA/ctB in, d_o/d_d out per ray; residuals and uniforms per
    # live step; tables in, their cotangents (every row) out
    d_tables_b = tables.tab.numel() * 4 + L * step.LIGHT_COLS * 4
    bwd_b = (R * (4 + 24 + 24) + S * (step.res_rows(L) + NU) * 4 + tables_b
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
    ``(d_tab, d_lights, d_oT, d_dT, mass_tab, mass_lights)``."""
    import torch

    from micro_raytracer_tpu_torch.ops import step

    R = oT.shape[1]
    f64 = torch.float64
    d_tab, m_tab = (torch.zeros_like(tables.tab, dtype=f64) for _ in "ab")
    d_lt, m_lt = (torch.zeros_like(tables.lights, dtype=f64) for _ in "ab")
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
        d_o[:, sl], d_d[:, sl] = g[2], g[3]
    return d_tab, d_lt, d_o, d_d, m_tab, m_lt


def compare_bwd(scene, tables, decay, oT, dT, u8s, resid, n_live, bad, gen):
    """The backward kernel on the plain residuals against autograd through
    the plain trace, for random output cotangents that are zero on the
    off-path rays.

    Per ray, d_oT and d_dT within rtol G_RTOL and G_FLOOR of the largest
    magnitude. A ray outside is ill-conditioned, not wrong: a step that
    starts inside a thin box wall and runs nearly parallel to it takes its
    t as the difference of two slab terms ~1e4 times larger, so float32
    rounding decides its gradient, and two float32 programs disagree there
    (float64 gives yet another value). At most ILL_SHARE of the rays may
    be so; both sides drop them (the cotangents are linear in ctA, ctB).
    The table cotangents, sums over millions of steps whose order differs,
    are then held within G_RTOL, G_FLOOR and SUM_TOL of the entry's mass.
    Returns the max abs error, the plain version's ms and the cotangents.
    """
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
    # the absolute floors stay those of the whole frame
    scales = [float(w.abs().max()) for w in want[:4]]
    ill = torch.zeros(R, dtype=torch.bool, device=oT.device)
    for g, w, scale in zip(got[2:], want[2:4], scales[2:]):
        ill |= outlier_rays(g, w, G_RTOL, G_FLOOR * scale)
    share = float(ill.float().mean())
    log(f"trace_bwd {R} rays: {int(ill.sum())} ill-conditioned rays (share "
        f"{share:.2e}, bound {ILL_SHARE})")
    if share > ILL_SHARE:
        raise AssertionError("trace_bwd: too many rays disagree with "
                             "autograd of the plain trace")
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
                torch.where(ill, 0.0, want[3])) + want[4:]
    err, msg = 0.0, []
    masses = (want[4], want[5], None, None)
    for name, g, w, m, scale in zip(("d_tab", "d_lights", "d_oT", "d_dT"),
                                    got, want, masses, scales):
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
            raise AssertionError(f"trace_bwd: {name} differs from autograd "
                                 f"on {int((e > tol).sum())} entries")
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
    mode = step.primary_mode(scene)
    o, d = camera_rays(compile_camera(cfg.frame.cam, dev), N_CMP, gen, dev)
    o, d = o.T.contiguous(), d.T.contiguous()
    u = torch.rand((BOUNCE + 1, step.n_uni(scene.any_refract), N_CMP),
                   generator=gen, device=dev)
    errs_f, errs_b = [], []
    for oT_, dT_, u_ in ((o, d, u), (oT, dT, u8s)):
        h = hit3.closest_hit(tables.tab, tables.layout, oT_.T, dT_.T, mode)
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


def phase_train(cfg, card, counts):
    """The training main path: 3 steps of make_train_step at full width."""
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
    gen = torch.Generator(device=dev).manual_seed(6)
    tables = step.pack_step(truth)
    with torch.no_grad():      # the target, through the render kernels
        target = sum(tracer.trace_radiance(truth, cam, (RES, RES), BOUNCE,
                                           loss_cfg, coords, gen, tables)
                     for _ in range(TARGET_SPP)) / TARGET_SPP
    params, scene = shard.split_params(truth)
    params = {k: v.detach().clone() for k, v in params.items()}
    params["mat_albedo"] = torch.full_like(params["mat_albedo"], 0.5)
    params["light_pwr"] = params["light_pwr"] * 0.3
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
            raise AssertionError(f"training: loss {losses[-1]}")
        for k, p in params.items():
            if p.grad is None or not bool(torch.isfinite(p.grad).all()):
                raise AssertionError(f"training: gradient of {k} is "
                                     f"missing or not finite")
        for k in ("mat_albedo", "light_pwr", "inst_pos"):
            if not bool((params[k].grad != 0).any()):
                raise AssertionError(f"training: gradient of {k} is zero")
        params = new
    launched = {k.name: k.launches for k in kernels}
    plain = {k.name: k.plain_calls for k in kernels if k.plain_calls}
    peak = torch.cuda.max_memory_allocated()
    counts.update(launched)
    want = {hit3.KERNEL.name: TRAIN_STEPS, step.KERNEL.name: 0,
            step.TRAIN_KERNEL.name: TRAIN_STEPS,
            step.BWD_KERNEL.name: TRAIN_STEPS}
    if launched != want or plain:
        raise AssertionError(f"training launches {launched} (want {want}), "
                             f"plain calls {plain}")
    step_s = sum(secs[1:]) / (TRAIN_STEPS - 1)
    rays = RES * RES
    drift = {k: float((params[k] - start[k]).abs().max())
             for k in ("inst_pos", "inst_dir", "mat_albedo", "light_pwr")}
    log(f"training main path: {RES}x{RES}, bounce {BOUNCE}, 1 path per "
        f"pixel, {TRAIN_STEPS} steps: seconds {[f'{s:.4f}' for s in secs]}, "
        f"losses {[f'{x:.6g}' for x in losses]}; {step_s:.4f} s per step "
        f"after the first = {rays / step_s / 1e6:.3f}M fwd+bwd rays/s; peak "
        f"device memory {peak / 2**30:.3f} GiB on {card}; launches "
        f"{launched}; largest change of a leaf over the steps "
        f"{ {k: f'{v:.3g}' for k, v in drift.items()} }")
    # one more step from the starting parameters, whose paths are those of
    # the scene phase 7 timed the kernels on; an error of the step raises
    (loss, _new), wall, busy, n_ops, by_name = _busy_share(
        lambda: ts.step(start, scene, cam, loss_cfg, coords, target, gen))
    if not np.isfinite(float(loss)):
        raise AssertionError(f"profiled training step: loss {float(loss)}")
    log(f"training profile, one step from the starting parameters: wall "
        f"{wall:.4f} s, device busy {busy:.4f} s = {busy / wall:.3f} of the "
        f"step, {n_ops} device operations (kernels, copies, fills)")
    for name, s in sorted(by_name.items(), key=lambda x: -x[1])[:8]:
        log(f"  {s * 1e3:9.3f} ms  {name[:90]}")
    return {"step_s": step_s, "steps_s": secs,
            "fwd_bwd_rays_per_s": rays / step_s, "peak_bytes": peak}


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
    phase_hit(cfg, results)
    phase_trace(cfg, results)
    counts = {}
    main_res = phase_main(card, counts)
    phase_server(cfg)
    phase_train_kernels(cfg, results)
    train_counts = {}
    train_res = phase_train(cfg, card, train_counts)

    from micro_raytracer_tpu_torch.ops import hit3, step

    fwd_src = "micro_raytracer_tpu_torch/csrc/trace_fwd.cu"
    kernels = [
        {"name": "trace_fwd", "route": "cuda", "source": fwd_src,
         "replaces": "micro_raytracer_tpu/ops/pallas_step.py:1313",
         "launches": counts[step.KERNEL.name], **results["trace_fwd"]},
        {"name": "closest_hit", "route": "cuda",
         "source": "micro_raytracer_tpu_torch/csrc/hit3.cu",
         "replaces": "micro_raytracer_tpu/ops/pallas_hit3.py:803",
         "launches": counts[hit3.KERNEL.name], **results["closest_hit"]},
        {"name": "trace_fwd_train", "route": "cuda", "source": fwd_src,
         "replaces": "micro_raytracer_tpu/ops/pallas_step.py:1313",
         "launches": train_counts[step.TRAIN_KERNEL.name],
         **results["trace_fwd_train"]},
        {"name": "trace_bwd", "route": "cuda",
         "source": "micro_raytracer_tpu_torch/csrc/trace_bwd.cu",
         "replaces": "micro_raytracer_tpu/ops/pallas_step.py:3428",
         "launches": train_counts[step.BWD_KERNEL.name],
         **results["trace_bwd"]},
    ]
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
