#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each of which raises on failure:

1. card: CUDA present; name and power limit from nvidia-smi; TF32 off.
2. build: nvcc builds both kernels from ``micro_raytracer_tpu_torch/csrc``.
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
   the image is non-constant and shows the lit emitter.
6. server: the HTTP service answers three render requests with JPEGs.

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
N_CMP = 1 << 17
OUTLIER_SHARE = 0.001
IN_ERR = 1e-3


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
    from micro_raytracer_tpu_torch.ops import hit3, step

    for k in (hit3.KERNEL, step.KERNEL):
        t0 = time.perf_counter()
        k.fn()
        log(f"built {k.source} in {time.perf_counter() - t0:.2f} s")
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")


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
    log(f"closest_hit {RES * RES} rays: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms")
    results["closest_hit"] = {"max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms}


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
                            "plain_ms": plain_ms}

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
    def __init__(self):
        super().__init__(logging.INFO)
        self.seconds = []

    def emit(self, record):
        if str(record.msg).startswith("cli:sample:"):
            self.seconds.append(float(record.args[1]))


def phase_main(card, counts):
    import numpy as np
    from PIL import Image

    from micro_raytracer_tpu_torch.frontends import cli
    from micro_raytracer_tpu_torch.ops import hit3, step

    kernels = (hit3.KERNEL, step.KERNEL)
    for k in kernels:
        k.launches = 0
        k.plain_calls = 0
    handler = _SampleLog()
    logging.getLogger("raytrace").addHandler(handler)
    out = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_"), "slice.png")
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
    render_s = sum(handler.seconds)
    rays = RES * RES * SAMPLES
    log(f"main path: {RES}x{RES} x {SAMPLES} spp, bounce {BOUNCE}: render "
        f"loop {render_s:.3f} s = {rays / render_s / 1e6:.2f}M rays/s, CLI "
        f"wall {wall:.3f} s = {rays / wall / 1e6:.2f}M rays/s on {card}; "
        f"launches {counts}")
    return {"render_s": render_s, "wall_s": wall,
            "rays_per_s": rays / render_s, "wall_rays_per_s": rays / wall}


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
    phase_build()
    cfg = slice_config()
    results = {}
    phase_hit(cfg, results)
    phase_trace(cfg, results)
    counts = {}
    main_res = phase_main(card, counts)
    phase_server(cfg)

    from micro_raytracer_tpu_torch.ops import hit3, step

    kernels = [
        {"name": "trace_fwd", "route": "cuda",
         "source": "micro_raytracer_tpu_torch/csrc/trace_fwd.cu",
         "replaces": "micro_raytracer_tpu/ops/pallas_step.py:1313",
         "launches": counts[step.KERNEL.name], **results["trace_fwd"]},
        {"name": "closest_hit", "route": "cuda",
         "source": "micro_raytracer_tpu_torch/csrc/hit3.cu",
         "replaces": "micro_raytracer_tpu/ops/pallas_hit3.py:803",
         "launches": counts[hit3.KERNEL.name], **results["closest_hit"]},
    ]
    log(f"main path: {json.dumps(main_res)}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
