"""`raytrace` CLI of the PyTorch port: flag surface, merge semantics and the
render loop of ``micro_raytracer_tpu.frontends.cli``.

Merge precedence (cli.rs:78-153):

  full JSON -> bounce/sample/loss overrides -> frame JSON -> res/ssaa/--cam
  -> scene JSON -> --obj/--light appended -> --sky replaced

then the render loop (cli.rs:155-177) with the same ``cli:*`` log lines.
``--device`` picks the render device (default ``cuda``; no fallback to the
CPU). ``--devices N [--sp S]`` renders over a (N / S, S) mesh of that kind
of device (``parallel/mesh.py``: the first N cards, raising where the
machine has fewer; on the CPU, the CPU named N times), rays over dp and
samples over sp; ``--sp`` without ``--devices`` is refused.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time

from ..models import schema
from . import miniargs

log = logging.getLogger("raytrace")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raytrace",
        description="Tiny raytracing microservice (PyTorch/CUDA).",
    )
    p.add_argument("full", nargs="?", metavar="FILE.json",
                   help="Full render description json input filename")
    p.add_argument("-v", "--verbose", action="store_true", help="Enable logging")
    p.add_argument("--pretty", action="store_true",
                   help="Print full render info in json with prettifier")
    p.add_argument("-d", "--dry", action="store_true",
                   help="Dry run (useful with verbose)")
    p.add_argument("-o", "--output", metavar="FILE.EXT",
                   help="Final image output filename")
    p.add_argument("--http", metavar="address", help="Launch http server")
    p.add_argument("--bounce", type=int, help="Max ray bounce")
    p.add_argument("--sample", type=int, help="Max path-tracing samples")
    p.add_argument("--loss", type=float, help="Ray bounce energy loss")
    p.add_argument("-u", "--update", action="store_true",
                   help="Save output on each sample")
    p.add_argument("-w", "--worker", type=int,
                   help="Parallel workers count (CPU-compat, ignored)")
    p.add_argument("--dim", type=int,
                   help="Parallel jobs count on each dimension (chunk hint)")
    p.add_argument("-s", "--scene", metavar="FILE.json",
                   help="Scene description json input filename")
    p.add_argument("-f", "--frame", metavar="FILE.json",
                   help="Frame description json input filename")
    p.add_argument("--res", nargs=2, type=int, metavar=("w", "h"),
                   help="Frame output image resolution")
    p.add_argument("--ssaa", type=float, help="Output image SSAAx antialiasing")
    p.add_argument("--cam", nargs="+", metavar="param",
                   help="Add camera to the scene (key: value tokens)")
    p.add_argument("--obj", nargs="*", action="append", metavar="param",
                   help="Add renderer to the scene (key: value tokens)")
    p.add_argument("--light", nargs="*", action="append", metavar="param",
                   help="Add light source to the scene (key: value tokens)")
    p.add_argument("--sky", nargs="+", metavar="param",
                   help="Scene sky color: r g b pwr")
    p.add_argument("--devices", type=int,
                   help="Render across N devices of --device's kind")
    p.add_argument("--sp", type=int,
                   help="Sample-parallel axis size within --devices "
                        "(default 1)")
    p.add_argument("--device", default="cuda",
                   help="Render device: cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=0, help="RNG seed")
    p.add_argument("--resume", metavar="FILE.npz",
                   help="Resume a progressive render from saved state")
    p.add_argument("--save-state", metavar="FILE.npz",
                   help="Persist progressive state after rendering")
    return p


def _flatten(groups):
    out = []
    for g in groups:
        out.extend(g)
    return out


def parse_render(args) -> schema.RenderConfig:
    """Merge files and flags into one RenderConfig (cli.rs:78-153)."""
    d = {}
    if args.full:
        with open(args.full) as f:
            d = json.load(f)
    cfg = schema.RenderConfig.from_json(d)

    if args.bounce is not None:
        cfg.rt.bounce = args.bounce
    if args.sample is not None:
        cfg.rt.sample = args.sample
    if args.loss is not None:
        cfg.rt.loss = args.loss

    if args.frame:
        with open(args.frame) as f:
            cfg.frame = schema.FrameConfig.from_json(json.load(f))
    if args.res is not None:
        cfg.frame.res = (args.res[0], args.res[1])
    if args.ssaa is not None:
        cfg.frame.ssaa = args.ssaa
    if args.cam is not None:
        # --cam REPLACES the camera with a freshly-defaulted one (cli.rs:127)
        cfg.frame.cam = schema.CameraConfig.from_json(
            miniargs.parse_camera(args.cam))

    if args.scene:
        with open(args.scene) as f:
            cfg.scene = schema.SceneConfig.from_json(json.load(f))
    if args.obj is not None:
        new_objs = miniargs.parse_objects(_flatten(args.obj))
        cfg.scene.objects.extend(
            schema.ObjectConfig.from_json(o) for o in new_objs)
    if args.light is not None:
        new_lights = miniargs.parse_lights(_flatten(args.light))
        cfg.scene.lights.extend(
            schema.LightConfig.from_json(lt) for lt in new_lights)
    if args.sky is not None:
        cfg.scene.sky = schema.SkyConfig.from_json(miniargs.parse_sky(args.sky))
    return cfg


def _save(img, filename: str) -> None:
    if filename.lower().endswith(".png"):
        from .. import native

        if native.available():
            native.png_write(filename, img)
            return
    from PIL import Image

    Image.fromarray(img).save(filename)


def make_cli_mesh(args):
    """The mesh of ``--devices`` / ``--sp`` (None without them)."""
    if args.devices is None:
        return None
    from ..parallel.mesh import make_mesh

    mesh = make_mesh(args.devices, sp=args.sp or 1, device=args.device)
    log.info("cli:mesh: %s", mesh.shape)
    return mesh


def raytrace(args, cfg: schema.RenderConfig) -> float:
    """Render loop (cli.rs:155-177): sample passes, --update, final save."""
    from ..models.render import Renderer
    from ..utils.profiling import device_trace, rays_per_second

    chunk = max(1024, args.dim * args.dim) if args.dim else None
    mesh = make_cli_mesh(args)
    r = Renderer(cfg, seed=args.seed, chunk=chunk, device=args.device,
                 mesh=mesh)
    if args.resume:
        r.load_state(args.resume)
    filename = args.output or "out.png"

    t0 = time.perf_counter()
    remaining = cfg.rt.sample - (r.count if args.resume else 0)
    # --update renders one sample per pass so every sample can be saved
    step = 1 if args.update else min(max(remaining, 1), 64)
    sample = r.count
    with device_trace():
        while sample < cfg.rt.sample:
            n = min(step, cfg.rt.sample - sample)
            dt = r.execute_many(n)
            sample += n
            log.info("cli:sample:%d: %.3fs (%.2fM rays/s)", sample - 1, dt,
                     rays_per_second(r.n_pix, n, dt) / 1e6)
            if args.update:
                _save(r.img(), filename)

    _save(r.img(), filename)
    if args.save_state:
        r.save_state(args.save_state)
    return time.perf_counter() - t0


def main(argv=None) -> int:
    """`raytrace` entry point (bin/raytrace.rs:12-57)."""
    args = build_parser().parse_args(argv)

    logging.basicConfig(
        stream=sys.stdout,
        format="%(asctime)s [%(levelname)s] %(message)s",
        level=logging.INFO if args.verbose else logging.ERROR,
    )

    try:
        if args.sp is not None and args.devices is None:
            raise ValueError("--sp needs --devices")
        if args.http:
            logging.getLogger().setLevel(logging.INFO)
            from .http import HttpServer

            HttpServer(args.http, device=args.device, devices=args.devices,
                       sp=args.sp).start()  # blocks
            return 0

        cfg = parse_render(args)
        if args.pretty:
            log.info("cli:render: %s", json.dumps(cfg.to_json(), indent=2))
        else:
            log.info("cli:render: %s", json.dumps(cfg.to_json()))
        if args.dry:
            return 0

        dt = raytrace(args, cfg)
        log.info("cli:done: %.3fs", dt)
        return 0
    except (ValueError, OSError, KeyError, NotImplementedError) as e:
        log.error("cli: %s", e)
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
