"""Progressive frame renderer: the counterpart of the reference Sampler.

The frame is a flat padded pixel buffer in Morton ray order, rendered in
fixed-size chunks; samples accumulate into a float32 framebuffer on the
render device (progressive rendering, cli.rs:162-170). Progressive state
(accumulator, count, generator state) is exposed for checkpoint/resume.

A render runs over a (dp, sp) device mesh (``parallel/mesh.py``; the JAX
package's ``_make_sp_chunk_fn``), one device being the (1, 1) mesh: each
chunk's rays are cut into dp contiguous parts,
part ``i`` accumulating on its owner ``devices[i][0]``, and the samples of
a pass are spread over sp: sample ``s`` of a chunk runs on the devices of
column ``s % sp``. Every (chunk, sample, ray) takes the uniforms the
one-device render of the same seed takes: they are drawn from the
renderer's generator on the primary device in the one-device order, and
each device gets its rays' part. So with sp = 1 the framebuffer is the
one-device one bit for bit, and with sp > 1 it differs by the order of
float32 sums (each column's samples summed apart, then added).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import step, tonemap
from ..ops.rng import make_generator
from ..parallel.mesh import make_mesh, to_device
from ..utils.device import require_device
from .compiler import compile_camera, compile_scene
from .schema import RenderConfig
from .tracer import draw_uniforms, trace_radiance_u


def _part1by1(v: np.ndarray) -> np.ndarray:
    """Spread the low 32 bits of ``v`` into the even bit positions."""
    v = v.astype(np.uint64)
    v = (v | (v << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
    v = (v | (v << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    v = (v | (v << np.uint64(2))) & np.uint64(0x3333333333333333)
    v = (v | (v << np.uint64(1))) & np.uint64(0x5555555555555555)
    return v


def morton_ray_order(nw: int, nh: int) -> np.ndarray:
    """Pixel flat indices (y*nw+x) in Morton (Z-curve) order: ray slot ``i``
    renders pixel ``order[i]``, so neighbouring rays (one warp) start from
    neighbouring pixels and take similar paths."""
    ys, xs = np.divmod(np.arange(nw * nh, dtype=np.int64), nw)
    code = _part1by1(xs) | (_part1by1(ys) << np.uint64(1))
    return np.argsort(code, kind="stable").astype(np.int64)


RAY_LAYOUT = "morton1"  # bump when the ray->pixel mapping changes


def _pick_chunk(n_pix: int, device: torch.device) -> int:
    """Rays per trace call.

    On the card one call runs one thread per ray, and each call pays a
    fixed host cost (camera rays, uniform draws, accumulation: a few dozen
    small launches), so one chunk should cover the frame: a 1080x1080 frame
    (1.17M rays) is one call. The cap of 2^21 rays bounds the per-call
    uniform stack (9 steps x 8 rows x 4 B = 288 B per ray, 604 MB at the
    cap) on an 80 GB card. On the CPU the dense plain path holds (R, P)
    intermediates per light, so chunks stay at 2^15 rays."""
    cap = 1 << 21 if device.type == "cuda" else 1 << 15
    return min(cap, -(-n_pix // 1024) * 1024)


class Renderer:
    """Progressive renderer over a compiled scene, over a device ``mesh``
    (``parallel/mesh.py``), by default the one device ``device``; the
    mesh's primary device is the render device.

    ``execute_many(n)`` adds n samples per pixel, ``img()`` tonemaps the
    running mean (sampler.rs:11-99)."""

    def __init__(self, config: RenderConfig, seed: int = 0,
                 chunk: int | None = None, device="cuda", mesh=None):
        self.mesh = mesh or make_mesh(1, sp=1, device=[device])
        self.device = self.mesh.primary
        self.config = config
        self.scene = compile_scene(config.scene, self.device)
        self.cam = compile_camera(config.frame.cam, self.device)
        # the scene's frames and kernel tables, built once for every sample
        self.tables = step.pack_step(self.scene)
        self.render_wh = config.frame.render_res
        nw, nh = self.render_wh
        self.n_pix = nw * nh
        dp = self.mesh.shape["dp"]
        self.chunk = chunk or _pick_chunk(self.n_pix, self.device)
        self.chunk = -(-self.chunk // dp) * dp
        n_pad = -(-self.n_pix // self.chunk) * self.chunk
        order = morton_ray_order(nw, nh)
        # padding ray slots re-render pixel 0; their accum rows are dropped
        pix = np.concatenate([order, np.zeros(n_pad - self.n_pix, np.int64)])
        ys, xs = np.divmod(pix, nw)
        coords = np.stack([xs, ys], axis=-1).astype(np.float32)
        inv = np.empty(self.n_pix, np.int64)
        inv[order] = np.arange(self.n_pix, dtype=np.int64)
        self._inv_order = torch.from_numpy(inv).to(self.device)
        coords = torch.from_numpy(coords.reshape(-1, self.chunk, 2))
        self.n_chunks = coords.shape[0]
        # per distinct device of the mesh: its scene, camera and tables
        self._local = {self.device: (self.scene, self.cam, self.tables)}
        for dev in self.mesh.distinct():
            if dev not in self._local:
                s = to_device(self.scene, dev)
                self._local[dev] = (s, to_device(self.cam, dev),
                                    step.pack_step(s))
        # per ray part: its coordinates on each device of its row and its
        # accumulator on its owner
        part = self.chunk // dp
        self._parts = [slice(i * part, (i + 1) * part) for i in range(dp)]
        self._coords = {(i, dev): coords[:, sl].to(dev)
                        for i, sl in enumerate(self._parts)
                        for dev in self.mesh.devices[i]}
        self._accum = [torch.zeros((self.n_chunks, part, 3),
                                   dtype=torch.float32,
                                   device=self.mesh.owner(i))
                       for i in range(dp)]
        self.count = 0
        self.gen = make_generator(seed, self.device)
        self._loss = float(config.rt.loss)

    # -- sampling ----------------------------------------------------------
    def execute(self) -> float:
        """One path-tracing sample for every pixel; returns elapsed seconds."""
        return self.execute_many(1)

    def execute_many(self, n_samples: int) -> float:
        """Add ``n_samples`` paths per pixel; returns seconds, measured after
        every device finished (``torch.cuda.synchronize``)."""
        t0 = time.perf_counter()
        for c in range(self.n_chunks):
            self._execute_chunk(c, n_samples)
        for dev in self.mesh.distinct():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        self.count += n_samples
        return time.perf_counter() - t0

    def _execute_chunk(self, c: int, n_samples: int):
        """``n_samples`` samples of chunk ``c``: sample ``s`` on column ``s
        % sp``, its uniforms drawn as the one-device render draws them;
        with sp = 1 each sample is added into its owner's accumulator as
        it comes (the one-device order), else each column sums its samples
        and the sums are added in column order."""
        bounce = self.config.rt.bounce
        sp = self.mesh.shape["sp"]
        sums = {}
        for s in range(n_samples):
            u_aprt, u8s = draw_uniforms(self.gen, self.chunk, bounce,
                                        self.scene.any_refract, self.device)
            j = s % sp
            for i, sl in enumerate(self._parts):
                dev = self.mesh.devices[i][j]
                scene, cam, tables = self._local[dev]
                rad = trace_radiance_u(
                    scene, cam, self.render_wh, bounce, self._loss,
                    self._coords[i, dev][c], u_aprt[sl].to(dev),
                    u8s[:, :, sl].contiguous().to(dev), tables)
                if sp == 1:
                    self._accum[i][c] += rad
                elif (i, j) in sums:
                    sums[i, j] += rad
                else:
                    sums[i, j] = rad
        for (i, _j), v in sorted(sums.items()):
            self._accum[i][c] += v.to(self.mesh.owner(i))

    # -- image -------------------------------------------------------------
    def _gathered(self):
        """The accumulator ``(n_chunks, chunk, 3)`` on the render device,
        its ray parts gathered from their owners."""
        return torch.cat([a.to(self.device) for a in self._accum], 1)

    def _frame(self):
        """Running radiance sum as an (nh, nw, 3) tensor on the device."""
        flat = self._gathered().reshape(-1, 3)[self._inv_order]
        nw, nh = self.render_wh
        return flat.reshape(nh, nw, 3)

    def framebuffer(self) -> np.ndarray:
        """Running radiance sum as (nh, nw, 3) float32 (host copy)."""
        return self._frame().cpu().numpy()

    def img(self) -> np.ndarray:
        """Tonemapped, SSAA-downsampled (h, w, 3) uint8 image
        (sampler.rs:80-99), computed on the render device."""
        out = tonemap.finalize(self._frame(), float(max(self.count, 1)),
                               self.cam.gamma, self.cam.exp,
                               self.config.frame.res)
        return out.cpu().numpy()

    # -- checkpoint/resume ---------------------------------------------------
    def save_state(self, path: str) -> None:
        """Persist progressive state (framebuffer, count, generator state)."""
        np.savez(path, accum=self._gathered().reshape(-1, 3).cpu().numpy(),
                 count=self.count,
                 gen_state=self.gen.get_state().cpu().numpy(),
                 render_wh=np.asarray(self.render_wh), chunk=self.chunk,
                 layout=RAY_LAYOUT)

    def load_state(self, path: str) -> None:
        data = np.load(path)
        saved_wh = tuple(int(v) for v in data["render_wh"]) \
            if "render_wh" in data else None
        if saved_wh is not None and saved_wh != tuple(self.render_wh):
            raise ValueError(
                f"saved state was rendered at {saved_wh}, current render "
                f"resolution is {tuple(self.render_wh)} — resume with the "
                "same --res/--ssaa settings")
        saved_layout = str(data["layout"]) if "layout" in data else "rowmajor"
        if saved_layout != RAY_LAYOUT:
            raise ValueError(
                f"saved state uses ray layout {saved_layout!r}, this build "
                f"renders in {RAY_LAYOUT!r} — the accumulator rows would map "
                "to the wrong pixels; restart the render")
        if "gen_state" not in data:
            raise ValueError("saved state holds no generator state (it was "
                             "not written by this renderer)")
        want = self.n_chunks * self.chunk
        if data["accum"].shape[0] != want:
            raise ValueError(
                f"saved state holds {data['accum'].shape[0]} accumulator rows "
                f"but the current render settings need {want} "
                f"({self.n_chunks} chunks x {self.chunk}) — state was saved "
                "with different render/chunk settings")
        accum = torch.from_numpy(data["accum"]).reshape(
            self.n_chunks, self.chunk, 3)
        self._accum = [accum[:, sl].to(self.mesh.owner(i)).contiguous()
                       for i, sl in enumerate(self._parts)]
        self.count = int(data["count"])
        self.gen.set_state(torch.from_numpy(data["gen_state"]))


def render_image(config: RenderConfig, seed: int = 0, on_sample=None,
                 samples_per_pass: int | None = None,
                 device="cuda", mesh=None) -> np.ndarray:
    """Render a full frame: ``rt.sample`` progressive passes then tonemap.
    ``on_sample(i, seconds, renderer)`` runs after each pass."""
    r = Renderer(config, seed=seed, device=device, mesh=mesh)
    total = config.rt.sample
    step = samples_per_pass or (1 if on_sample else total)
    done = 0
    while done < total:
        n = min(step, total - done)
        dt = r.execute_many(n)
        done += n
        if on_sample:
            on_sample(done - 1, dt, r)
    return r.img()
