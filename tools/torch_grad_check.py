#!/usr/bin/env python3
"""Gradient gates of the PyTorch port: the fused path's gradient (the
whole-trace kernels on the card, the plain trace on the CPU) against the
record path's (``tracer.trace_records`` / ``shade_records`` through the
differentiable closest hit ``hit3.ClosestHit``: ``csrc/hit3.cu`` and its
VJP ``csrc/hit3_bwd.cu`` on the card), and a finite-difference
self-check of both.

The counterpart of the JAX package's ``tools/grad_check.py`` (its
gradient agreement and finite-difference gates; no timing), on the port
alone. Both routes draw the same uniforms from the same generator and
differ only by float reassociation, so their gradients must agree; where
paths split between the two routes (a float32 rounding flip of a branch)
the difference is statistically a small resampling, so each leaf's gate is
the larger of the scene's base gate and twice the fused path's own
difference under a fresh generator (the Monte-Carlo resampling noise):
a mis-scaled backward exceeds both.

The finite-difference self-check perturbs each leaf of ``FD_LEAVES`` (they
enter no branch or hit decision, so every path stays the same) by +-h along
ones and holds the central difference of the loss against the analytic
directional derivative, relative gate ``--fd-gate``, on both routes.

Scenes: ``chip_smoke.py``'s in-repo stand-ins for the JAX tool's
``SCENE_DEFAULTS`` (the reference's example scenes are not in the
repository): ``CornellBox`` the slice room (gate 5e-3, a centred block of
pixels), ``dof`` ``tex_dof`` (5e-3, block), ``Mesh`` ``mesh_glass`` (2e-2,
interior pixels: every pixel of their 5 x 5 neighbourhood primary-hits the
same mesh group, away from silhouettes).

Usage:
  python3 tools/torch_grad_check.py [--scene CornellBox|dof|Mesh]
      [--device cuda|cpu] [--res 256] [--rays 8192] [--samples 2]
      [--bounce N] [--gate G] [--pixels block|interior] [--fd-gate 0.05]
      [--no-fd]
Prints JSON lines: one per leaf, one per finite-difference leaf and route,
one summary. Exit 0 iff every gate passes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SCENE_DEFAULTS = {
    "CornellBox": {"gate": 5e-3, "pixels": "block"},
    "dof": {"gate": 5e-3, "pixels": "block"},
    "Mesh": {"gate": 2e-2, "pixels": "interior"},
}
# leaves that enter no branch or hit decision: perturbing them keeps every
# path, so the central difference of the loss is exact up to float noise
FD_LEAVES = ("mat_albedo", "light_pwr", "light_color", "sky_color",
             "sky_pwr")
FD_H = 2e-3
SEED, MC_SEED = 7, 1007


def scene_config(name):
    """The render config of a stand-in (chip_smoke.py builds them)."""
    import chip_smoke

    if name == "CornellBox":
        return chip_smoke.slice_config()
    if name == "dof":
        return chip_smoke.tex_config("tex_dof")
    if name == "Mesh":
        return chip_smoke.mesh_config("mesh_glass")
    raise ValueError(f"unknown scene {name}")


def interior_coords(scene, cam, wh, n, dev):
    """Pixels whose 5 x 5 neighbourhood primary-hits one mesh group,
    probed at pixel centres with centred aperture uniforms (a 2-pixel
    erosion margin covers the aperture jitter), ``n`` of them spread over
    the set (repeated to fill ``n``); None if there are none."""
    import numpy as np
    import torch

    from micro_raytracer_tpu_torch.models import camera, schema
    from micro_raytracer_tpu_torch.ops import hit3, step

    W, H = wh
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    coords = torch.from_numpy(np.stack([xs.ravel(), ys.ravel()], -1)).to(
        dev, torch.float32)
    u = torch.full((coords.shape[0], 2), 0.5, device=dev)
    o, d = camera.gen_rays(cam, wh, coords, u)
    tables = step.pack_step(scene)
    with torch.no_grad():
        te, row, _tx, _xrow = hit3.closest_hit(
            tables.tab, tables.layout, o, d, step.primary_mode(scene),
            tables.tri, tables.tbb, tables.sbb, step._walk(tables),
            tables.box)
    s = scene.seg(schema.KIND_TRIANGLE)
    idx = row.long().cpu().numpy()
    gid = scene.group_id.cpu().numpy()[idx]
    in_tri = (te < hit3.BIG * 0.5).cpu().numpy() & (idx >= s.start) \
        & (idx < s.stop)
    gmap = np.where(in_tri, gid, -1).reshape(H, W)
    inner = gmap >= 0
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            inner &= np.roll(np.roll(gmap, dy, 0), dx, 1) == gmap
    inner[:2] = inner[-2:] = False
    inner[:, :2] = inner[:, -2:] = False
    iy, ix = np.nonzero(inner)
    if iy.size == 0:
        return None
    take = np.linspace(0, iy.size - 1, min(n, iy.size)).astype(np.int64)
    sel = np.stack([ix[take], iy[take]], -1).astype(np.float32)
    sel = np.tile(sel, (-(-n // sel.shape[0]), 1))[:n]
    return torch.from_numpy(sel).to(dev)


def block_coords(wh, n, dev):
    """A centred block of ``n`` pixels (the top rows of a closed room can
    be dark, which would zero most leaves' gradients)."""
    import numpy as np
    import torch

    W, H = wh
    start = max(0, (W * H - n) // 2)
    ys, xs = np.divmod(start + np.arange(n, dtype=np.int64), W)
    return torch.from_numpy(np.stack([xs % W, ys % H], -1).astype(
        np.float32)).to(dev)


class Problem:
    """The loss of one route as a function of the trainable leaves:
    ``sum over samples of mean((radiance - 0.25)^2)``, each sample's
    uniforms from a generator seeded with ``seed`` and the sample index."""

    def __init__(self, cfg, dev, wh, coords, samples, bounce):
        from micro_raytracer_tpu_torch.models.compiler import (
            compile_camera, compile_scene)
        from micro_raytracer_tpu_torch.parallel import shard

        self.scene = compile_scene(cfg.scene, dev)
        self.cam = compile_camera(cfg.frame.cam, dev)
        self.params, _ = shard.split_params(self.scene)
        self.params = {k: v.detach().clone()
                       for k, v in self.params.items()}
        self.dev, self.wh, self.coords = dev, wh, coords
        self.samples, self.bounce = samples, bounce
        self.loss_cfg = cfg.rt.loss

    def loss(self, params, fused, seed):
        import torch

        from micro_raytracer_tpu_torch.models import tracer
        from micro_raytracer_tpu_torch.parallel import shard

        s = shard.merge_params(self.scene, params)
        total = 0.0
        for i in range(self.samples):
            gen = torch.Generator(device=self.dev).manual_seed(
                seed * 1000 + i)
            rad = tracer.trace_radiance(s, self.cam, self.wh, self.bounce,
                                        self.loss_cfg, self.coords, gen,
                                        fused=fused)
            total = total + torch.mean((rad - 0.25) ** 2)
        return total

    def grads(self, fused, seed=SEED):
        import torch

        p = {k: v.clone().requires_grad_(True) for k, v in self.params.items()}
        loss = self.loss(p, fused, seed)
        loss.backward()
        return {k: (v.grad if v.grad is not None else torch.zeros_like(v))
                .detach() for k, v in p.items()}

    def fd(self, fused, grads, h=FD_H):
        """``{leaf: (fd, analytic, rel)}`` along ones for FD_LEAVES."""
        import torch

        out = {}
        with torch.no_grad():
            for leaf in FD_LEAVES:
                base = self.params.get(leaf)
                if base is None or base.numel() == 0:
                    continue
                v = torch.ones_like(base)
                vals = []
                for sgn in (1.0, -1.0):
                    p = dict(self.params)
                    p[leaf] = base + sgn * h * v
                    vals.append(float(self.loss(p, fused, SEED)))
                fd = (vals[0] - vals[1]) / (2.0 * h)
                an = float((grads[leaf] * v).sum())
                scale = max(abs(an), abs(fd))
                out[leaf] = (fd, an, abs(fd - an) / (scale + 1e-12), scale)
        return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="torch_grad_check")
    p.add_argument("--scene", default="CornellBox",
                   choices=sorted(SCENE_DEFAULTS))
    p.add_argument("--device", default="cuda")
    p.add_argument("--res", type=int, default=256)
    p.add_argument("--rays", type=int, default=8192)
    p.add_argument("--samples", type=int, default=2)
    p.add_argument("--bounce", type=int, default=None,
                   help="bounce depth (default: the scene's)")
    p.add_argument("--gate", type=float, default=None)
    p.add_argument("--pixels", default=None, choices=("block", "interior"))
    p.add_argument("--fd-gate", type=float, default=0.05)
    p.add_argument("--no-fd", action="store_true")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from micro_raytracer_tpu_torch.utils.device import require_device

    dev = require_device(args.device)
    defaults = SCENE_DEFAULTS[args.scene]
    gate_arg = args.gate if args.gate is not None else defaults["gate"]
    pixels = args.pixels or defaults["pixels"]
    cfg = scene_config(args.scene)
    bounce = cfg.rt.bounce if args.bounce is None else args.bounce
    wh = (args.res, args.res)
    prob = Problem(cfg, dev, wh, None, args.samples, bounce)
    coords = None
    if pixels == "interior":
        coords = interior_coords(prob.scene, prob.cam, wh, args.rays, dev)
        if coords is None:
            print(json.dumps({"warn": "no interior pixels; block pixels"}))
            pixels = "block"
    if coords is None:
        coords = block_coords(wh, args.rays, dev)
    prob.coords = coords

    g_fused = prob.grads(True)
    g_mc = prob.grads(True, MC_SEED)
    g_rec = prob.grads(False)
    ok, worst, worst_excess = True, 0.0, 0.0
    for k in sorted(g_fused):
        a, b, m = (x.double().cpu().numpy() for x in
                   (g_fused[k], g_rec[k], g_mc[k]))
        scale = float(np.abs(a).max()) if a.size else 0.0
        ad = float(np.abs(a - b).max()) if a.size else 0.0
        md = float(np.abs(a - m).max()) if a.size else 0.0
        rel, mrel = ad / (scale + 1e-12), md / (scale + 1e-12)
        leaf_gate = max(gate_arg, 2.0 * mrel)
        passed = scale <= 1e-6 or rel < leaf_gate
        if scale > 1e-6:
            worst = max(worst, rel)
            worst_excess = max(worst_excess, rel / leaf_gate)
        ok = ok and passed
        print(json.dumps({"leaf": k, "max_abs_diff": ad, "ref_scale": scale,
                          "rel": rel, "mc_rel": mrel, "gate": leaf_gate,
                          "pass": passed}), flush=True)

    fd_ok, fd_worst = True, {}
    if not args.no_fd:
        for route, fused, g in (("fused", True, g_fused),
                                ("record", False, g_rec)):
            worst_r = 0.0
            for leaf, (fd, an, rel, scale) in prob.fd(fused, g).items():
                if scale > 1e-6:
                    worst_r = max(worst_r, rel)
                print(json.dumps({"fd_leaf": leaf, "route": route, "fd": fd,
                                  "analytic": an, "rel": rel}), flush=True)
            fd_worst[route] = worst_r
            fd_ok = fd_ok and worst_r < args.fd_gate
    print(json.dumps({"scene": args.scene, "device": str(dev),
                      "pixels": pixels, "rays": int(coords.shape[0]),
                      "samples": args.samples, "bounce": bounce,
                      "grad_match": ok, "worst_rel": worst,
                      "worst_gate_excess": worst_excess,
                      "gate": gate_arg, "fd_worst_rel": fd_worst,
                      "fd_gate": args.fd_gate, "fd_match": fd_ok,
                      "ok": ok and fd_ok}), flush=True)
    return 0 if ok and fd_ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
