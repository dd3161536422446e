"""The differentiable training step and sharded rendering over devices.

The counterpart of ``micro_raytracer_tpu.parallel.shard``. On one device,
:class:`TrainStep` is an inverse-rendering step that renders the scene
from its current parameters, takes the L2 loss against a target image,
backpropagates through the whole trace (on the card: the primary-hit
kernel, the train instance of the trace kernel and the backward kernel;
on the CPU: autograd through the plain trace) and applies SGD to every
trainable scene leaf. Over a (dp, sp) mesh (``parallel/mesh.py``) the rays
are cut into dp contiguous parts and each part is traced with sp draws of
the uniforms, one a device of its row of the grid:
:func:`make_sharded_render` averages the sp draws (JAX's ``pmean`` over
sp), and :class:`ShardedTrainStep` takes each part's loss on its
sp-averaged radiance and averages the losses over dp, so its gradient is
JAX's ``pmean`` over dp and sp of the per-device gradients. One process
issues every device's work; the parameters live on the primary device
and reach the others as differentiable copies, so their gradients meet
there, where the SGD step runs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import tracer
from ..ops import step as step_mod
from ..utils.device import require_device
from .mesh import make_mesh, to_device

# Scene leaves treated as trainable: material params, light power/color,
# sky, and object transforms (shard.py:30-34 of the JAX package).
TRAINABLE_FIELDS = (
    "mat_albedo", "mat_rough", "mat_metal", "mat_glass", "mat_opacity",
    "mat_emit", "light_pwr", "light_color", "sky_color", "sky_pwr",
    "inst_pos", "inst_dir",
)


def split_params(scene):
    """Split a compiled scene into (trainable dict, remainder scene)."""
    params = {k: getattr(scene, k) for k in TRAINABLE_FIELDS}
    return params, scene


def merge_params(scene, params):
    return dataclasses.replace(scene, **params)


def params_from_numpy(d: dict, device="cuda") -> dict:
    """Trainable leaves from numpy arrays (such as the JAX package's
    parameters): float32 tensors on ``device`` that require a gradient."""
    dev = require_device(device)
    return {k: torch.tensor(np.asarray(d[k], np.float32), device=dev,
                            requires_grad=True) for k in TRAINABLE_FIELDS}


class TrainStep:
    """One SGD step of the L2 inverse-rendering loss.

    ``step(params, scene, cam, loss_cfg, coords, target, gen)`` draws the
    aperture and path uniforms from ``gen``; ``step_u(..., u_aprt, u8s)``
    takes them explicitly. Both return ``(loss, new_params)``: the loss
    before the step, and fresh leaves ``p - lr * grad`` that require a
    gradient. The gradients stay on the given leaves (``params[k].grad``).
    The radiance is ``tracer.trace_radiance_u``'s: the fused path, or the
    record path under ``MRT_NO_FUSE=1``, each bounce checkpointed there
    with ``remat``.
    """

    def __init__(self, render_wh, bounce: int, lr: float, device,
                 remat: bool = False):
        self.render_wh = tuple(render_wh)
        self.bounce = bounce
        self.lr = lr
        self.device = require_device(device)
        self.remat = remat

    def step_u(self, params, scene, cam, loss_cfg, coords, target, u_aprt,
               u8s):
        if coords.device.type != self.device.type:
            raise ValueError(f"train step on {self.device}: coords are on "
                             f"{coords.device}")
        for p in params.values():
            p.grad = None
        s = merge_params(scene, params)
        rad = tracer.trace_radiance_u(s, cam, self.render_wh, self.bounce,
                                      loss_cfg, coords, u_aprt, u8s,
                                      remat=self.remat)
        loss = torch.mean((rad - target) ** 2)
        loss.backward()
        with torch.no_grad():
            new = {k: (p - self.lr * p.grad if p.grad is not None
                       else p.detach().clone()).requires_grad_(True)
                   for k, p in params.items()}
        return loss.detach(), new

    def step(self, params, scene, cam, loss_cfg, coords, target, gen):
        u_aprt, u8s = tracer.draw_uniforms(gen, coords.shape[0], self.bounce,
                                           scene.any_refract, coords.device)
        return self.step_u(params, scene, cam, loss_cfg, coords, target,
                           u_aprt, u8s)


def _draw_samples(gen, n_rays: int, bounce: int, any_refract: bool, device,
                  sp: int):
    """``(u_aprt (sp, R, 2), u8s (sp, bounce + 1, NU, R))``: sp samples'
    uniforms for every ray, drawn from ``gen`` one sample after the other
    as :func:`tracer.trace_radiance` draws one."""
    draws = [tracer.draw_uniforms(gen, n_rays, bounce, any_refract, device)
             for _ in range(sp)]
    return (torch.stack([a for a, _ in draws]),
            torch.stack([u for _, u in draws]))


def _part_radiance(mesh, coords, u_aprt, u8s, trace, what):
    """Per ray part ``i`` of ``coords`` (dp equal contiguous parts), its
    radiance averaged over the sp samples, each traced on device ``(i,
    j)`` by ``trace(dev, coords, u_aprt, u8s)`` and added on the part's
    owner: ``[(slice, radiance on the owner)]``."""
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    R = coords.shape[0]
    if R % dp:
        raise ValueError(f"{what}: {R} rays do not split into dp={dp} parts")
    if u_aprt.shape[0] != sp or u8s.shape[0] != sp:
        raise ValueError(f"{what}: uniforms for {u_aprt.shape[0]} samples, "
                         f"the mesh has sp={sp}")
    part = R // dp
    out = []
    for i in range(dp):
        sl = slice(i * part, (i + 1) * part)
        rad = None
        for j, dev in enumerate(mesh.devices[i]):
            r = trace(dev, coords[sl].to(dev), u_aprt[j, sl].to(dev),
                      u8s[j, :, :, sl].contiguous().to(dev)).to(mesh.owner(i))
            rad = r if rad is None else rad + r
        out.append((sl, rad / sp))
    return out


class ShardedTrainStep(TrainStep):
    """:class:`TrainStep` over a (dp, sp) ``mesh``: ray part ``i`` of
    ``coords`` (dp equal contiguous parts) is traced on device ``(i, j)``
    with sample ``j``'s uniforms, the sp radiances are averaged on the
    part's owner, the part's L2 loss is taken there, and the loss is the
    mean of the dp parts' (JAX's ``pmean``s over dp and sp). With one
    device and sp = 1 it is :class:`TrainStep` bit for bit.

    ``step_u`` takes ``u_aprt`` ``(sp, R, 2)`` and ``u8s`` ``(sp, bounce +
    1, NU, R)``: sample ``j``'s uniforms for every ray; ``step`` draws them
    from ``gen``, sample after sample, each as :class:`TrainStep` draws
    its one. The new leaves are on the primary device; every device gets
    them as copies at the next step."""

    def __init__(self, mesh, render_wh, bounce: int, lr: float,
                 remat: bool = False):
        super().__init__(render_wh, bounce, lr, mesh.primary, remat)
        self.mesh = mesh

    def step_u(self, params, scene, cam, loss_cfg, coords, target, u_aprt,
               u8s):
        for p in params.values():
            p.grad = None

        def trace(dev, c, ua, u8):
            s = merge_params(to_device(scene, dev),
                             {k: p.to(dev) for k, p in params.items()})
            return tracer.trace_radiance_u(
                s, to_device(cam, dev), self.render_wh, self.bounce,
                loss_cfg, c, ua, u8, remat=self.remat)

        parts = _part_radiance(self.mesh, coords, u_aprt, u8s, trace,
                               "train step")
        loss = sum(torch.mean((rad - target[sl].to(rad.device)) ** 2)
                   .to(self.device) for sl, rad in parts) / len(parts)
        loss.backward()
        with torch.no_grad():
            new = {k: (p - self.lr * p.grad if p.grad is not None
                       else p.detach().clone()).requires_grad_(True)
                   for k, p in params.items()}
        return loss.detach(), new

    def step(self, params, scene, cam, loss_cfg, coords, target, gen):
        return self.step_u(params, scene, cam, loss_cfg, coords, target,
                           *_draw_samples(gen, coords.shape[0], self.bounce,
                                          scene.any_refract, coords.device,
                                          self.mesh.shape["sp"]))


def make_train_step(render_wh, bounce: int, lr: float = 1e-2,
                    device="cuda", n_devices: int = 1,
                    remat: bool = False, mesh=None) -> TrainStep:
    """The training step of JAX's ``make_train_step`` (shard.py:70-106):
    L2 against a target, ``loss.backward()``, SGD; ``remat`` checkpoints
    each bounce of the record path (``MRT_NO_FUSE=1``). On ``mesh`` (or,
    with ``n_devices`` > 1, on ``make_mesh(n_devices, device=device)``) a
    :class:`ShardedTrainStep`, else one device's :class:`TrainStep`."""
    if mesh is None and n_devices != 1:
        mesh = make_mesh(n_devices, device=device)
    if mesh is not None:
        return ShardedTrainStep(mesh, render_wh, bounce, lr, remat)
    return TrainStep(render_wh, bounce, lr, device, remat)


class ShardedRender:
    """:func:`make_sharded_render`'s function: ``fn(scene, cam, loss,
    coords, gen)`` -> ``(R, 3)`` radiance on the primary device, ray part
    ``i`` traced on the devices of row ``i`` of the mesh, one sample each
    (sample ``j``'s uniforms drawn from ``gen`` for every ray, after sample
    ``j - 1``'s, as :func:`tracer.trace_radiance` draws one), averaged over
    sp; ``call_u`` takes the uniforms ``(sp, R, 2)``, ``(sp, bounce + 1,
    NU, R)``. ``R`` must split into dp parts."""

    def __init__(self, mesh, render_wh, bounce: int):
        self.mesh = mesh
        self.render_wh = tuple(render_wh)
        self.bounce = bounce

    def call_u(self, scene, cam, loss, coords, u_aprt, u8s):
        local = {}
        for dev in self.mesh.distinct():
            s = to_device(scene, dev)
            local[dev] = (s, to_device(cam, dev), step_mod.pack_step(s))

        def trace(dev, c, ua, u8):
            s, cm, tables = local[dev]
            return tracer.trace_radiance_u(s, cm, self.render_wh,
                                           self.bounce, loss, c, ua, u8,
                                           tables)

        return torch.cat([rad.to(self.mesh.primary) for _sl, rad in
                          _part_radiance(self.mesh, coords, u_aprt, u8s,
                                         trace, "sharded render")])

    def __call__(self, scene, cam, loss, coords, gen):
        return self.call_u(scene, cam, loss, coords,
                           *_draw_samples(gen, coords.shape[0], self.bounce,
                                          scene.any_refract, coords.device,
                                          self.mesh.shape["sp"]))


def make_sharded_render(mesh, render_wh, bounce: int) -> ShardedRender:
    """The sharded forward pass of JAX's ``make_sharded_render``
    (shard.py:47-67): coords cut over ``dp``, samples averaged over
    ``sp``."""
    return ShardedRender(mesh, render_wh, bounce)


# the inverse-rendering scene of the JAX package's tools/invert_render.py
_FIT_SCENE = {
    "renderer": [
        {"type": "sphere", "r": 0.5,
         "mat": {"albedo": [0.9, 0.3, 0.2], "rough": 0.8}},
        {"type": "plane", "n": [0, 0, 1], "pos": [0, 0, -0.5],
         "mat": {"albedo": [0.3, 0.5, 0.9], "rough": 1.0}},
    ],
    "light": [{"type": "point", "pos": [-0.6, -1, 0.6], "pwr": 0.6}],
    "sky": {"color": [0.1, 0.1, 0.15], "pwr": 0.5},
}


def main(argv=None) -> int:
    """Fit a perturbed scene's albedos and light power to a target
    rendered from the true scene, printing one JSON line per step:

        python -m micro_raytracer_tpu_torch.parallel.shard --device cpu \\
            --res 16 --steps 3
    """
    import argparse
    import json

    from ..models import schema
    from ..models.compiler import compile_camera, compile_scene

    ap = argparse.ArgumentParser(
        prog="python -m micro_raytracer_tpu_torch.parallel.shard")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--bounce", type=int, default=3)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--target-spp", type=int, default=16)
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    cfg = schema.RenderConfig.from_json({"scene": _FIT_SCENE})
    truth = compile_scene(cfg.scene, dev)
    cam = compile_camera(cfg.frame.cam, dev)
    wh = (args.res, args.res)
    ys, xs = np.divmod(np.arange(args.res * args.res), args.res)
    coords = torch.from_numpy(np.stack([xs, ys], -1)).to(dev, torch.float32)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        target = sum(tracer.trace_radiance(truth, cam, wh, args.bounce,
                                           cfg.rt.loss, coords, gen)
                     for _ in range(args.target_spp)) / args.target_spp
    params, scene = split_params(truth)
    params = {k: v.detach().clone() for k, v in params.items()}
    params["mat_albedo"] = torch.full_like(params["mat_albedo"], 0.5)
    params["light_pwr"] = params["light_pwr"] * 0.3
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    ts = make_train_step(wh, args.bounce, lr=args.lr, device=dev)
    for i in range(args.steps):
        loss, params = ts.step(params, scene, cam, cfg.rt.loss, coords,
                               target, gen)
        print(json.dumps({"step": i, "loss": float(loss)}), flush=True)
    print(json.dumps({k: params[k].detach().cpu().tolist()
                      for k in ("mat_albedo", "light_pwr")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
