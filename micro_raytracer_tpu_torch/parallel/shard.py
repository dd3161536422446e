"""The differentiable training step, on one device.

The counterpart of ``micro_raytracer_tpu.parallel.shard``'s
``make_train_step`` without the mesh: an inverse-rendering step that
renders the scene from its current parameters, takes the L2 loss against a
target image, backpropagates through the whole trace (on the card: the
primary-hit kernel, the train instance of the trace kernel and the
backward kernel; on the CPU: autograd through the plain trace) and applies
SGD to every trainable scene leaf. Pixel (``dp``) and sample (``sp``)
sharding across devices are not ported yet; asking for more than one
device raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import tracer
from ..utils.device import require_device

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


def make_train_step(render_wh, bounce: int, lr: float = 1e-2,
                    device="cuda", n_devices: int = 1,
                    remat: bool = False) -> TrainStep:
    """The training step of JAX's ``make_train_step`` (shard.py:70-106) on
    one device: L2 against a target, ``loss.backward()``, SGD; ``remat``
    checkpoints each bounce of the record path (``MRT_NO_FUSE=1``)."""
    if n_devices != 1:
        raise ValueError("make_train_step: multi-device not yet ported")
    return TrainStep(render_wh, bounce, lr, device, remat)


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
