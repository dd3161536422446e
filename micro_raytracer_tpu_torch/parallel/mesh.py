"""Device meshes for multi-device rendering and training.

The counterpart of ``micro_raytracer_tpu.parallel.mesh``: a (dp, sp) grid
of devices with two logical axes,

* ``dp``: pixel (ray) parallelism, each chunk's rays cut into dp
  contiguous parts (the reference's tile grid, sampler.rs:28-78);
* ``sp``: sample parallelism, the samples of a pass spread over sp devices
  and their sums added (the reference's tile merge).

One process drives every device of the grid (the counterpart of JAX's
single controller over ``jax.devices()``): work is issued to each device
in turn on its current stream, and the results meet on the devices that
own them. A grid may name one device more than once: the CPU tests run a
mesh of eight ``cpu`` entries (as the JAX tests force eight host devices),
and ``chip_smoke.py`` names its one card twice.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.device import require_device


def _indexed(device) -> torch.device:
    """``device`` as a ``torch.device`` that names its card (``cuda`` is
    the current card), so a tensor already there is where ``.to`` of it
    leaves it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class DeviceMesh:
    """A (dp, sp) grid of ``torch.device``: ``devices[i][j]`` renders part
    ``i`` of the rays and share ``j`` of the samples; ``devices[i][0]``
    owns part ``i``'s sums and ``devices[0][0]`` is the primary device,
    where results are gathered. ``shape`` is ``{"dp": dp, "sp": sp}``."""

    def __init__(self, grid):
        self.devices = [[_indexed(d) for d in row] for row in grid]
        dp, sp = len(self.devices), len(self.devices[0])
        if dp == 0 or sp == 0 or any(len(r) != sp for r in self.devices):
            raise ValueError(f"a mesh is a (dp, sp) grid, got {grid}")
        self.shape = {"dp": dp, "sp": sp}

    @property
    def primary(self) -> torch.device:
        return self.devices[0][0]

    def owner(self, i: int) -> torch.device:
        """The device that holds ray part ``i``'s sums."""
        return self.devices[i][0]

    def distinct(self) -> list:
        """Each device of the grid once, in grid order."""
        out = []
        for row in self.devices:
            for d in row:
                if d not in out:
                    out.append(d)
        return out

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape}, {self.devices})"


def make_mesh(n_devices: int | None = None, sp: int | None = None,
              device="cuda") -> DeviceMesh:
    """A (dp, sp) mesh over ``n_devices`` devices.

    ``device``: ``"cuda"`` takes the first ``n_devices`` cards of the
    machine (default all), ``"cuda:k"`` the ``n_devices`` cards from card
    ``k`` on (default all from there); either raises where the machine
    has fewer, never falling back to fewer cards or to the CPU; ``"cpu"``
    names the CPU ``n_devices`` times (default once); a list of devices
    (repeats allowed) takes its first ``n_devices`` entries (default
    all). ``sp`` defaults to 2 when the count is even, else 1 (as the JAX
    package's); dp * sp must equal the count."""
    if isinstance(device, (list, tuple)):
        devices = [torch.device(d) for d in device]
        for d in devices:
            require_device(d)
        n = n_devices or len(devices)
        if n > len(devices):
            raise ValueError(f"make_mesh: {n} devices asked of a list of "
                             f"{len(devices)}")
        devices = devices[:n]
    else:
        dev = require_device(device)
        if dev.type == "cpu":
            n = n_devices or 1
            devices = [dev] * n
        else:
            count = torch.cuda.device_count()
            first = dev.index or 0
            n = n_devices or count - first
            if first + n > count:
                raise ValueError(f"make_mesh: {n} CUDA devices asked from "
                                 f"cuda:{first}, the machine has {count}")
            devices = [torch.device("cuda", first + i) for i in range(n)]
    if n < 1:
        raise ValueError(f"make_mesh: {n} devices")
    if sp is None:
        sp = 2 if n % 2 == 0 and n >= 2 else 1
    dp = n // sp
    if sp < 1 or dp * sp != n:
        raise ValueError(f"cannot factor {n} devices into dp*sp with "
                         f"sp={sp}")
    return DeviceMesh([devices[i * sp:(i + 1) * sp] for i in range(dp)])


def to_device(x, device):
    """The dataclass ``x`` (``SceneArrays``, ``CameraArrays``) with each
    tensor field on ``device``: ``x`` itself where every field is there
    already, so a grid that names a device twice shares its arrays."""
    moved = {}
    for f in dataclasses.fields(x):
        v = getattr(x, f.name)
        if isinstance(v, torch.Tensor):
            w = v.to(device)
            if w is not v:
                moved[f.name] = w
    return dataclasses.replace(x, **moved) if moved else x
