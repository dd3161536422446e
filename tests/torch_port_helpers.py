"""Shared inputs for the PyTorch port's tests (``test_torch_*.py``).

The JAX package's compiled scenes are handed to the port unchanged through
``scene_from_numpy``, inputs come from numpy seeds, and ``cuda_device``
skips a test when no CUDA device is present (such tests also carry the
``cuda`` marker; run them on the card with ``pytest -m cuda``).
"""

import numpy as np
import pytest
import torch

from micro_raytracer_tpu_torch.models import compiler as tcomp


# spheres, planes and boxes with rotated instances and a refractive box
MIXED = {
    "renderer": [
        {"type": "sphere", "r": 0.4, "pos": [0.3, 0.2, 0]},
        {"type": "sphere", "r": 0.25, "pos": [-0.5, 0.5, 0.2],
         "dir": [0, 0.6, 0.4, 0]},
        {"type": "plane", "n": [0, 0, 1], "pos": [0, 0, -0.8]},
        {"type": "plane", "n": [0.3, -1, 0.1], "pos": [0, 1.5, 0]},
        {"type": "box", "sizes": [0.3, 0.4, 0.5], "pos": [0.6, 0.8, 0],
         "dir": [0, 0.5, 0.5, 0.1], "mat": {"opacity": 0.0, "glass": 0.1}},
    ],
    "light": [{"type": "point", "pos": [-0.5, -1, 0.5], "pwr": 0.6},
              {"type": "dir", "dir": [0.3, 0.5, -1], "pwr": 0.3}],
    "sky": {"color": [0.15, 0.2, 0.3], "pwr": 0.5},
}
# the same without refraction, and with an emitter
MIXED_OPAQUE = {
    "renderer": [dict(r, mat={"rough": 0.5, "emit": 0.3})
                 if r["type"] == "box" else r for r in MIXED["renderer"]],
    "light": MIXED["light"],
    "sky": MIXED["sky"],
}


# exact ties: two identical spheres (same segment), and a plane through
# z = 0 with a box whose top face lies on it (across segments)
TIES = {
    "renderer": [
        {"type": "sphere", "r": 0.3, "pos": [0.6, 0, 0]},
        {"type": "sphere", "r": 0.3, "pos": [0.6, 0, 0]},
        {"type": "plane", "n": [0, 0, 1], "pos": [0, 0, 0]},
        {"type": "box", "sizes": [0.6, 0.6, 0.5], "pos": [-0.6, 0, -0.25]},
    ],
    "light": [{"type": "point", "pos": [-0.5, -1, 1.5], "pwr": 0.6}],
}


def port_scene(js, device="cpu"):
    """The port's SceneArrays from the JAX package's compiled scene."""
    leaves = {k: np.asarray(getattr(js, k)) for k in tcomp.SCENE_FIELDS}
    meta = {k: getattr(js, k) for k in tcomp.SCENE_META}
    return tcomp.scene_from_numpy(leaves, meta, device)


def port_camera(jcam, device="cpu"):
    return tcomp.camera_from_numpy(
        {k: np.asarray(getattr(jcam, k)) for k in tcomp.CAMERA_FIELDS},
        device)


def rays(n=512, seed=1):
    """float32 numpy origins in [-2, 2]^3 and unit directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def outlier_rows(a, b, rtol, atol):
    """Rows (first axis) of ``a`` and ``b`` with any element outside
    tolerance."""
    a = np.asarray(a).reshape(len(a), -1)
    b = np.asarray(b).reshape(len(b), -1)
    return np.nonzero(~np.isclose(a, b, rtol=rtol, atol=atol).all(axis=1))[0]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    return torch.device("cuda")
