"""The port's scene compiler against the JAX package's, field by field
(the texture atlas, its offsets and sizes, the map ids, the present map
slots and mapped kinds included: ``textured``, ``textured_flat`` and the
textured stand-ins of ``torch_tex_helpers``)."""

import numpy as np
import pytest
import torch

from micro_raytracer_tpu.frontends import cli as jcli
from micro_raytracer_tpu.models import compiler as jcomp
from micro_raytracer_tpu.models import schema
from micro_raytracer_tpu_torch.models import compiler as tcomp
from test_pallas_step import scenes
from torch_port_helpers import port_camera, port_scene
from torch_tex_helpers import tex_scene

CORNELL_ARGS = [
    "--obj", "sph", "r:", "0.15", "pos:", "0", "0", "-0.1",
    "--obj", "box", "size:", "0.3", "0.3", "0.01", "pos:", "0", "0", "0.499",
    "emit:", "1",
    "--obj", "box", "size:", "1", "0.01", "1", "pos:", "0", "0.5", "0",
    "--light", "point:", "0", "-0.2", "0.3",
    "--cam", "pos:", "0", "-1.25", "0", "fov:", "60", "gamma:", "0.6",
    "exp:", "0.8",
]


def _config(name):
    if name == "cornell":
        return jcli.parse_render(jcli.build_parser().parse_args(CORNELL_ARGS))
    if name.startswith("tex_"):
        return schema.RenderConfig.from_json({"scene": tex_scene(name)})
    return schema.RenderConfig.from_json({"scene": scenes()[name]})


NAMES = ["opaque", "glass", "textured", "glass_flat", "textured_flat",
         "cornell", "tex_dof", "tex_blocks", "tex_mesh"]


def _assert_same(port, js):
    for k in tcomp.SCENE_FIELDS:
        got, want = getattr(port, k).cpu().numpy(), np.asarray(getattr(js, k))
        assert got.dtype == want.dtype, (k, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=k)
    for k in tcomp.SCENE_META:
        assert getattr(port, k) == getattr(js, k), k


@pytest.mark.parametrize("name", NAMES)
def test_compile_scene_matches_jax(name):
    cfg = _config(name)
    _assert_same(tcomp.compile_scene(cfg.scene), jcomp.compile_scene(cfg.scene))


@pytest.mark.parametrize("name", ["glass_flat", "cornell"])
def test_scene_from_numpy_roundtrip(name):
    js = jcomp.compile_scene(_config(name).scene)
    port = port_scene(js)
    _assert_same(port, js)
    leaves = {k: getattr(port, k).numpy() for k in tcomp.SCENE_FIELDS}
    meta = {k: getattr(port, k) for k in tcomp.SCENE_META}
    _assert_same(tcomp.scene_from_numpy(leaves, meta), js)
    assert port.prim_a.dtype == torch.float32
    assert port.group_id.dtype == torch.int32
    assert port.prim_valid.dtype == torch.bool


def test_compile_camera_matches_jax():
    cfg = _config("cornell")
    got = tcomp.compile_camera(cfg.frame.cam)
    want = jcomp.compile_camera(cfg.frame.cam)
    ported = port_camera(want)
    for k in tcomp.CAMERA_FIELDS:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)))
        np.testing.assert_array_equal(getattr(ported, k).numpy(),
                                      np.asarray(getattr(want, k)))
