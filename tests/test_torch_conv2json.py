"""The port's ``conv2json`` against the JAX package's: the same bytes on
stdout for a PNG and an OBJ that the test writes, in both formats, compact
and pretty, and the same exit code and message on a missing file."""

import numpy as np
import pytest
from PIL import Image

from micro_raytracer_tpu.frontends import conv2json as jconv
from micro_raytracer_tpu_torch.frontends import conv2json as tconv

OBJ = """# a quad and a triangle, with normals and texture coordinates
v 0 0 0
v 1 0 0
v 1 1 0.5
v 0 1 0.25
v 0.5 0.5 2
vt 0 0
vn 0 0 1
f 1/1/1 2/1/1 3/1/1 4/1/1
f 1//1 3//1 5//1
"""


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("conv2json")
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (5, 7, 3), dtype=np.uint8)
    png = d / "tex.png"
    Image.fromarray(img).save(png)
    obj = d / "mesh.obj"
    obj.write_text(OBJ)
    return {"img": str(png), "obj": str(obj),
            "missing": str(d / "absent.png")}


def _run(mod, argv, capsys):
    rc = mod.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("kind", ["img", "obj"])
@pytest.mark.parametrize("fmt", ["buf", "inl"])
@pytest.mark.parametrize("pretty", [False, True])
def test_output_equals_jax(inputs, kind, fmt, pretty, capsys):
    argv = [f"--{kind}", inputs[kind], "-f", fmt] + \
        (["--pretty"] if pretty else [])
    want = _run(jconv, argv, capsys)
    got = _run(tconv, argv, capsys)
    assert want[0] == 0 and len(want[1]) > 20
    assert got == want


def test_missing_file_exits_1_like_jax(inputs, capsys):
    argv = ["--img", inputs["missing"]]
    want = _run(jconv, argv, capsys)
    got = _run(tconv, argv, capsys)
    assert want[0] == 1 and got == want
