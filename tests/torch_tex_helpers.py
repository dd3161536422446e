"""Textured scenes of the PyTorch port's tests: in-repo stand-ins for the
textured configurations of the JAX package's benchmark (``bench.py:69``),
whose scene files are not in the repository. Every texture is an inline
buffer (``{"w", "h", "dat"}``) made with numpy from a seed.

* ``tex_dof`` (the class of dof.json): an open scene, a ground plane with a
  checker albedo texture tiled by the plane uv (64 x 64 texels), a camera
  with depth of field (aperture 0.05, focus on the middle sphere), a metal
  sphere (metal 1, rough 0.1), an emissive sphere (emit 1), a diffuse
  sphere with a spherical-map texture (32 x 16), a glass sphere (glass
  0.08, opacity 0), one point light and the sky.
* ``tex_blocks`` (the class of Minecraft.json): a 16 x 16 grid of unit
  boxes at stepped heights over a plane (257 rows), as eight instanced box
  objects, one per material; each material has one 4x3 cross-atlas texture
  of 64 x 48 texels (24,576 texels in all), and together they use all six
  map slots (tex, rmap, mmap, gmap, omap, emap). Every eighth box is
  rotated; the glass-mapped material has opacity 0.6 and glass 0.1.

``tex_mesh`` puts textures into the Mesh class: the glass room of
``torch_mesh_helpers`` (the coarse torus) with cross-atlas textures on its
walls (one an opacity map) and an albedo texture on the torus, whose
triangles sample texel (0, 0) (uv 0, the reference's ``todo!()``).

``small=True`` builds the same scenes with 8 x 8 / 8 x 4 textures and a
4 x 4 grid of 16 x 12 textures, for the CPU tests that run the JAX
package's kernels in interpret mode. The builders of ``tex_dof`` and
``tex_blocks`` are ``chip_smoke.py``'s (it runs without the tests
directory); this module adds ``tex_mesh`` and the small render JSONs.
"""

import numpy as np

from chip_smoke import TEX_CAMERAS as CAMERAS  # noqa: F401  (re-exported)
from chip_smoke import TEX_NAMES, max_flips  # noqa: F401  (re-exported)
from chip_smoke import _buf, _q, checker, cross_atlas
from chip_smoke import tex_scene as _stand_in


def tex_mesh():
    """The ``tex_mesh`` scene (``renderer``, ``light``)."""
    from torch_mesh_helpers import mesh_scene, small_torus

    scene = mesh_scene("mesh_glass", small_torus())
    rng = np.random.default_rng(22)
    objs = []
    for k, ob in enumerate(scene["renderer"]):
        ob = dict(ob, mat=dict(ob.get("mat", {})))
        if ob["type"] == "box" and k < 5:
            slot = "omap" if k == 2 else "tex"
            img = cross_atlas(rng, 8, [0.6, 0.6, 0.6])
            if slot == "omap":
                img[..., 0] = _q(0.2 + 0.8 * img[..., 0])
            ob["mat"][slot] = _buf(img)
        elif ob["type"] == "mesh":
            ob["mat"]["tex"] = _buf(checker(4, 2))
        objs.append(ob)
    return dict(scene, renderer=objs)


def tex_scene(name, small=False):
    if name == "tex_mesh":
        return tex_mesh()
    return _stand_in(name, small)


def render_json(name, small=False, res=32, bounce=2, sample=2):
    """A whole render config of a textured scene."""
    return {"scene": tex_scene(name, small),
            "frame": {"res": [res, res], "cam": CAMERAS[name]},
            "rt": {"bounce": bounce, "sample": sample}}
