"""Instance-class scenes of the PyTorch port's tests: in-repo stand-ins for
the reference's Instance.json (1000 spheres, ``bench.py:69``), which is not
in the repository. The builders are ``chip_smoke.py``'s (it runs without
the tests directory).

* ``inst_grid``: a 10 x 10 x 10 grid of instanced spheres (r 0.18, spacing
  0.5) over a ground plane, seen from outside the grid, with the sky, a
  point and a directional light: 1,000 sphere rows (16 cull blocks, the
  last of 40 rows) and the plane's 8. ``small=True`` gives a 6 x 7 x 7
  grid (294 spheres: still culled, the last block of 38 rows) for the
  tests that run the JAX package in interpret mode.
* ``inst_glass``: a 7 x 7 x 7 grid (343 spheres) of which about a
  twentieth are glass: the entry sweeps take the group exit and stay
  dense, the shadow sweeps cull.
"""

from chip_smoke import INST_CAMERA as CAMERA  # noqa: F401  (re-exported)
from chip_smoke import INST_NAMES, inst_scene  # noqa: F401  (re-exported)


def render_json(name, small=False, res=32, bounce=2, sample=2):
    """A whole render config of an Instance-class scene."""
    return {"scene": inst_scene(name, small),
            "frame": {"res": [res, res], "cam": CAMERA},
            "rt": {"bounce": bounce, "sample": sample}}
