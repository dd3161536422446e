"""The port's gradients on textured scenes against the JAX package's
whole-trace custom VJP (its kernels in interpret mode on the CPU): one
trace's cotangents, and every ``TRAINABLE_FIELDS`` leaf through one SGD
step of ``make_train_step``, on ``textured_flat`` (every group one row,
refractive) and ``textured`` (with a 4-triangle mesh).

Textures are constants: the albedo's cotangent is multiplied by the texel
where slot 0 is mapped, and the rough, metal and glass cotangents are 0
where their slot is mapped (``pallas_step._tex_base_bwd``); the JAX
package's attribute table also holds the map ids, whose cotangents are 0.

Tolerances and the rule for rays whose path flips are those of
``test_torch_grad.py``; a ray outside the forward tolerance with a texel
coordinate within ``step.TEX_EDGE`` of an integer at a live step is a
shown texel flip and is dropped the same way (at most 2% of the rays).
"""

import numpy as np
import pytest

import test_torch_grad_slice as gs
from test_torch_grad import (_assert_grad_close, _module_case, _scene,
                             check_resid, check_trace_grad)
from torch_mesh_helpers import one_torch_thread  # noqa: F401

NAMES = ["textured_flat", "textured"]


@pytest.mark.parametrize("name", NAMES)
def test_trace_grad_matches_pallas_vjp(name):
    """d_attr (the port's columns; the map ids get none), d_lights, d_oT,
    d_dT of one trace, and on ``textured`` the triangle cotangents against
    JAX's dAT[:, 6:9] and dHT[:, 2]."""
    _js, ps = _scene(name)
    assert ps.has_maps
    check_trace_grad(name)
    if name == "textured":
        _bad, g_j, g_t = _module_case(name)
        d_tri = g_t[4].numpy()
        Pt = d_tri.shape[0]
        _assert_grad_close("dG2", d_tri[:, 6:9], np.asarray(g_j[4])[:Pt, 6:9])
        _assert_grad_close("dh2", d_tri[:, 11], np.asarray(g_j[5])[:Pt, 2])


@pytest.mark.parametrize("name", NAMES)
def test_resid_matches_pallas_train_mode(name):
    """The residual rows both layouts hold (the texel rows are in
    ``test_torch_tex.py``)."""
    check_resid(name)


@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_jax_sgd(name):
    """One make_train_step SGD step of the 16x16 slice (camera rays, the
    tables, the trace, the sky fold): the loss, every leaf's gradient and
    the new leaves against JAX's ``p - lr * grad``."""
    gs.test_train_step_matches_jax_sgd(name)
