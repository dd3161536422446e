"""The port's linalg, sphere sampling and camera rays against the JAX
package's on the same inputs.

Tolerance: both sides run the same float32 operations in the same order,
so they agree to a few ulps (sums of three products may associate
differently); rtol 1e-5 / atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micro_raytracer_tpu.models import camera as jcam
from micro_raytracer_tpu.models import compiler as jcomp
from micro_raytracer_tpu.models import schema
from micro_raytracer_tpu.ops import linalg as jl
from micro_raytracer_tpu.ops import rng as jrng
from micro_raytracer_tpu_torch.models import camera as tcam
from micro_raytracer_tpu_torch.models import compiler as tcomp
from micro_raytracer_tpu_torch.ops import linalg as tl
from micro_raytracer_tpu_torch.ops import rng as trng
from torch_port_helpers import port_camera

RTOL, ATOL = 1e-5, 1e-6


def _inputs(seed=0, n=257):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    w = rng.normal(size=(n, 3)).astype(np.float32)
    dir4 = rng.normal(size=(n, 4)).astype(np.float32)
    dir4[:, 0] = rng.uniform(-0.9, 0.9, n)          # roll sine in (-1, 1)
    m = rng.normal(size=(n, 3, 3)).astype(np.float32)
    eta = rng.uniform(1.0, 1.6, n).astype(np.float32)
    return v, w, dir4, m, eta


CASES = {
    "dot": lambda L, v, w, d4, m, eta: L.dot(v, w),
    "cross": lambda L, v, w, d4, m, eta: L.cross(v, w),
    "mag": lambda L, v, w, d4, m, eta: L.mag(v),
    "normalize": lambda L, v, w, d4, m, eta: L.normalize(v),
    "safe_normalize": lambda L, v, w, d4, m, eta: L.safe_normalize(v),
    "reflect": lambda L, v, w, d4, m, eta: L.reflect(v, L.normalize(w)),
    "refract": lambda L, v, w, d4, m, eta: L.refract(
        L.normalize(v), eta, L.normalize(w))[0],
    "refract_ok": lambda L, v, w, d4, m, eta: L.refract(
        L.normalize(v), eta, L.normalize(w))[1],
    "rotate_y_mat": lambda L, v, w, d4, m, eta: L.rotate_y_mat(d4),
    "lookat_mat": lambda L, v, w, d4, m, eta: L.lookat_mat(d4),
    "matvec": lambda L, v, w, d4, m, eta: L.matvec(m, v),
    "matmul3": lambda L, v, w, d4, m, eta: L.matmul3(m, m),
    "instance_mat": lambda L, v, w, d4, m, eta: L.instance_mat(d4),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_linalg_matches_jax(name):
    v, w, d4, m, eta = _inputs()
    want = np.asarray(CASES[name](jl, *(jnp.asarray(a) for a in
                                        (v, w, d4, m, eta))))
    got = CASES[name](tl, *(torch.from_numpy(np.ascontiguousarray(a))
                            for a in (v, w, d4, m, eta))).numpy()
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_sphere_rand_matches_jax():
    rng = np.random.default_rng(3)
    n = rng.normal(size=(300, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    rough, u1, u2 = (rng.random(300).astype(np.float32) for _ in range(3))
    want = np.asarray(jrng.sphere_rand(*(jnp.asarray(a)
                                         for a in (n, rough, u1, u2))))
    got = trng.sphere_rand(*(torch.from_numpy(a)
                             for a in (n, rough, u1, u2))).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_gen_rays_matches_jax_with_dof():
    cam_cfg = schema.CameraConfig.from_json({
        "pos": [0.1, -1.5, 0.2], "dir": [0.2, 0.1, 1.0, -0.1], "fov": 55,
        "aprt": 0.3, "foc": 1.7})
    jc = jcomp.compile_camera(cam_cfg)
    rng = np.random.default_rng(5)
    coords = np.stack([rng.integers(0, 96, 500), rng.integers(0, 64, 500)],
                      -1).astype(np.float32)
    u_aprt = rng.random((500, 2)).astype(np.float32)
    o_j, d_j = jcam.gen_rays(jc, (96, 64), jnp.asarray(coords),
                             jnp.asarray(u_aprt))
    for cam in (port_camera(jc), tcomp.compile_camera(cam_cfg)):
        o_t, d_t = tcam.gen_rays(cam, (96, 64), torch.from_numpy(coords),
                                 torch.from_numpy(u_aprt))
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=RTOL,
                                   atol=ATOL)


def test_generator_draws_are_reproducible():
    a = trng.uniform(trng.make_generator(7, "cpu"), (1000,), "cpu")
    b = trng.uniform(trng.make_generator(7, "cpu"), (1000,), "cpu")
    c = trng.uniform(trng.make_generator(8, "cpu"), (1000,), "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.dtype == torch.float32 and 0.0 <= a.min() and a.max() < 1.0
