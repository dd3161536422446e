"""The port's radiance function, tonemap and renderer against the JAX
package's.

``trace_radiance_u`` is fed the exact uniforms JAX's ``trace_radiance``
draws for one key (tracer.py:489-491, 695-696); tolerance rtol 1e-3 /
atol 1e-4 on all but at most 0.5% of pixels (a float32 rounding difference
can flip one sampling branch of one path; outliers are printed). The
finalized u8 image may differ by 1 where a value rounds to the other side
of .5 after a resize summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micro_raytracer_tpu.models import compiler as jcomp
from micro_raytracer_tpu.models import render as jrender
from micro_raytracer_tpu.models import schema
from micro_raytracer_tpu.models import tracer as jtr
from micro_raytracer_tpu.ops import pallas_step as jps
from micro_raytracer_tpu.ops import rng as jrng
from micro_raytracer_tpu.ops import tonemap as jtm
from micro_raytracer_tpu_torch.models import render as trender
from micro_raytracer_tpu_torch.models import tracer as ttr
from micro_raytracer_tpu_torch.ops import tonemap as ttm
from test_pallas_step import scenes
from torch_port_helpers import outlier_rows, port_camera, port_scene
from torch_mesh_helpers import one_torch_thread  # noqa: F401


def _jax_uniforms(key, R, bounce, any_refract):
    """The uniforms jax trace_radiance draws, packed as (K, NU, R)."""
    k_cam, k_trace, k_shade = jax.random.split(key, 3)
    u_aprt = jrng.uniform(k_cam, (R, 2))
    rows = []
    for i in range(bounce + 1):
        u = jrng.uniform(jax.random.fold_in(k_trace, i), (R, 7))
        ue = jrng.uniform(jax.random.fold_in(k_shade, i), (R,))
        u_t = u.T if jps.n_uni(any_refract) == 8 else u[:, :3].T
        rows.append(jnp.concatenate([u_t, ue[None]], axis=0))
    return np.array(u_aprt), np.array(jnp.stack(rows))


@pytest.mark.parametrize("name", ["opaque", "glass_flat", "glass"])
def test_trace_radiance_u_matches_jax(name, monkeypatch):
    monkeypatch.setenv("MRT_STEP", "0")       # the JAX jnp path
    js = jcomp.compile_scene(schema.SceneConfig.from_json(scenes()[name]))
    jc = jcomp.compile_camera(schema.CameraConfig.from_json(
        {"pos": [0, -2, 0], "aprt": 0.05, "foc": 2.0}))
    xs, ys = np.meshgrid(np.arange(2, 64, 3), np.arange(2, 64, 3))
    coords = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)
    R, bounce = coords.shape[0], 3
    key = jax.random.PRNGKey(9)
    want = np.asarray(jtr.trace_radiance(js, jc, (64, 64), bounce,
                                         jnp.float32(0.15),
                                         jnp.asarray(coords), key))
    u_aprt, u8s = _jax_uniforms(key, R, bounce, js.any_refract)
    got = ttr.trace_radiance_u(port_scene(js), port_camera(jc), (64, 64),
                               bounce, 0.15, torch.from_numpy(coords),
                               torch.from_numpy(u_aprt),
                               torch.from_numpy(u8s)).numpy()
    assert want.max() > 0 and np.isfinite(got).all()
    bad = outlier_rows(got, want, 1e-3, 1e-4)
    if len(bad):
        print(f"{len(bad)} of {R} pixels outside tolerance:", bad[:20])
    assert len(bad) <= 0.005 * R


@pytest.mark.parametrize("ssaa", [1, 2])
def test_finalize_matches_jax(ssaa):
    rng = np.random.default_rng(ssaa)
    w, h = 24, 16
    accum = rng.uniform(0, 3, (h * ssaa, w * ssaa, 3)).astype(np.float32)
    accum[0, 0] = np.nan                         # saturating-cast semantics
    want = np.asarray(jtm.finalize(jnp.asarray(accum), jnp.float32(4.0),
                                   jnp.float32(0.8), jnp.float32(0.2),
                                   (w, h)))
    got = ttm.finalize(torch.from_numpy(accum), 4.0, torch.tensor(0.8),
                       torch.tensor(0.2), (w, h)).numpy()
    assert got.shape == want.shape == (h, w, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("wh", [(48, 32), (64, 64), (33, 7)])
def test_morton_ray_order_matches_jax(wh):
    np.testing.assert_array_equal(trender.morton_ray_order(*wh),
                                  jrender.morton_ray_order(*wh))


def _small_config(sample=2):
    return schema.RenderConfig.from_json({
        "rt": {"bounce": 3, "sample": sample},
        "frame": {"res": [40, 24]},
        "scene": scenes()["glass_flat"],
    })


def test_state_roundtrip(tmp_path):
    """save_state/load_state keep the accumulator, count and generator
    state: a resumed renderer continues exactly like the original."""
    a = trender.Renderer(_small_config(), seed=3, device="cpu")
    a.execute_many(1)
    path = str(tmp_path / "s.npz")
    a.save_state(path)
    b = trender.Renderer(_small_config(), seed=99, device="cpu")
    b.load_state(path)
    assert b.count == 1
    np.testing.assert_array_equal(b.framebuffer(), a.framebuffer())
    a.execute_many(1)
    b.execute_many(1)
    np.testing.assert_array_equal(b.framebuffer(), a.framebuffer())
    with np.load(path) as data:
        assert str(data["layout"]) == trender.RAY_LAYOUT
    c = trender.Renderer(schema.RenderConfig.from_json({
        "rt": {"bounce": 3}, "frame": {"res": [20, 12]},
        "scene": scenes()["glass_flat"]}), device="cpu")
    with pytest.raises(ValueError, match="resolution"):
        c.load_state(path)


def test_renderer_progressive_and_seeded():
    a = trender.Renderer(_small_config(), seed=1, device="cpu")
    b = trender.Renderer(_small_config(), seed=1, device="cpu")
    for r in (a, b):
        r.execute_many(2)
    assert a.count == 2
    np.testing.assert_array_equal(a.framebuffer(), b.framebuffer())
    img = a.img()
    assert img.shape == (24, 40, 3) and img.dtype == np.uint8
    assert img.max() > 20
    c = trender.Renderer(_small_config(), seed=2, device="cpu")
    c.execute_many(2)
    assert not np.array_equal(c.framebuffer(), a.framebuffer())


def test_padding_slots_are_dropped():
    """A chunk smaller than the frame pads the last chunk with pixel-0
    rays; the framebuffer keeps exactly one row per pixel."""
    r = trender.Renderer(_small_config(), seed=0, chunk=256, device="cpu")
    assert r.n_chunks * r.chunk > r.n_pix
    r.execute_many(1)
    fb = r.framebuffer()
    assert fb.shape == (24, 40, 3) and np.isfinite(fb).all()


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ValueError, match="no CUDA device"):
        trender.Renderer(_small_config(), device="cuda")
