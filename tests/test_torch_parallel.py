"""The port's multi-device modules (``parallel/mesh.py``,
``parallel/distributed.py``, ``parallel/shard.py``'s sharded render and
train step, ``Renderer(mesh=)``) on the CPU, against the one-device port
and the JAX package.

A mesh here names the CPU eight times (the counterpart of the JAX tests'
eight forced host devices, ``tests/conftest.py``). Over a mesh every
(ray, sample) takes the uniforms the one-device render draws for it, so:

* with sp = 1 the sharded render and the renderer's framebuffer equal the
  one-device port's bit for bit;
* with sp > 1 they differ from it by the order of float32 sums (rtol
  1e-5);
* the sharded train step's loss and every leaf's gradient equal the
  one-device formula (the L2 loss of each ray part's sp-averaged radiance,
  averaged over dp) on the same uniforms within rtol 1e-5, the order of
  the sums again.

The JAX package's sharded render of the same scene on its eight devices
draws other random numbers: it is held to the port in shape, finiteness
and mean radiance (within five standard errors of the difference).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from micro_raytracer_tpu_torch.models import schema, tracer
from micro_raytracer_tpu_torch.models.compiler import (compile_camera,
                                                       compile_scene)
from micro_raytracer_tpu_torch.models.render import Renderer
from micro_raytracer_tpu_torch.ops import step
from micro_raytracer_tpu_torch.parallel import distributed, shard
from micro_raytracer_tpu_torch.parallel.mesh import make_mesh
from torch_mesh_helpers import one_torch_thread  # noqa: F401

SCENE = {
    "renderer": [{"type": "sphere", "r": 0.5, "mat": {"rough": 1.0}},
                 {"type": "sphere", "r": 0.3, "pos": [0.6, 0.2, 0.1],
                  "mat": {"glass": 0.1, "opacity": 0.0}}],
    "light": [{"type": "point", "pos": [-0.5, -1, 0.5], "pwr": 0.5}],
    "sky": {"color": [0.1, 0.1, 0.1]},
}
CPU8 = ["cpu"] * 8
MESHES = [(4, 2), (8, 1)]
LOSS = 0.15


def _coords(n, w):
    ys, xs = np.divmod(np.arange(n), w)
    return torch.from_numpy(np.stack([xs, ys], -1).astype(np.float32))


@pytest.fixture(scope="module")
def setup():
    scene = compile_scene(schema.SceneConfig.from_json(SCENE), "cpu")
    cam = compile_camera(schema.CameraConfig.from_json({}), "cpu")
    return scene, cam


def test_mesh_shapes():
    """``make_mesh`` as the JAX package's (``tests/test_parallel.py``):
    sp 2 for an even count, dp * sp the count, an explicit sp, and a
    count that does not factor refused; a device list with repeats."""
    m = make_mesh(8, device=CPU8)
    assert m.shape == {"dp": 4, "sp": 2}
    assert m.shape["dp"] * m.shape["sp"] == 8
    assert make_mesh(1, device="cpu").shape == {"dp": 1, "sp": 1}
    assert make_mesh(3, device="cpu").shape == {"dp": 3, "sp": 1}
    m = make_mesh(8, sp=1, device=CPU8)
    assert m.shape == {"dp": 8, "sp": 1}
    assert m.distinct() == [torch.device("cpu")]
    assert m.primary == m.owner(7) == torch.device("cpu")
    with pytest.raises(ValueError, match="cannot factor"):
        make_mesh(8, sp=3, device=CPU8)
    with pytest.raises(ValueError, match="of a list of 8"):
        make_mesh(9, device=CPU8)


def test_make_mesh_past_the_card_count_raises(monkeypatch):
    """Asking for more cards than the machine has raises, and so does a
    card where there is none: never fewer cards, never the CPU."""
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no CUDA device"):
            make_mesh(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="the machine has 1"):
        make_mesh(2)
    m = make_mesh(1, sp=1)
    assert m.devices == [[torch.device("cuda", 0)]]
    # "cuda" in a list names the current card
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert make_mesh(2, sp=1, device=["cuda", "cuda"]).devices == [
        [torch.device("cuda", 0)], [torch.device("cuda", 0)]]
    # a named card is where the mesh starts, never dropped for card 0
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    with pytest.raises(ValueError, match="from cuda:2, the machine has 3"):
        make_mesh(2, device="cuda:2")
    assert make_mesh(1, device="cuda:1").devices == [[torch.device("cuda",
                                                                   1)]]
    assert make_mesh(2, sp=1, device="cuda:1").devices == [
        [torch.device("cuda", 1)], [torch.device("cuda", 2)]]
    assert make_mesh(device="cuda:1").devices == [
        [torch.device("cuda", 1), torch.device("cuda", 2)]]


def test_launch_makes_its_tensors_card_current(monkeypatch):
    """``CudaKernel.launch`` runs its entry point (which launches on the
    current device) with the card of its tensors current where another
    is, and leaves the current card as it was."""
    from micro_raytracer_tpu_torch.utils.kernels import CudaKernel

    current, seen = [0], []

    class Scope:
        def __init__(self, device):
            self.index = torch.device(device).index

        def __enter__(self):
            self.prev, current[0] = current[0], self.index

        def __exit__(self, *_exc):
            current[0] = self.prev

    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[0])
    monkeypatch.setattr(torch.cuda, "device", Scope)
    k = CudaKernel("probe", "hit3.cu", (), "probe", [])
    k._fn = lambda *_a: seen.append(current[0]) or 0
    k.launch(device=torch.device("cuda", 1))
    k.launch(device=torch.device("cuda", 0))
    k.launch(device=torch.device("cuda"))
    k.launch()
    assert seen == [1, 0, 0, 0] and current[0] == 0 and k.launches == 4


@pytest.mark.parametrize("dp,sp", MESHES)
def test_sharded_render_matches_one_device(dp, sp, setup):
    """``make_sharded_render`` on a (dp, sp) mesh of the CPU against the
    one-device trace of the same uniforms: sp = 1 bit for bit; sp = 2 the
    mean of the two draws within rtol 1e-5."""
    scene, cam = setup
    mesh = make_mesh(8, sp=sp, device=CPU8)
    assert mesh.shape == {"dp": dp, "sp": sp}
    fn = shard.make_sharded_render(mesh, (32, 32), 2)
    coords = _coords(dp * 24, 32)
    got = fn(scene, cam, LOSS, coords, torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(3)
    one = [tracer.trace_radiance(scene, cam, (32, 32), 2, LOSS, coords, gen)
           for _ in range(sp)]
    assert got.shape == (dp * 24, 3) and bool(torch.isfinite(got).all())
    assert float(got.abs().sum()) > 0
    if sp == 1:
        assert torch.equal(got, one[0])
    else:
        torch.testing.assert_close(got, sum(one) / sp, rtol=1e-5, atol=1e-7)


def _config(samples=3):
    return schema.RenderConfig.from_json({
        "scene": SCENE, "frame": {"res": [16, 12]},
        "rt": {"bounce": 2, "sample": samples}})


@pytest.mark.parametrize("dp,sp", MESHES)
def test_renderer_over_a_mesh_matches_one_device(dp, sp, tmp_path):
    """``Renderer(mesh=)`` over two passes (3 then 4 samples) against the
    one-device renderer of the same seed and chunk: the framebuffer bit
    for bit with sp = 1, within rtol 1e-5 with sp = 2; the image equal;
    its saved state resumes on a mesh renderer to the same framebuffer."""
    cfg = _config()
    mesh = make_mesh(8, sp=sp, device=CPU8)
    one = Renderer(cfg, seed=4, chunk=64, device="cpu")
    many = Renderer(cfg, seed=4, chunk=64, mesh=mesh)
    assert many.chunk == 64 and many.n_chunks == one.n_chunks == 3
    for n in (3, 4):
        one.execute_many(n)
        many.execute_many(n)
    a, b = one.framebuffer(), many.framebuffer()
    assert a.shape == b.shape == (12, 16, 3) and float(a.sum()) > 0
    if sp == 1:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
    assert np.abs(one.img().astype(int) - many.img().astype(int)).max() <= 1
    state = tmp_path / "s.npz"
    many.save_state(str(state))
    again = Renderer(cfg, seed=4, chunk=64, mesh=mesh)
    again.load_state(str(state))
    np.testing.assert_array_equal(again.framebuffer(), b)
    assert again.count == 7


def test_renderer_rounds_the_chunk_to_dp():
    """A chunk that does not split into dp parts is rounded up to one
    that does."""
    r = Renderer(_config(1), seed=0, chunk=1030, mesh=make_mesh(
        4, sp=1, device=["cpu"] * 4))
    assert r.chunk == 1032 and r.chunk % 4 == 0
    r.execute_many(1)
    assert np.isfinite(r.framebuffer()).all()


def _one_device_loss(scene, cam, params, coords, target, u_aprt, u8s, dp):
    """The formula the sharded step computes, on one device: the L2 loss
    of each of dp ray parts' sp-averaged radiance, averaged over dp."""
    s = shard.merge_params(scene, params)
    rad = sum(tracer.trace_radiance_u(s, cam, (16, 16), 2, LOSS, coords,
                                      u_aprt[j], u8s[j])
              for j in range(u_aprt.shape[0])) / u_aprt.shape[0]
    part = coords.shape[0] // dp
    return sum(torch.mean((rad[i * part:(i + 1) * part]
                           - target[i * part:(i + 1) * part]) ** 2)
               for i in range(dp)) / dp


@pytest.mark.parametrize("dp,sp", MESHES)
def test_sharded_train_step_matches_the_one_device_formula(dp, sp, setup):
    """The sharded train step's loss and every leaf's gradient against
    the one-device formula on the same uniforms (rtol 1e-5), its SGD step
    ``p - lr * grad`` on the primary device; then it descends against a
    black target with the same uniforms (``tests/test_parallel.py``)."""
    scene, cam = setup
    mesh = make_mesh(8, sp=sp, device=CPU8)
    ts = shard.make_train_step((16, 16), 2, lr=0.1, mesh=mesh)
    assert isinstance(ts, shard.ShardedTrainStep)
    R = dp * 16
    coords = _coords(R, 16)
    rng = np.random.default_rng(9)
    target = torch.from_numpy(rng.random((R, 3)).astype(np.float32)) * 0.2
    u_aprt = torch.from_numpy(rng.random((sp, R, 2)).astype(np.float32))
    u8s = torch.from_numpy(rng.random(
        (sp, 3, step.n_uni(scene.any_refract), R)).astype(np.float32))
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in shard.split_params(scene)[0].items()}
    loss, new = ts.step_u(params, scene, cam, LOSS, coords, target, u_aprt,
                          u8s)
    ref = {k: v.detach().clone().requires_grad_(True)
           for k, v in shard.split_params(scene)[0].items()}
    want = _one_device_loss(scene, cam, ref, coords, target, u_aprt, u8s, dp)
    want.backward()
    torch.testing.assert_close(loss, want.detach(), rtol=1e-5, atol=0)
    moved = 0
    for k in shard.TRAINABLE_FIELDS:
        g, w = params[k].grad, ref[k].grad
        if w is None:
            assert g is None or not bool(g.any()), k
            continue
        scale = float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7 * scale + 1e-12)
        torch.testing.assert_close(new[k].detach(),
                                   params[k].detach() - 0.1 * g)
        moved += int(scale > 0)
    assert moved >= 5
    black = torch.zeros(R, 3)
    loss0, p1 = ts.step(params, scene, cam, LOSS, coords, black,
                        torch.Generator().manual_seed(0))
    loss1, _ = ts.step(p1, scene, cam, LOSS, coords, black,
                       torch.Generator().manual_seed(0))
    assert np.isfinite(float(loss0))
    assert float(loss1) <= float(loss0) + 1e-6


def test_train_step_on_one_device_mesh_is_the_one_device_step(setup):
    """dp = sp = 1: the sharded step draws the one-device step's uniforms
    and returns its loss and new leaves bit for bit."""
    scene, cam = setup
    coords = _coords(64, 16)
    target = torch.full((64, 3), 0.1)
    out = []
    for ts in (shard.make_train_step((16, 16), 2, device="cpu"),
               shard.make_train_step((16, 16), 2, mesh=make_mesh(
                   1, device="cpu"))):
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in shard.split_params(scene)[0].items()}
        out.append(ts.step(params, scene, cam, LOSS, coords, target,
                           torch.Generator().manual_seed(2)))
    assert torch.equal(out[0][0], out[1][0])
    for k in shard.TRAINABLE_FIELDS:
        assert torch.equal(out[0][1][k], out[1][1][k]), k


def test_local_slice_and_one_process():
    """Without a process group: ``initialize`` does nothing, this process
    is the primary one and owns the whole axis."""
    env = {k: os.environ.pop(k) for k in ("WORLD_SIZE", "RANK")
           if k in os.environ}
    try:
        assert distributed.initialize(device="cpu") is False
        assert distributed.is_primary()
        assert distributed.local_slice(10) == (0, 10)
        assert distributed.local_slice(0) == (0, 0)
    finally:
        os.environ.update(env)


_WORKER = r"""
import json, sys
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[1])
from micro_raytracer_tpu_torch.parallel import distributed
assert distributed.initialize(device="cpu")
t = torch.tensor([float(dist.get_rank() + 1)])
dist.all_reduce(t)
print(json.dumps({"slice": distributed.local_slice(11),
                  "primary": distributed.is_primary(), "sum": float(t)}))
dist.destroy_process_group()
"""


def test_two_processes_over_gloo():
    """Two processes joined by ``initialize`` from the standard
    environment over gloo (a localhost address, each process with a 60 s
    limit): their slices of 11 cover it, rank 0 is the primary one, an
    all-reduce sees both."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, root], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=60)
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [o["slice"] for o in outs] == [[0, 6], [6, 11]]
    assert [o["primary"] for o in outs] == [True, False]
    assert [o["sum"] for o in outs] == [3.0, 3.0]


def test_port_and_jax_sharded_renders_agree(setup):
    """The same scene through the JAX package's sharded render on its
    eight CPU devices (dp 4, sp 2) and the port's over eight CPU entries:
    the same shape, finite, and mean radiance within five standard errors
    of the difference (the two draw different random numbers)."""
    import jax
    import jax.numpy as jnp

    from micro_raytracer_tpu.models import compiler as jcomp
    from micro_raytracer_tpu.models import schema as jschema
    from micro_raytracer_tpu.parallel import shard as jshard
    from micro_raytracer_tpu.parallel.mesh import make_mesh as jmesh

    jm = jmesh(8)
    assert jm.shape["dp"] == 4 and jm.shape["sp"] == 2
    n = 64 * 64
    coords = _coords(n, 64)
    jscene = jcomp.compile_scene(jschema.SceneConfig.from_json(SCENE))
    jcam = jcomp.compile_camera(jschema.CameraConfig.from_json({}))
    want = np.asarray(jshard.make_sharded_render(jm, (64, 64), 2)(
        jscene, jcam, jnp.float32(LOSS), jnp.asarray(coords.numpy()),
        jax.random.PRNGKey(0)))
    scene, cam = setup
    got = shard.make_sharded_render(make_mesh(8, device=CPU8), (64, 64), 2)(
        scene, cam, LOSS, coords, torch.Generator().manual_seed(0)).numpy()
    assert got.shape == want.shape == (n, 3)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    a, b = got.mean(1), want.mean(1)
    se = np.sqrt(a.var() / n + b.var() / n)
    assert abs(a.mean() - b.mean()) < 5 * se + 1e-4, (a.mean(), b.mean(), se)
    assert a.mean() > 0.01
