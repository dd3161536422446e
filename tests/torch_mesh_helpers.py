"""The Mesh-class scenes of the PyTorch port's tests.

A closed torus (major radius 0.16, minor radius 0.06, 30 x 16 quads: 960
triangles, about the 976 of the reference's Mesh.json deer) in the room of
``chip_smoke.py``'s slice scene: five thin-box walls, two of them coloured,
an emissive box light, a metal sphere and one point light. The torus takes
the glass sphere's place. ``chip_smoke.py`` keeps its own copy of
:func:`torus` (it runs without the tests directory).

* ``mesh_glass``: the torus is glass (opacity 0, glass 0.08): rays refract
  through a multi-row group, so the sweeps take the group exit and the
  scene is not ``same_row``;
* ``mesh_opaque``: the torus is diffuse (rough 0.6, albedo 0.8 0.7 0.3):
  every sweep is entry-only, so the 64-row block cull is active.
"""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test process while a test runs: the plain
    trace issues thousands of small CPU ops, and several test processes
    that each spin a full thread pool over them slow one another down by
    two orders of magnitude. Import it into a test module to apply it
    there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TORUS_POS = [-0.18, 0.12, -0.26]
TORUS_TILT = 0.45            # radians about x: the ring leans back


def torus(n_major=30, n_minor=16, R=0.16, r=0.06, tilt=TORUS_TILT):
    """(2 * n_major * n_minor, 3, 3) float32 vertices of a closed torus in
    object space, the ring in the plane of x and (0, -sin tilt, cos tilt),
    every triangle wound outward."""
    u = 2.0 * np.pi * np.arange(n_major) / n_major
    v = 2.0 * np.pi * np.arange(n_minor) / n_minor
    uu, vv = np.meshgrid(u, v, indexing="ij")
    ring = R + r * np.cos(vv)
    a, b, c = ring * np.cos(uu), ring * np.sin(uu), r * np.sin(vv)
    ct, st = np.cos(tilt), np.sin(tilt)
    pts = np.stack([a, b * ct - c * st, b * st + c * ct], -1)   # (M, m, 3)
    i1 = (np.arange(n_major) + 1) % n_major
    j1 = (np.arange(n_minor) + 1) % n_minor
    p00 = pts
    p10 = pts[i1]
    p11 = pts[i1][:, j1]
    p01 = pts[:, j1]
    quads = [np.stack([p00, p10, p11], -2), np.stack([p00, p11, p01], -2)]
    return np.stack(quads, 2).reshape(-1, 3, 3).astype(np.float32)


ROOM = [
    {"type": "box", "sizes": [1, 1, 0.01], "pos": [0, 0, -0.5]},
    {"type": "box", "sizes": [1, 1, 0.01], "pos": [0, 0, 0.5]},
    {"type": "box", "sizes": [1, 0.01, 1], "pos": [0, 0.5, 0]},
    {"type": "box", "sizes": [0.01, 1, 1], "pos": [-0.5, 0, 0],
     "mat": {"albedo": [0.9, 0.15, 0.15]}},
    {"type": "box", "sizes": [0.01, 1, 1], "pos": [0.5, 0, 0],
     "mat": {"albedo": [0.15, 0.9, 0.15]}},
    {"type": "box", "sizes": [0.3, 0.3, 0.01], "pos": [0, 0, 0.49],
     "mat": {"emit": 1}},
    {"type": "sphere", "r": 0.15, "pos": [0.2, -0.1, -0.35],
     "mat": {"metal": 1, "rough": 0.1}},
]
TORUS_MAT = {
    "mesh_glass": {"opacity": 0.0, "glass": 0.08},
    "mesh_opaque": {"rough": 0.6, "albedo": [0.8, 0.7, 0.3]},
}
CAMERA = {"pos": [0, -1.25, 0], "fov": 60, "gamma": 0.6, "exp": 0.8}


def mesh_scene(name, tris=None):
    """The scene JSON (``renderer``, ``light``) of ``mesh_glass`` or
    ``mesh_opaque``; ``tris`` replaces the torus (a smaller mesh for slow
    reference runs)."""
    mesh = torus() if tris is None else tris
    return {
        "renderer": ROOM + [{"type": "mesh", "mesh": mesh.tolist(),
                             "pos": TORUS_POS, "mat": TORUS_MAT[name]}],
        "light": [{"type": "point", "pos": [0, -0.1, 0.4], "pwr": 0.5}],
    }


def two_tori():
    """The coarse glass torus instanced twice (two groups of 192 rows, one
    rotated): the exit pass must keep to the winner's own rows."""
    scene = mesh_scene("mesh_glass", small_torus())
    mesh = dict(scene["renderer"][-1])
    del mesh["pos"]
    mesh["inst"] = [[[-0.2, 0.1, -0.25], [0, 0, -1, 0]],
                    [[0.15, 0.2, 0.1], [0, 0.3, 0.9, 0.2]]]
    scene["renderer"] = scene["renderer"][:-1] + [mesh]
    return scene


def small_torus():
    """A coarse torus (12 x 8 quads, 192 triangles: three cull blocks) of
    the same shape, for the CPU tests that run the JAX package's kernels
    in interpret mode."""
    return torus(12, 8)


def clustered_tris():
    """The clustered 210-triangle mesh of test_pallas_hit3's culling test:
    three tight clusters far apart, so that most rays skip most blocks, and
    no |det| >= E phantom hit lies outside its block's AABB."""
    rng = np.random.default_rng(7)
    tris = []
    for c in ([-3.0, 0.0, 0.0], [3.0, 2.0, 0.0], [0.0, -3.0, 2.0]):
        base = rng.uniform(-0.5, 0.5, (70, 1, 3)) + np.asarray(c)[None, None]
        tris.append(base + rng.uniform(-0.2, 0.2, (70, 3, 3)))
    return np.concatenate(tris).astype(np.float32)


CLUSTERED = {
    "renderer": [
        {"type": "mesh", "mesh": clustered_tris().tolist(),
         "pos": [0.2, 0.1, 0.0], "dir": [0, 0.4, 0.8, 0.1]},
        {"type": "plane", "n": [0, 0, 1], "pos": [0, 0, -4]},
    ],
}
# the same, lit from above: an open scene whose shadow rays reach the
# triangle segment (a closed room's any-hit sweeps meet a wall first)
CLUSTERED_LIT = dict(CLUSTERED, light=[
    {"type": "point", "pos": [0.5, -0.5, 6.0], "pwr": 0.8}])


def aimed_rays(scene, n, seed):
    """float32 numpy rays from [-2, 2]^3 toward random points of the port
    scene's triangle blocks' AABBs, so that many of them meet the mesh."""
    from micro_raytracer_tpu_torch.ops import hit3, intersect
    from torch_port_helpers import rays

    o, _d = rays(n, seed=seed)
    bb = hit3.tri_blockbounds(scene, intersect.build_frames(scene)).numpy()
    rng = np.random.default_rng(seed)
    b = bb[rng.integers(0, len(bb), n)]
    d = b[:, :3] + rng.random((n, 3)) * (b[:, 3:6] - b[:, :3]) - o
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
        np.float32)


def big_tris(n=8224, seed=5):
    """``n`` small random triangles (edges ~0.06: their cross products pass
    the reference's |det| >= 1e-4 window) with centres in a 0.8-wide
    cube."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-0.4, 0.4, (n, 1, 3))
    return (c + rng.uniform(-0.04, 0.04, (n, 3, 3))).astype(np.float32)


def big_mesh(glass=False, n_lights=1, glass_sphere=False):
    """A mesh past hit3.MAX_TRI_BLOCKS: :func:`big_tris` instanced twice
    (two groups, 16,448 rows in 257 cull blocks), diffuse or glass, beside
    a metal sphere (``glass_sphere``: a glass one) over a plane, under
    ``n_lights`` point lights."""
    mat = {"opacity": 0.0, "glass": 0.1} if glass else {"rough": 0.5}
    sphere_mat = {"opacity": 0.0, "glass": 0.1} if glass_sphere \
        else {"metal": 1, "rough": 0.2}
    return {"renderer": [
        {"type": "mesh", "mesh": big_tris().tolist(), "mat": mat,
         "inst": [[[-0.3, 0.6, 0.0], [0, 0, -1, 0]],
                  [[0.35, 0.9, 0.2], [0, 0.3, 0.9, 0.2]]]},
        {"type": "sphere", "r": 0.25, "pos": [0.6, 0.2, -0.1],
         "mat": sphere_mat},
        {"type": "plane", "n": [0, 0, 1], "pos": [0, 0, -0.6]},
    ], "light": [{"type": "point", "pos": [0.2 * i - 0.4, -1, 1.5],
                  "pwr": 0.6} for i in range(n_lights)]}
