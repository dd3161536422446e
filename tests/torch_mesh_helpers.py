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


def stack_table(seed=31):
    """A hand-made triangle table for row 8: 300 rows of unit Woop
    triangles (``G`` = diag(1, 1, s), ``s = +-1``) stacked at a few
    heights, so many rays meet many rows of their group at equal t; group
    ids 0, 1, 2 and 3 (group 3 in two runs apart), 7.5, -0.0 then +0.0
    (one run: ``==`` holds), and NaN (never matched). Rows 40 and 200 of
    group 3 meet rays from the origin at t = -0 and +0 (``o'_z = +0``,
    ``d'_z`` of either sign), their group's only hits on those rays, in
    two slices and two of the plain version's 64-row blocks. Returns the
    table and (o, d) of 301 rays (the last 12 from the origin), on the
    CPU."""
    from micro_raytracer_tpu_torch.ops import tri

    rng = np.random.default_rng(seed)
    P = 300
    gid = np.zeros(P, np.float32)
    for lo, hi, g in ((0, 30, 0.0), (30, 60, 3.0), (60, 110, 1.0),
                      (110, 150, 2.0), (150, 190, 7.5), (190, 220, 3.0),
                      (220, 250, -0.0), (250, 280, 0.0),
                      (280, 300, np.nan)):
        gid[lo:hi] = g
    s = np.where(rng.random(P) < 0.5, 1.0, -1.0).astype(np.float32)
    G = np.zeros((P, 9), np.float32)
    G[:, 0], G[:, 4], G[:, 8] = 1.0, 1.0, s
    h = np.zeros((P, 3), np.float32)
    h[:, :2] = rng.uniform(-0.3, 0.1, (P, 2))
    h[:, 2] = s * rng.choice(np.float32([-0.5, -0.25, 0.0, 0.25]), P)
    # group 3's other rows: u < 0 for rays from the origin along z
    h[gid == 3.0, 0] = rng.uniform(-0.3, -0.05, int((gid == 3.0).sum()))
    thr = np.full((P, 1), 1e-6, np.float32)
    t = tri.from_pallas_consts(G, h, thr, gid)
    # rows 40 and 200: o'_z = +0 for rays from the origin, u = v = 0.2
    for r, sz in ((40, 1.0), (200, -1.0)):
        t[r, 8], t[r, 9:12] = sz, torch.tensor([0.2, 0.2, 0.0])
    n_r = 301
    o = np.zeros((n_r, 3), np.float32)
    o[:, :2] = rng.uniform(0.0, 0.5, (n_r, 2))
    o[:, 2] = -1.0
    d = np.zeros((n_r, 3), np.float32)
    d[:, :2] = rng.normal(0.0, 0.05, (n_r, 2))
    d[:, 2] = rng.choice([1.0, -1.0], n_r, p=[0.8, 0.2])
    o[-12:] = 0.0
    d[-12:] = 0.0
    d[-12:, 2] = np.where(np.arange(12) % 2, 1.0, -1.0)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return t, torch.from_numpy(o), torch.from_numpy(d.astype(np.float32))
