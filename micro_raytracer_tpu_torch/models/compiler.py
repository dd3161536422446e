"""Scene -> padded, kind-sorted tensors on a chosen device.

The PyTorch counterpart of ``micro_raytracer_tpu.models.compiler``: the
scene graph is flattened on the host, in numpy, into dense kind-sorted
primitive buffers, and the result is moved to ``device`` as torch tensors.
The row layout is the JAX package's exactly — the kernels depend on it:

* primitive rows sorted by kind ``[spheres | planes | boxes | triangles]``,
  each segment padded to a multiple of 8 (padding rows invalid, group -1,
  a unit instance direction);
* one ``group_id`` per (object, instance) pair, so that mesh entry/exit hits
  follow rt.rs:740-772 and every non-mesh group is a single row;
* ``any_refract``, ``n_groups`` and ``kind_counts`` as static metadata, and
  ``kind_sweep``, the rows of each segment the kernels need to test;
* ``box_order``, the box walk's order of a long box segment's rows.

:func:`scene_from_numpy` / :func:`camera_from_numpy` build the tensors from
numpy leaves, which is also how a test hands the JAX compiler's output to
the port unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import schema

# Segment order == kind code (schema.KIND_*).
N_KINDS = 4
_SEG_PAD = 8

# tensor leaves of SceneArrays, in declaration order
SCENE_FIELDS = (
    "prim_a", "prim_b", "prim_c", "prim_r", "inst_pos", "inst_dir",
    "prim_valid", "group_id", "mat_id",
    "mat_albedo", "mat_rough", "mat_metal", "mat_glass", "mat_opacity",
    "mat_emit", "mat_maps",
    "tex_data", "tex_offset", "tex_w", "tex_h",
    "light_is_dir", "light_pos", "light_dir", "light_pwr", "light_color",
    "sky_color", "sky_pwr",
)
SCENE_META = ("kind_counts", "n_lights", "has_maps", "any_refract",
              "map_slots", "n_groups", "mapped_kinds")
_INT_FIELDS = ("group_id", "mat_id", "mat_maps", "tex_offset", "tex_w",
               "tex_h")
_BOOL_FIELDS = ("prim_valid", "light_is_dir")
CAMERA_FIELDS = ("pos", "dir", "fov", "gamma", "exp", "aprt", "foc")


@dataclass
class SceneArrays:
    """Compiled scene: dense kind-sorted primitive/material/light tables.

    Shapes as in the JAX package: P primitive rows, M material rows, L
    lights (unpadded; L may be 0), T textures.
    """

    prim_a: torch.Tensor      # (P,3) plane: n | box: sizes | tri: v0
    prim_b: torch.Tensor      # (P,3) tri: v1
    prim_c: torch.Tensor      # (P,3) tri: v2
    prim_r: torch.Tensor      # (P,)  sphere radius
    inst_pos: torch.Tensor    # (P,3)
    inst_dir: torch.Tensor    # (P,4) [w,x,y,z]
    prim_valid: torch.Tensor  # (P,) bool
    group_id: torch.Tensor    # (P,) int32
    mat_id: torch.Tensor      # (P,) int32
    mat_albedo: torch.Tensor  # (M,3)
    mat_rough: torch.Tensor   # (M,)
    mat_metal: torch.Tensor
    mat_glass: torch.Tensor
    mat_opacity: torch.Tensor
    mat_emit: torch.Tensor
    mat_maps: torch.Tensor    # (M,6) int32, -1 = none
    tex_data: torch.Tensor    # (N_texels,3)
    tex_offset: torch.Tensor  # (T,) int32
    tex_w: torch.Tensor
    tex_h: torch.Tensor
    light_is_dir: torch.Tensor  # (L,) bool
    light_pos: torch.Tensor     # (L,3)
    light_dir: torch.Tensor     # (L,3)
    light_pwr: torch.Tensor     # (L,)
    light_color: torch.Tensor   # (L,3)
    sky_color: torch.Tensor     # (3,)
    sky_pwr: torch.Tensor       # ()
    kind_counts: tuple
    # rows of each kind segment up to its last valid one, derived from
    # prim_valid: what the kernels sweep (the padding after it never hits)
    kind_sweep: tuple
    n_lights: int
    has_maps: bool
    any_refract: bool = True
    map_slots: tuple = (True,) * 6
    n_groups: int = 0
    mapped_kinds: tuple = (True,) * 4
    # where the box segment's swept rows are enough for the box walk
    # (ops/hit3.py BOX_CULL_MIN): its valid rows' segment-local indices in
    # the walk's order (hit3.box_order, from the compiled positions), a
    # device int64 tensor; else None
    box_order: torch.Tensor | None = None

    @property
    def n_prims(self) -> int:
        return sum(self.kind_counts)

    @property
    def device(self) -> torch.device:
        return self.prim_a.device

    def seg(self, kind: int) -> slice:
        start = sum(self.kind_counts[:kind])
        return slice(start, start + self.kind_counts[kind])


@dataclass
class CameraArrays:
    pos: torch.Tensor   # (3,)
    dir: torch.Tensor   # (4,)
    fov: torch.Tensor   # ()
    gamma: torch.Tensor
    exp: torch.Tensor
    aprt: torch.Tensor
    foc: torch.Tensor


def scene_from_numpy(d: dict, meta: dict, device="cpu") -> SceneArrays:
    """SceneArrays from numpy leaves ``d`` (keys :data:`SCENE_FIELDS`) and
    the static fields ``meta`` (keys :data:`SCENE_META`)."""
    leaves = {}
    for k in SCENE_FIELDS:
        a = np.asarray(d[k])
        if k in _BOOL_FIELDS:
            a = a.astype(bool)
        elif k in _INT_FIELDS:
            a = a.astype(np.int32)
        else:
            a = a.astype(np.float32)
        leaves[k] = torch.tensor(a, device=device)
    static = {k: meta[k] for k in SCENE_META}
    static["kind_counts"] = tuple(int(c) for c in static["kind_counts"])
    static["map_slots"] = tuple(bool(v) for v in static["map_slots"])
    static["mapped_kinds"] = tuple(bool(v) for v in static["mapped_kinds"])
    static["kind_sweep"] = _kind_sweep(static["kind_counts"],
                                       np.asarray(d["prim_valid"], bool))
    static["box_order"] = _box_order(static["kind_counts"],
                                     static["kind_sweep"], d, device)
    return SceneArrays(**leaves, **static)


def camera_from_numpy(d: dict, device="cpu") -> CameraArrays:
    return CameraArrays(**{
        k: torch.tensor(np.asarray(d[k], np.float32), device=device)
        for k in CAMERA_FIELDS})


def compile_camera(cam: schema.CameraConfig, device="cpu") -> CameraArrays:
    return camera_from_numpy({k: getattr(cam, k) for k in CAMERA_FIELDS},
                             device)


def _pad_rows(arr: np.ndarray, n: int) -> np.ndarray:
    if arr.shape[0] == n:
        return arr
    pad = [(0, n - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)


def _kind_sweep(kind_counts, prim_valid):
    """Per kind: the rows of its segment up to and including its last valid
    row (0 for a segment with none)."""
    out, start = [], 0
    for c in kind_counts:
        valid = np.flatnonzero(prim_valid[start:start + c])
        out.append(int(valid[-1]) + 1 if len(valid) else 0)
        start += c
    return tuple(out)


def _box_order(kind_counts, kind_sweep, d, device):
    """:attr:`SceneArrays.box_order` of a scene's numpy leaves ``d``."""
    from ..ops import hit3

    n = kind_sweep[schema.KIND_BOX]
    if n < hit3.BOX_CULL_MIN:
        return None
    s = sum(kind_counts[:schema.KIND_BOX])
    order = hit3.box_order(np.asarray(d["inst_pos"])[s:s + n],
                           np.asarray(d["prim_valid"], bool)[s:s + n])
    return torch.as_tensor(order, dtype=torch.int64, device=device)


def _mapped_kinds(kind_counts, mat_id, mat_maps_np, prim_valid):
    """Per-kind flag: does any valid row of this kind carry a texture map?"""
    has_map_row = (mat_maps_np[np.asarray(mat_id)] >= 0).any(axis=1) \
        & np.asarray(prim_valid)
    out, start = [], 0
    for c in kind_counts:
        out.append(bool(has_map_row[start:start + c].any()))
        start += c
    return tuple(out)


def _median_split_order(tris: np.ndarray, leaf: int = 64) -> np.ndarray:
    """Row order by recursive widest-axis median split: every aligned
    ``leaf``-row run is one node of a median-split BVH. Only permutes rows
    within a kind (hit semantics are order-free)."""
    n = tris.shape[0]
    if n <= leaf:
        return np.arange(n)
    c = tris.mean(axis=1)
    order = np.empty(n, np.int64)
    pos = 0
    stack = [np.arange(n)]
    while stack:
        idx = stack.pop()
        if idx.shape[0] <= leaf:
            order[pos:pos + idx.shape[0]] = idx
            pos += idx.shape[0]
            continue
        cc = c[idx]
        axis = int(np.argmax(cc.max(0) - cc.min(0)))
        half = ((idx.shape[0] // 2 + leaf - 1) // leaf) * leaf
        part = np.argsort(cc[:, axis], kind="stable")
        stack.append(idx[part[half:]])
        stack.append(idx[part[:half]])
    return order


def compile_numpy(scene: schema.SceneConfig):
    """Flatten a :class:`~.schema.SceneConfig` into numpy ``(leaves, meta)``.

    Row for row the JAX compiler's ``compile_scene``."""
    rows = {k: {"a": [], "b": [], "c": [], "r": [], "ipos": [], "idir": [],
                "group": [], "mat": []} for k in range(N_KINDS)}
    group_counter = 0
    mat_albedo = []
    mat_scalar = {k: [] for k in ("rough", "metal", "glass", "opacity", "emit")}
    mat_maps = []
    textures = []

    def add_texture(arr) -> int:
        textures.append(np.asarray(arr, np.float32))
        return len(textures) - 1

    for obj in scene.objects:
        m = obj.mat
        mid = len(mat_albedo)
        mat_albedo.append(np.asarray(m.albedo, np.float32))
        for k in mat_scalar:
            mat_scalar[k].append(float(getattr(m, k)))
        mat_maps.append([
            add_texture(getattr(m, key)) if getattr(m, key) is not None else -1
            for key in schema.MaterialConfig.MAP_KEYS
        ])
        kind = schema._KIND_NAMES[obj.kind]
        if obj.kind == "mesh":
            tris = obj.geometry["mesh"]
        # one group_id per (object, instance); only mesh instances push more
        # than one row per group (the kernels' single-row-group fast path
        # rests on this)
        for ipos, idir in obj.instances:
            gid = group_counter
            group_counter += 1
            bucket = rows[kind]

            def push(a, b, c, r):
                bucket["a"].append(a)
                bucket["b"].append(b)
                bucket["c"].append(c)
                bucket["r"].append(r)
                bucket["ipos"].append(ipos)
                bucket["idir"].append(idir)
                bucket["group"].append(gid)
                bucket["mat"].append(mid)

            z3 = np.zeros(3, np.float32)
            if obj.kind == "sphere":
                push(z3, z3, z3, obj.geometry["r"])
            elif obj.kind == "plane":
                push(obj.geometry["n"], z3, z3, 0.0)
            elif obj.kind == "box":
                push(obj.geometry["sizes"], z3, z3, 0.0)
            elif obj.kind == "triangle":
                v = obj.geometry["vtx"]
                push(v[0], v[1], v[2], 0.0)
            elif obj.kind == "mesh":
                for t in _median_split_order(tris):
                    push(tris[t, 0], tris[t, 1], tris[t, 2], 0.0)

    # an empty scene still gets one all-invalid sphere segment so every
    # downstream gather/argmin is well-formed (all rays miss)
    if not any(rows[k]["a"] for k in range(N_KINDS)):
        z3 = np.zeros(3, np.float32)
        sph = rows[schema.KIND_SPHERE]
        for key, v in (("a", z3), ("b", z3), ("c", z3), ("r", 0.0),
                       ("ipos", z3), ("idir", schema.BACKWARD4.copy()),
                       ("group", -1), ("mat", 0)):
            sph[key].append(v)
        placeholder = True
    else:
        placeholder = False

    # long sphere segments get the median-split row order (cull blocks)
    ns = len(rows[schema.KIND_SPHERE]["a"])
    if ns >= 256:
        ctr = np.asarray(rows[schema.KIND_SPHERE]["ipos"],
                         np.float32).reshape(ns, 3)
        perm = _median_split_order(np.repeat(ctr[:, None, :], 3, axis=1))
        b = rows[schema.KIND_SPHERE]
        for kkey in b:
            b[kkey] = [b[kkey][i] for i in perm]

    kind_counts = []
    cat = {key: [] for key in ("a", "b", "c", "r", "ipos", "idir", "group",
                               "mat", "valid")}
    for k in range(N_KINDS):
        n = len(rows[k]["a"])
        n_pad = max(_SEG_PAD, -(-n // _SEG_PAD) * _SEG_PAD) if n else 0
        kind_counts.append(n_pad)
        if n_pad == 0:
            continue

        def v3(key):
            return _pad_rows(np.asarray(rows[k][key], np.float32)
                             .reshape(n, 3), n_pad)

        cat["a"].append(v3("a"))
        cat["b"].append(v3("b"))
        cat["c"].append(v3("c"))
        cat["r"].append(_pad_rows(np.asarray(rows[k]["r"], np.float32), n_pad))
        cat["ipos"].append(v3("ipos"))
        # padded rows need a unit-norm dir so instance_mat stays finite
        idir = np.asarray(rows[k]["idir"], np.float32).reshape(n, 4)
        idir_pad = np.tile(schema.BACKWARD4, (n_pad - n, 1)).astype(np.float32)
        cat["idir"].append(np.concatenate([idir, idir_pad], axis=0))
        # padding rows get group -1 so they never join a real group
        cat["group"].append(np.concatenate(
            [np.asarray(rows[k]["group"], np.int32),
             np.full(n_pad - n, -1, np.int32)]))
        cat["mat"].append(_pad_rows(np.asarray(rows[k]["mat"], np.int32),
                                    n_pad))
        cat["valid"].append(np.arange(n_pad) < n)

    def concat(key, empty_shape, dtype):
        if cat[key]:
            return np.concatenate(cat[key], axis=0).astype(dtype)
        return np.zeros(empty_shape, dtype)

    d = {
        "prim_a": concat("a", (0, 3), np.float32),
        "prim_b": concat("b", (0, 3), np.float32),
        "prim_c": concat("c", (0, 3), np.float32),
        "prim_r": concat("r", (0,), np.float32),
        "inst_pos": concat("ipos", (0, 3), np.float32),
        "inst_dir": concat("idir", (0, 4), np.float32),
        "group_id": concat("group", (0,), np.int32),
        "mat_id": concat("mat", (0,), np.int32),
        "prim_valid": concat("valid", (0,), bool),
    }
    if placeholder:
        d["prim_valid"] = np.zeros_like(d["prim_valid"])

    # material table (at least one row so gathers are well-formed)
    M = max(1, len(mat_albedo))
    d["mat_albedo"] = (_pad_rows(np.asarray(mat_albedo, np.float32)
                                 .reshape(len(mat_albedo), 3), M)
                       if mat_albedo else np.ones((1, 3), np.float32))
    for k, v in mat_scalar.items():
        d["mat_" + k] = (_pad_rows(np.asarray(v, np.float32), M) if v
                         else np.zeros(M, np.float32))
    if not mat_scalar["opacity"]:
        d["mat_opacity"] = np.ones(M, np.float32)
    mat_maps_np = (_pad_rows(np.asarray(mat_maps, np.int32)
                             .reshape(len(mat_maps), 6), M)
                   if mat_maps else np.full((1, 6), -1, np.int32))
    if mat_maps and len(mat_maps) < M:
        mat_maps_np[len(mat_maps):] = -1
    d["mat_maps"] = mat_maps_np

    # texture atlas
    offs, ws, hs, flat = [], [], [], []
    cursor = 0
    for t in textures:
        h, w = t.shape[:2]
        offs.append(cursor)
        ws.append(w)
        hs.append(h)
        flat.append(t.reshape(-1, 3))
        cursor += h * w
    if flat:
        d["tex_data"] = np.concatenate(flat, axis=0)
    else:
        d["tex_data"] = np.zeros((1, 3), np.float32)
        offs, ws, hs = [0], [1], [1]
    d["tex_offset"] = np.asarray(offs, np.int32)
    d["tex_w"] = np.asarray(ws, np.int32)
    d["tex_h"] = np.asarray(hs, np.int32)

    lights = scene.lights
    L = len(lights)
    d["light_is_dir"] = np.asarray([lt.kind == "dir" for lt in lights],
                                   bool).reshape(L)
    d["light_pos"] = np.asarray([lt.pos for lt in lights],
                                np.float32).reshape(L, 3)
    d["light_dir"] = np.asarray([lt.dir for lt in lights],
                                np.float32).reshape(L, 3)
    d["light_pwr"] = np.asarray([lt.pwr for lt in lights],
                                np.float32).reshape(L)
    d["light_color"] = np.asarray([lt.color for lt in lights],
                                  np.float32).reshape(L, 3)
    d["sky_color"] = np.asarray(scene.sky.color, np.float32)
    d["sky_pwr"] = np.asarray(scene.sky.pwr, np.float32)

    meta = {
        "kind_counts": tuple(kind_counts), "n_lights": L,
        "has_maps": bool(textures), "n_groups": group_counter,
        "map_slots": tuple(bool(np.any(mat_maps_np[:, s] >= 0))
                           for s in range(6)),
        "mapped_kinds": _mapped_kinds(kind_counts, d["mat_id"], mat_maps_np,
                                      d["prim_valid"]),
        "any_refract": any(
            o.mat.opacity != 1.0 or o.mat.glass != 0.0
            or o.mat.omap is not None or o.mat.gmap is not None
            for o in scene.objects),
    }
    return d, meta


def compile_scene(scene: schema.SceneConfig, device="cpu") -> SceneArrays:
    """Flatten a :class:`~.schema.SceneConfig` into :class:`SceneArrays`."""
    return scene_from_numpy(*compile_numpy(scene), device=device)
