"""Host-side asset loaders: textures and triangle meshes.

Re-implements the three wire formats the reference accepts for textures and
meshes (the reference's ``src/parser.rs:601-711``):

* raw buffer  — ``{"w": W, "h": H, "dat": [[r,g,b], ...]}`` / vertex list
* inline      — base64(gzip(JSON of the buffer form))
* file        — PNG/JPEG image (textures) or Wavefront OBJ (meshes)

All loaders return plain numpy arrays; the scene compiler packs them into the
device-side atlas.
"""

from __future__ import annotations

import base64
import gzip
import json

import numpy as np


def _looks_like_path(s: str) -> bool:
    # The reference routes strings containing "." to the file loader
    # (parser.rs:633-638, 687-692).
    return "." in s


def load_texture_file(path: str) -> np.ndarray:
    """Load an RGB image file to ``(H, W, 3)`` float32 in [0, 1].

    Mirrors ``TextureWrapper::load`` (parser.rs:660-672): RGB8 only, /255.
    """
    from PIL import Image

    img = Image.open(path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img, dtype=np.float32) / 255.0


def decode_inline(s: str):
    """Decode base64(gzip(JSON)) payloads (parser.rs:620-628, 674-682)."""
    return json.loads(gzip.decompress(base64.b64decode(s)).decode("utf-8"))


def encode_inline(obj) -> str:
    """Inverse of :func:`decode_inline` (parser.rs:644-656, 698-710)."""
    raw = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    return base64.b64encode(gzip.compress(raw, compresslevel=9)).decode("ascii")


def load_texture(spec) -> np.ndarray:
    """Resolve any texture wire format to ``(H, W, 3)`` float32.

    ``spec`` may be a dict buffer, an inline-base64 string, or a filename
    (string containing ``.``), matching ``TextureWrapper::to_buffer``
    (parser.rs:684-696).
    """
    if isinstance(spec, dict):
        w, h = int(spec.get("w", 0)), int(spec.get("h", 0))
        dat = spec.get("dat")
        if dat is None:
            return np.zeros((h, w, 3), dtype=np.float32)
        arr = np.asarray(dat, dtype=np.float32).reshape(h, w, 3)
        return arr
    if isinstance(spec, str):
        if _looks_like_path(spec):
            return load_texture_file(spec)
        inner = decode_inline(spec)
        return load_texture(inner)
    raise ValueError(f"unsupported texture spec: {type(spec)}")


def texture_to_buffer_json(tex: np.ndarray) -> dict:
    """Pack a ``(H, W, 3)`` array into the reference's buffer JSON form."""
    h, w = tex.shape[:2]
    return {"w": w, "h": h, "dat": [[float(c) for c in px] for px in tex.reshape(-1, 3)]}


def load_obj_mesh(path: str) -> np.ndarray:
    """Load the first object/group of a Wavefront OBJ as ``(T, 3, 3)``.

    Mirrors ``MeshWrapper::load`` (parser.rs:602-618): positions only,
    triangles assumed.  Faces with more than 3 vertices use the first three
    indices, like the reference's ``idx.0[0..3]`` access.
    """
    positions = []
    tris = []
    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                positions.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:4]]
                tris.append(idx)
    if not tris:
        raise ValueError(f"no triangle faces found in {path!r}")
    pos = np.asarray(positions, dtype=np.float32)
    out = np.stack([pos[[a, b, c]] for a, b, c in tris], axis=0)
    return out.astype(np.float32)


def load_mesh(spec) -> np.ndarray:
    """Resolve any mesh wire format to ``(T, 3, 3)`` float32 vertices.

    Accepts a vertex-triple list, an inline-base64 string, or an OBJ filename
    (``MeshWrapper::to_buffer``, parser.rs:630-642).
    """
    if isinstance(spec, (list, tuple)):
        return np.asarray(spec, dtype=np.float32).reshape(-1, 3, 3)
    if isinstance(spec, str):
        if _looks_like_path(spec):
            return load_obj_mesh(spec)
        inner = decode_inline(spec)
        return load_mesh(inner)
    raise ValueError(f"unsupported mesh spec: {type(spec)}")


def mesh_to_buffer_json(mesh: np.ndarray) -> list:
    """Pack ``(T, 3, 3)`` vertices into the reference's JSON list form."""
    return [[[float(c) for c in v] for v in tri] for tri in mesh]
