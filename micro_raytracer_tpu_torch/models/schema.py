"""Scene description schema: the JSON grammar of the reference renderer.

Mirrors the serde ``*Wrapper`` types and their field defaults from
the reference's ``src/parser.rs:16-271`` so that every ``example/*.json`` the
reference ships parses to the same render description here.  This is pure
host-side config; lowering to device arrays happens in
:mod:`micro_raytracer_tpu_torch.models.compiler`.

Defaults (parser.rs):
  rt     bounce=8 sample=16 loss=0.15                     (parser.rs:188-196)
  frame  res=(1280,720) ssaa=1                            (parser.rs:212-220)
  cam    pos=(0,-1,0) dir=[0,0,1,0] fov=70 gamma=0.8
         exp=0.2 aprt=0.001 foc=100                       (parser.rs:198-210)
  sky    color=0 pwr=0.5                                  (parser.rs:222-229)
  mat    albedo=1 opacity=1 rough/metal/glass/emit=0      (parser.rs:242-259)
  light  point at origin, pwr=0.5, color=1                (parser.rs:261-271)
  object pos=0, dir=backward=[0,0,-1,0]                   (parser.rs:843-853)
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


def parse_color(v) -> np.ndarray:
    """Color: ``[r,g,b]`` floats or ``"#rrggbb"`` hex (parser.rs:713-733)."""
    if isinstance(v, str):
        if not v.startswith("#"):
            raise ValueError(f"{v} is not a hex color!")
        n = int(v[1:7], 16)
        return np.array(
            [((n >> 16) & 0xFF) / 255.0, ((n >> 8) & 0xFF) / 255.0, (n & 0xFF) / 255.0],
            dtype=np.float32,
        )
    return np.asarray(v, dtype=np.float32)


def _vec3(v) -> np.ndarray:
    return np.asarray(v, dtype=np.float32).reshape(3)


def _vec4(v) -> np.ndarray:
    """[w, x, y, z] direction (lin.rs:428-443)."""
    return np.asarray(v, dtype=np.float32).reshape(4)


BACKWARD4 = np.array([0.0, 0.0, -1.0, 0.0], dtype=np.float32)  # Vec4f::backward
FORWARD4 = np.array([0.0, 0.0, 1.0, 0.0], dtype=np.float32)


@dataclass
class RayTracerConfig:
    bounce: int = 8
    sample: int = 16
    loss: float = 0.15

    @classmethod
    def from_json(cls, d: dict) -> "RayTracerConfig":
        out = cls()
        for k in ("bounce", "sample"):
            if k in d:
                setattr(out, k, int(d[k]))
        if "loss" in d:
            out.loss = float(d["loss"])
        return out

    def to_json(self) -> dict:
        return {"bounce": self.bounce, "sample": self.sample, "loss": self.loss}


@dataclass
class CameraConfig:
    pos: np.ndarray = field(default_factory=lambda: np.array([0.0, -1.0, 0.0], np.float32))
    dir: np.ndarray = field(default_factory=lambda: FORWARD4.copy())
    fov: float = 70.0
    gamma: float = 0.8
    exp: float = 0.2
    aprt: float = 0.001
    foc: float = 100.0

    @classmethod
    def from_json(cls, d: dict) -> "CameraConfig":
        out = cls()
        if "pos" in d:
            out.pos = _vec3(d["pos"])
        if "dir" in d:
            out.dir = _vec4(d["dir"])
        for k in ("fov", "gamma", "exp", "aprt", "foc"):
            if k in d:
                setattr(out, k, float(d[k]))
        return out

    def to_json(self) -> dict:
        return {
            "pos": [float(v) for v in self.pos],
            "dir": [float(v) for v in self.dir],
            "fov": self.fov,
            "gamma": self.gamma,
            "exp": self.exp,
            "aprt": self.aprt,
            "foc": self.foc,
        }


@dataclass
class FrameConfig:
    res: tuple = (1280, 720)
    ssaa: float = 1.0
    cam: CameraConfig = field(default_factory=CameraConfig)

    @classmethod
    def from_json(cls, d: dict) -> "FrameConfig":
        out = cls()
        if "res" in d:
            out.res = (int(d["res"][0]), int(d["res"][1]))
        if "ssaa" in d:
            out.ssaa = float(d["ssaa"])
        if "cam" in d:
            out.cam = CameraConfig.from_json(d["cam"])
        return out

    def to_json(self) -> dict:
        return {"res": list(self.res), "ssaa": self.ssaa, "cam": self.cam.to_json()}

    @property
    def render_res(self) -> tuple:
        """Supersampled internal resolution (sampler.rs:29-30): truncating."""
        return (int(self.res[0] * self.ssaa), int(self.res[1] * self.ssaa))


@dataclass
class MaterialConfig:
    albedo: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    rough: float = 0.0
    metal: float = 0.0
    glass: float = 0.0
    opacity: float = 1.0
    emit: float = 0.0
    # Optional texture maps; each is a (H, W, 3) float32 array once loaded.
    tex: Optional[np.ndarray] = None
    rmap: Optional[np.ndarray] = None
    mmap: Optional[np.ndarray] = None
    gmap: Optional[np.ndarray] = None
    omap: Optional[np.ndarray] = None
    emap: Optional[np.ndarray] = None

    MAP_KEYS = ("tex", "rmap", "mmap", "gmap", "omap", "emap")

    @classmethod
    def from_json(cls, d: dict) -> "MaterialConfig":
        from ..utils import assets

        out = cls()
        if "albedo" in d:
            out.albedo = parse_color(d["albedo"])
        for k in ("rough", "metal", "glass", "opacity", "emit"):
            if k in d:
                setattr(out, k, float(d[k]))
        for k in cls.MAP_KEYS:
            if d.get(k) is not None:
                setattr(out, k, assets.load_texture(d[k]))
        return out

    def to_json(self) -> dict:
        from ..utils import assets

        out = {
            "albedo": [float(v) for v in self.albedo],
            "rough": self.rough,
            "metal": self.metal,
            "glass": self.glass,
            "opacity": self.opacity,
            "emit": self.emit,
        }
        for k in self.MAP_KEYS:
            v = getattr(self, k)
            out[k] = None if v is None else assets.texture_to_buffer_json(v)
        return out


# Primitive kind codes, also the sort order of the compiled SoA buffers.
KIND_SPHERE = 0
KIND_PLANE = 1
KIND_BOX = 2
KIND_TRIANGLE = 3  # standalone triangles AND flattened mesh triangles

_KIND_NAMES = {"sphere": KIND_SPHERE, "plane": KIND_PLANE, "box": KIND_BOX,
               "triangle": KIND_TRIANGLE, "mesh": KIND_TRIANGLE}


@dataclass
class ObjectConfig:
    """One renderer entry: a primitive + material + instance transforms.

    ``kind`` is the JSON ``type`` string; geometry holds:
      sphere   -> {"r": float}
      plane    -> {"n": (3,)}
      box      -> {"sizes": (3,)}
      triangle -> {"vtx": (3,3)}
      mesh     -> {"mesh": (T,3,3)}
    """

    kind: str = "sphere"
    geometry: dict = field(default_factory=lambda: {"r": 0.5})
    mat: MaterialConfig = field(default_factory=MaterialConfig)
    instances: list = field(default_factory=list)  # [(pos(3,), dir(4,)), ...]
    name: Optional[str] = None

    @classmethod
    def from_json(cls, d: dict) -> "ObjectConfig":
        from ..utils import assets

        kind = d["type"]
        if kind not in _KIND_NAMES:
            raise ValueError(f"`{kind}` type is unexpected!")
        out = cls(kind=kind)
        if kind == "sphere":
            out.geometry = {"r": float(d["r"])}
        elif kind == "plane":
            out.geometry = {"n": _vec3(d["n"])}
        elif kind == "box":
            out.geometry = {"sizes": _vec3(d["sizes"])}
        elif kind == "triangle":
            out.geometry = {"vtx": np.asarray(d["vtx"], np.float32).reshape(3, 3)}
        elif kind == "mesh":
            out.geometry = {"mesh": assets.load_mesh(d["mesh"])}
        out.mat = MaterialConfig.from_json(d.get("mat", {}))
        out.name = d.get("name")

        # Instance normalization (parser.rs:838-853): explicit `inst` list,
        # with (pos, dir) prepended iff either was given; else single instance
        # from pos/dir with defaults pos=0, dir=backward.
        pos = _vec3(d["pos"]) if d.get("pos") is not None else None
        dr = _vec4(d["dir"]) if d.get("dir") is not None else None
        inst = d.get("inst")
        if inst is not None:
            lst = [( _vec3(p), _vec4(q)) for p, q in inst]
            if pos is not None or dr is not None:
                lst.insert(0, (pos if pos is not None else np.zeros(3, np.float32),
                               dr if dr is not None else BACKWARD4.copy()))
            out.instances = lst
        else:
            out.instances = [(pos if pos is not None else np.zeros(3, np.float32),
                              dr if dr is not None else BACKWARD4.copy())]
        return out

    def to_json(self) -> dict:
        g = {}
        if self.kind == "sphere":
            g = {"r": self.geometry["r"]}
        elif self.kind == "plane":
            g = {"n": [float(v) for v in self.geometry["n"]]}
        elif self.kind == "box":
            g = {"sizes": [float(v) for v in self.geometry["sizes"]]}
        elif self.kind == "triangle":
            g = {"vtx": [[float(c) for c in v] for v in self.geometry["vtx"]]}
        elif self.kind == "mesh":
            from ..utils import assets

            g = {"mesh": assets.mesh_to_buffer_json(self.geometry["mesh"])}
        out = {"type": self.kind, **g, "mat": self.mat.to_json(), "name": self.name}
        out["inst"] = [[[float(v) for v in p], [float(v) for v in q]]
                       for p, q in self.instances]
        return out


@dataclass
class LightConfig:
    kind: str = "point"  # "point" | "dir"
    pos: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    dir: np.ndarray = field(default_factory=lambda: np.array([0, 1, 0], np.float32))
    pwr: float = 0.5
    color: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))

    @classmethod
    def from_json(cls, d: dict) -> "LightConfig":
        out = cls()
        out.kind = d.get("type", "point")
        if out.kind == "point":
            if "pos" in d:
                out.pos = _vec3(d["pos"])
        elif out.kind == "dir":
            if "dir" in d:
                out.dir = _vec3(d["dir"])
        else:
            raise ValueError(f"unknown light type {out.kind}")
        if "pwr" in d:
            out.pwr = float(d["pwr"])
        if "color" in d:
            out.color = parse_color(d["color"])
        return out

    def to_json(self) -> dict:
        out = {"type": self.kind, "pwr": self.pwr,
               "color": [float(v) for v in self.color]}
        if self.kind == "point":
            out["pos"] = [float(v) for v in self.pos]
        else:
            out["dir"] = [float(v) for v in self.dir]
        return out


@dataclass
class SkyConfig:
    color: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    pwr: float = 0.5

    @classmethod
    def from_json(cls, d: dict) -> "SkyConfig":
        out = cls()
        if "color" in d:
            out.color = parse_color(d["color"])
        if "pwr" in d:
            out.pwr = float(d["pwr"])
        return out

    def to_json(self) -> dict:
        return {"color": [float(v) for v in self.color], "pwr": self.pwr}


@dataclass
class SceneConfig:
    objects: list = field(default_factory=list)   # [ObjectConfig]
    lights: list = field(default_factory=list)    # [LightConfig]
    sky: SkyConfig = field(default_factory=SkyConfig)

    @classmethod
    def from_json(cls, d: dict) -> "SceneConfig":
        out = cls()
        if d.get("renderer"):
            out.objects = [ObjectConfig.from_json(o) for o in d["renderer"]]
        if d.get("light"):
            out.lights = [LightConfig.from_json(l) for l in d["light"]]
        if "sky" in d:
            out.sky = SkyConfig.from_json(d["sky"])
        return out

    def to_json(self) -> dict:
        return {
            "renderer": [o.to_json() for o in self.objects] or None,
            "light": [l.to_json() for l in self.lights] or None,
            "sky": self.sky.to_json(),
        }


@dataclass
class RenderConfig:
    """Top-level render description (RenderWrapper, parser.rs:160-166)."""

    rt: RayTracerConfig = field(default_factory=RayTracerConfig)
    frame: FrameConfig = field(default_factory=FrameConfig)
    scene: SceneConfig = field(default_factory=SceneConfig)

    @classmethod
    def from_json(cls, d: dict) -> "RenderConfig":
        out = cls()
        if "rt" in d:
            out.rt = RayTracerConfig.from_json(d["rt"])
        if "frame" in d:
            out.frame = FrameConfig.from_json(d["frame"])
        if "scene" in d:
            out.scene = SceneConfig.from_json(d["scene"])
        return out

    def to_json(self) -> dict:
        return {"rt": self.rt.to_json(), "frame": self.frame.to_json(),
                "scene": self.scene.to_json()}

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
