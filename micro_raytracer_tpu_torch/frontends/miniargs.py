"""The ``key:`` CLI mini-language for building scenes from flag tokens.

Re-implements the reference's ``FromArgs``/``ParseFromArgs`` token grammar
(src/parser.rs:274-598): ``--obj``/``--light``/``--cam``/
``--sky`` take flat token streams where parameters are introduced by
``key:``-suffixed tokens and values are whitespace-separated floats, hex
colors, names, or file/base64 strings.

Multi-object splitting reproduces the reference's reversed
``split_inclusive`` exactly (parser.rs:584-595): the token list is reversed,
split inclusively at type tokens, and each chunk is reversed back — so
object groups come out in *reverse* command-line order, and stray tokens
before the first type token form a final (erroring) group.

The output of each parser is a plain JSON-style dict in the same shape the
schema layer accepts, so CLI-built and JSON-built scenes share one lowering
path (:mod:`micro_raytracer_tpu_torch.models.schema`).
"""

from __future__ import annotations

OBJ_TYPE_TOKENS = ("sphere", "sph", "plane", "pln", "box", "tri", "triangle",
                   "mesh")
LIGHT_TYPE_TOKENS = ("pt:", "point:", "dir:")


class TokenError(ValueError):
    pass


class _It:
    """Peekable iterator over tokens, mirroring the Rust iterator protocol."""

    def __init__(self, tokens):
        self.tokens = list(tokens)
        self.i = 0

    def next(self) -> str:
        if self.i >= len(self.tokens):
            raise TokenError("unexpected ends!")
        t = self.tokens[self.i]
        self.i += 1
        return t

    def peek(self):
        return self.tokens[self.i] if self.i < len(self.tokens) else None

    def done(self) -> bool:
        return self.i >= len(self.tokens)

    # checkpoint/rollback for the mesh vertex-stream loop (parser.rs:478-494)
    def mark(self) -> int:
        return self.i

    def rollback(self, mark: int) -> None:
        self.i = mark


def _f32(it: _It) -> float:
    t = it.next()
    try:
        return float(t)
    except ValueError:
        raise TokenError("should be <f32>!")


def _vec3(it: _It) -> list:
    return [_f32(it), _f32(it), _f32(it)]


def _vec4(it: _It) -> list:
    return [_f32(it), _f32(it), _f32(it), _f32(it)]


def _color(it: _It):
    """Hex string or 3 floats (parser.rs:313-326)."""
    t = it.peek()
    if t is None:
        raise TokenError("unexpected ends!")
    if t.startswith("#"):
        it.next()
        return t
    return _vec3(it)


def _norm3(v):
    m = (v[0] ** 2 + v[1] ** 2 + v[2] ** 2) ** 0.5
    return [v[0] / m, v[1] / m, v[2] / m]


def parse_camera(tokens) -> dict:
    """``--cam`` tokens -> camera JSON dict (parser.rs:331-353).

    Starts from a fresh default camera: the result *replaces* any camera
    from ``--frame`` JSON (cli.rs:127-129).
    """
    it = _It(tokens)
    cam = {}
    while not it.done():
        p = it.next()
        if p == "pos:":
            cam["pos"] = _vec3(it)
        elif p == "dir:":
            cam["dir"] = _vec4(it)
        elif p in ("fov:", "gamma:", "exp:", "aprt:", "foc:"):
            cam[p[:-1]] = _f32(it)
        else:
            raise TokenError(f"`{p}` param for `cam` is unxpected!")
    return cam


def _parse_light(tokens) -> dict:
    """One light group -> light JSON dict (parser.rs:356-416).

    The leading token selects the kind; the same token later re-sets the
    type parameter (point position / normalized direction).
    """
    t = tokens[0]
    if t in ("pt:", "point:"):
        light = {"type": "point", "pos": [0.0, 0.0, 0.0]}
    elif t == "dir:":
        light = {"type": "dir", "dir": [0.0, 1.0, 0.0]}
    else:
        raise TokenError(f"`{t}` type is unxpected!")

    it = _It(tokens)
    while not it.done():
        p = it.next()
        is_type_param = False
        if light["type"] == "point" and p in ("pt:", "point:"):
            light["pos"] = _vec3(it)
            is_type_param = True
        elif light["type"] == "dir" and p == "dir:":
            light["dir"] = _norm3(_vec3(it))  # normalized at parse time
            is_type_param = True

        if p == "col:":
            light["color"] = _color(it)
        elif p == "pwr:":
            light["pwr"] = _f32(it)
        elif not is_type_param:
            raise TokenError(f"`{p}` param for `light` is unxpected!")
    return light


_DEFAULT_TRI = [[0.5, 0.0, -0.25], [0.0, 0.0, 0.5], [-0.5, 0.0, -0.25]]


def _parse_obj(tokens) -> dict:
    """One object group -> renderer JSON dict (parser.rs:418-582).

    CLI-built objects get type-parameter defaults (sphere r=0.5, plane
    n=+z, box 0.5 cube, default triangle) that pure JSON input does not.
    """
    t = tokens[0]
    if t in ("sph", "sphere"):
        obj = {"type": "sphere", "r": 0.5}
    elif t in ("pln", "plane"):
        obj = {"type": "plane", "n": [0.0, 0.0, 1.0]}
    elif t == "box":
        obj = {"type": "box", "sizes": [0.5, 0.5, 0.5]}
    elif t in ("tri", "triangle"):
        obj = {"type": "triangle", "vtx": [list(v) for v in _DEFAULT_TRI]}
    elif t == "mesh":
        obj = {"type": "mesh", "mesh": [[list(v) for v in _DEFAULT_TRI]]}
    else:
        raise TokenError(f"`{t}` type is unxpected!")

    obj["pos"] = [0.0, 0.0, 0.0]
    obj["dir"] = [0.0, 0.0, -1.0, 0.0]  # Vec4f::backward
    mat = {}

    it = _It(tokens[1:])
    while not it.done():
        p = it.next()
        is_type_param = False
        if obj["type"] == "sphere" and p == "r:":
            obj["r"] = _f32(it)
            is_type_param = True
        elif obj["type"] == "plane" and p == "n:":
            obj["n"] = _vec3(it)
            is_type_param = True
        elif obj["type"] == "box" and p == "size:":
            obj["sizes"] = _vec3(it)
            is_type_param = True
        elif obj["type"] == "triangle" and p == "vtx:":
            obj["vtx"] = [_vec3(it), _vec3(it), _vec3(it)]
            is_type_param = True
        elif obj["type"] == "mesh" and p == "mesh:":
            tris = [[_vec3(it), _vec3(it), _vec3(it)]]
            while True:  # greedy vertex stream (parser.rs:478-494)
                mark = it.mark()
                try:
                    tris.append([_vec3(it), _vec3(it), _vec3(it)])
                except TokenError:
                    it.rollback(mark)
                    break
            obj["mesh"] = tris
            is_type_param = True

        if p == "name:":
            obj["name"] = it.next()
        elif p == "pos:":
            obj["pos"] = _vec3(it)
        elif p == "dir:":
            obj["dir"] = _vec4(it)
        elif p == "albedo:":
            mat["albedo"] = _color(it)
        elif p in ("rough:", "metal:", "glass:", "opacity:", "emit:"):
            mat[p[:-1]] = _f32(it)
        elif p in ("tex:", "rmap:", "mmap:", "gmap:", "omap:", "emap:"):
            # file if the string contains ".", else inline base64
            mat[p[:-1]] = it.next()
        elif not is_type_param:
            raise TokenError(f"`{p}` param for `{t}` is unxpected!")

    if mat:
        obj["mat"] = mat
    return obj


def split_groups(tokens, type_tokens) -> list:
    """Reference group-splitting (parser.rs:584-595): reversed
    ``split_inclusive`` at type tokens, each chunk reversed back.
    Groups therefore come out in reverse command-line order."""
    rev = list(reversed(list(tokens)))
    chunks, cur = [], []
    for t in rev:
        cur.append(t)
        if t in type_tokens:
            chunks.append(cur)
            cur = []
    if cur:
        chunks.append(cur)
    return [list(reversed(c)) for c in chunks]


def parse_objects(tokens) -> list:
    return [_parse_obj(g) for g in split_groups(tokens, OBJ_TYPE_TOKENS)]


def parse_lights(tokens) -> list:
    return [_parse_light(g) for g in split_groups(tokens, LIGHT_TYPE_TOKENS)]


def parse_sky(tokens) -> dict:
    """``--sky r g b pwr`` — vec3 color + required pwr (cli.rs:146-150)."""
    it = _It(tokens)
    return {"color": _vec3(it), "pwr": _f32(it)}
