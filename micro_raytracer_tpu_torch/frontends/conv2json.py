"""`conv2json`: convert images / wavefront OBJs to render-JSON fragments.

The counterpart of ``micro_raytracer_tpu.frontends.conv2json`` over the
port's own copy of ``utils/assets.py``, with its flags and its output byte
for byte: ``--img`` emits ``{"tex": ...}`` and ``--obj`` emits ``{"mesh":
...}`` in raw-buffer (``buf``, default) or gzip+base64 inline (``inl``)
format, compact or ``--pretty``; an unreadable or malformed input exits 1
with the error on stderr.

    python -m micro_raytracer_tpu_torch.frontends.conv2json --img x.png -f inl
    python -m micro_raytracer_tpu_torch.frontends.conv2json --obj x.obj --pretty
"""

from __future__ import annotations

import argparse
import json
import sys

from ..utils import assets


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="conv2json",
        description="Convert images to json for micro-rt.")
    p.add_argument("--img", help="Input image filename")
    p.add_argument("--obj", help="Input wavefont object filename")
    p.add_argument("--pretty", action="store_true",
                   help="Print json with prettifier")
    p.add_argument("-f", "--fmt", choices=("buf", "inl"), default="buf",
                   metavar="fmt: <buf|inl>", help="Texture format")
    args = p.parse_args(argv)

    out = {}
    try:
        if args.img:
            buf = assets.texture_to_buffer_json(
                assets.load_texture_file(args.img))
            out = {"tex": assets.encode_inline(buf) if args.fmt == "inl"
                   else buf}
        elif args.obj:
            buf = assets.mesh_to_buffer_json(assets.load_obj_mesh(args.obj))
            out = {"mesh": assets.encode_inline(buf) if args.fmt == "inl"
                   else buf}
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    print(json.dumps(out, indent=2) if args.pretty
          else json.dumps(out, separators=(",", ":")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
