"""The port's CLI and HTTP service on the CPU: the same flags, merge order
and log lines as the JAX CLI, PNG output, and JPEG responses."""

import json
import logging
import socket
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from micro_raytracer_tpu.frontends import cli as jcli
from micro_raytracer_tpu_torch.frontends import cli as tcli
from micro_raytracer_tpu_torch.frontends.http import HttpServer
from torch_mesh_helpers import one_torch_thread  # noqa: F401

SPHERE = ["--obj", "sphere", "--light", "point:", "-0.5", "-1", "0.5"]


def test_cli_renders_png(tmp_path):
    out = tmp_path / "o.png"
    rc = tcli.main(SPHERE + ["--res", "32", "32", "--sample", "2",
                             "--device", "cpu", "-o", str(out)])
    assert rc == 0 and out.exists()
    img = np.asarray(Image.open(out))
    assert img.shape == (32, 32, 3)
    assert img.max() > 20          # the lit sphere is visible


def _render_logs(main, argv, caplog):
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="raytrace"):
        assert main(argv) == 0
    return [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("cli:render:")]


@pytest.mark.parametrize("extra", [[], ["--pretty"]])
def test_dry_run_prints_the_same_merged_json(extra, caplog, tmp_path):
    argv = SPHERE + ["--obj", "box", "size:", "0.3", "0.4", "0.5", "pos:",
                     "0", "1", "0", "emit:", "1", "--sky", "0.1", "0.2",
                     "0.3", "0.9", "--cam", "pos:", "0", "-2", "0",
                     "--bounce", "3", "--res", "40", "30", "-d", "-v",
                     "-o", str(tmp_path / "none.png")] + extra
    got = _render_logs(tcli.main, argv, caplog)
    want = _render_logs(jcli.main, argv, caplog)
    assert len(got) == 1 and got == want
    assert json.loads(got[0][len("cli:render: "):])["rt"]["bounce"] == 3
    assert not (tmp_path / "none.png").exists()


def test_resume_roundtrip(tmp_path):
    out, state = tmp_path / "o.png", tmp_path / "s.npz"
    argv = SPHERE + ["--res", "24", "16", "--sample", "2", "--bounce", "2",
                     "--device", "cpu", "-o", str(out),
                     "--save-state", str(state)]
    assert tcli.main(argv) == 0 and state.exists()
    argv2 = argv[:-2] + ["--sample", "3", "--resume", str(state)]
    assert tcli.main(argv2) == 0
    with np.load(state) as data:
        assert int(data["count"]) == 2


@pytest.mark.parametrize("flag", [["--devices", "2"], ["--sp", "2"]])
def test_multi_device_flags_are_refused(flag, capsys):
    assert tcli.main(SPHERE + flag + ["--device", "cpu", "-d"]) == 1
    assert "multi-device not yet ported" in capsys.readouterr().err


def test_unported_scene_class_is_refused(capsys, tmp_path):
    """A textured material (not ported yet) is refused with rc 1."""
    cfg = tmp_path / "textured.json"
    cfg.write_text(json.dumps({"scene": {"renderer": [
        {"type": "sphere", "r": 0.5, "mat": {"tex": {
            "w": 2, "h": 1, "dat": [[1, 0, 0], [0, 1, 0]]}}}]}}))
    rc = tcli.main([str(cfg), "--res", "8", "8", "--sample", "1",
                    "--device", "cpu", "-o", str(tmp_path / "unused.png")])
    assert rc == 1
    assert "not ported" in capsys.readouterr().err


def test_cuda_without_a_card_is_refused(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = tcli.main(SPHERE + ["--res", "8", "8", "--sample", "1",
                             "-o", "unused.png"])
    assert rc == 1
    assert "no CUDA device" in capsys.readouterr().err


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _req(port, raw: bytes) -> bytes:
    with socket.create_connection(("127.0.0.1", port), timeout=120) as s:
        s.sendall(raw)
        out = b""
        while True:
            chunk = s.recv(1 << 20)
            if not chunk:
                return out
            out += chunk


@pytest.fixture()
def server():
    port = _free_port()
    srv = HttpServer(f"127.0.0.1:{port}", device="cpu")
    th = threading.Thread(target=srv.start, daemon=True)
    th.start()
    deadline = time.time() + 30
    while True:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            break
        except OSError:
            assert time.time() < deadline and th.is_alive()
            time.sleep(0.05)
    yield port
    srv.stop()
    th.join(timeout=30)
    assert not th.is_alive()


def test_http_render_and_method_check(server):
    body = json.dumps({
        "rt": {"sample": 2, "bounce": 2},
        "frame": {"res": [32, 24]},
        "scene": {"renderer": [{"type": "sphere", "r": 0.5}],
                  "light": [{"type": "point", "pos": [-0.5, -1, 0.5]}]},
    }).encode()
    head = (b"HTTP/1.1\r\nContent-Type: application/json\r\n"
            + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    res = _req(server, b"POST /render " + head)
    assert res.startswith(b"HTTP/1.1 200 OK")
    assert b"Content-Type: image/jpeg" in res
    assert res.split(b"\r\n\r\n", 1)[1][:2] == b"\xff\xd8"
    res = _req(server, b"GET /render " + head)
    assert b"405" in res.split(b"\r\n")[0]
