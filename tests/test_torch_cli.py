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


@pytest.mark.parametrize("flag", [["--devices", "2", "--sp", "2"],
                                  ["--devices", "2"]])
def test_multi_device_flags_are_refused(flag, tmp_path, caplog):
    """Once refused, ``--devices 2 [--sp 2]`` now render over a mesh of
    the CPU named twice ((1, 2) and (2, 1)): the PNG equals the one-device
    one (two samples: with sp = 2 each column sums one, so the sums keep
    the one-device order)."""
    base = SPHERE + ["--res", "24", "16", "--sample", "2", "--bounce", "2",
                     "--device", "cpu", "-v"]
    one, many = tmp_path / "one.png", tmp_path / "many.png"
    assert tcli.main(base + ["-o", str(one)]) == 0
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="raytrace"):
        assert tcli.main(base + flag + ["-o", str(many)]) == 0
    shape = {"dp": 1, "sp": 2} if "--sp" in flag else {"dp": 2, "sp": 1}
    assert f"cli:mesh: {shape}" in [r.getMessage() for r in caplog.records]
    np.testing.assert_array_equal(np.asarray(Image.open(many)),
                                  np.asarray(Image.open(one)))


def test_sp_without_devices_is_refused(capsys):
    """``--sp`` alone names no mesh: refused, not rendered on one
    device."""
    assert tcli.main(SPHERE + ["--sp", "2", "--device", "cpu", "-d"]) == 1
    assert "--sp needs --devices" in capsys.readouterr().err


def test_unported_scene_class_is_refused(tmp_path):
    """A textured material, refused with rc 1 before textures were ported,
    now renders (rc 0): the texture shows in the image."""
    imgs = []
    for dat in ([[1, 0, 0], [0, 1, 0]], [[0, 0, 1], [0, 0, 1]]):
        cfg = tmp_path / "textured.json"
        cfg.write_text(json.dumps({"scene": {
            "renderer": [{"type": "sphere", "r": 0.5, "mat": {"tex": {
                "w": 2, "h": 1, "dat": dat}}}],
            "light": [{"type": "point", "pos": [-0.5, -1, 0.5]}]}}))
        out = tmp_path / "textured.png"
        rc = tcli.main([str(cfg), "--res", "16", "16", "--sample", "1",
                        "--device", "cpu", "-o", str(out)])
        assert rc == 0
        imgs.append(np.asarray(Image.open(out)).astype(int))
    # the red/green texture against the blue one: the sphere's colour moves
    assert imgs[0][..., 2].sum() < imgs[1][..., 2].sum()


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


def test_http_server_renders_over_one_mesh():
    """``HttpServer(devices=, sp=)`` builds one mesh for the whole server
    (the CLI's ``--devices`` / ``--sp``) and renders each request over it:
    the JPEG equals the one-device server's (two samples, so even with
    sp = 2 the sums keep the one-device order); sp alone is refused."""
    from micro_raytracer_tpu_torch.frontends.http import render_jpeg

    body = json.dumps({
        "rt": {"sample": 2, "bounce": 2}, "frame": {"res": [24, 16]},
        "scene": {"renderer": [{"type": "sphere", "r": 0.5}],
                  "light": [{"type": "point", "pos": [-0.5, -1, 0.5]}]},
    }).encode()
    srv = HttpServer("127.0.0.1:0", device="cpu", devices=4, sp=2)
    assert srv.mesh.shape == {"dp": 2, "sp": 2}
    got = srv._render(body, "test")
    assert got[:2] == b"\xff\xd8"
    assert got == render_jpeg(body, device="cpu")
    with pytest.raises(ValueError, match="sp needs devices"):
        HttpServer("127.0.0.1:0", device="cpu", sp=2)
