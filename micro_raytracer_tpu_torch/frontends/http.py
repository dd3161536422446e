"""HTTP rendering microservice: POST a render JSON, receive a JPEG.

The counterpart of ``micro_raytracer_tpu.frontends.http`` (the reference's
http.rs:14-164): strict request validation (HTTP/1.1 + POST +
application/json + matching Content-Length -> 505/405/400/415/411), a render
at the request's own sample count on the server's device (or over the
one device mesh of the whole server, ``devices`` / ``sp``: the CLI's
``--devices`` / ``--sp``), serialized through a lock, and a quality-90
``image/jpeg`` response. The socket loop
runs in the native C++ transport when it is built, else in Python.
:meth:`HttpServer.stop` ends either loop.
"""

from __future__ import annotations

import io
import json
import logging
import os
import socket
import threading
import time

from ..models import schema

log = logging.getLogger("raytrace")

_MAX_HEADER = 1 << 20


def render_jpeg(body: bytes, peer: str = "?", device="cuda",
                mesh=None) -> bytes:
    """Parse a render JSON body and return the rendered JPEG (q90) bytes
    (``HttpServer::raytrace``, http.rs:136-148); over ``mesh`` where
    given."""
    from PIL import Image

    from ..models.render import Renderer

    cfg = schema.RenderConfig.from_json(json.loads(body.decode("utf-8")))
    log.info("http:render[%s]: %s", peer, json.dumps(cfg.to_json()))
    r = Renderer(cfg, device=device, mesh=mesh)
    sample = 0
    while sample < cfg.rt.sample:
        n = min(16, cfg.rt.sample - sample)
        dt = r.execute_many(n)
        sample += n
        log.info("http:sample[%s]:%d: %.3fs", peer, sample - 1, dt)
    buf = io.BytesIO()
    Image.fromarray(r.img()).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def _parse_request(raw: bytes):
    head, _, body = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) < 3:
        raise ValueError("malformed status line")
    method, uri, version = parts[0], parts[1], parts[2]
    headers = {}
    for line in lines[1:]:
        k, _, v = line.partition(": ")
        if k:
            headers[k] = v
    return method, uri, version, headers, body


class HttpServer:
    """Blocking accept-loop server (http.rs:150-163) on ``device``, or
    over one mesh of ``devices`` devices of its kind (``sp``: the
    sample-parallel axis, default 1), built for the whole server."""

    def __init__(self, addr: str, device="cuda", devices: int | None = None,
                 sp: int | None = None):
        host, _, port = addr.rpartition(":")
        self.host = host or "0.0.0.0"
        self.port = int(port)
        self.device = device
        self.mesh = None
        if devices is not None:
            from ..parallel.mesh import make_mesh

            self.mesh = make_mesh(devices, sp=sp or 1, device=device)
            log.info("http:mesh: %s", self.mesh.shape)
        elif sp is not None:
            raise ValueError("sp needs devices")
        self._render_lock = threading.Lock()
        self._stop = threading.Event()
        self._native = False

    def _render(self, body: bytes, peer: str) -> bytes:
        with self._render_lock:
            return render_jpeg(body, peer=peer, device=self.device,
                               mesh=self.mesh)

    # -- per-connection handler (http.rs:61-134) --------------------------
    def handle(self, conn: socket.socket, peer) -> None:
        try:
            conn.settimeout(30.0)
            raw = conn.recv(_MAX_HEADER)
            if not raw:
                return
            while b"\r\n\r\n" not in raw and len(raw) < _MAX_HEADER:
                more = conn.recv(_MAX_HEADER)
                if not more:
                    break
                raw += more
            try:
                method, _uri, version, headers, body = _parse_request(raw)
            except ValueError:
                conn.sendall(b"HTTP/1.1 400 Bad Request\r\n")
                return

            # validation order matches http.rs:73-113
            if version != "HTTP/1.1":
                conn.sendall(b"HTTP/1.1 505 HTTP Version Not Supported\r\n")
                return
            if method != "POST":
                conn.sendall(b"HTTP/1.1 405 Method Not Allowed\r\n")
                return
            if "Content-Type" not in headers:
                conn.sendall(b"HTTP/1.1 400 Bad Request\r\n")
                return
            if not headers["Content-Type"].startswith("application/json"):
                conn.sendall(b"HTTP/1.1 415 Unsupported Media Type\r\n")
                return
            if "Content-Length" not in headers:
                conn.sendall(b"HTTP/1.1 411 Length Required\r\n")
                return
            try:
                length = int(headers["Content-Length"])
            except ValueError:
                conn.sendall(b"HTTP/1.1 400 Bad Request\r\n")
                return
            while len(body) < length:
                more = conn.recv(_MAX_HEADER)
                if not more:
                    break
                body += more
            if len(body) != length:
                conn.sendall(b"HTTP/1.1 400 Bad Request\r\n")
                return

            t0 = time.perf_counter()
            jpg = self._render(body, str(peer))
            log.info("http:done[%s]: %.3fs", peer, time.perf_counter() - t0)
            head = (f"HTTP/1.1 200 OK\r\nContent-Type: image/jpeg\r\n"
                    f"Content-Length: {len(jpg)}\r\n\r\n").encode()
            conn.sendall(head + jpg + b"\r\n")
        except Exception as e:  # noqa: BLE001 — per-connection isolation
            log.exception("http: %s", e)
            try:
                conn.sendall(b"HTTP/1.1 500 Internal Server Error\r\n")
            except OSError:
                pass
        finally:
            conn.close()

    # -- accept loop -------------------------------------------------------
    def start(self) -> None:
        """Serve until :meth:`stop`; prefers the native C++ transport."""
        from .. import native

        if native.available() and os.environ.get("MRT_NO_NATIVE") != "1":
            log.info("http: native transport on %s:%d", self.host, self.port)
            self._native = True
            rc = native.http_serve(self.host, self.port,
                                   lambda body: self._render(body, "native"))
            if rc != 0:
                raise OSError(f"native http transport failed: rc={rc}")
            return
        self._start_python()

    def stop(self) -> None:
        """End the accept loop (either transport)."""
        self._stop.set()
        if self._native:
            from .. import native

            native.http_stop()

    def _start_python(self) -> None:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((self.host, self.port))
        srv.listen(64)
        srv.settimeout(0.2)   # wake to check for stop()
        log.info("http: listening on %s:%d", self.host, self.port)
        try:
            while not self._stop.is_set():
                try:
                    conn, peer = srv.accept()
                except socket.timeout:
                    continue
                conn.settimeout(None)
                log.info("http:connected: %s", peer)
                threading.Thread(target=self.handle, args=(conn, peer),
                                 daemon=True).start()
        finally:
            srv.close()
