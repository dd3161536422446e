"""ctypes bindings for the native C++ runtime (``native/libmrt_native.so``).

The reference's runtime is native (Rust: hand-rolled HTTP server http.rs,
PNG/JPEG via the image crate); this module binds the same repo-root library
the JAX package uses — a C++ PNG encoder and HTTP/1.1 transport, built with
``make -C native`` or on demand here (:func:`build`, the Makefile's flags,
one process at a time) when g++ is present, and loaded here. Everything has
a pure-Python fallback: ``available()`` gates use.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SO = os.path.join(_REPO, "native", "libmrt_native.so")

_lib = None
_lib_lock = threading.Lock()


def build(native_dir: str) -> str | None:
    """``native_dir``'s ``libmrt_native.so``, built from its
    ``mrt_native.cpp`` with the Makefile's flags if it is missing; None
    where it cannot be built. Processes that build at once (test workers)
    take turns under an exclusive lock on ``libmrt_native.so.lock`` beside
    it, and the library is compiled to a temporary file and renamed into
    place, so no process loads a half-written library."""
    import fcntl

    so = os.path.join(native_dir, "libmrt_native.so")
    if os.path.exists(so):
        return so
    src = os.path.join(native_dir, "mrt_native.cpp")
    if not os.path.exists(src):
        return None
    try:
        with open(so + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if os.path.exists(so):
                return so
            tmp = f"{so}.{os.getpid()}.tmp"
            try:
                subprocess.run(
                    [os.environ.get("CXX", "g++"), "-O2", "-fPIC",
                     "-std=c++17", src, "-shared", "-pthread", "-lz", "-o",
                     tmp], check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
    except (subprocess.SubprocessError, OSError):
        return None
    return so


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if build(os.path.dirname(_SO)) is None:
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None

        lib.mrt_png_write.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                      ctypes.c_int, ctypes.c_int]
        lib.mrt_png_write.restype = ctypes.c_int
        lib.mrt_png_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t)]
        lib.mrt_png_encode.restype = ctypes.c_int
        lib.mrt_free.argtypes = [ctypes.c_void_p]
        lib.mrt_alloc.argtypes = [ctypes.c_size_t]
        lib.mrt_alloc.restype = ctypes.c_void_p
        lib.mrt_http_serve.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                       ctypes.c_void_p]
        lib.mrt_http_serve.restype = ctypes.c_int
        lib.mrt_http_stop.argtypes = []
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


# ------------------------------------------------------------------ PNG --
def png_write(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as PNG via the native encoder."""
    lib = _load()
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    rc = lib.mrt_png_write(path.encode(), img.ctypes.data, w, h)
    if rc != 0:
        raise OSError(f"mrt_png_write failed: {rc}")


def png_encode(img: np.ndarray) -> bytes:
    """Encode an (H, W, 3) uint8 array to PNG bytes via the native encoder."""
    lib = _load()
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    out = ctypes.c_void_p()
    out_len = ctypes.c_size_t()
    rc = lib.mrt_png_encode(img.ctypes.data, w, h,
                            ctypes.byref(out), ctypes.byref(out_len))
    if rc != 0:
        raise OSError(f"mrt_png_encode failed: {rc}")
    try:
        return ctypes.string_at(out, out_len.value)
    finally:
        lib.mrt_free(out)


# ----------------------------------------------------------------- HTTP --
_CB_TYPE = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.c_size_t,
    ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t))

_active_cb = None  # keep the callback object alive while serving


def http_serve(host: str, port: int, render_fn) -> int:
    """Run the native HTTP transport; blocks until :func:`http_stop`.

    ``render_fn(body: bytes) -> bytes`` produces the JPEG response body;
    exceptions turn into HTTP 500.
    """
    global _active_cb
    lib = _load()
    # the C side uses inet_addr(), which cannot resolve hostnames
    if host and not host.replace(".", "").isdigit():
        import socket

        host = socket.gethostbyname(host)

    def cb(body, length, out, out_len):
        try:
            data = render_fn(ctypes.string_at(body, length))
        except Exception:  # noqa: BLE001 — crossing the C boundary
            import logging

            logging.getLogger("raytrace").exception("http: render failed")
            return 1
        buf = lib.mrt_alloc(len(data))
        if not buf:
            return 2
        ctypes.memmove(buf, data, len(data))
        out[0] = buf
        out_len[0] = len(data)
        return 0

    _active_cb = _CB_TYPE(cb)
    return lib.mrt_http_serve(host.encode(), port, _active_cb)


def http_stop() -> None:
    lib = _load()
    lib.mrt_http_stop()
