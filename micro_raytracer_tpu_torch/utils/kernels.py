"""Build and bind the port's hand-written CUDA kernels.

Each kernel is a plain C entry point of a ``.cu`` file under
``micro_raytracer_tpu_torch/csrc``. At first use the file is compiled by
``nvcc`` into a shared library under ``micro_raytracer_tpu_torch/build``
(git-ignored), named after the source, and loaded with ctypes; entry points
of one file share its library, and a library is rebuilt when the hash of
its sources or flags changes; ``nvcc``'s output (``-Xptxas -v``: each
kernel's registers and spills) is kept beside it. Pointers cross as
``tensor.data_ptr()`` and the stream as
``torch.cuda.current_stream().cuda_stream``; every entry point returns
``cudaGetLastError()`` after its launch, and :meth:`CudaKernel.launch`
raises on anything but 0.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` so the kernels
round each product and sum exactly like the plain PyTorch versions they
are held against (no fused multiply-add contraction); no fast-math and no
flush-to-zero.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels")


class CudaKernel:
    """One kernel library: build on first use, bind one C entry point,
    count launches.

    ``launches`` is a plain integer that :meth:`launch` increments once per
    kernel launch; callers reset it to 0 to count a run's launches.
    ``variants`` counts the launches of a named variant of the entry
    point (``launch(..., variant=name)``; callers reset it to ``{}``).
    ``plain_calls`` is the matching count for the plain PyTorch version,
    incremented by that function.
    """

    def __init__(self, name: str, source: str, headers: tuple, symbol: str,
                 argtypes: list):
        self.name = name
        self.source = source
        self.headers = headers
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.variants = {}
        self.plain_calls = 0
        self.build_log = ""
        self._fn = None
        self._lock = threading.Lock()

    def _digest(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for f in (self.source,) + self.headers:
            with open(os.path.join(CSRC, f), "rb") as fh:
                h.update(f.encode() + b"\0" + fh.read())
        return h.hexdigest()[:16]

    def library_path(self) -> str:
        stem = os.path.splitext(self.source)[0]
        return os.path.join(BUILD, f"lib{stem}-{self._digest()}.so")

    def _build(self, out: str) -> None:
        os.makedirs(BUILD, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, self.source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        self.build_log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source} "
                               f"(rc={res.returncode}):\n{self.build_log}")
        with open(f"{tmp}.log", "w") as fh:
            fh.write(self.build_log)
        os.replace(f"{tmp}.log", f"{out}.log")
        # atomic: a concurrent build never loads a partial library
        os.replace(tmp, out)

    def fn(self):
        """The bound C entry point, building the library if needed."""
        with self._lock:
            if self._fn is None:
                path = self.library_path()
                if not os.path.exists(path):
                    self._build(path)
                elif os.path.exists(f"{path}.log"):
                    with open(f"{path}.log") as fh:
                        self.build_log = fh.read()
                lib = ctypes.CDLL(path)
                f = getattr(lib, self.symbol)
                f.argtypes = self.argtypes
                f.restype = ctypes.c_int
                self._fn = f
            return self._fn

    def launch(self, *args, variant: str | None = None) -> None:
        """Launch on the current stream; raise if the launch failed.
        ``variant`` names the instance the arguments select, if counted."""
        rc = (self._fn or self.fn())(*args)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error {rc}")
        self.launches += 1
        if variant is not None:
            self.variants[variant] = self.variants.get(variant, 0) + 1


def ptxas_table(log: str) -> dict:
    """``{entry function: (registers, spill store bytes, spill load
    bytes)}`` of an ``nvcc -Xptxas -v`` log (mangled names)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = [0, 0, 0]
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raw_stream(device) -> int:
    """The handle of ``device``'s current CUDA stream as an integer (the
    value of :func:`stream_ptr`, without making a stream object)."""
    import torch

    get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if get is None:
        return torch.cuda.current_stream(device).cuda_stream
    return get(torch.cuda.current_device() if device.index is None
               else device.index)


def require_cuda_tensor(name: str, t, dtype, shape=None,
                        contiguous: bool = True) -> None:
    """Validate a tensor argument of a kernel wrapper before its pointer
    crosses into C (a strided one only where the kernel takes strides)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
