"""Build and bind the port's hand-written CUDA kernels.

Each kernel is one ``.cu`` file under ``micro_raytracer_tpu_torch/csrc``
with a plain C entry point. At first use it is compiled by ``nvcc`` into a
shared library under ``micro_raytracer_tpu_torch/build`` (git-ignored) and
loaded with ctypes; a library is rebuilt when the hash of its sources or
flags changes. Pointers cross as ``tensor.data_ptr()`` and the stream as
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
        return os.path.join(BUILD, f"lib{self.name}-{self._digest()}.so")

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
        # atomic: a concurrent build never loads a partial library
        os.replace(tmp, out)

    def fn(self):
        """The bound C entry point, building the library if needed."""
        with self._lock:
            if self._fn is None:
                path = self.library_path()
                if not os.path.exists(path):
                    self._build(path)
                lib = ctypes.CDLL(path)
                f = getattr(lib, self.symbol)
                f.argtypes = self.argtypes
                f.restype = ctypes.c_int
                self._fn = f
            return self._fn

    def launch(self, *args) -> None:
        """Launch on the current stream; raise if the launch failed."""
        rc = self.fn()(*args)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error {rc}")
        self.launches += 1


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


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
