"""The port's build of the native library (``native.build``): processes
that find the library missing and build it at once take turns under a
lock and rename a finished library into place, so each of them loads it
(before, a process could load another's half-written file and give up on
the library). Built in a temporary copy of ``native/``."""

import os
import shutil
import subprocess
import sys

import pytest

from micro_raytracer_tpu_torch import native

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import ctypes, sys, time
sys.path.insert(0, sys.argv[1])
from micro_raytracer_tpu_torch import native
while time.time() < float(sys.argv[3]):
    pass
so = native.build(sys.argv[2])
lib = ctypes.CDLL(so)
print("loaded", bool(lib.mrt_png_encode))
"""


def test_concurrent_builds_all_load(tmp_path):
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("needs g++")
    d = tmp_path / "native"
    d.mkdir()
    shutil.copy(os.path.join(_REPO, "native", "mrt_native.cpp"), d)
    import time
    start = str(time.time() + 2.0)      # the workers start building at once
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, _REPO,
                               str(d), start], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "loaded True", (out, err)
    assert sorted(os.listdir(d)) == ["libmrt_native.so",
                                     "libmrt_native.so.lock",
                                     "mrt_native.cpp"]
    assert native.build(str(d)) == str(d / "libmrt_native.so")
