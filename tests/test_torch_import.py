"""The PyTorch port imports neither JAX nor the JAX package."""

import os
import pkgutil
import re
import subprocess
import sys

import micro_raytracer_tpu_torch

PKG_DIR = os.path.dirname(micro_raytracer_tpu_torch.__file__)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG_DIR], prefix="micro_raytracer_tpu_torch.")
        if not m.name.endswith("__main__"))


def test_every_module_imports_without_jax():
    mods = ["micro_raytracer_tpu_torch"] + _modules()
    assert "micro_raytracer_tpu_torch.frontends.cli" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'micro_raytracer_tpu'"
        " or m.startswith('micro_raytracer_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(PKG_DIR))
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_no_source_file_names_jax():
    """Static check: no import of jax or of the JAX package in the port."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|micro_raytracer_tpu)\b",
                     re.M)
    for root, dirs, files in os.walk(PKG_DIR):
        # build/ holds kernel build outputs (git-ignored), never package code
        dirs[:] = [d for d in dirs if d != "build"]
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    assert not pat.search(fh.read()), f
