"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device: it carries the ``cuda`` marker and
skips elsewhere. This file imports no JAX, so it runs on a machine without
it; there, skip the JAX test harness's conftest:

    python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

Tolerances: the closest-hit kernel is compiled without FMA contraction and
follows the plain version's operation order, so rows are equal and t is
within rtol 1e-5 / atol 1e-6. The trace is compared at rtol 1e-4 / atol
1e-5 on all but 0.3% of rays, and within 1e-3 absolute on the rest: the
plain version reaches the hit through the dense intersect path, whose sums
of three products may round differently, and a one-ulp difference can
flip a sampling branch. These scenes' random rays graze rotated boxes and
planes more often than camera rays in a room: measured on the card, 36
and 28 of 16,384 rays (0.22% and 0.17%) fall outside.
"""

import numpy as np
import pytest
import torch

from micro_raytracer_tpu_torch.frontends import cli
from micro_raytracer_tpu_torch.models import schema
from micro_raytracer_tpu_torch.models.compiler import compile_scene
from micro_raytracer_tpu_torch.ops import hit3, step
from torch_port_helpers import (MIXED, MIXED_OPAQUE,  # noqa: F401
                                cuda_device, outlier_rows, rays)

SCENES = {"mixed": MIXED, "mixed_opaque": MIXED_OPAQUE}


def _scene(name, device):
    return compile_scene(schema.SceneConfig.from_json(SCENES[name]), device)


def _rays(n, device, seed=1):
    return tuple(torch.from_numpy(a).to(device) for a in rays(n, seed))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCENES))
def test_closest_hit_kernel_matches_plain(name, cuda_device):
    """Row-major rays on the sweep table, and lane-major views on the
    trace's row table (the primary-hit pass's inputs)."""
    scene = _scene(name, cuda_device)
    tables = step.pack_step(scene)
    o, d = _rays(1 << 14, cuda_device)
    oT, dT = o.T.contiguous(), d.T.contiguous()
    for tab, o_, d_ in ((hit3.pack_scene(scene, tables.frames), o, d),
                        (tables.tab, oT.T, dT.T)):
        for mode in (hit3.MODE_EXIT, hit3.MODE_ENTRY, hit3.MODE_ANY):
            before = hit3.KERNEL.launches
            got = hit3.closest_hit(tab, tables.layout, o_, d_, mode)
            assert hit3.KERNEL.launches == before + 1
            ref = hit3.closest_hit_plain(tab, tables.layout, o, d, mode)
            for g, r in zip(got, ref):
                if g.dtype == torch.int32:
                    assert torch.equal(g, r)
                else:
                    torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCENES))
def test_trace_kernel_matches_plain(name, cuda_device):
    scene = _scene(name, cuda_device)
    tables = step.pack_step(scene)
    R = 1 << 14
    o, d = (t.T.contiguous() for t in _rays(R, cuda_device, seed=2))
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    u8s = torch.rand((9, step.n_uni(scene.any_refract), R), generator=gen,
                     device=cuda_device)
    before = (hit3.KERNEL.launches, step.KERNEL.launches)
    A, B, fl = step.trace_packed(scene, tables, 0.85, o, d, u8s)
    assert (hit3.KERNEL.launches, step.KERNEL.launches) == \
        (before[0] + 1, before[1] + 1)
    A_r, B_r, fl_r = step.trace_plain(scene, tables, 0.85, o, d, u8s)
    assert torch.equal(fl, fl_r) and bool(fl.any())
    bad = set()
    for g, r in ((A, A_r), (B, B_r)):
        bad |= set(outlier_rows(g.T.cpu().numpy(), r.T.cpu().numpy(), 1e-4,
                                1e-5).tolist())
    good = torch.ones(R, dtype=torch.bool)
    good[sorted(bad)] = False
    err_in = max(float((g - r).cpu()[:, good].abs().max())
                 for g, r in ((A, A_r), (B, B_r)))
    print(f"{name}: {len(bad)} of {R} rays outside tolerance; max abs err "
          f"{err_in:.3g} on the rest")
    assert len(bad) <= 0.003 * R and err_in <= 1e-3, (len(bad), err_in)


@pytest.mark.cuda
def test_cli_render_runs_the_kernels(cuda_device, tmp_path):
    """The CLI's main path launches the primary-hit and trace kernels and
    never the plain versions."""
    for k in (hit3.KERNEL, step.KERNEL):
        k.launches = k.plain_calls = 0
    out = tmp_path / "o.png"
    assert cli.main(["--obj", "sphere", "--light", "point:", "-0.5", "-1",
                     "0.5", "--res", "64", "48", "--sample", "2",
                     "-o", str(out)]) == 0
    assert step.KERNEL.launches > 0 and hit3.KERNEL.launches > 0
    assert step.KERNEL.plain_calls == 0 and hit3.KERNEL.plain_calls == 0
    from PIL import Image

    img = np.asarray(Image.open(out))
    assert img.shape == (48, 64, 3) and img.max() > 20


@pytest.mark.cuda
def test_kernel_refuses_unported_scenes(cuda_device):
    scene = compile_scene(schema.SceneConfig.from_json(
        {"renderer": [{"type": "triangle",
                       "vtx": [[0, 1, 0], [1, 1, 0], [0, 1, 1]]}]}),
        cuda_device)
    o, d = (t.T.contiguous() for t in _rays(64, cuda_device))
    with pytest.raises(NotImplementedError, match="not ported"):
        step.trace_packed(scene, step.pack_step(scene), 0.85, o, d,
                          torch.rand((2, 4, 64), device=cuda_device))
