"""Profiling hooks: per-pass rays/s and an opt-in torch.profiler trace.

The reference's only instrumentation is a per-sample wall-clock log
(sampler.rs:35,77; cli.rs:164); here that becomes the rays/s figure in the
CLI log, plus a device trace when ``MRT_TRACE_DIR`` names a directory.
"""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def device_trace(logdir: str | None = None):
    """Trace the enclosed block with ``torch.profiler`` (CPU and, when
    present, CUDA activity) under ``logdir`` or ``MRT_TRACE_DIR``: a Chrome
    trace (``trace.json``) and the per-operator totals sorted by device time
    (``summary.txt``). A no-op when neither is set."""
    logdir = logdir or os.environ.get("MRT_TRACE_DIR")
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    sort = "cpu_time_total"
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
        sort = "cuda_time_total"
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "summary.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=40))


def rays_per_second(n_pixels: int, n_samples: int, seconds: float) -> float:
    """Primary paths per second (the reference's unit of work)."""
    return n_pixels * n_samples / max(seconds, 1e-9)
