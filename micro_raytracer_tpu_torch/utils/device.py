"""The render device: chosen explicitly, never a silent fallback."""

from __future__ import annotations

import torch


def require_device(device) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device without a usable card
    raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ValueError("device 'cuda' requested but no CUDA device is "
                         "available; pass --device cpu to render on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
