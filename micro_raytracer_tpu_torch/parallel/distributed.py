"""Several processes on ``torch.distributed``.

The counterpart of ``micro_raytracer_tpu.parallel.distributed``: every
process runs the same script, :func:`initialize` joins them into one
process group, each renders its :func:`local_slice` of the work, and the
primary process (:func:`is_primary`) writes images and logs. The address,
world size and rank come from torch's standard environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) or the
arguments; nothing on the machine names a cluster.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def initialize(address: str | None = None, world_size: int | None = None,
               rank: int | None = None, device="cuda") -> bool:
    """Join the process group when more than one process is named; return
    whether one is joined. Does nothing in a single process (the common
    case and every test but the two-process one) or when already joined.
    ``address`` is ``host:port`` (default ``MASTER_ADDR:MASTER_PORT``);
    the backend is ``nccl`` for the card, ``gloo`` for the CPU. Over
    ``nccl`` each process takes a card of its own as its current device:
    ``LOCAL_RANK`` (as ``torchrun`` sets it), else its rank modulo the
    machine's card count."""
    n = world_size if world_size is not None else int(
        os.environ.get("WORLD_SIZE", "1"))
    if n <= 1:
        return False
    if dist.is_initialized():
        return True
    if address is None:
        host, port = os.environ.get("MASTER_ADDR"), os.environ.get(
            "MASTER_PORT")
        if not host or not port:
            raise ValueError("distributed.initialize: WORLD_SIZE > 1 needs "
                             "MASTER_ADDR and MASTER_PORT (or an address)")
        address = f"{host}:{port}"
    r = rank if rank is not None else int(os.environ.get("RANK", "0"))
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", r % torch.cuda.device_count())))
    dist.init_process_group(backend, init_method=f"tcp://{address}",
                            world_size=n, rank=r)
    return True


def is_primary() -> bool:
    """True in the process that should write images and logs."""
    return not dist.is_initialized() or dist.get_rank() == 0


def local_slice(n_total: int):
    """This process's contiguous ``[start, end)`` of a length-``n_total``
    axis: equal parts of ``ceil(n_total / processes)``, the last short."""
    count = dist.get_world_size() if dist.is_initialized() else 1
    index = dist.get_rank() if dist.is_initialized() else 0
    per = -(-n_total // count)
    start = min(index * per, n_total)
    return start, min(start + per, n_total)
