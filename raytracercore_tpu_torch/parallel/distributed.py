"""Multi-process support (counterpart of
``raytracercore_tpu.parallel.distributed``).

The reference never leaves one process (its "backend" is a mutex and a
concurrent queue, FullRaytracer.cs:52-59).  The port runs one process per
rank under ``torch.distributed``: the scene replicated, image rows split
over ranks, the loss and gradient sums as collectives, and a gather of
the film only for image output.  :func:`init_distributed` is the entry
point; under ``torchrun`` it needs no arguments::

    torchrun --nproc-per-node 4 my_render.py   # calls init_distributed()
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..render.film import Film


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     device=None) -> None:
    """``dist.init_process_group`` for this process.

    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` fall back to torchrun's ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``; ``init_method`` (e.g. ``file:///path``)
    replaces the address.  ``backend=None`` is ``"nccl"`` unless ``device``
    is the CPU, then ``"gloo"``; a caller who wants gloo on the card says
    so.  A backend that fails to start raises: nothing falls back to
    another one."""
    if init_method is None:
        addr = coordinator_address
        if addr is None and "MASTER_ADDR" in os.environ:
            addr = (f"{os.environ['MASTER_ADDR']}:"
                    f"{os.environ.get('MASTER_PORT', '29500')}")
        if addr is None:
            raise ValueError("init_distributed: give coordinator_address, "
                             "init_method or set MASTER_ADDR/MASTER_PORT")
        init_method = f"tcp://{addr}"
    world = num_processes if num_processes is not None else int(
        os.environ["WORLD_SIZE"])
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    if backend is None:
        is_cpu = device is not None and torch.device(device).type == "cpu"
        backend = "gloo" if is_cpu else "nccl"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(world), rank=int(rank))


def gather_film(film: Film, mesh) -> Film:
    """Every rank's row block of the film, all-gathered over ``rays``: the
    whole film as host-local numpy arrays, on every rank (the IO gather).
    Blocks may be uneven: each rank's row count travels first."""
    group = mesh.rays_group
    rows = torch.tensor([film.samples.shape[0]], dtype=torch.int64,
                        device=film.samples.device)
    counts = [torch.zeros_like(rows) for _ in range(mesh.n_rays)]
    dist.all_gather(counts, rows, group=group)
    counts = [int(c) for c in counts]
    top = max(counts)

    def fetch(x):
        if x is None:
            return None
        pad = torch.zeros((top,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        pad[:x.shape[0]] = x
        parts = [torch.empty_like(pad) for _ in range(mesh.n_rays)]
        dist.all_gather(parts, pad, group=group)
        return np.concatenate([p[:n].cpu().numpy()
                               for p, n in zip(parts, counts)])

    return Film(color_sum=fetch(film.color_sum), samples=fetch(film.samples),
                misses=fetch(film.misses), color_c=fetch(film.color_c))
