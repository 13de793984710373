"""The (rays, prims) process mesh (counterpart of
``raytracercore_tpu.parallel.mesh``).

The reference's only parallel axis is CPU threads over image tiles
(FullRaytracer.cs:219-229).  The port's axes, over the ranks of the
default ``torch.distributed`` process group:

* ``rays``  — data parallelism over pixels: each rank traces its
  contiguous block of image rows (:func:`ray_slice`).
* ``prims`` — the triangle table split over ranks: each rank intersects
  its slice and the closest hit is combined across the axis
  (:func:`..parallel.shard.make_prims_sharded_render_pass`).

Rank ``r`` sits at ``(r // n_prims, r % n_prims)``, the row-major order of
the JAX mesh's device grid.  The JAX package also has ``replicated``, a
sharding that puts one copy of an array on every device; here every rank
holds its own copy of whatever is not split, so it has no counterpart.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..core.device import resolve_device

RAYS_AXIS = "rays"
PRIMS_AXIS = "prims"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the mesh: its coordinates, the axes' sizes, the
    process group of each axis (the ranks that share its other
    coordinate) and the device it computes on."""

    rays: int
    prims: int
    n_rays: int
    n_prims: int
    rays_group: object
    prims_group: object
    device: torch.device

    @property
    def size(self) -> int:
        return self.n_rays * self.n_prims


def _local_device():
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def make_mesh(n_rays: Optional[int] = None, n_prims: int = 1,
              device=None) -> Mesh:
    """This rank's place in an ``(n_rays, n_prims)`` mesh over the default
    process group (:func:`.distributed.init_distributed` first); every
    rank must call it, in the same order as its other group creations.
    ``n_rays=None`` puts all remaining ranks on ``rays``.  ``device=None``
    or a bare ``"cuda"`` is ``cuda:<LOCAL_RANK % device_count>`` (ranks
    that share a card all get it), made the current device; the tests pass
    ``"cpu"``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "init_distributed first")
    world = dist.get_world_size()
    if n_rays is None:
        n_rays = world // n_prims
    if n_rays < 1 or n_prims < 1 or n_rays * n_prims != world:
        raise ValueError(f"make_mesh: a ({n_rays}, {n_prims}) mesh needs "
                         f"{n_rays * n_prims} ranks, the group has {world}")
    if device is None or torch.device(device) == torch.device("cuda"):
        device = _local_device()
    device = resolve_device(device, "make_mesh")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    rank = dist.get_rank()
    r, p = divmod(rank, n_prims)
    # new_group is collective: every rank creates every group, in order.
    rays_group = prims_group = None
    for q in range(n_prims):
        g = dist.new_group([i * n_prims + q for i in range(n_rays)])
        if q == p:
            rays_group = g
    for i in range(n_rays):
        g = dist.new_group([i * n_prims + q for q in range(n_prims)])
        if i == r:
            prims_group = g
    return Mesh(rays=r, prims=p, n_rays=n_rays, n_prims=n_prims,
                rays_group=rays_group, prims_group=prims_group,
                device=device)


def block(n: int, parts: int, index: int) -> slice:
    """Block ``index`` of ``n`` rows cut into ``parts`` contiguous blocks
    whose sizes differ by at most one (the first ``n % parts`` blocks take
    the extra row)."""
    base, extra = divmod(n, parts)
    lo = index * base + min(index, extra)
    return slice(lo, lo + base + (1 if index < extra else 0))


def ray_slice(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous block of ``n`` rows along ``rays`` (the
    counterpart of ``ray_sharded``: image rows, pixels or paths).  Blocks
    may be uneven: 700 rows over 3 ranks are 234, 233 and 233."""
    return block(n, mesh.n_rays, mesh.rays)
