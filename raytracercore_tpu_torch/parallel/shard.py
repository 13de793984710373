"""Material-optimization train step and loop (counterpart of
``raytracercore_tpu.parallel.shard``'s ``make_train_step`` and
``make_train_loop``), single device.

A step renders the target's view through the train path
(:func:`..render.replay.trace_replay`: uniforms kernel → megakernel recorder
→ replay backward kernel), takes the L2 image loss against the target and
lets the caller's ``torch.optim`` optimizer update the material params in
place.  The JAX step is stateless (params and optimizer state in, new ones
out); here ``params`` is the dict of leaf tensors the optimizer was built
over.  Multi-device training (a ``mesh``) is not ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..diff.params import with_material_params
from ..render import camera as cam_mod
from ..render.renderer import pass_seed
from ..render.replay import trace_replay


def _single_device(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "multi-device training is not ported yet (ROADMAP.md queue 1, "
            "the parallel/ item); pass mesh=None")


def step_rays(camera, h: int, w: int, seed: int, jitter=None):
    """The camera rays of a step seeded ``seed`` and the seed of its path
    uniforms: ``(ray_o [h·w, 3], ray_d [h·w, 3], path_seed)``.  The jitter
    [h·w, 4] is drawn from the step's camera seed unless it is given (the
    JAX step splits its key in two the same way)."""
    cam_seed, path_seed = pass_seed(seed, 0), pass_seed(seed, 1)
    device = camera.position.device
    if jitter is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(cam_seed)
        jitter = torch.rand((h * w, 4), generator=gen, device=device,
                            dtype=camera.position.dtype)
    px, py = cam_mod.pixel_grid(w, h, device=device)
    ray_o, ray_d = cam_mod.camera_rays(camera, px, py, jitter)
    return ray_o.contiguous(), ray_d.contiguous(), path_seed


def image_loss(color, miss, target):
    """L2 loss of a traced image (misses black) against the linear
    ``target`` [H, W, 3]."""
    img = torch.where(miss[:, None], 0.0, color).reshape(target.shape)
    return torch.mean((img - target) ** 2)


def make_train_step(mesh, optimizer: torch.optim.Optimizer) -> Callable:
    """A material-optimization step: render → L2 image loss → gradients →
    ``optimizer.step()``.

    ``optimizer`` is built over the params dict the step will be given
    (e.g. ``torch.optim.Adam(params.values(), lr)``).  ``mesh`` must be
    ``None``.

    Returns ``step(params, scene, camera, target, seed, jitter=None,
    uniforms=None) → loss`` (a detached scalar tensor, the loss before the
    update).  ``target`` is a linear ``[H, W, 3]`` image; ``seed`` keys the
    step's camera jitter and path uniforms, unless ``jitter`` [H·W, 4] and
    ``uniforms`` [B, 7, H·W] are given.
    """
    _single_device(mesh)

    def step(params: dict, scene, camera, target, seed: int,
             jitter=None, uniforms=None):
        h, w = target.shape[:2]
        ray_o, ray_d, path_seed = step_rays(camera, h, w, seed, jitter)
        color, miss = trace_replay(with_material_params(scene, params),
                                   ray_o, ray_d, seed=path_seed,
                                   uniforms=uniforms)
        loss = image_loss(color, miss, target)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_train_loop(mesh, optimizer: torch.optim.Optimizer,
                    n_steps: int) -> Callable:
    """``n_steps`` optimization steps; step ``i`` is seeded
    ``pass_seed(seed, i)``, so the loop equals ``n_steps`` calls of
    :func:`make_train_step`'s step (the JAX loop folds the step index into
    its key the same way).

    Returns ``loop(params, scene, camera, target, seed) → losses
    [n_steps]``."""
    _single_device(mesh)
    step = make_train_step(None, optimizer)

    def loop(params: dict, scene, camera, target, seed: int):
        return torch.stack([step(params, scene, camera, target,
                                 pass_seed(seed, i))
                            for i in range(n_steps)])

    return loop
