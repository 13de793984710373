"""Path replay: material gradients without re-running selection
(counterpart of ``raytracercore_tpu.render.replay``).

The train path is:

1. **Record** (no grad): one megakernel pass with the tape on
   (:func:`record_tape_fused`): per bounce the winning primitive, branch
   code, inside/Fresnel-live bits and hit normal.
2. **Replay** (differentiable): re-walk the recorded path with shading math
   only.  Given the tape, a path's colour is a closed-form function of the
   material table, so its gradient needs no intersection at all.

:func:`replay` is the plain differentiable replay (eager torch, autograd):
the gradient oracle and the plain version of the forward kernel.
:func:`trace_replay` is the train path's drop-in for a trace: uniforms from
the uniforms kernel, the megakernel recorder, then the replay kernels
(:func:`.replay_kernel.replay_fused`).
"""

from __future__ import annotations

import torch

from ..scene.types import SceneArrays
from . import fused
from .integrator import PathTape
from .replay_kernel import (material_table, replay_fused,
                            replay_fwd_reference)
from .uniforms_kernel import prepare_uniforms_kernel


def replay(scene: SceneArrays, ray_o, ray_d, uniforms, tape: PathTape):
    """Differentiable re-walk of a recorded path: ``(color [R, 3], miss
    [R] bool)``, the JAX ``replay``'s contract and semantics.  Every
    discrete decision and every geometric quantity comes from ``tape``;
    gradients reach ``scene.materials`` (and air IOR and ambient) through
    torch autograd.  Computes in ``ray_o``'s dtype."""
    dtype = ray_o.dtype
    matf, scf = material_table(scene, dtype)
    return replay_fwd_reference(ray_d.to(dtype), uniforms.to(dtype), tape,
                                matf, scf, scene.ambient_is_miss)


def _require_fits(scene: SceneArrays):
    if not fused.fits(scene):
        raise NotImplementedError(
            "the train path records with the megakernel, which takes scenes "
            f"of at most FUSED_MAX_PRIMS ({fused.MAX_PRIMS}) table rows "
            "without `debug geom`; larger scenes need the per-bounce select "
            "kernel or the BVH recorder (ROADMAP.md queue 1)")


@torch.no_grad()
def _record(scene: SceneArrays, ray_o, ray_d, uniforms):
    _require_fits(scene)
    return fused.trace_fused(scene, ray_o, ray_d, uniforms, want_tape=True)


def record_tape_fused(scene: SceneArrays, ray_o, ray_d, uniforms) -> PathTape:
    """The recording pass through the megakernel with the tape on (no
    grad): the :class:`.integrator.PathTape` of the paths it samples."""
    return _record(scene, ray_o, ray_d, uniforms)[2]


def trace_replay(scene: SceneArrays, ray_o, ray_d, seed: int | None = None,
                 uniforms=None, record_as_primal: bool = True):
    """The train path's trace: ``(color [R, 3], miss [R] bool)``,
    differentiable in ``scene.materials``.

    Uniforms come from :func:`.uniforms_kernel.prepare_uniforms_kernel`
    keyed by ``seed``, unless ``uniforms`` [B, 7, R] is given.  The
    megakernel records the tape with ``scene``'s own materials, then
    :func:`.replay_kernel.replay_fused` replays it.  Scenes the megakernel
    cannot trace raise ``NotImplementedError``.

    ``record_as_primal`` picks the route of the forward value.  True (the
    default, and the only route of :func:`..parallel.shard.make_train_step`
    and of the JAX train step) passes the recorder's colour through, so
    only the backward kernel runs.  False recomputes the colour from the
    tape with the replay-forward kernel: the port of the JAX
    ``replay_fused(primal=None)`` route, kept so that that kernel runs
    inside a whole train path (``chip_smoke.py`` builds a step on it and
    holds it to the default route); its gradients are the same."""
    R = ray_o.shape[0]
    if uniforms is None:
        if seed is None:
            raise ValueError("trace_replay: give a seed or the uniforms")
        uniforms = prepare_uniforms_kernel(seed, R, scene.recursion + 1,
                                           ray_o.device)
    color_r, miss_r, tape = _record(scene, ray_o.detach(), ray_d.detach(),
                                    uniforms)
    primal = (color_r, miss_r) if record_as_primal else None
    return replay_fused(scene, ray_o, ray_d, uniforms, tape, primal=primal)
