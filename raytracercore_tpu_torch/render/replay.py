"""Path replay: material gradients without re-running selection
(counterpart of ``raytracercore_tpu.render.replay``).

The train path is:

1. **Record** (no grad): the per-bounce winning primitive, branch code,
   inside/Fresnel-live bits and hit normal of every path — one megakernel
   pass with the tape on (:func:`record_tape_fused`) for scenes the
   megakernel takes, else the integrator's own loop with the tape on
   (:func:`record_tape`), its closest hit from the select kernel or, for
   scenes above the dense tier, from the BVH traversal kernel.
2. **Replay** (differentiable): re-walk the recorded path with shading math
   only.  Given the tape, a path's colour is a closed-form function of the
   material table, so its gradient needs no intersection at all.

:func:`replay` is the plain differentiable replay (eager torch, autograd):
the gradient oracle and the plain version of the forward kernel.
:func:`trace_replay` is the train path's drop-in for a trace: uniforms from
the uniforms kernel, a recorder, then the replay kernels
(:func:`.replay_kernel.replay_fused`).
"""

from __future__ import annotations

import torch

from ..config import SELECT_MAX_PRIMS
from ..intersect.dispatch import closest_hit, n_table_rows
from ..scene.types import SceneArrays
from . import fused
from .integrator import PathTape, trace
from .replay_kernel import (AllReduceInBackward, GradBuckets,  # noqa: F401
                            material_table, replay_fused,
                            replay_fwd_reference)
from .uniforms_kernel import prepare_uniforms_keyed, prepare_uniforms_kernel


def replay(scene: SceneArrays, ray_o, ray_d, uniforms, tape: PathTape,
           grad_group=None):
    """Differentiable re-walk of a recorded path: ``(color [R, 3], miss
    [R] bool)``, the JAX ``replay``'s contract and semantics.  Every
    discrete decision and every geometric quantity comes from ``tape``;
    gradients reach ``scene.materials`` (and air IOR and ambient) through
    torch autograd.  Computes in ``ray_o``'s dtype.

    ``grad_group``: a process group whose ranks hold other rays of the same
    image.  Each bounce's material-gradient contribution is then all-reduced
    over it inside the backward, one bucket per bounce
    (:class:`.replay_kernel.AllReduceInBackward`), so the returned gradients
    are already summed over the group."""
    dtype = ray_o.dtype
    matf, scf = material_table(scene, dtype)
    return replay_fwd_reference(ray_d.to(dtype), uniforms.to(dtype), tape,
                                matf, scf, scene.ambient_is_miss,
                                grad_group=grad_group)


@torch.no_grad()
def record_tape(scene: SceneArrays, ray_o, ray_d, uniforms,
                closest_fn=closest_hit) -> PathTape:
    """The recording pass through the integrator's own loop body
    (``trace(..., want_tape=True)``, no grad), so the tape can never drift
    from the render path."""
    return trace(scene, ray_o.detach(), ray_d.detach(), None,
                 closest_fn=closest_fn, uniforms=uniforms.detach(),
                 want_tape=True)[2]


@torch.no_grad()
def _record_fused(scene: SceneArrays, ray_o, ray_d, uniforms):
    return fused.trace_fused(scene, ray_o.detach(), ray_d.detach(), uniforms,
                             want_tape=True)


def record_tape_fused(scene: SceneArrays, ray_o, ray_d, uniforms) -> PathTape:
    """The recording pass through the megakernel with the tape on (no
    grad): the :class:`.integrator.PathTape` of the paths it samples."""
    return _record_fused(scene, ray_o, ray_d, uniforms)[2]


def _default_record_fn(scene: SceneArrays, closest_fn):
    """Pick the fastest recorder: on the card the select kernel's full hit
    record (selection values never reach the tape's gradients, so the
    non-differentiable kernel is fine), else the given ``closest_fn``."""
    if closest_fn is not closest_hit:
        return closest_fn  # the caller chose (e.g. a BVH)
    if scene.materials.emission.device.type == "cuda":
        from ..intersect.cuda_select import closest_hit_fused
        return closest_hit_fused
    return closest_fn


def trace_replay(scene: SceneArrays, ray_o, ray_d, seed=None,
                 uniforms=None, record_as_primal: bool = True,
                 closest_fn=closest_hit, grad_group=None,
                 record_fused: bool | None = None,
                 replay_kernel: bool | None = None):
    """The train path's trace: ``(color [R, 3], miss [R] bool)``,
    differentiable in ``scene.materials`` — the estimator of
    :func:`.integrator.trace` with a selection-free backward.

    Uniforms come from :func:`.uniforms_kernel.prepare_uniforms_kernel`
    keyed by ``seed``, unless ``uniforms`` [B, 7, R] is given.  ``seed``
    may also be the ``[2]`` int32 key tensor of
    :func:`.uniforms_kernel.seed_key` on the rays' device
    (:func:`.uniforms_kernel.prepare_uniforms_keyed`): the form a captured
    train step takes, whose key is filled before each replay.

    The recorder (``record_fused``): None picks the megakernel
    (:func:`record_tape_fused`) for f32 rays when ``closest_fn`` is the
    default and the scene :func:`.fused.fits`, else :func:`record_tape`
    with :func:`_default_record_fn`'s closest hit (the select kernel on
    the card, ``closest_fn`` off it); then values and gradients equal
    ``trace``'s for the same uniforms.  False always takes
    :func:`record_tape`, even on a scene the megakernel takes.  True
    always takes the megakernel, and raises ``ValueError`` on a scene it
    does not fit or on rays that are not f32 (it samples paths in f32,
    which would not be an f64 estimator).  ``debug geom`` scenes have no
    bounce loop to replay and return ``trace``.  With the default
    ``closest_fn`` a scene above ``config.SELECT_MAX_PRIMS`` table rows
    raises ``NotImplementedError``: give it the BVH tier's closest hit
    (:func:`..intersect.dispatch.make_bvh_closest_fn`), which then records
    the tape.

    The replay (``replay_kernel``): None takes the kernels for f32 rays —
    :func:`.replay_kernel.replay_fused`, whose kernels keep a material
    table of up to ``MAX_KERNEL_MATS`` rows in shared memory and read a
    larger one (a mesh has one material row per triangle) from device
    memory; they give no gradient to the rays, air IOR or ambient.  For
    other rays None takes the plain :func:`replay` on CPU tensors and
    raises ``ValueError`` on CUDA tensors, where no plain version runs
    unless asked for.  False takes the plain differentiable :func:`replay`
    on any device: its gradients also reach air IOR and ambient.  True
    takes the kernels, on f32 copies of other rays.

    ``record_as_primal`` picks the route of the forward value on the
    megakernel-recorder route.  True (the default, and the only route of
    :func:`..parallel.shard.make_train_step` and of the JAX train step)
    passes the recorder's colour through, so only the backward kernel
    runs.  False recomputes the colour from the tape with the
    replay-forward kernel: the port of the JAX ``replay_fused(primal=None)``
    route, kept so that that kernel runs inside a whole train path
    (``chip_smoke.py`` builds a step on it and holds it to the default
    route); its gradients are the same.

    ``grad_group``: a process group whose ranks trace the other rays of
    the same image; the material gradient comes back summed over it.  On
    CUDA tensors :func:`.replay_kernel.replay_fused` sums it in one bucket
    after its backward kernel; on CPU tensors the plain :func:`replay`
    sums one bucket per bounce, the JAX package's schedule."""
    rows = n_table_rows(scene)
    if closest_fn is closest_hit and rows > SELECT_MAX_PRIMS:
        raise NotImplementedError(
            f"trace_replay on a scene of {rows} table rows: the dense tier "
            f"takes up to SELECT_MAX_PRIMS ({SELECT_MAX_PRIMS}) rows; give "
            "closest_fn=make_bvh_closest_fn(build_bvh(scene), scene)")
    f32 = ray_o.dtype == torch.float32
    if record_fused is None:
        record_fused = f32 and closest_fn is closest_hit and fused.fits(scene)
    elif record_fused and not (f32 and fused.fits(scene)):
        raise ValueError(
            "trace_replay(record_fused=True) needs float32 rays and a scene "
            f"that fused.fits (at most {fused.MAX_PRIMS} table rows, no "
            f"debug geom); got {ray_o.dtype} rays on a scene of {rows} rows")
    if scene.debug_geom:
        return trace(scene, ray_o, ray_d, None, closest_fn=closest_fn)
    if replay_kernel is None:
        if not f32 and ray_o.device.type == "cuda":
            raise ValueError(
                f"trace_replay: the replay kernels compute in float32, and "
                f"{ray_o.dtype} rays on a CUDA device take the plain replay "
                "only when asked: pass replay_kernel=False (or True for "
                "the kernels on float32 copies)")
        replay_kernel = f32
    if uniforms is None:
        if seed is None:
            raise ValueError("trace_replay: give a seed or the uniforms")
        if isinstance(seed, torch.Tensor):
            uniforms = prepare_uniforms_keyed(seed, ray_o.shape[0],
                                              scene.recursion + 1)
        else:
            uniforms = prepare_uniforms_kernel(
                seed, ray_o.shape[0], scene.recursion + 1, ray_o.device)
    primal = None
    if record_fused:
        color_r, miss_r, tape = _record_fused(scene, ray_o, ray_d, uniforms)
        if record_as_primal:
            primal = (color_r, miss_r)
    else:
        tape = record_tape(scene, ray_o, ray_d, uniforms,
                           closest_fn=_default_record_fn(scene, closest_fn))
    if not replay_kernel or (grad_group is not None
                             and ray_o.device.type == "cpu"):
        return replay(scene, ray_o, ray_d, uniforms, tape,
                      grad_group=grad_group)
    return replay_fused(scene, ray_o, ray_d, uniforms, tape, primal=primal,
                        grad_group=grad_group)
