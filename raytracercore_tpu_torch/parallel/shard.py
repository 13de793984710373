"""Sharded render passes and material-optimization steps (counterpart of
``raytracercore_tpu.parallel.shard``).

Every rank of a :class:`.mesh.Mesh` holds the scene (:func:`place_scene`)
and its block of image rows (:func:`place_film`, :func:`.mesh.ray_slice`).
A pass draws the whole frame's random numbers from the pass seed on every
rank, exactly as :func:`..render.renderer.render_passes` does, and traces
only its own rows, so the gathered film is the single-device film row for
row.  On the ``prims`` axis each rank intersects its slice of the
triangle table and the ranks agree on the closest hit at every bounce.
A train step takes its rows of rays, target and uniforms; the loss and the
material gradient are summed over ``rays`` with ``torch.distributed``
collectives.  ``mesh=None`` is the single-device step; on a CUDA device
it is captured once as a CUDA graph and replayed (:class:`StepGraph`, the
counterpart of the JAX package's ``jax.jit`` step and ``lax.scan`` loop).
Sharded steps and passes stay eager.

The JAX step is stateless (params and optimizer state in, new ones out);
here ``params`` is the dict of leaf tensors the caller's ``torch.optim``
optimizer was built over, updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from ..core import graphs as graphs_mod
from ..core.spans import span
from ..diff.params import MATERIAL_FIELDS, with_material_params
from ..intersect.cuda_select import closest_hit_fused
from ..intersect.dispatch import HitRecord, closest_hit
from ..render import camera as cam_mod
from ..render.film import Film
from ..render.integrator import trace
from ..render.renderer import (_clone_camera, _use_graphs, camera_tensors,
                               pass_draws, pass_seed, pick_route,
                               trace_pixels)
from ..render.replay import trace_replay
from ..render.uniforms_kernel import (fill_seed_key, prepare_uniforms_keyed,
                                      prepare_uniforms_kernel, seed_key)
from ..scene.types import SceneArrays, Triangles
from .mesh import Mesh, block, ray_slice


def place_scene(mesh: Mesh, scene: SceneArrays) -> SceneArrays:
    """The scene on this rank's device, the same on every rank: a new
    scene whose material rows are rank 0's (broadcast), so that ranks
    whose copies were made apart cannot drift."""
    s = scene.to(mesh.device)
    mats = {f: getattr(s.materials, f).clone() for f in MATERIAL_FIELDS}
    for t in mats.values():
        dist.broadcast(t, src=0)
    return dataclasses.replace(
        s, materials=dataclasses.replace(s.materials, **mats))


def place_film(mesh: Mesh, film: Film) -> Film:
    """This rank's block of the film's rows (:func:`.mesh.ray_slice`), on
    its device."""
    rows = ray_slice(mesh, film.shape[0])

    def cut(x):
        return None if x is None else x[rows].to(mesh.device)
    return Film(color_sum=cut(film.color_sum), samples=cut(film.samples),
                misses=cut(film.misses), color_c=cut(film.color_c))


def _pixels(mesh: Mesh, h: int, w: int, film=None):
    """This rank's image rows and their pixels (row-major)."""
    rows = ray_slice(mesh, h)
    if film is not None and film.shape != (rows.stop - rows.start, w):
        raise ValueError(
            f"sharded pass: the film block is {film.shape}, this rank's "
            f"rows of a {h}x{w} image are {rows.start}:{rows.stop} (make "
            "it with place_film)")
    return rows, slice(rows.start * w, rows.stop * w)


def _rank_pass(mesh: Mesh, scene, camera, film, seed, pass_index, jitter,
               uniforms, closest_fn, trace_fn):
    """One progressive pass over this rank's pixels of the scene's
    ``height x width`` frame; the frame's draws as in ``render_passes``
    unless ``jitter`` [H·W, 4] and ``uniforms`` [B, 7, H·W] are given."""
    h, w = scene.height, scene.width
    _, pix = _pixels(mesh, h, w, film)
    device = film.samples.device
    if jitter is None or uniforms is None:
        jitter, uniforms = pass_draws(seed, pass_index, h * w,
                                      scene.recursion + 1, device)
    px, py = cam_mod.pixel_grid(w, h, device=device)
    with torch.no_grad():
        color, miss = trace_pixels(scene, camera, px[pix], py[pix],
                                   jitter[pix],
                                   uniforms[:, :, pix].contiguous(),
                                   closest_fn, trace_fn)
    return film.add_full_frame(color, miss)


class _PerScene:
    """A value derived from the last scene it was asked about, kept while
    that scene object is the one passed in (scenes are frozen)."""

    def __init__(self, make):
        self.make = make
        self.scene = self.value = None

    def __call__(self, scene):
        if self.scene is not scene:
            self.scene, self.value = scene, self.make(scene)
        return self.value


def make_sharded_render_pass(mesh: Mesh, closest_fn=None) -> Callable:
    """A progressive pass with rays sharded over ``rays``.

    Returns ``render_pass(scene, camera, film, seed, pass_index=0,
    jitter=None, uniforms=None) → film``: ``film`` is this rank's block
    (:func:`place_film`) of the scene's ``height x width`` film.  The rays
    go through the route :class:`..render.renderer.Renderer` picks
    (:func:`..render.renderer.pick_route`: the megakernel, ``trace`` with
    the select kernel, or the BVH), unless ``closest_fn`` is given."""
    route = _PerScene(lambda scene: pick_route(scene)[:2])

    def render_pass(scene: SceneArrays, camera, film, seed: int,
                    pass_index: int = 0, jitter=None, uniforms=None):
        cfn, tfn = ((closest_fn, None) if closest_fn is not None
                    else route(scene))
        return _rank_pass(mesh, scene, camera, film, seed, pass_index,
                          jitter, uniforms, cfn, tfn)

    return render_pass


def pad_triangles_for_prims(scene: SceneArrays, n_prims: int) -> SceneArrays:
    """The scene with its triangle table padded to a multiple of
    ``n_prims`` rows: padding rows are zeros with ``prim_id = -1``, which
    every selection path skips.  A new scene object (its packed tables are
    built anew)."""
    tri = scene.triangles
    pad = (-tri.v0.shape[0]) % n_prims
    if pad == 0:
        return scene

    def grow(a, fill=0):
        return torch.cat([a, torch.full((pad,) + tuple(a.shape[1:]), fill,
                                        dtype=a.dtype, device=a.device)])

    fields = {f.name: grow(getattr(tri, f.name))
              for f in dataclasses.fields(tri) if f.name != "prim_id"}
    return dataclasses.replace(
        scene, triangles=Triangles(**fields, prim_id=grow(tri.prim_id, -1)))


def _prims_closest(mesh: Mesh):
    """The closest hit over the ``prims`` axis: this rank's select-kernel
    query on its slice, then every rank's record all-gathered and the
    nearest taken (the lowest rank on ties, as ``jnp.argmin``).  Spheres
    and planes are on every rank, so their candidates tie exactly."""
    group, n = mesh.prims_group, mesh.n_prims

    def gather(x):
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.stack(parts)

    def closest(scene, ray_o, ray_d, skip):
        hit = closest_hit_fused(scene, ray_o, ray_d, skip)
        t_key = torch.where(hit.found, hit.t, torch.inf)
        f = gather(torch.cat([t_key[:, None], hit.t[:, None], hit.position,
                              hit.normal], dim=1))             # [p, R, 8]
        i = gather(torch.stack([hit.prim, hit.inside.to(torch.int32)],
                               dim=1))                          # [p, R, 2]
        win = torch.argmin(f[:, :, 0], dim=0)[None, :, None]

        def pick(a):
            return torch.gather(a, 0, win.expand(1, -1, a.shape[2]))[0]
        f, i = pick(f), pick(i)
        found = torch.isfinite(f[:, 0])
        return HitRecord(prim=torch.where(found, i[:, 0], -1), t=f[:, 1],
                         position=f[:, 2:5], normal=f[:, 5:8],
                         inside=i[:, 1] != 0)

    return closest


def make_prims_sharded_render_pass(mesh: Mesh) -> Callable:
    """A progressive pass with the TRIANGLE TABLE sharded over ``prims``
    and the rays over ``rays``: each rank intersects its rays against its
    contiguous slice of the triangle rows (spheres and planes stay on every
    rank) with the select kernel, and the ranks of a ``prims`` group agree
    on the closest hit at every bounce (:func:`_prims_closest`), inside the
    integrator's bounce loop.  The film equals the single-device
    ``trace`` + select pass.

    Returns ``render_pass(scene, camera, film, seed, pass_index=0,
    jitter=None, uniforms=None) → film`` as
    :func:`make_sharded_render_pass`; ``scene`` must be padded with
    :func:`pad_triangles_for_prims`."""

    def slice_scene(scene):
        tri = scene.triangles
        rows = tri.v0.shape[0]
        if rows % mesh.n_prims:
            raise ValueError(f"prims-sharded pass: {rows} triangle rows do "
                             f"not split over {mesh.n_prims} ranks; pad "
                             "them with pad_triangles_for_prims")
        mine = block(rows, mesh.n_prims, mesh.prims)
        return dataclasses.replace(scene, triangles=Triangles(
            **{f.name: getattr(tri, f.name)[mine]
               for f in dataclasses.fields(tri)}))

    local = _PerScene(slice_scene)
    closest = _prims_closest(mesh)

    def render_pass(scene: SceneArrays, camera, film, seed: int,
                    pass_index: int = 0, jitter=None, uniforms=None):
        return _rank_pass(mesh, local(scene), camera, film, seed,
                          pass_index, jitter, uniforms, closest, None)

    return render_pass


def step_rays(camera, h: int, w: int, seed: int, jitter=None):
    """The camera rays of a step seeded ``seed`` and the seed of its path
    uniforms: ``(ray_o [h·w, 3], ray_d [h·w, 3], path_seed)``.  The jitter
    [h·w, 4] is drawn from the step's camera seed unless it is given (the
    JAX step splits its key in two the same way)."""
    cam_seed, path_seed = pass_seed(seed, 0), pass_seed(seed, 1)
    if jitter is None:
        gen = torch.Generator(device=camera.position.device)
        gen.manual_seed(cam_seed)
        jitter = step_jitter(gen, camera, h * w)
    ray_o, ray_d = _rays(camera, h, w, jitter)
    return ray_o, ray_d, path_seed


def step_jitter(gen: torch.Generator, camera, n: int):
    """The camera jitter [n, 4] of a step, drawn from ``gen``."""
    return torch.rand((n, 4), generator=gen, device=camera.position.device,
                      dtype=camera.position.dtype)


def _rays(camera, h, w, jitter):
    px, py = cam_mod.pixel_grid(w, h, device=camera.position.device)
    ray_o, ray_d = cam_mod.camera_rays(camera, px, py, jitter)
    return ray_o.contiguous(), ray_d.contiguous()


def image_loss(color, miss, target, n=None):
    """L2 loss of a traced image (misses black) against the linear
    ``target`` [H, W, 3]: the sum of squares over ``n`` (default: the
    target's size; a rank's block divides by the whole image's)."""
    img = torch.where(miss[:, None], 0.0, color).reshape(target.shape)
    return torch.sum((img - target) ** 2) / (target.numel() if n is None
                                              else n)


def _rank_inputs(mesh, scene, camera, target, seed, jitter, uniforms):
    """A step's rays, uniforms (``None``: drawn by the route) and target,
    cut to this rank's rows when there is a mesh, and the path seed.  With
    a mesh the uniforms are drawn over all ``H·W`` paths, then cut, so
    every rank holds the single-device step's numbers."""
    h, w = target.shape[:2]
    ray_o, ray_d, path_seed = step_rays(camera, h, w, seed, jitter)
    if mesh is None:
        return ray_o, ray_d, uniforms, target, path_seed
    rows, pix = _pixels(mesh, h, w)
    if uniforms is None:
        uniforms = prepare_uniforms_kernel(path_seed, h * w,
                                           scene.recursion + 1, ray_o.device)
    return (ray_o[pix], ray_d[pix], uniforms[:, :, pix].contiguous(),
            target[rows], path_seed)


def _sum_grads(mesh: Mesh, params: dict) -> None:
    """Sum every param's gradient over ``rays`` in one flattened bucket."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params.values()]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.rays_group)
    for p, part in zip(params.values(),
                       flat.split([g.numel() for g in grads])):
        p.grad = part.view_as(p)


def step_backward(params: dict, scene, ray_o, ray_d, target, key,
                  uniforms, optimizer, closest_fn=closest_hit,
                  use_replay: bool = True, n=None):
    """The forward and backward of a train step on given rays: the body a
    :class:`StepGraph` captures, the eager single-device step's and a
    rank's of the sharded step (each with ``optimizer.step()`` after it,
    the sharded one after its all-reduces).

    Rays ``ray_o``, ``ray_d`` [R, 3]; path uniforms ``uniforms`` [B, 7,
    R], or from the uniforms kernel keyed by the ``[2]`` int32 tensor
    ``key`` (:func:`..render.uniforms_kernel.seed_key`); then
    :func:`..render.replay.trace_replay` (or ``trace`` with
    ``use_replay=False``), the L2 loss against ``target`` (the rays' rows
    of the image, ``[rows, W, 3]``) over ``n``, the whole image's size
    (default: the target's), ``optimizer.zero_grad(set_to_none=True)``
    and ``backward()``.  Returns the detached loss; the gradients are in
    the params' ``.grad``."""
    s = with_material_params(scene, params)
    if use_replay:
        color, miss = trace_replay(s, ray_o, ray_d, seed=key,
                                   uniforms=uniforms, closest_fn=closest_fn)
    else:
        if uniforms is None:
            uniforms = prepare_uniforms_keyed(key, ray_o.shape[0],
                                              scene.recursion + 1)
        color, miss = trace(s, ray_o, ray_d, None, closest_fn=closest_fn,
                            uniforms=uniforms)
    loss = image_loss(color, miss, target, n)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    return loss.detach()


class StepGraph:
    """One single-device train step's forward and backward, captured once
    as a CUDA graph (:func:`..core.graphs.capture`) and replayed, with
    ``optimizer.step()`` after each replay, outside the graph (so any
    ``torch.optim`` optimizer works).

    Static buffers: the camera, the target, the jitter and uniforms when
    the caller gives them, and the uniforms kernel's key
    (:func:`..render.uniforms_kernel.fill_seed_key`, filled before each
    replay); a drawn jitter comes from :attr:`generator`, registered with
    the graph and seeded before each replay.  The graph reads the params
    and the scene in place.  Its gradients live in the graph's pool: after
    every replay each param's ``.grad`` is pointed at them again, so a
    ``zero_grad(set_to_none=True)`` between steps cannot detach them."""

    def __init__(self, params: dict, scene, camera, target, optimizer,
                 closest_fn, use_replay, jitter=None, uniforms=None):
        device = target.device
        h, w = target.shape[:2]
        self.params = params
        self.optimizer = optimizer
        self.generator = torch.Generator(device=device)
        self.path_key = seed_key(0, device)
        self.camera = _clone_camera(camera)
        cam = camera_tensors(self.camera)
        statics = [t.clone() for t in (target, jitter, uniforms)
                   if t is not None]
        self.drawn_jitter = jitter is None
        self.given_uniforms = uniforms is not None

        def body(*tensors):  # the camera's, target[, jitter][, uniforms]
            tgt, *rest = tensors[len(cam):]
            jit = (step_jitter(self.generator, self.camera, h * w)
                   if self.drawn_jitter else rest.pop(0))
            uni = rest.pop(0) if self.given_uniforms else None
            ray_o, ray_d = _rays(self.camera, h, w, jit)
            return step_backward(params, scene, ray_o, ray_d, tgt,
                                 self.path_key, uni, optimizer, closest_fn,
                                 use_replay)

        self.captured = graphs_mod.capture(
            body, cam + tuple(statics),
            label=f"train step {h}x{w} rec{scene.recursion}",
            generators=(self.generator,))
        self.grads = [p.grad for p in params.values()]

    @staticmethod
    def key_of(params, scene, camera, target, closest_fn, use_replay,
               jitter=None, uniforms=None):
        """What a step's graph is specialized on: the scene, the params,
        the route (``closest_fn``, ``use_replay``: with the scene they
        pick the recorder), the shapes and dtypes of the target and the
        given draws, the camera's mode and the device."""
        return (id(scene), tuple((k, id(p)) for k, p in params.items()),
                closest_fn, use_replay, tuple(target.shape), target.dtype,
                None if jitter is None else tuple(jitter.shape),
                None if uniforms is None else tuple(uniforms.shape),
                camera.mode, target.device)

    def run(self, camera, target, seed: int, jitter=None, uniforms=None):
        """One step seeded ``seed`` (the eager step's draws): feed, replay,
        ``optimizer.step()``; returns the loss (a new tensor).  No host
        synchronisation.  Spans: ``graph.feed``, ``train.seed``,
        ``graph.replay``, ``train.optimizer``, ``train.loss``."""
        self.captured.feed(*camera_tensors(camera), *(
            t for t in (target, jitter, uniforms) if t is not None))
        with span("train.seed"):
            if self.drawn_jitter:
                self.generator.manual_seed(pass_seed(seed, 0))
            if not self.given_uniforms:
                fill_seed_key(self.path_key, pass_seed(seed, 1))
        self.captured.replay()
        with span("train.optimizer"):
            for p, g in zip(self.params.values(), self.grads):
                p.grad = g
            self.optimizer.step()
        with span("train.loss"):
            return self.captured.outputs.clone()


def make_train_step(mesh: Mesh | None, optimizer: torch.optim.Optimizer,
                    closest_fn=closest_hit, use_replay: bool = True,
                    graphs: bool | None = None) -> Callable:
    """A material-optimization step: render → L2 image loss → gradients →
    ``optimizer.step()``.

    ``optimizer`` is built over the params dict the step will be given
    (e.g. ``torch.optim.Adam(params.values(), lr)``).

    ``mesh``: ``None`` for one device.  With a :class:`.mesh.Mesh`, each
    rank traces its rows of the image, takes the sum of its squared errors
    over the whole image's size, and after ``backward()`` the material
    gradient is summed over ``rays`` in one flattened all-reduce (and the
    loss in another); every rank then takes the same optimizer step.

    ``use_replay`` routes the loss through the path-replay estimator
    (:func:`..render.replay.trace_replay`): the values and gradients of
    ``trace``, but the backward pass differentiates only the ``[R]``-shaped
    replay instead of the whole bounce loop.  False differentiates the full
    :func:`..render.integrator.trace` with autograd (the slow oracle the
    replay is tested against).  ``closest_fn`` is the closest-hit query of
    either route.

    ``graphs`` (one device only): None captures the step's forward and
    backward once as a CUDA graph and replays it (:class:`StepGraph`;
    ``optimizer.step()`` runs after the replay) when the target is on a
    CUDA device, and runs the eager step on the CPU; False always runs the
    eager step; True on the CPU, or with a mesh, raises ``ValueError``.
    The step keeps a graph for each of the last two scenes, params,
    routes and shapes (``step.graphs``).  Losses are bit-equal between
    the forms; gradients agree to the replay backward's atomic sum order.

    Returns ``step(params, scene, camera, target, seed, jitter=None,
    uniforms=None) → loss`` (a detached scalar tensor, the whole image's
    loss before the update).  ``target`` is the whole linear ``[H, W, 3]``
    image; ``seed`` keys the step's camera jitter and path uniforms, unless
    ``jitter`` [H·W, 4] and ``uniforms`` [B, 7, H·W] are given.  A call
    is the span ``train.step``, ``optimizer.step()`` in it the span
    ``train.optimizer`` (:mod:`..core.spans`).
    """
    if mesh is not None and graphs:
        raise ValueError("make_train_step: a sharded step stays eager "
                         "(graphs=True needs mesh=None)")
    cache = graphs_mod.GraphCache(size=2)

    def step(params: dict, scene, camera, target, seed: int,
             jitter=None, uniforms=None):
        with span("train.step"):
            h, w = target.shape[:2]
            if mesh is None and _use_graphs(graphs, target.device,
                                            "make_train_step"):
                key = StepGraph.key_of(params, scene, camera, target,
                                       closest_fn, use_replay, jitter,
                                       uniforms)
                sg = cache.get(key, lambda: StepGraph(
                    params, scene, camera, target, optimizer, closest_fn,
                    use_replay, jitter, uniforms))
                return sg.run(camera, target, seed, jitter, uniforms)
            ray_o, ray_d, uniforms, tgt, path_seed = _rank_inputs(
                mesh, scene, camera, target, seed, jitter, uniforms)
            loss = step_backward(params, scene, ray_o, ray_d, tgt,
                                 seed_key(path_seed, target.device),
                                 uniforms, optimizer, closest_fn, use_replay,
                                 h * w * 3)
            if mesh is not None:
                dist.all_reduce(loss, group=mesh.rays_group)
                _sum_grads(mesh, params)
            with span("train.optimizer"):
                optimizer.step()
            return loss

    step.graphs = cache
    return step


def make_overlapped_train_step(mesh: Mesh, optimizer: torch.optim.Optimizer
                               ) -> Callable:
    """A sharded train step whose material-gradient all-reduce runs inside
    the backward (the JAX step with ``grad_axis``): the loss goes through
    :func:`..render.replay.trace_replay` with ``grad_group`` the ``rays``
    group, so the gradients come out of ``backward()`` already summed, and
    only the scalar loss has a collective of its own (issued before the
    backward, waited on after it).

    The schedule differs by device.  On CPU tensors the plain replay runs,
    with one bucket per bounce (the JAX schedule: bounce ``k``'s bucket is
    on the wire while bounce ``k - 1``'s backward computes).  On CUDA
    tensors the replay backward is one kernel over all bounces, so there
    is one bucket, issued after it: nothing inside the kernel is left to
    overlap.  A backward split by ray blocks, each block's bucket
    overlapping the next block, is open work that only more than one card
    can measure.

    Returns ``step(params, scene, camera, target, seed, jitter=None,
    uniforms=None) → loss`` as :func:`make_train_step`."""

    def step(params: dict, scene, camera, target, seed: int,
             jitter=None, uniforms=None):
        h, w = target.shape[:2]
        ray_o, ray_d, uniforms, tgt, _ = _rank_inputs(
            mesh, scene, camera, target, seed, jitter, uniforms)
        color, miss = trace_replay(with_material_params(scene, params),
                                   ray_o, ray_d, uniforms=uniforms,
                                   grad_group=mesh.rays_group)
        loss = image_loss(color, miss, tgt, h * w * 3)
        total = loss.detach().clone()
        work = dist.all_reduce(total, group=mesh.rays_group, async_op=True)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        work.wait()
        optimizer.step()
        return total

    return step


def make_train_loop(mesh: Mesh | None, optimizer: torch.optim.Optimizer,
                    n_steps: int, closest_fn=closest_hit,
                    use_replay: bool = True, graphs: bool | None = None
                    ) -> Callable:
    """``n_steps`` optimization steps; step ``i`` is seeded
    ``pass_seed(seed, i)``, so the loop equals ``n_steps`` calls of
    :func:`make_train_step`'s step (the JAX loop folds the step index into
    its key the same way).  Graphed (``graphs`` as in
    :func:`make_train_step`) it is ``n_steps`` replays of the step's
    graph, the counterpart of the JAX loop's ``lax.scan``.

    Returns ``loop(params, scene, camera, target, seed) → losses
    [n_steps]``."""
    step = make_train_step(mesh, optimizer, closest_fn=closest_fn,
                           use_replay=use_replay, graphs=graphs)

    def loop(params: dict, scene, camera, target, seed: int):
        return torch.stack([step(params, scene, camera, target,
                                 pass_seed(seed, i))
                            for i in range(n_steps)])

    loop.graphs = step.graphs
    return loop
