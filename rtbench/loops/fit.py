"""The ``fit`` loop: material fitting to a target image (CLI ``optimize``).

Consecutive fitting jobs of ``steps_per_job`` Adam steps at ``lr``
through ``make_train_step(None, Adam)`` (graphed on the card), the loss
read on the host every ``loss_every``-th step, one sample per pixel a
step.  The target is a linear image the benchmark makes from the seed, as
the CLI makes one from a PNG (8-bit levels, gamma 2.2 undone).  A job
restarts in place: the materials go back to the configuration's and
Adam's state is cleared; the step's graph is kept.

Set-up drives the first job's first ``setup_steps`` steps through the
same step (the first captures the graph), keeping their losses, the first
gradient as Adam holds it after step 1 (its first moment over
``1 - beta1``) and the materials after the last; the window goes on with
that job.  End to end: ``fit_steps_per_s``, the steps completed in the
window over its wall seconds, ending at a synchronize.

Correct, after the window: those first steps against
:func:`rtbench.reference.fit.steps` from the same inputs, by the worst
step's loss gap (``loss_gap``), and by the worst leaf the gap of the
first gradient's norm (``grad_gap``) and of the materials' change
(``change_gap``), each against the reference's norm of the leaf or of the
median leaf, whichever is larger.  Leaves whose reference gradient is
under a thousandth of the median leaf's (nought to rounding) are left out
of the change.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rtbench import scenes, stats
from rtbench.reference import fit as ref_fit
from rtbench.reference.tracer import pass_seed


def make_target(seed: int, h: int, w: int, device):
    """A linear ``[h, w, 3]`` float32 target: 8-bit levels drawn from a
    generator on ``device`` seeded from ``seed``, to the power 2.2."""
    gen = torch.Generator(device=device)
    gen.manual_seed(pass_seed(seed, 3))
    q = torch.randint(0, 256, (h, w, 3), generator=gen, device=device)
    return (q.to(torch.float32) / 255.0) ** 2.2


def job_seed(seed: int, job: int) -> int:
    return pass_seed(seed, 100 + job)


def run(ctx):
    cfg, mix = ctx.config, ctx.traffic
    w, h = cfg["size"]
    dev = ctx.device
    inputs = scenes.make(cfg)
    scene, cameras = scenes.for_program(inputs, dev)

    from raytracercore_tpu_torch.bvh.builder import build_bvh
    from raytracercore_tpu_torch.config import SELECT_MAX_PRIMS
    from raytracercore_tpu_torch.diff import get_material_params
    from raytracercore_tpu_torch.intersect.dispatch import (
        closest_hit, make_bvh_closest_fn, n_table_rows)
    from raytracercore_tpu_torch.parallel import make_train_step
    from raytracercore_tpu_torch.scene.types import (freeze_scene,
                                                     init_camera)

    ctx.note("program imported")
    if cameras is None:
        arrays = freeze_scene(scene, device=dev)
        host_cam = scene.cameras[cfg.get("camera", 0)]
    else:
        arrays, host_cam = scene, cameras[0]
    camera = init_camera(host_cam, w, h, device=dev)
    target = make_target(ctx.seed, h, w, dev)
    ctx.note("scene on the card, target made")
    params = get_material_params(arrays)
    start = {k: v.detach().clone() for k, v in params.items()}
    optimizer = torch.optim.Adam(params.values(), lr=float(mix["lr"]))
    closest_fn = closest_hit
    if n_table_rows(arrays) > SELECT_MAX_PRIMS:  # as the CLI's optimize
        closest_fn = make_bvh_closest_fn(build_bvh(arrays), arrays,
                                         traversal="kernel")
    step = make_train_step(None, optimizer, closest_fn=closest_fn)
    ctx.note("scene, target and step made")
    spans = ctx.spans
    per_job, every = int(mix["steps_per_job"]), int(mix["loss_every"])
    n_setup = int(mix["setup_steps"])

    seeds0 = [pass_seed(job_seed(ctx.seed, 0), i) for i in range(n_setup)]
    losses, first_grad = [], None
    for i in range(n_setup):
        losses.append(float(step(params, arrays, camera, target, seeds0[i])))
        if i == 0:
            first_grad = {k: optimizer.state[p]["exp_avg"].detach().clone()
                          / (1.0 - ref_fit.BETA1)
                          for k, p in params.items()}
    after = {k: v.detach().clone() for k, v in params.items()}
    ctx.note(f"{n_setup} steps, losses {losses}")
    ctx.sync()
    ctx.end_setup()

    job, i, steps = 0, n_setup, 0
    t0 = time.perf_counter()
    while True:
        if ctx.profile is not None:
            ctx.profile_frame(steps)
        with spans("step"):
            loss = step(params, arrays, camera, target,
                        pass_seed(job_seed(ctx.seed, job), i))
        if i % every == 0:
            with spans("loss_read"):
                float(loss)
        i += 1
        steps += 1
        if i == per_job:
            with spans("job_reset"):
                with torch.no_grad():
                    for k, p in params.items():
                        p.copy_(start[k])
                optimizer.state.clear()
            job, i = job + 1, 0
        if time.perf_counter() - t0 - ctx.paused_s >= ctx.seconds:
            break
    ctx.sync()
    t1 = time.perf_counter()
    if ctx.profile is not None:
        ctx.profile_frame(None)
    ctx.read_memory_peak()

    got = {"losses": losses, "grads": first_grad, "params": after,
           "start": start}
    del params, optimizer, step, closest_fn, scene, arrays
    ctx.free()
    ctx.note(f"window closed: {steps} steps; reference of {n_setup} steps")
    want = ref_fit.steps(inputs.tables, inputs.camera, target, seeds0,
                         float(mix["lr"]), dev)
    ctx.counts.update(rays_per_step=h * w, bounces_per_path=want["bounces"],
                      steps=steps, scene_tables=inputs.tables)
    return {"end_to_end": {"fit_steps_per_s": stats.rate(steps, t1 - t0)},
            "attempted": steps, "failed": 0,
            "numbers": compare(got, want)}


def _norms(d):
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            d.items()}


def compare(got, want):
    """The numbers ``correct`` is decided on (see the module's doc)."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(got["losses"], want["losses"]))
    g_got, g_ref = _norms(got["grads"]), _norms(want["grads"])
    g_med = float(np.median(list(g_ref.values())))
    grad_gap = max(abs(g_got[k] - g_ref[k]) / max(g_ref[k], g_med, 1e-30)
                   for k in g_ref)
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    c_got = _norms({k: got["params"][k] - got["start"][k] for k in moved})
    c_ref = _norms({k: want["params"][k] - want["start"][k] for k in moved})
    c_med = float(np.median(list(c_ref.values())))
    change_gap = max(abs(c_got[k] - c_ref[k]) / max(c_ref[k], c_med, 1e-30)
                     for k in moved)
    return {"loss_gap": float(loss_gap), "grad_gap": float(grad_gap),
            "change_gap": float(change_gap)}
