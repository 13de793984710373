"""The port's train step and loop (``parallel/shard.py``), params
(``diff/params.py``) and the ``optimize`` CLI against the JAX package.

One step is held to JAX ``make_train_step(None, optax.sgd(1e-2))`` on the
same random numbers: the jitter and uniforms JAX's step draws from its key
are handed to the port's step.  The two recorders differ (JAX records with
its XLA ``trace``, the port with the megakernel's plain version), so the
test first checks that they picked the same branch on every bounce; then
loss within 1e-5 relative, params within rtol 1e-5 / atol 1e-7.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raytracercore_tpu.diff import get_material_params as jget_params
from raytracercore_tpu.parallel.shard import \
    make_train_step as jmake_train_step
from raytracercore_tpu.render import camera as jcam
from raytracercore_tpu.render.integrator import PathTape as JTape
from raytracercore_tpu.render.integrator import prepare_uniforms as jprep
from raytracercore_tpu.render.replay import record_tape as jrecord_tape
from raytracercore_tpu.scene import types as jtypes
from raytracercore_tpu_torch.diff import (MATERIAL_FIELDS,
                                          get_material_params,
                                          material_params_from_numpy,
                                          with_material_params)
from raytracercore_tpu_torch.parallel import make_train_loop, make_train_step
from raytracercore_tpu_torch.parallel.shard import image_loss, step_rays
from raytracercore_tpu_torch.render import camera as tcam
from raytracercore_tpu_torch.render import fused
from raytracercore_tpu_torch.render import replay_kernel as rk
from raytracercore_tpu_torch.render import uniforms_kernel as uk
from raytracercore_tpu_torch.render.renderer import pass_seed
from raytracercore_tpu_torch.render.replay import (record_tape_fused,
                                                   trace_replay)
from raytracercore_tpu_torch.scene import loader as tloader
from raytracercore_tpu_torch.scene import types as ttypes
from raytracercore_tpu_torch.tools.png import write_png
from test_torch_fused import cuda_device  # noqa: F401
from test_torch_replay import _hosts
from test_torch_scene import REPO_ROOT, ROUGH_SCENE


def _t(a):
    return torch.tensor(np.asarray(a))


def _scenes(name="rough", size=12, recursion=3):
    jhost, thost = _hosts(name)
    for host in (jhost, thost):
        host.width = host.height = size
        host.recursion = recursion
    ja = jtypes.freeze_scene(jhost)
    jc = jtypes.init_camera(jhost.cameras[0], size, size)
    ta = ttypes.freeze_scene(thost, device="cpu")
    tc = ttypes.init_camera(thost.cameras[0], size, size, device="cpu")
    return ja, jc, ta, tc


def _target(size, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 0.6, (size, size, 3)).astype(np.float32)


def _train_step(optimizer, record_as_primal=True):
    """``make_train_step``'s step, or the same step on ``trace_replay``'s
    replay-forward route (the route the forward kernel runs on)."""
    if record_as_primal:
        return make_train_step(None, optimizer)

    def step(params, scene, camera, target, seed, jitter=None,
             uniforms=None):
        h, w = target.shape[:2]
        ray_o, ray_d, path_seed = step_rays(camera, h, w, seed, jitter)
        color, miss = trace_replay(with_material_params(scene, params),
                                   ray_o, ray_d, seed=path_seed,
                                   uniforms=uniforms, record_as_primal=False)
        loss = image_loss(color, miss, target)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


@pytest.mark.parametrize("name,size,recursion,record_as_primal", [
    ("rough", 12, 4, True), ("rough", 12, 4, False)])
def test_one_step_matches_jax(name, size, recursion, record_as_primal):
    ja, jc, ta, tc = _scenes(name, size, recursion)
    R, B = size * size, recursion + 1
    key = jax.random.PRNGKey(21)
    k_cam, k_path = jax.random.split(key)
    jitter = jax.random.uniform(k_cam, (R, 4), dtype=jnp.float32)
    uniforms = jprep(k_path, R, B, jnp.float32)

    # The JAX recorder (XLA trace) and the port's (the megakernel) must
    # have picked the same branches, or the comparison is meaningless.
    px, py = jcam.pixel_grid(size, size)
    ray_o, ray_d = jcam.camera_rays(jc, px, py, k_cam)
    jtape = jrecord_tape(ja, ray_o, ray_d, uniforms)
    tpx, tpy = tcam.pixel_grid(size, size, device="cpu")
    to, td = tcam.camera_rays(tc, tpx, tpy, _t(jitter))
    ttape = record_tape_fused(ta, to, td, _t(uniforms))
    jcode = np.asarray(jtape.flags) & JTape.CODE_MASK
    tcode = ttape.flags.numpy() & JTape.CODE_MASK
    live = tcode != 0
    assert live.sum() > R
    np.testing.assert_array_equal(tcode[live], jcode[live])

    target = _target(size)
    optimizer = optax.sgd(1e-2)
    params = jget_params(ja)
    jstep = jmake_train_step(None, optimizer)
    want_p, _, want_loss = jstep(params, ja, jc, jnp.asarray(target),
                                 optimizer.init(params), key)

    tparams = material_params_from_numpy(
        {k: np.asarray(v) for k, v in params.items()}, device="cpu")
    step = _train_step(torch.optim.SGD(tparams.values(), lr=1e-2),
                       record_as_primal)
    loss = step(tparams, ta, tc, torch.tensor(target), seed=0,
                jitter=_t(jitter), uniforms=_t(uniforms))
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    moved = 0
    for k in MATERIAL_FIELDS:
        got = tparams[k].detach().numpy()
        np.testing.assert_allclose(got, np.asarray(want_p[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
        moved += int((got != np.asarray(params[k])).sum())
    assert moved > 10


def test_adam_matches_optax_adam():
    """torch.optim.Adam and optax.adam on the same gradients, 3 steps."""
    rng = np.random.default_rng(1)
    _, _, ta, _ = _scenes()
    init = {k: v.detach().numpy() for k, v in get_material_params(ta).items()}
    grads = [{k: rng.normal(0, 0.1, v.shape).astype(np.float32)
              for k, v in init.items()} for _ in range(3)]
    opt = optax.adam(1e-2)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = opt.init(jp)
    tp = material_params_from_numpy(init, device="cpu")
    adam = torch.optim.Adam(tp.values(), lr=1e-2)
    for g in grads:
        updates, state = opt.update({k: jnp.asarray(v) for k, v in
                                     g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        adam.step()
        # The two order their f32 operations differently: the updates
        # agree to 1e-4 of a step (lr 1e-2).
        for k in tp:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=k)


def test_train_loop_equals_n_steps():
    _, _, ta, tc = _scenes("rough", 8, 3)
    target = torch.tensor(_target(8, 2))
    pa, pb = get_material_params(ta), get_material_params(ta)
    loop = make_train_loop(None, torch.optim.Adam(pa.values(), lr=1e-2), 3)
    losses = loop(pa, ta, tc, target, 5)
    step = make_train_step(None, torch.optim.Adam(pb.values(), lr=1e-2))
    want = [step(pb, ta, tc, target, pass_seed(5, i)) for i in range(3)]
    assert losses.shape == (3,)
    assert torch.equal(losses, torch.stack(want))
    for k in MATERIAL_FIELDS:
        assert torch.equal(pa[k], pb[k]), k
    assert not torch.equal(pa["diffuse"], ta.materials.diffuse)


def test_step_draws_its_own_random_numbers_from_the_seed():
    _, _, ta, tc = _scenes("rough", 8, 3)
    target = torch.tensor(_target(8, 3))
    losses = []
    for seed in (1, 1, 2):
        p = get_material_params(ta)
        step = make_train_step(None, torch.optim.SGD(p.values(), lr=1e-2))
        losses.append(float(step(p, ta, tc, target, seed)))
    assert losses[0] == losses[1] != losses[2]


def test_material_params_carry_over_from_jax():
    ja, _, ta, _ = _scenes()
    jp = {k: np.asarray(v) for k, v in jget_params(ja).items()}
    tp = material_params_from_numpy(jp, device="cpu")
    assert tuple(tp) == MATERIAL_FIELDS == tuple(jp)
    for k in MATERIAL_FIELDS:
        assert tp[k].requires_grad and tp[k].is_leaf
        np.testing.assert_array_equal(tp[k].detach().numpy(), jp[k])
        # The port's own params of the same scene are the same values.
        np.testing.assert_array_equal(
            get_material_params(ta)[k].detach().numpy(), jp[k])


def test_train_step_rejections(tmp_path):
    # A mesh is no longer refused: on a one-rank mesh the step and the
    # loop are the single-device ones (tests/test_torch_parallel.py holds
    # the sharded steps on two ranks).
    import torch.distributed as dist

    from raytracercore_tpu_torch.parallel import (init_distributed,
                                                  make_mesh)
    _, _, ta, tc = _scenes("rough", 8, 3)
    target = torch.full((8, 8, 3), 0.3)
    init_distributed(num_processes=1, process_id=0, device="cpu",
                     init_method=(tmp_path / "store").as_uri())
    try:
        mesh = make_mesh(device="cpu")
        for make in (lambda m, o: make_train_step(m, o),
                     lambda m, o: make_train_loop(m, o, 2)):
            out = []
            for m in (None, mesh):
                p = get_material_params(ta)
                run = make(m, torch.optim.SGD(p.values(), lr=1e-2))
                out.append((run(p, ta, tc, target, 4),
                            [v.detach() for v in p.values()]))
            assert torch.equal(out[0][0], out[1][0])
            for a, b in zip(out[0][1], out[1][1]):
                assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()
    big = ("size 4 4\ncamera 0 0 5  0 0 0  0 1 0  40\n"
           "emission 4 4 4\nsphere 0 0 40 30\nemission 0 0 0\n"
           "diffuse .5 .5 .5\n"
           + "".join(f"sphere {(i - 32) * .02} 0 0 1\n" for i in range(65)))
    host = tloader.parse(big)
    sa = ttypes.freeze_scene(host, device="cpu")
    sc = ttypes.init_camera(host.cameras[0], 4, 4, device="cpu")
    sp = get_material_params(sa)
    # A scene above the megakernel's cap is no longer rejected: it trains
    # through the integrator's recorder and the replay kernels' route.
    step = make_train_step(None, torch.optim.SGD(sp.values(), lr=1e-2))
    before = sp["diffuse"].detach().clone()
    loss = step(sp, sa, sc, torch.full((4, 4, 3), 0.5), 0)
    assert torch.isfinite(loss)
    assert not torch.equal(sp["diffuse"].detach(), before)


def test_cli_optimize_writes_the_jax_keys(tmp_path):
    scene = tmp_path / "scene.txt"
    scene.write_text(ROUGH_SCENE)
    target = tmp_path / "target.png"
    img = np.zeros((8, 8, 4), np.uint8)
    img[..., :3] = (np.asarray(_target(8)) * 255).astype(np.uint8)
    img[..., 3] = 255
    write_png(str(target), img)
    out = tmp_path / "materials.npz"
    res = subprocess.run(
        [sys.executable, "-m", "raytracercore_tpu_torch.tools.cli",
         "optimize", str(scene), "--device", "cpu", "--size", "8",
         "--recursion", "3", "--steps", "3", "--target", str(target),
         "-o", str(out)], check=True, cwd=REPO_ROOT, capture_output=True,
        text=True, timeout=300)
    assert "step 0 loss" in res.stderr
    with np.load(out) as data:
        keys = set(data.files)
        diffuse = data["diffuse"]
    ja, _, _, _ = _scenes()
    assert keys == set(jget_params(ja)) == set(MATERIAL_FIELDS)
    assert diffuse.shape == (4, 3) and np.isfinite(diffuse).all()


@pytest.mark.cuda
def test_train_step_on_card_launches_each_kernel_once(  # noqa: F811
        cuda_device):
    _, _, ta, tc = _scenes("rough", 32, 4)
    scene, cam = ta.to(cuda_device), tc.to(cuda_device)
    target = torch.tensor(_target(32), device=cuda_device)
    for record_as_primal, n_fwd in ((True, 0), (False, 1)):
        p = get_material_params(scene)
        step = _train_step(torch.optim.Adam(p.values(), lr=1e-2),
                           record_as_primal)
        counters = (fused.trace_fused, uk.prepare_uniforms_kernel,
                    rk.replay_fwd, rk.replay_bwd)
        before = [f.launches for f in counters]
        loss = step(p, scene, cam, target, 3)
        torch.cuda.synchronize()
        assert torch.isfinite(loss)
        assert [f.launches - b for f, b in zip(counters, before)] == [
            1, 1, n_fwd, 1]
