"""The port's multi-device paths (``parallel/``) against its single-device
paths and against the JAX package on its 8 virtual CPU devices.

Ranks are CPU processes over gloo, started once per world shape by a
module-scoped fixture: two ranks on ``rays`` (render, film gather, train
steps, the overlapped step, the BVH step, the loop) and a ``(2 rays, 2
prims)`` mesh (the prims-sharded render).  The parent writes the inputs
(scene texts, and the jitter and uniforms JAX draws from its key), the
ranks write what they computed, and the tests compare.  Each rank imports
only this module's top level, which holds no JAX.
"""

import dataclasses
import multiprocessing
import pathlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

from raytracercore_tpu_torch.diff import (MATERIAL_FIELDS,
                                          get_material_params,
                                          material_params_from_numpy)
from raytracercore_tpu_torch.intersect.dispatch import (closest_hit,
                                                        make_bvh_closest_fn)
from raytracercore_tpu_torch.parallel import (distributed, gather_film,
                                              init_distributed, make_mesh,
                                              make_overlapped_train_step,
                                              make_prims_sharded_render_pass,
                                              make_sharded_render_pass,
                                              make_train_loop,
                                              make_train_step,
                                              pad_triangles_for_prims,
                                              place_film, place_scene,
                                              ray_slice)
from raytracercore_tpu_torch.parallel.mesh import Mesh
from raytracercore_tpu_torch.render.film import Film
from raytracercore_tpu_torch.render.renderer import pass_seed
from raytracercore_tpu_torch.scene import loader, meshgen
from raytracercore_tpu_torch.scene.types import freeze_scene, init_camera

SIZE, REC = 16, 3            # the render checks (Cornell)
T_SIZE, T_REC = 12, 4        # the train checks (the rough scene)
SEED = 5
LR = 1e-2
JOIN_S = 120


# --- the ranks (run in spawned processes) ----------------------------------

def _scene(text, size, recursion):
    host = loader.parse(text)
    host.width = host.height = size
    host.recursion = recursion
    return (freeze_scene(host, device="cpu"),
            init_camera(host.cameras[0], size, size, device="cpu"))


def _film_dict(film):
    return {k: np.asarray(getattr(film, k))
            for k in ("color_sum", "samples", "misses")}


def _params_np(params):
    return {k: v.detach().numpy().copy() for k, v in params.items()}


def bvh_scene():
    """82 triangles over a floor, the light made two-sided, and a camera
    that sees them: ``(SceneArrays, CameraRT)`` at 16 x 16."""
    arrays, _, _ = meshgen.make_mesh_scene(grid=1, subdiv=1, recursion=3,
                                           width=16, height=16, device="cpu")
    two_sided = arrays.materials.two_sided.clone()
    two_sided[-1] = True
    arrays = dataclasses.replace(arrays, materials=dataclasses.replace(
        arrays.materials, two_sided=two_sided))
    from raytracercore_tpu_torch.scene.types import HostCamera
    cam = init_camera(HostCamera(
        mode="frustum", position=np.array([0.0, -5.0, 3.0]),
        look_at=np.array([0.0, 0.0, 0.9]), up=np.array([0.0, 0.0, 1.0]),
        fov_or_size=np.deg2rad(45.0)), 16, 16, device="cpu")
    return arrays, cam


def _train(make, inputs, mesh_or_none, **kw):
    """One step from the inputs' params on the inputs' rays: ``(loss,
    params after)``."""
    ta, tc = _scene(inputs["train_text"], T_SIZE, T_REC)
    params = material_params_from_numpy(inputs["params"], device="cpu")
    step = make(mesh_or_none, torch.optim.SGD(params.values(), lr=LR), **kw)
    loss = step(params, ta, tc, torch.tensor(inputs["target"]), 0,
                jitter=torch.tensor(inputs["t_jitter"]),
                uniforms=torch.tensor(inputs["t_uniforms"]))
    return float(loss), _params_np(params)


def _rays_checks(inputs, rank):
    mesh = make_mesh(device="cpu")
    out = {}
    arrays, cam = _scene(inputs["render_text"], SIZE, REC)
    arrays = place_scene(mesh, arrays)
    render_pass = make_sharded_render_pass(mesh)
    film = place_film(mesh, Film.create(SIZE, SIZE, device="cpu"))
    for k in range(2):
        film = render_pass(arrays, cam, film, SEED, k)
    out["render"] = _film_dict(gather_film(film, mesh))
    jax_route = make_sharded_render_pass(mesh, closest_fn=closest_hit)
    film = jax_route(arrays, cam,
                     place_film(mesh, Film.create(SIZE, SIZE, device="cpu")),
                     0, jitter=torch.tensor(inputs["r_jitter"]),
                     uniforms=torch.tensor(inputs["r_uniforms"]))
    out["render_jax"] = _film_dict(gather_film(film, mesh))

    # An uneven film: 15 rows over 2 ranks, every cell its global index.
    rows = ray_slice(mesh, 15)
    full = torch.arange(15 * 4 * 3, dtype=torch.float32).reshape(15, 4, 3)
    block = Film(color_sum=full[rows], samples=full[rows, :, 0],
                 misses=full[rows, :, 1])
    out["gather"] = _film_dict(gather_film(block, mesh))
    out["rows"] = (rows.start, rows.stop)

    out["step"] = _train(make_train_step, inputs, mesh)
    calls = []
    all_reduce = dist.all_reduce

    def counting(tensor, *args, **kwargs):
        calls.append(tuple(tensor.shape))
        return all_reduce(tensor, *args, **kwargs)
    dist.all_reduce = counting
    try:
        out["overlapped"] = _train(make_overlapped_train_step, inputs, mesh)
    finally:
        dist.all_reduce = all_reduce
    out["overlapped_calls"] = calls

    ta, tc = _scene(inputs["train_text"], T_SIZE, T_REC)
    target = torch.tensor(inputs["target"])
    params = material_params_from_numpy(inputs["params"], device="cpu")
    loop = make_train_loop(mesh, torch.optim.SGD(params.values(), lr=LR), 3)
    out["loop"] = (loop(params, ta, tc, target, 11).numpy(),
                   _params_np(params))
    params = material_params_from_numpy(inputs["params"], device="cpu")
    step = make_train_step(mesh, torch.optim.SGD(params.values(), lr=LR))
    losses = [float(step(params, ta, tc, target, pass_seed(11, i)))
              for i in range(3)]
    out["sequential"] = (np.asarray(losses), _params_np(params))

    from raytracercore_tpu_torch.bvh.builder import build_bvh
    arrays, cam = bvh_scene()
    fn = make_bvh_closest_fn(build_bvh(arrays, leaf_size=4), arrays,
                             traversal="kernel")
    params = material_params_from_numpy(inputs["bvh_params"], device="cpu")
    step = make_train_step(mesh, torch.optim.SGD(params.values(), lr=LR),
                           closest_fn=fn)
    out["bvh"] = (float(step(params, arrays, cam, torch.zeros(16, 16, 3), 9)),
                  _params_np(params))
    return out


def _prims_checks(inputs, rank):
    mesh = make_mesh(n_rays=2, n_prims=2, device="cpu")
    arrays, cam = _scene(inputs["render_text"], SIZE, REC)
    arrays = pad_triangles_for_prims(place_scene(mesh, arrays), 2)
    render_pass = make_prims_sharded_render_pass(mesh)
    film = render_pass(arrays, cam,
                       place_film(mesh, Film.create(SIZE, SIZE, device="cpu")),
                       SEED, 0)
    film_jax = render_pass(
        arrays, cam, place_film(mesh, Film.create(SIZE, SIZE, device="cpu")),
        0, jitter=torch.tensor(inputs["r_jitter"]),
        uniforms=torch.tensor(inputs["r_uniforms"]))
    return {"render": _film_dict(gather_film(film, mesh)),
            "render_jax": _film_dict(gather_film(film_jax, mesh)),
            "coords": (mesh.rays, mesh.prims)}


def _rank_main(kind, rank, world, tmp):
    torch.set_num_threads(1)
    tmp = pathlib.Path(tmp)
    init_distributed(num_processes=world, process_id=rank, device="cpu",
                     init_method=(tmp / "store").as_uri())
    try:
        inputs = torch.load(tmp / "inputs.pt", weights_only=False)
        checks = _rays_checks if kind == "rays" else _prims_checks
        torch.save(checks(inputs, rank), tmp / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _spawn(kind, world, tmp, inputs):
    torch.save(inputs, tmp / "inputs.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(kind, r, world, str(tmp)))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=JOIN_S)
    for p in procs:
        if p.is_alive():
            p.kill()
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"{kind} ranks exited with {codes}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


# --- the inputs and the JAX side (the parent) ------------------------------

def _texts():
    from test_torch_replay import TEXTS
    from test_torch_scene import CORNELL_SCENE
    return CORNELL_SCENE, TEXTS["rough"]


def _jax_draws(key, size, recursion):
    import jax
    import jax.numpy as jnp

    from raytracercore_tpu.render.integrator import prepare_uniforms
    k_cam, k_path = jax.random.split(key)
    n = size * size
    return (np.asarray(jax.random.uniform(k_cam, (n, 4), dtype=jnp.float32)),
            np.asarray(prepare_uniforms(k_path, n, recursion + 1,
                                        jnp.float32)))


def _jax_scene(text, size, recursion):
    from raytracercore_tpu.scene import loader as jloader
    from raytracercore_tpu.scene import types as jtypes
    host = jloader.parse(text)
    host.width = host.height = size
    host.recursion = recursion
    return (jtypes.freeze_scene(host),
            jtypes.init_camera(host.cameras[0], size, size))


@pytest.fixture(scope="module")
def inputs():
    import jax

    from raytracercore_tpu.diff import get_material_params as jparams
    render_text, train_text = _texts()
    r_jitter, r_uniforms = _jax_draws(jax.random.PRNGKey(11), SIZE, REC)
    t_jitter, t_uniforms = _jax_draws(jax.random.PRNGKey(3), T_SIZE, T_REC)
    ja, _ = _jax_scene(train_text, T_SIZE, T_REC)
    rng = np.random.default_rng(0)
    return {
        "render_text": render_text, "train_text": train_text,
        "r_jitter": r_jitter, "r_uniforms": r_uniforms,
        "t_jitter": t_jitter, "t_uniforms": t_uniforms,
        "target": rng.uniform(0.0, 0.6, (T_SIZE, T_SIZE, 3)).astype(
            np.float32),
        "params": {k: np.asarray(v) for k, v in jparams(ja).items()},
        "bvh_params": _params_np(get_material_params(bvh_scene()[0])),
    }


@pytest.fixture(scope="module")
def rays_ranks(inputs, tmp_path_factory):
    return _spawn("rays", 2, tmp_path_factory.mktemp("rays"), inputs)


@pytest.fixture(scope="module")
def prims_ranks(inputs, tmp_path_factory):
    return _spawn("prims", 4, tmp_path_factory.mktemp("prims"), inputs)


def _single_film(inputs, passes=(0, 1), closest_fn=None, jitter=None,
                 uniforms=None):
    """The port's single-device film: its own draws for ``passes``, or
    one pass on the given draws."""
    from raytracercore_tpu_torch.render.renderer import (pick_route,
                                                         render_pass,
                                                         render_passes)
    arrays, cam = _scene(inputs["render_text"], SIZE, REC)
    film = Film.create(SIZE, SIZE, device="cpu")
    if closest_fn is None:
        closest_fn, trace_fn, _ = pick_route(arrays)
    else:
        trace_fn = None
    if jitter is not None:
        return _film_dict(render_pass(arrays, cam, film,
                                      torch.tensor(jitter),
                                      torch.tensor(uniforms),
                                      closest_fn=closest_fn,
                                      trace_fn=trace_fn))
    return _film_dict(render_passes(arrays, cam, film, SEED, passes[0],
                                    len(passes), closest_fn=closest_fn,
                                    trace_fn=trace_fn))


def _assert_films(got, want, atol=None):
    np.testing.assert_array_equal(got["samples"], want["samples"])
    np.testing.assert_array_equal(got["misses"], want["misses"])
    if atol is None:
        np.testing.assert_array_equal(got["color_sum"], want["color_sum"])
    else:
        np.testing.assert_allclose(got["color_sum"], want["color_sum"],
                                   atol=atol, rtol=0)


def _jax_step(inputs, mesh_devices, closest=None):
    """JAX ``make_train_step`` with ``optax.sgd`` on the rough scene."""
    import jax
    import jax.numpy as jnp
    import optax

    from raytracercore_tpu.parallel import make_mesh as jmake_mesh
    from raytracercore_tpu.parallel.shard import \
        make_train_step as jmake_train_step
    ja, jc = _jax_scene(inputs["train_text"], T_SIZE, T_REC)
    params = {k: jnp.asarray(v) for k, v in inputs["params"].items()}
    optimizer = optax.sgd(LR)
    mesh = jmake_mesh(n_rays=mesh_devices) if mesh_devices else None
    step = jmake_train_step(mesh, optimizer)
    p, _, loss = step(params, ja, jc, jnp.asarray(inputs["target"]),
                      optimizer.init(params), jax.random.PRNGKey(3))
    return float(loss), {k: np.asarray(v) for k, v in p.items()}


def _assert_step(got, want, rel=1e-5, atol=1e-6):
    assert got[0] == pytest.approx(want[0], rel=rel)
    for k in MATERIAL_FIELDS:
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=0, atol=atol,
                                   err_msg=k)


# --- mesh, init, gather ------------------------------------------------------

@pytest.mark.parametrize("n,parts", [(700, 3), (15, 2), (5, 4), (16, 8)])
def test_ray_slice_blocks_cover_the_rows(n, parts):
    blocks = [ray_slice(Mesh(rays=i, prims=0, n_rays=parts, n_prims=1,
                             rays_group=None, prims_group=None,
                             device=torch.device("cpu")), n)
              for i in range(parts)]
    sizes = [b.stop - b.start for b in blocks]
    assert [b.start for b in blocks] == [0] + list(np.cumsum(sizes)[:-1])
    assert sum(sizes) == n and max(sizes) - min(sizes) <= 1
    if (n, parts) == (700, 3):
        assert sizes == [234, 233, 233]


def test_init_distributed_reads_torchrun_variables(monkeypatch):
    seen = {}
    monkeypatch.setattr(
        distributed.dist, "init_process_group",
        lambda backend, **kw: seen.update(backend=backend, **kw))
    for k, v in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", "29511"),
                 ("WORLD_SIZE", "4"), ("RANK", "3")):
        monkeypatch.setenv(k, v)
    init_distributed(device="cpu")
    assert seen == {"backend": "gloo", "init_method": "tcp://localhost:29511",
                    "world_size": 4, "rank": 3}
    init_distributed(coordinator_address="h:1", num_processes=2,
                     process_id=0)
    assert seen == {"backend": "nccl", "init_method": "tcp://h:1",
                    "world_size": 2, "rank": 0}
    monkeypatch.delenv("MASTER_ADDR")
    with pytest.raises(ValueError, match="coordinator_address"):
        init_distributed(num_processes=1, process_id=0)


def test_make_mesh_at_world_size_one(tmp_path):
    init_distributed(num_processes=1, process_id=0, device="cpu",
                     init_method=(tmp_path / "store").as_uri())
    try:
        mesh = make_mesh(device="cpu")
        assert (mesh.rays, mesh.prims, mesh.n_rays, mesh.n_prims) == (
            0, 0, 1, 1)
        assert ray_slice(mesh, 700) == slice(0, 700)
        with pytest.raises(ValueError, match="needs 2 ranks"):
            make_mesh(n_rays=1, n_prims=2, device="cpu")
        if not torch.cuda.is_available():
            # The default device is the card: without one, the error of
            # every entry point that defaults to it.
            with pytest.raises(RuntimeError, match='device="cpu"'):
                make_mesh()
        # One rank: the sharded pass is the single-device pass.
        inputs = {"render_text": _texts()[0]}
        arrays, cam = _scene(inputs["render_text"], SIZE, REC)
        film = make_sharded_render_pass(mesh)(
            place_scene(mesh, arrays), cam,
            place_film(mesh, Film.create(SIZE, SIZE, device="cpu")), SEED, 0)
        _assert_films(_film_dict(film), _single_film(inputs, passes=(0,)))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("device,local_rank,want", [
    (None, "3", "cuda:1"), ("cuda", "3", "cuda:1"), ("cuda", None, "cuda:0"),
    ("cuda:0", "3", "cuda:0"), ("cpu", "3", "cpu")])
def test_make_mesh_puts_each_rank_on_its_card(tmp_path, monkeypatch, device,
                                              local_rank, want):
    """The default and a bare ``"cuda"`` are ``cuda:<LOCAL_RANK %
    device_count>`` (the rank without ``LOCAL_RANK``), made the current
    device; an explicit card or the CPU stays as given.  Two cards are
    mocked."""
    current = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    init_distributed(num_processes=1, process_id=0, device="cpu",
                     init_method=(tmp_path / "store").as_uri())
    try:
        mesh = make_mesh(device=device)
    finally:
        dist.destroy_process_group()
    assert mesh.device == torch.device(want)
    assert current == ([] if want == "cpu" else [torch.device(want)])


def test_gather_film_takes_uneven_blocks(rays_ranks):
    full = np.arange(15 * 4 * 3, dtype=np.float32).reshape(15, 4, 3)
    assert [r["rows"] for r in rays_ranks] == [(0, 8), (8, 15)]
    for r in rays_ranks:
        np.testing.assert_array_equal(r["gather"]["color_sum"], full)
        np.testing.assert_array_equal(r["gather"]["samples"], full[..., 0])
        np.testing.assert_array_equal(r["gather"]["misses"], full[..., 1])


# --- the sharded render ------------------------------------------------------

def test_sharded_render_matches_single_device(inputs, rays_ranks):
    """Two passes on each rank's rows, gathered: the single-device film
    (the megakernel's route), bit for bit, on every rank."""
    want = _single_film(inputs)
    assert want["samples"].sum() > 0
    for r in rays_ranks:
        _assert_films(r["render"], want)


def test_sharded_render_matches_jax(inputs, rays_ranks):
    """The JAX sharded pass on 8 devices against the port's on 2 ranks,
    both on JAX's draws through the dense closest hit."""
    import jax

    from raytracercore_tpu.parallel import make_mesh as jmake_mesh
    from raytracercore_tpu.parallel import \
        make_sharded_render_pass as jmake_pass
    from raytracercore_tpu.parallel import place_film as jplace_film
    from raytracercore_tpu.parallel import place_scene as jplace_scene
    from raytracercore_tpu.render.film import Film as JFilm
    ja, jc = _jax_scene(inputs["render_text"], SIZE, REC)
    mesh = jmake_mesh(n_rays=8)
    want = jmake_pass(mesh)(jplace_scene(mesh, ja), jc,
                            jplace_film(mesh, JFilm.create(SIZE, SIZE)),
                            jax.random.PRNGKey(11))
    want = {k: np.asarray(getattr(want, k))
            for k in ("color_sum", "samples", "misses")}
    got = rays_ranks[0]["render_jax"]
    _assert_films(got, want, atol=1e-5)
    _assert_films(got, _single_film(inputs, closest_fn=closest_hit,
                                    jitter=inputs["r_jitter"],
                                    uniforms=inputs["r_uniforms"]))


# --- the prims axis --------------------------------------------------------

def test_pad_triangles_for_prims_matches_jax(inputs):
    from raytracercore_tpu.parallel.shard import \
        pad_triangles_for_prims as jpad
    ja, _ = _jax_scene(inputs["render_text"], SIZE, REC)
    ta, _ = _scene(inputs["render_text"], SIZE, REC)
    rows = ta.triangles.v0.shape[0]
    for n in (3, 4, 5):
        got = pad_triangles_for_prims(ta, n)
        want = jpad(ja, n)
        assert got.triangles.v0.shape[0] % n == 0
        assert (got is ta) == (rows % n == 0)
        for f in dataclasses.fields(got.triangles):
            np.testing.assert_array_equal(
                getattr(got.triangles, f.name).numpy(),
                np.asarray(getattr(want.triangles, f.name)), err_msg=f.name)


def test_prims_sharded_render_matches_single_device(inputs, prims_ranks):
    """A (2 rays, 2 prims) mesh: every rank's slice of the triangle table,
    the winner agreed per bounce: the single-device trace + select film."""
    from raytracercore_tpu_torch.intersect.cuda_select import \
        closest_hit_fused
    assert sorted(r["coords"] for r in prims_ranks) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    want = _single_film(inputs, passes=(0,), closest_fn=closest_hit_fused)
    for r in prims_ranks:
        _assert_films(r["render"], want, atol=1e-5)


def test_prims_sharded_render_matches_jax(inputs, prims_ranks):
    import jax

    from raytracercore_tpu.parallel import make_mesh as jmake_mesh
    from raytracercore_tpu.parallel.shard import (
        make_prims_sharded_render_pass as jmake_pass,
        pad_triangles_for_prims as jpad)
    from raytracercore_tpu.render.film import Film as JFilm
    ja, jc = _jax_scene(inputs["render_text"], SIZE, REC)
    want = jmake_pass(jmake_mesh(n_rays=2, n_prims=4))(
        jpad(ja, 4), jc, JFilm.create(SIZE, SIZE), jax.random.PRNGKey(11))
    want = {k: np.asarray(getattr(want, k))
            for k in ("color_sum", "samples", "misses")}
    _assert_films(prims_ranks[0]["render_jax"], want, atol=1e-5)


# --- the train steps -------------------------------------------------------

def test_train_step_runs_sharded(inputs, rays_ranks):
    loss, params = rays_ranks[0]["step"]
    assert np.isfinite(loss)
    moved = sum(int((params[k] != inputs["params"][k]).sum())
                for k in MATERIAL_FIELDS)
    assert moved > 10
    for r in rays_ranks[1:]:      # every rank took the same step
        _assert_step(r["step"], rays_ranks[0]["step"], rel=0, atol=0)


def test_train_step_sharded_matches_single(inputs, rays_ranks):
    want = _train(make_train_step, inputs, None)
    _assert_step(rays_ranks[0]["step"], want)


def test_train_step_sharded_matches_jax(inputs, rays_ranks):
    _assert_step(rays_ranks[0]["step"], _jax_step(inputs, 8))
    _assert_step(_train(make_train_step, inputs, None),
                 _jax_step(inputs, None))


def test_overlapped_train_step_matches_single(inputs, rays_ranks):
    """Per-bounce gradient buckets inside the backward (the CPU schedule):
    the single step's loss and params, and ``recursion + 1`` all-reduces
    of the ``[N, 14]`` material matrix plus one of the scalar loss."""
    r = rays_ranks[0]
    _assert_step(r["overlapped"], _train(make_train_step, inputs, None))
    _assert_step(r["overlapped"], r["step"])
    n_mats = inputs["params"]["shininess"].shape[0]
    calls = r["overlapped_calls"]
    assert calls.count((n_mats, 14)) == T_REC + 1
    assert calls.count(()) == 1 and len(calls) == T_REC + 2


def test_bvh_train_step_sharded_matches_single(inputs, rays_ranks):
    from raytracercore_tpu_torch.bvh.builder import build_bvh
    arrays, cam = bvh_scene()
    fn = make_bvh_closest_fn(build_bvh(arrays, leaf_size=4), arrays,
                             traversal="kernel")
    params = material_params_from_numpy(inputs["bvh_params"], device="cpu")
    step = make_train_step(None, torch.optim.SGD(params.values(), lr=LR),
                           closest_fn=fn)
    want = (float(step(params, arrays, cam, torch.zeros(16, 16, 3), 9)),
            _params_np(params))
    assert sum(int((want[1][k] != inputs["bvh_params"][k]).sum())
               for k in MATERIAL_FIELDS) > 5
    _assert_step(rays_ranks[0]["bvh"], want)


def test_train_loop_matches_sequential_steps(rays_ranks):
    losses, params = rays_ranks[0]["loop"]
    want_losses, want_params = rays_ranks[0]["sequential"]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-6)
    for k in MATERIAL_FIELDS:
        np.testing.assert_allclose(params[k], want_params[k], atol=1e-7,
                                   err_msg=k)
