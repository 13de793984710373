"""The graphed forms of the port's main path (``core/graphs.py``, the
graphed ``Renderer.step`` / ``render_passes`` and ``make_train_step``)
on the CPU, where no graph is captured: what each graph captures, run
eagerly, against the eager forms and against JAX.

* the uniforms kernel's key tensor (the form a captured step reads)
  against the integer seed, below and above 2^63;
* ``Film.add_full_frame_`` (the graphed pass ends in it) against
  ``add_full_frame``, compensated and not;
* the pass body (``render_pass_`` on the draws of a pass graph's
  generator) against ``render_pass`` bit for bit, and against the JAX
  chain at ``test_render_pass_matches_jax_chain``'s tolerances;
* the step body (camera rays and ``step_backward`` on static buffers +
  Adam) against ``make_train_step(None, ...)`` bit for bit, and against
  the JAX step;
* the refusals (``graphs=True`` off the card, ``early_exit`` under a
  capture, a capture under a recording profiler) and the launch
  accounting of captured graphs;
* on a card only: graphed against eager passes and steps.
"""

import dataclasses

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
from raytracercore_tpu.render.film import Film as JFilm
from raytracercore_tpu.render.integrator import prepare_uniforms as jprep
from raytracercore_tpu.render.integrator import trace as jtrace
from raytracercore_tpu.scene import types as jtypes
from raytracercore_tpu_torch import kernels
from raytracercore_tpu_torch.core import graphs
from raytracercore_tpu_torch.diff import (MATERIAL_FIELDS,
                                          get_material_params,
                                          material_params_from_numpy)
from raytracercore_tpu_torch.intersect.cuda_select import closest_hit_fused
from raytracercore_tpu_torch.parallel import make_train_loop, make_train_step
from raytracercore_tpu_torch.parallel import shard
from raytracercore_tpu_torch.render import fused
from raytracercore_tpu_torch.render import uniforms_kernel as uk
from raytracercore_tpu_torch.render.film import Film
from raytracercore_tpu_torch.render.integrator import trace
from raytracercore_tpu_torch.render.renderer import (Renderer,
                                                     generator_draws,
                                                     pass_draws, pass_seed,
                                                     render_pass,
                                                     render_pass_,
                                                     render_passes)
from raytracercore_tpu_torch.scene import types as ttypes
from test_torch_fused import cuda_device  # noqa: F401
from test_torch_renderer import _small
from test_torch_train import _scenes, _target

SEEDS = [0, 7, 2 ** 32 + 1, 2 ** 63 - 1, 2 ** 63, 2 ** 63 + 17,
         2 ** 64 - 1]


def _t(a):
    return torch.tensor(np.asarray(a))


def _films_equal(a: Film, b: Film):
    assert (a.color_c is None) == (b.color_c is None)
    for x, y in zip(a.tensors(), b.tensors()):
        assert torch.equal(x, y)


# --- the uniforms kernel's key tensor ---------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_keyed_uniforms_equal_seeded(seed):
    key = uk.seed_key(seed)
    assert key.dtype == torch.int32 and key.shape == (2,)
    assert tuple(int(w) & uk.MASK32 for w in key) == uk.split_seed(seed)
    want = uk.prepare_uniforms_reference(seed, 300, 3)
    assert torch.equal(uk.prepare_uniforms_reference(key, 300, 3), want)
    before = uk.prepare_uniforms_kernel.launches
    assert torch.equal(uk.prepare_uniforms_keyed(key, 300, 3), want)
    assert uk.prepare_uniforms_kernel.launches == before


def test_fill_seed_key_rewrites_in_place():
    key = uk.seed_key(5)
    ptr = key.data_ptr()
    for seed in (2 ** 63 + 3, 11):
        assert uk.fill_seed_key(key, seed) is key and key.data_ptr() == ptr
        assert torch.equal(uk.prepare_uniforms_reference(key, 64, 2),
                           uk.prepare_uniforms_reference(seed, 64, 2))


# --- the in-place film -------------------------------------------------------

@pytest.mark.parametrize("compensated", [False, True])
def test_add_full_frame_in_place_equals_value(compensated):
    rng = np.random.default_rng(3)
    value = Film.create(6, 5, device="cpu", compensated=compensated)
    inplace = Film.create(6, 5, device="cpu", compensated=compensated)
    planes = [t.data_ptr() for t in inplace.tensors()]
    for i in range(5):
        scale = 10.0 ** (4 * (i % 2))  # big and small terms: compensation
        color = torch.tensor(rng.uniform(0, scale, (30, 3)),
                             dtype=torch.float32)
        miss = torch.tensor(rng.uniform(size=30) < 0.3)
        value = value.add_full_frame(color, miss)
        assert inplace.add_full_frame_(color, miss) is inplace
        _films_equal(inplace, value)
    assert [t.data_ptr() for t in inplace.tensors()] == planes


# --- the pass body ------------------------------------------------------------

def _pass_inputs(name, size, recursion):
    jhost, thost = _small(name, size, recursion)
    ta = ttypes.freeze_scene(thost, device="cpu")
    tc = ttypes.init_camera(thost.cameras[0], size, size, device="cpu")
    return jhost, ta, tc


@pytest.mark.parametrize("name,size,recursion,route", [
    ("fused", 16, 4, "megakernel"), ("cornell", 16, 10, "megakernel"),
    ("cornell", 16, 6, "trace")])
@pytest.mark.parametrize("compensated", [False, True])
def test_pass_body_equals_render_pass(name, size, recursion, route,
                                      compensated):
    _, ta, tc = _pass_inputs(name, size, recursion)
    kw = ({"trace_fn": fused.trace_fused} if route == "megakernel"
          else {"closest_fn": closest_hit_fused})
    gen = torch.Generator(device="cpu")
    film = Film.create(size, size, device="cpu", compensated=compensated)
    body = Film.create(size, size, device="cpu", compensated=compensated)
    for k in range(3):
        gen.manual_seed(pass_seed(9, k))
        jitter, uniforms = generator_draws(gen, size * size, recursion + 1)
        want_j, want_u = pass_draws(9, k, size * size, recursion + 1, "cpu")
        assert torch.equal(jitter, want_j) and torch.equal(uniforms, want_u)
        film = render_pass(ta, tc, film, jitter, uniforms, **kw)
        assert render_pass_(ta, tc, body, jitter, uniforms, **kw) is body
        _films_equal(body, film)


@pytest.mark.parametrize("name,size,recursion", [
    ("fused", 16, 4), ("cornell", 16, 10)])
def test_pass_body_matches_jax_chain(name, size, recursion):
    jhost, ta, tc = _pass_inputs(name, size, recursion)
    ja = jtypes.freeze_scene(jhost)
    jc = jtypes.init_camera(jhost.cameras[0], size, size)
    px, py = jcam.pixel_grid(size, size)
    k_cam, k_path = jax.random.split(jax.random.PRNGKey(4))
    jitter = jax.random.uniform(k_cam, (size * size, 4), dtype=jnp.float32)
    uniforms = jprep(k_path, size * size, recursion + 1, jnp.float32)
    ray_o, ray_d = jcam.camera_rays(jc, px, py, k_cam)
    color, miss = jtrace(ja, ray_o, ray_d, None, uniforms=uniforms)
    jf = JFilm.create(size, size).add_full_frame(color, miss)

    tf = render_pass_(ta, tc, Film.create(size, size, device="cpu"),
                      _t(jitter), _t(uniforms), trace_fn=fused.trace_fused)
    np.testing.assert_array_equal(tf.samples.numpy(), np.asarray(jf.samples))
    np.testing.assert_array_equal(tf.misses.numpy(), np.asarray(jf.misses))
    want = np.asarray(jf.color_sum).reshape(-1, 3)
    got = tf.color_sum.numpy().reshape(-1, 3)
    assert want.max() > 0.5
    close = np.all(np.abs(want - got) <= 1e-3 + 1e-3 * np.abs(want), axis=1)
    assert close.mean() >= 0.97, f"only {close.mean():.3f} close"


# --- the step body ------------------------------------------------------------

def _step_inputs(size=12, recursion=4):
    ja, jc, ta, tc = _scenes("rough", size, recursion)
    return ja, jc, ta, tc, torch.tensor(_target(size))


@pytest.mark.parametrize("use_replay", [True, False])
def test_step_body_equals_train_step(use_replay):
    _, _, ta, tc, target = _step_inputs()
    h, w = target.shape[:2]
    eager_p = get_material_params(ta)
    eager = make_train_step(None, torch.optim.Adam(eager_p.values(),
                                                   lr=1e-2),
                            use_replay=use_replay)
    body_p = get_material_params(ta)
    adam = torch.optim.Adam(body_p.values(), lr=1e-2)
    # The step graph's static buffers, filled as StepGraph.run fills them.
    gen = torch.Generator(device="cpu")
    key = uk.seed_key(0)
    static_target = target.clone()
    for seed in (5, 2 ** 63 + 1):
        want = eager(eager_p, ta, tc, target, seed)
        gen.manual_seed(pass_seed(seed, 0))
        uk.fill_seed_key(key, pass_seed(seed, 1))
        jitter = shard.step_jitter(gen, tc, h * w)
        ray_o, ray_d, _ = shard.step_rays(tc, h, w, seed, jitter)
        got = shard.step_backward(body_p, ta, ray_o, ray_d, static_target,
                                  key, None, adam, use_replay=use_replay)
        adam.step()
        assert torch.equal(got, want)
        for f in MATERIAL_FIELDS:
            assert torch.equal(body_p[f], eager_p[f]), f


def test_step_body_matches_jax():
    ja, jc, ta, tc, target = _step_inputs()
    R, B = 12 * 12, 5
    key = jax.random.PRNGKey(21)
    k_cam, k_path = jax.random.split(key)
    jitter = jax.random.uniform(k_cam, (R, 4), dtype=jnp.float32)
    uniforms = jprep(k_path, R, B, jnp.float32)
    optimizer = optax.sgd(1e-2)
    params = jget_params(ja)
    want_p, _, want_loss = jmake_train_step(None, optimizer)(
        params, ja, jc, jnp.asarray(target.numpy()), optimizer.init(params),
        key)

    tparams = material_params_from_numpy(
        {k: np.asarray(v) for k, v in params.items()}, device="cpu")
    sgd = torch.optim.SGD(tparams.values(), lr=1e-2)
    ray_o, ray_d, _ = shard.step_rays(tc, 12, 12, 0, _t(jitter))
    loss = shard.step_backward(tparams, ta, ray_o, ray_d, target,
                               uk.seed_key(0), _t(uniforms), sgd)
    sgd.step()
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    for k in MATERIAL_FIELDS:
        np.testing.assert_allclose(tparams[k].detach().numpy(),
                                   np.asarray(want_p[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


# --- refusals -----------------------------------------------------------------

def test_graphs_refused_off_the_card():
    _, ta, tc = _pass_inputs("fused", 8, 4)
    _, thost = _small("fused", 8, 4)
    with pytest.raises(ValueError, match="graphs=True"):
        Renderer(thost, device="cpu", graphs=True)
    assert Renderer(thost, device="cpu").graphs is False
    with pytest.raises(ValueError, match="graphs=True"):
        render_passes(ta, tc, Film.create(8, 8, device="cpu"), 0, 0,
                      graphs=True)
    params = get_material_params(ta)
    step = make_train_step(None, torch.optim.SGD(params.values(), lr=0.1),
                           graphs=True)
    with pytest.raises(ValueError, match="graphs=True"):
        step(params, ta, tc, torch.zeros((8, 8, 3)), 0)
    with pytest.raises(ValueError, match="eager"):
        make_train_step(object(), torch.optim.SGD(params.values(), lr=0.1),
                        graphs=True)


def test_graphed_pass_refuses_early_exit(monkeypatch):
    _, ta, tc = _pass_inputs("fused", 8, 4)
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(4, 1)
    u = torch.rand((5, 7, 4))
    trace(ta, o, d, None, early_exit=True, uniforms=u)  # eager: allowed
    monkeypatch.setattr(graphs, "capturing", lambda device: True)
    with pytest.raises(ValueError, match="early_exit"):
        trace(ta, o, d, None, early_exit=True, uniforms=u)
    trace(ta, o, d, None, early_exit=False, uniforms=u)


def test_capture_refused_under_profiler():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(graphs.GraphCaptureError, match="profiler"):
            graphs.capture(lambda x: x + 1, (torch.zeros(3),), label="x")


def test_failing_op_names_the_operation():
    def body():
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")
    try:
        fused.fits(None)  # AttributeError inside the package
    except AttributeError as exc:
        where = graphs._failing_op(exc)
    assert where.startswith("raytracercore_tpu_torch/render/fused.py:")
    assert "fits" in where
    try:
        body()
    except RuntimeError as exc:
        assert "body" in graphs._failing_op(exc)


# --- launch accounting and the cache -----------------------------------------

class _FakeGraph:
    """Stands in for a CUDA graph: replays count, the dump is a file."""

    DOT = ('"n0"[label="{KERNEL\n| {ID | 0 (topoId: 1) | '
           '_ZN3rtc17trace_fused_kernelILb0ELb0ELb0ELb1EEEvNS_6ParamsE'
           '\\<\\<\\<1,128,0\\>\\>\\>}"];\n'
           '"n1"[label="{KERNEL\n| {ID | 1 (topoId: 0) | '
           '_ZN2at6native13reduce_kernelILi512E\\<\\<\\<1,128,512\\>\\>\\>}'
           '"];\n"n2"[label="{MEMSET\n| {ID | 2}"];\n')

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1

    def debug_dump(self, path):
        with open(path, "w") as f:
            f.write(self.DOT)


def test_launches_count_replays_not_captures(tmp_path):
    before = fused.trace_fused.launches
    tally = {}
    kernels._capture_tally[0] = tally
    try:
        kernels.count_launch(fused.trace_fused)
        kernels.count_launch(fused.trace_fused)
    finally:
        kernels._capture_tally[0] = None
    assert fused.trace_fused.launches == before
    assert tally == {fused.trace_fused: 2}
    cap = graphs.Captured(graph=_FakeGraph(), inputs=(), outputs=None,
                          launches=tally, capture_ms=0.0, pool_bytes=0,
                          label="fake")
    for _ in range(3):
        cap.replay()
    assert cap.replays == cap.graph.replays == 3
    assert fused.trace_fused.launches == before + 6
    kernels.count_launch(fused.trace_fused)
    assert fused.trace_fused.launches == before + 7
    nodes = cap.kernel_nodes(str(tmp_path / "g.dot"))
    assert sum(nodes.values()) == 2
    assert any("trace_fused_kernel" in name for name in nodes)


def test_feed_copies_only_other_tensors():
    a, b = torch.zeros(4), torch.zeros(2, 3)
    cap = graphs.Captured(graph=_FakeGraph(), inputs=(a, b), outputs=None,
                          launches={}, capture_ms=0.0, pool_bytes=0,
                          label="fake")
    cap.feed(torch.arange(4.0), b)
    assert torch.equal(a, torch.arange(4.0)) and cap.inputs[1] is b
    with pytest.raises(ValueError, match="inputs fed"):
        cap.feed(a)


def test_graph_cache_keeps_the_last_entries():
    cache = graphs.GraphCache(size=2)
    made = []

    def make(k):
        return lambda: made.append(k) or k
    assert [cache.get(k, make(k)) for k in "abab"] == list("abab")
    cache.get("c", make("c"))       # evicts "a", the least recently used
    cache.get("b", make("b"))
    cache.get("a", make("a"))
    assert made == ["a", "b", "c", "a"] and cache.captures == 4
    assert list(cache.entries) == ["b", "a"]


def test_train_loop_passes_graphs_on():
    _, _, ta, tc, target = _step_inputs(8, 3)
    p1, p2 = get_material_params(ta), get_material_params(ta)
    loop = make_train_loop(None, torch.optim.Adam(p1.values(), lr=1e-2), 3,
                           graphs=False)
    step = make_train_step(None, torch.optim.Adam(p2.values(), lr=1e-2))
    losses = loop(p1, ta, tc, target, 4)
    want = torch.stack([step(p2, ta, tc, target, pass_seed(4, i))
                        for i in range(3)])
    assert torch.equal(losses, want)
    assert loop.graphs.captures == step.graphs.captures == 0


# --- on the card --------------------------------------------------------------

@pytest.mark.cuda
def test_graphed_passes_equal_eager_on_card(cuda_device):
    _, thost = _small("cornell", 64, 10)
    graphed = Renderer(thost, device=cuda_device, seed=2)
    eager = Renderer(thost, device=cuda_device, seed=2, graphs=False)
    for r in (graphed, eager):
        r.step(3)
        r.next_camera()
        r.step(2)
    _films_equal(graphed.film, eager.film)
    assert graphed.pass_graphs.captures >= 1


@pytest.mark.cuda
def test_graphed_step_equals_eager_on_card(cuda_device):
    _, thost = _small("cornell", 64, 6)
    ta = ttypes.freeze_scene(thost, device=cuda_device)
    tc = ttypes.init_camera(thost.cameras[0], 64, 64, device=cuda_device)
    target = torch.rand((64, 64, 3), device=cuda_device)
    losses = []
    for graphed in (True, False):
        p = get_material_params(ta)
        step = make_train_step(None, torch.optim.Adam(p.values(), lr=1e-2),
                               graphs=graphed)
        losses.append(torch.stack([step(p, ta, tc, target, s)
                                   for s in range(3)]))
    assert torch.equal(*losses)


def test_camera_clone_is_independent():
    _, ta, tc = _pass_inputs("fused", 8, 4)
    from raytracercore_tpu_torch.render.renderer import (_clone_camera,
                                                         camera_tensors)
    c = _clone_camera(tc)
    assert c.mode == tc.mode
    for x, y in zip(camera_tensors(c), camera_tensors(tc)):
        assert torch.equal(x, y) and x.data_ptr() != y.data_ptr()
    assert len(camera_tensors(tc)) == sum(
        isinstance(getattr(tc, f.name), torch.Tensor)
        for f in dataclasses.fields(tc))


def test_cli_bench_says_whether_graphed(tmp_path, capsys):
    from raytracercore_tpu_torch.parallel.worker import CORNELL_SCENE
    from raytracercore_tpu_torch.tools import cli

    scene = tmp_path / "scene.txt"
    scene.write_text(CORNELL_SCENE)
    cli.main(["bench", str(scene), "--device", "cpu", "--size", "8",
              "--recursion", "3", "--spp", "1"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"graphed": false' in line and '"route": "megakernel"' in line
