"""The last of the JAX package's public surface in the port, held against
the JAX package on the same numpy-seeded inputs:

* ``Film.add_scatter``: unique indices bit-equal to JAX ``add_scatter`` and
  to ``add_full_frame`` of the same samples in pixel order; repeated
  indices with the counts exact and the colour within 1e-6 relative (a
  float sum in another order); the compensation term carried unchanged;
* ``Film.merge``: bit-equal to JAX ``merge`` for the four ``color_c``
  combinations, and tests/test_film.py's compensated merge (rtol 1e-7);
* ``Renderer(dtype=torch.float64)`` on the CPU: the ``trace`` route with
  the f64 dense closest hit, a pass against JAX ``camera_rays`` + ``trace``
  in float64 (misses equal, colours within 1e-9·(1 + |c|): both run the
  same f64 operations), chunk invariance, f64 checkpoints both ways;
* ``Renderer.profile``: a Chrome trace holding the JAX package's phase
  scopes, its film equal to ``step(n)``;
* ``trace_replay(record_fused=, replay_kernel=)``: the ``trace`` recorder
  with the plain replay bit-identical to ``trace`` (as
  tests/test_replay.py:35-45 holds the JAX package), gradients within
  1e-5·max|g| of autograd of ``trace`` and of JAX ``trace_replay``, air IOR
  and ambient gradients within 1e-5 relative of JAX
  ``trace_replay(replay_kernel=False)``, and the guards.

JAX float64 runs inside ``jax.enable_x64()`` only: the workers share one
process between the tests of a file.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracercore_tpu.render import camera as jcam
from raytracercore_tpu.render.film import Film as JFilm
from raytracercore_tpu.render.integrator import prepare_uniforms as jprep
from raytracercore_tpu.render.integrator import trace as jtrace
from raytracercore_tpu.render.renderer import Renderer as JRenderer
from raytracercore_tpu.render.replay import trace_replay as jtrace_replay
from raytracercore_tpu.scene import types as jtypes
from raytracercore_tpu_torch.diff import MATERIAL_FIELDS
from raytracercore_tpu_torch.intersect.cuda_select import closest_hit_fused
from raytracercore_tpu_torch.intersect.dispatch import closest_hit
from raytracercore_tpu_torch.render import fused
from raytracercore_tpu_torch.render.film import Film
from raytracercore_tpu_torch.render.integrator import trace
from raytracercore_tpu_torch.render.renderer import (Renderer, pass_draws,
                                                     render_pass)
from raytracercore_tpu_torch.render.replay import trace_replay
from raytracercore_tpu_torch.scene import meshgen
from test_torch_fused import cuda_device  # noqa: F401
from test_torch_replay import (assert_grads_match, jax_loss_grads,
                               port_loss_grads)
from test_torch_scene import host_scenes
from test_torch_trace import case as trace_case

H, W = 8, 12


def _t(a):
    return torch.tensor(np.asarray(a))


def _films(compensated, seed=0):
    """A JAX and a port film holding the same non-zero state."""
    rng = np.random.default_rng(seed)
    color = rng.uniform(0, 3, (H * W, 3)).astype(np.float32)
    miss = rng.uniform(size=H * W) < 0.2
    jf = JFilm.create(H, W, compensated=compensated).add_full_frame(
        jnp.asarray(color), jnp.asarray(miss))
    tf = Film.create(H, W, device="cpu", compensated=compensated)
    tf = tf.add_full_frame(_t(color), _t(miss))
    if compensated:  # a non-zero compensation term, to see it carried
        c = rng.normal(0, 1e-7, (H, W, 3)).astype(np.float32)
        jf = jf.replace(color_c=jnp.asarray(c))
        tf = dataclasses.replace(tf, color_c=_t(c))
    return jf, tf


def _samples(n, seed):
    rng = np.random.default_rng(seed)
    color = rng.uniform(0, 5, (n, 3)).astype(np.float32)
    miss = rng.uniform(size=n) < 0.25
    return color, miss


def _fields(film):
    return {k: getattr(film, k) for k in
            ("color_sum", "samples", "misses", "color_c")}


def _np(x):
    return None if x is None else np.asarray(x)


@pytest.mark.parametrize("compensated", [False, True])
def test_add_scatter_unique_indices_bit_equal(compensated):
    jf, tf = _films(compensated)
    color, miss = _samples(H * W, 1)
    perm = np.random.default_rng(2).permutation(H * W).astype(np.int32)
    want = jf.add_scatter(jnp.asarray(perm), jnp.asarray(color),
                          jnp.asarray(miss))
    got = tf.add_scatter(_t(perm), _t(color), _t(miss))
    for k, v in _fields(got).items():
        w = _np(getattr(want, k))
        if w is None:
            assert v is None
            continue
        np.testing.assert_array_equal(v.numpy(), w, err_msg=k)
    # One add a pixel: add_full_frame of the samples in pixel order.
    inv = np.argsort(perm)
    frame = dataclasses.replace(tf, color_c=None).add_full_frame(
        _t(color[inv]), _t(miss[inv]))
    for k in ("color_sum", "samples", "misses"):
        assert torch.equal(getattr(got, k), getattr(frame, k)), k
    if compensated:
        assert torch.equal(got.color_c, tf.color_c)  # carried unchanged


@pytest.mark.parametrize("compensated", [False, True])
def test_add_scatter_repeated_indices(compensated):
    jf, tf = _films(compensated)
    n = 4 * H * W
    color, miss = _samples(n, 3)
    idx = np.random.default_rng(4).integers(0, H * W, n).astype(np.int32)
    want = jf.add_scatter(jnp.asarray(idx), jnp.asarray(color),
                          jnp.asarray(miss))
    got = tf.add_scatter(_t(idx), _t(color), _t(miss))
    assert len(np.unique(idx)) < n  # collisions happen
    for k in ("samples", "misses"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)))
    np.testing.assert_allclose(got.color_sum.numpy(),
                               np.asarray(want.color_sum), rtol=1e-6)
    # Against the exact sum in float64.
    exact = tf.color_sum.double().reshape(-1, 3).index_add_(
        0, _t(idx).long(), torch.where(_t(miss)[:, None], 0.0,
                                       _t(color)).double())
    np.testing.assert_allclose(got.color_sum.reshape(-1, 3).numpy(),
                               exact.numpy(), rtol=1e-6)
    if compensated:
        assert torch.equal(got.color_c, tf.color_c)
    else:
        assert got.color_c is None


@pytest.mark.parametrize("a_comp,b_comp", [
    (False, False), (True, False), (False, True), (True, True)])
def test_merge_matches_jax(a_comp, b_comp):
    ja, ta = _films(a_comp, seed=5)
    jb, tb = _films(b_comp, seed=6)
    want, got = ja.merge(jb), ta.merge(tb)
    for k, v in _fields(got).items():
        w = _np(getattr(want, k))
        if w is None:
            assert v is None and not (a_comp or b_comp)
            continue
        np.testing.assert_array_equal(v.numpy(), w, err_msg=k)


def test_compensated_merge():
    """The port of tests/test_film.py's compensated merge: 2^24 plus 1000
    halves, merged with itself."""
    big, small, n = float(2 ** 24), 0.5, 1000
    no_miss = torch.zeros((1,), dtype=torch.bool)
    a = Film.create(1, 1, device="cpu", compensated=True)
    a = a.add_full_frame(torch.full((1, 3), big), no_miss)
    for _ in range(n):
        a = a.add_full_frame(torch.full((1, 3), small), no_miss)
    merged = a.merge(a)
    np.testing.assert_allclose(float(merged.corrected_sum[0, 0, 0]),
                               2 * (big + n * small), rtol=1e-7)
    assert float(merged.samples[0, 0]) == 2 * (n + 1)


# --- Renderer(dtype=) ------------------------------------------------------

def _hosts(name, size, recursion):
    jhost, thost = host_scenes(name)
    for host in (jhost, thost):
        host.width = host.height = size
        host.recursion = recursion
    return jhost, thost


def test_float64_renderer_route_and_dtypes():
    _, thost = _hosts("cornell", 16, 10)
    r32 = Renderer(thost, device="cpu")
    r64 = Renderer(thost, device="cpu", dtype=torch.float64)
    assert r32.route == "megakernel"
    assert r64.route == "trace" and r64.closest_fn is closest_hit
    for t in (r64.arrays.triangles.v0, r64.camera.position,
              r64.film.color_sum, r64.film.samples):
        assert t.dtype == torch.float64
    assert r64.arrays.triangles.prim_id.dtype == torch.int32
    # Frozen arrays given with their cameras are cast too.
    arrays, cam, _ = meshgen.make_mesh_scene(grid=1, subdiv=1, width=8,
                                             height=8, device="cpu")
    rm = Renderer(arrays, device="cpu", cameras=[cam], dtype=torch.float64)
    assert rm.arrays.triangles.v0.dtype == torch.float64
    assert rm.arrays.materials.two_sided.dtype == torch.bool
    rm.step(1)
    assert rm.film.color_sum.dtype == torch.float64
    assert rm.image().shape == (8, 8, 4)
    with pytest.raises(ValueError, match="float32 or float64"):
        Renderer(thost, device="cpu", dtype=torch.float16)


@pytest.mark.parametrize("name,size,recursion", [
    ("cornell", 16, 10), ("fused", 16, 4)])
def test_float64_pass_matches_jax_x64(name, size, recursion):
    jhost, thost = _hosts(name, size, recursion)
    with jax.enable_x64():
        ja = jtypes.freeze_scene(jhost, dtype=jnp.float64)
        jc = jtypes.init_camera(jhost.cameras[0], size, size,
                                dtype=jnp.float64)
        px, py = jcam.pixel_grid(size, size)
        k_cam, k_path = jax.random.split(jax.random.PRNGKey(5))
        jitter = jax.random.uniform(k_cam, (size * size, 4),
                                    dtype=jnp.float64)
        uniforms = jprep(k_path, size * size, recursion + 1, jnp.float64)
        ray_o, ray_d = jcam.camera_rays(jc, px, py, k_cam)
        color, miss = jtrace(ja, ray_o, ray_d, None, uniforms=uniforms)
        color, miss, jitter, uniforms = (np.asarray(x) for x in
                                         (color, miss, jitter, uniforms))
    assert uniforms.dtype == np.float64
    r = Renderer(thost, device="cpu", dtype=torch.float64)
    film = render_pass(r.arrays, r.camera, r.film, _t(jitter), _t(uniforms),
                       closest_fn=r.closest_fn, trace_fn=r.trace_fn)
    assert film.color_sum.dtype == torch.float64
    np.testing.assert_array_equal(film.misses.numpy().reshape(-1), miss)
    np.testing.assert_array_equal(film.samples.numpy().reshape(-1), ~miss)
    want = np.where(miss[:, None], 0.0, color)
    assert want.max() > 0.5
    got = film.color_sum.numpy().reshape(-1, 3)
    assert np.all(np.abs(got - want) <= 1e-9 * (1 + np.abs(want)))


def test_float64_step_chunking_and_draws():
    _, thost = _hosts("cornell", 12, 10)
    a = Renderer(thost, device="cpu", seed=3, dtype=torch.float64)
    a.step(2)
    a.step(2)
    b = Renderer(thost, device="cpu", seed=3, dtype=torch.float64)
    b.step(4)
    for k in ("color_sum", "samples", "misses"):
        assert torch.equal(getattr(a.film, k), getattr(b.film, k)), k
    # Every dtype draws the same numbers; the channels follow the dtype.
    j32, u32 = pass_draws(3, 1, 50, 4, "cpu")
    j64, u64 = pass_draws(3, 1, 50, 4, "cpu", torch.float64)
    assert j64.dtype == u64.dtype == torch.float64
    assert torch.equal(j64, j32.double())
    np.testing.assert_allclose(u64.numpy(), u32.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_float64_checkpoints(tmp_path):
    jhost, thost = _hosts("fused", 8, 2)
    r = Renderer(thost, device="cpu", seed=1, dtype=torch.float64,
                 compensated=True)
    r.step(2)
    path = str(tmp_path / "port64.npz")
    r.save_checkpoint(path)
    back = Renderer(thost, device="cpu", dtype=torch.float64)
    back.load_checkpoint(path)
    assert back.pass_index == 2 and back.compensated
    for k, v in _fields(r.film).items():
        got = getattr(back.film, k)
        assert got.dtype == torch.float64 and torch.equal(got, v), k
    # A float32 renderer loads it in float32 (its own dtype).
    f32 = Renderer(thost, device="cpu")
    f32.load_checkpoint(path)
    assert f32.film.color_sum.dtype == torch.float32
    # A JAX float64 checkpoint loads bit for bit.
    with jax.enable_x64():
        jr = JRenderer(jhost, seed=2, dtype=jnp.float64)
        jr.step(2)
        jpath = str(tmp_path / "jax64.npz")
        jr.save_checkpoint(jpath)
        want = {k: _np(v) for k, v in _fields(jr.film).items()}
    assert want["color_sum"].dtype == np.float64
    tr = Renderer(thost, device="cpu", dtype=torch.float64)
    tr.load_checkpoint(jpath)
    assert tr.pass_index == 2
    for k, w in want.items():
        got = getattr(tr.film, k)
        if w is None:
            assert got is None
            continue
        assert got.dtype == torch.float64
        np.testing.assert_array_equal(got.numpy(), w, err_msg=k)


# --- Renderer.profile ------------------------------------------------------

@pytest.mark.parametrize("dtype,route,scope", [
    (torch.float32, "megakernel", "trace_fused"),
    (torch.float64, "trace", "closest_hit")])
def test_profile_writes_the_phase_scopes(tmp_path, dtype, route, scope):
    _, thost = _hosts("cornell", 12, 4)
    r = Renderer(thost, device="cpu", seed=9, dtype=dtype)
    assert r.route == route
    r.step(1)
    path = r.profile(str(tmp_path / "prof"), n=2)
    assert r.pass_index == 3
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    counts = {}
    for e in events:
        counts[e.get("name")] = counts.get(e.get("name"), 0) + 1
    per_pass = 1 if route == "megakernel" else thost.recursion + 1
    assert counts.get("camera_rays") == 2
    assert counts.get("film_accum") == 2
    assert counts.get(scope) == 2 * per_pass
    want = Renderer(thost, device="cpu", seed=9, dtype=dtype)
    want.step(3)
    for k in ("color_sum", "samples", "misses"):
        assert torch.equal(getattr(r.film, k), getattr(want.film, k)), k


# --- trace_replay(record_fused=, replay_kernel=) ---------------------------

@pytest.mark.parametrize("name,size,recursion", [
    ("cornell", 16, 10), ("mesh-82", 16, 3)])
def test_unfused_plain_replay_equals_trace(name, size, recursion):
    """``record_fused=False`` + ``replay_kernel=False``: the recorder is
    ``trace``'s own loop and the replay re-walks it with the same
    operations, so colour and miss equal ``trace``'s bit for bit."""
    _, _, ta, _, _, (o, d, u), _ = trace_case(name, size, recursion)
    want_c, want_m = trace(ta, o, d, None, uniforms=u)
    got_c, got_m = trace_replay(ta, o, d, uniforms=u, record_fused=False,
                                replay_kernel=False)
    assert float(want_c.max()) > 0.1
    assert torch.equal(got_m, want_m)
    assert torch.equal(got_c, want_c)


def test_unfused_replay_gradients_match_trace_and_jax():
    """Gradients of both replays on the ``trace`` recorder within
    1e-5·max|g| of autograd of ``trace`` and of JAX
    ``trace_replay(record_fused=False)`` on the same uniforms."""
    ja, _, ta, _, (jo, jd, _), (o, d, u), _ = trace_case("cornell", 16, 3)
    key = jax.random.split(jax.random.PRNGKey(7))[1]  # trace_case's path key
    want_c, want_m, want_g = port_loss_grads(trace, ta, (o, d, None),
                                             uniforms=u)
    jax_c, jax_m, jax_g = jax_loss_grads(jtrace_replay, ja, (jo, jd, key),
                                         record_fused=False)
    np.testing.assert_array_equal(jax_m, want_m.numpy())
    for replay_kernel in (False, None):
        got_c, got_m, got_g = port_loss_grads(
            trace_replay, ta, (o, d), uniforms=u, record_fused=False,
            replay_kernel=replay_kernel)
        assert torch.equal(got_m, want_m)
        np.testing.assert_allclose(got_c.numpy(), want_c.numpy(),
                                   rtol=1e-6, atol=1e-6)
        for ref in (want_g, jax_g):
            assert_grads_match(got_g, ref, MATERIAL_FIELDS[:4])
            for k in MATERIAL_FIELDS:
                np.testing.assert_allclose(
                    got_g[k], ref[k], rtol=1e-5,
                    atol=1e-5 * np.abs(ref[k]).max() + 1e-7, err_msg=k)


def _scene_grads(fn, scene, ray_o, ray_d, **kw):
    """Gradients of the L2 image loss w.r.t. air IOR and ambient."""
    air = scene.air_refractive_index.detach().clone().requires_grad_(True)
    amb = scene.ambient_rgb.detach().clone().requires_grad_(True)
    s = dataclasses.replace(scene, air_refractive_index=air, ambient_rgb=amb)
    color, miss = fn(s, ray_o, ray_d, **kw)
    torch.mean(torch.where(miss[:, None], 0.0, color) ** 2).backward()
    return air.grad.numpy(), amb.grad.numpy()


def test_plain_replay_gives_air_and_ambient_gradients():
    """``replay_kernel=False`` differentiates air IOR and ambient (the
    kernels give them none), within 1e-5 relative of JAX
    ``trace_replay(replay_kernel=False)`` on the same tape and uniforms."""
    from test_torch_train import _scenes
    ja, jc, ta, _ = _scenes("rough", 16, 4)  # open, with an ambient colour
    px, py = jcam.pixel_grid(16, 16)
    k_cam, key = jax.random.split(jax.random.PRNGKey(3))
    jo, jd = jcam.camera_rays(jc, px, py, k_cam)
    o, d, u = _t(jo), _t(jd), _t(jprep(key, 16 * 16, 5, jnp.float32))

    def jloss(air, amb):
        s = ja.replace(air_refractive_index=air, ambient_rgb=amb)
        color, miss = jtrace_replay(s, jo, jd, key, record_fused=False,
                                    replay_kernel=False)
        return jnp.mean(jnp.where(miss[:, None], 0.0, color) ** 2)
    want = [np.asarray(g) for g in jax.grad(jloss, argnums=(0, 1))(
        ja.air_refractive_index, ja.ambient_rgb)]
    got = _scene_grads(trace_replay, ta, o, d, uniforms=u,
                       record_fused=False, replay_kernel=False)
    for g, w, what in zip(got, want, ("air IOR", "ambient")):
        assert np.abs(w).max() > 0, what  # not vacuous
        np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=what)
    # The kernel route gives them none: with the materials fixed, its
    # colour does not depend on anything autograd can reach.
    s = dataclasses.replace(
        ta, air_refractive_index=ta.air_refractive_index.clone()
        .requires_grad_(True), ambient_rgb=ta.ambient_rgb.clone()
        .requires_grad_(True))
    color, _ = trace_replay(s, o, d, uniforms=u, record_fused=False)
    assert not color.requires_grad


def test_record_fused_routes_and_guards():
    _, _, ta, _, _, (o, d, u), _ = trace_case("cornell", 12, 4)
    default = trace_replay(ta, o, d, uniforms=u)
    forced = trace_replay(ta, o, d, uniforms=u, record_fused=True)
    assert torch.equal(default[0], forced[0])
    assert torch.equal(default[1], forced[1])
    with pytest.raises(ValueError, match="fits"):
        trace_replay(ta, o.double(), d.double(), uniforms=u,
                     record_fused=True)
    # Float64 rays on the CPU take the trace recorder and the plain replay.
    c64, m64 = trace_replay(ta, o.double(), d.double(), uniforms=u)
    want = trace(ta, o.double(), d.double(), None, uniforms=u)
    assert c64.dtype == torch.float64
    assert torch.equal(c64, want[0]) and torch.equal(m64, want[1])
    _, _, mesh, _, _, (mo, md, mu), _ = trace_case("mesh-82", 12, 3)
    assert not fused.fits(mesh)
    with pytest.raises(ValueError, match="fits"):
        trace_replay(mesh, mo, md, uniforms=mu, record_fused=True)


def test_trace_fused_takes_float64_rays():
    """f64 rays go to the megakernel (here its plain version) as f32
    copies; colour and tape normals come back in f64."""
    _, _, ta, _, _, (o, d, u), _ = trace_case("cornell", 12, 10)
    want = fused.trace_fused(ta, o, d, u, want_tape=True)
    got = fused.trace_fused(ta, o.double(), d.double(), u.double(),
                            want_tape=True)
    assert got[0].dtype == got[2].nx.dtype == torch.float64
    assert torch.equal(got[0], want[0].double())
    assert torch.equal(got[1], want[1])
    for k in ("prim", "flags", "nx", "ny", "nz"):
        assert torch.equal(getattr(got[2], k).to(getattr(want[2], k).dtype),
                           getattr(want[2], k)), k
    # An f64 scene packs the kernel's tables in f32.
    jhost, thost = _hosts("cornell", 12, 10)
    r64 = Renderer(thost, device="cpu", dtype=torch.float64)
    assert all(t.dtype in (torch.float32, torch.int32)
               for t in r64.arrays.fused_tables)
    got64 = fused.trace_fused(r64.arrays, o.double(), d.double(), u)
    assert torch.equal(got64[0], want[0].double())


@pytest.mark.cuda
def test_float64_rays_on_card_need_replay_kernel_false(cuda_device):  # noqa: F811
    _, _, ta, _, _, (o, d, u), _ = trace_case("cornell", 12, 4)
    ta = ta.to(cuda_device)
    o, d, u = (x.to(cuda_device) for x in (o, d, u))
    with pytest.raises(ValueError, match="replay_kernel=False"):
        trace_replay(ta, o.double(), d.double(), uniforms=u)
    c, m = trace_replay(ta, o.double(), d.double(), uniforms=u,
                        replay_kernel=False)
    want = trace(ta, o.double(), d.double(), None,
                 closest_fn=closest_hit_fused, uniforms=u)
    assert c.dtype == torch.float64
    assert torch.equal(m, want[1])
    np.testing.assert_allclose(c.cpu().numpy(), want[0].cpu().numpy(),
                               rtol=1e-9, atol=1e-9)
