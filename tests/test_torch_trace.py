"""The port's differentiable integrator (``render/integrator.py:trace``) and
what is built on it — the ``trace`` recorder of ``trace_replay``, the
``use_replay=False`` train step, the ``Renderer``'s per-bounce route and
the CLI on a mid-size scene — against the JAX package.

Both packages get the same scene arrays, camera rays and
``prepare_uniforms`` channels.  On the CPU both run their dense grid closest
hit, the same formulas in f32, so the two follow the same stochastic paths:

* miss flags equal; at least 0.97 of rays within 1e-3 + 1e-3·|ref| and
  channel means within 5e-3 (the tolerances of tests/test_torch_fused.py;
  the rest may only be knife-edge f32 branch flips, never the same path
  with another colour);
* tape codes equal on at least 0.99 of bounces, prim where the path is live
  and the whole flag word on bounced codes (where a replay reads them);
  normals there within 1e-4 on the first bounce and 1e-2 on later ones
  (``assert_geometry_close`` says why), but for grazing hits (at most
  0.5 % of them);
* ``BounceRecords`` on touched bounces: type, prim and inside equal where
  the codes agree, t, position and normal to the same tolerances;
* material gradients within 1e-5·max|g| per field.
"""

import dataclasses
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
from raytracercore_tpu.render.integrator import prepare_uniforms as jprep
from raytracercore_tpu.render.integrator import trace as jtrace
from raytracercore_tpu.scene import types as jtypes
from raytracercore_tpu_torch.diff import (MATERIAL_FIELDS,
                                          get_material_params,
                                          material_params_from_numpy)
from raytracercore_tpu_torch.intersect.cuda_select import closest_hit_fused
from raytracercore_tpu_torch.intersect.dispatch import closest_hit
from raytracercore_tpu_torch.parallel import make_train_loop, make_train_step
from raytracercore_tpu_torch.render import fused
from raytracercore_tpu_torch.render.integrator import (BounceType, PathTape,
                                                       trace)
from raytracercore_tpu_torch.render.renderer import Renderer, pass_seed
from raytracercore_tpu_torch.render.replay import (record_tape, replay,
                                                   trace_replay)
from raytracercore_tpu_torch.scene import loader as tloader
from raytracercore_tpu_torch.scene import meshgen as tmeshgen
from raytracercore_tpu_torch.scene import types as ttypes
from raytracercore_tpu_torch.tools.png import read_png
from test_torch_dispatch import scene_pair
from test_torch_fused import CLOSE_FRAC, _as_port, cuda_device  # noqa: F401
from test_torch_replay import (assert_grads_match, jax_loss_grads,
                               port_loss_grads)
from test_torch_scene import REPO_ROOT, host_scenes


def _t(a):
    return torch.tensor(np.asarray(a))


def _close_camera(types):
    """A camera near the single icosphere of mesh-82 (the generator's own
    camera frames a whole field: nine tenths of its rays miss)."""
    return types.HostCamera(
        mode="frustum", position=np.array([0.0, -5.0, 3.0]),
        look_at=np.array([0.0, 0.0, 0.9]), up=np.array([0.0, 0.0, 1.0]),
        fov_or_size=np.deg2rad(45.0))


def case(name, size, recursion, seed=7, **overrides):
    """Both packages' scene and camera and the same rays and uniforms:
    ``(ja, jc, ta, tc, jax (o, d, u), port (o, d, u), jitter)``."""
    if name == "mesh-82":
        ja, ta = scene_pair(name, width=size, height=size,
                            recursion=recursion)
        jhc, thc = _close_camera(jtypes), _close_camera(ttypes)
    else:
        ja, ta = scene_pair(name, width=size, height=size,
                            recursion=recursion, **overrides)
        jhost, thost = host_scenes(name)
        jhc, thc = jhost.cameras[0], thost.cameras[0]
    jc = jtypes.init_camera(jhc, size, size)
    tc = ttypes.init_camera(thc, size, size, device="cpu")
    px, py = jcam.pixel_grid(size, size)
    k_cam, k_path = jax.random.split(jax.random.PRNGKey(seed))
    jitter = jax.random.uniform(k_cam, (size * size, 4), dtype=jnp.float32)
    ray_o, ray_d = jcam.camera_rays(jc, px, py, k_cam)
    uniforms = jprep(k_path, size * size, recursion + 1, jnp.float32)
    return (ja, jc, ta, tc, (ray_o, ray_d, uniforms),
            (_t(ray_o), _t(ray_d), _t(uniforms)), jitter)


def assert_colours_match(ref, got, min_lit=0.5):
    ref_c, got_c = np.asarray(ref[0]), got[0].detach().numpy()
    assert ref_c.max() > min_lit  # no vacuous agreement
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    close = np.all(np.abs(ref_c - got_c) <= 1e-3 + 1e-3 * np.abs(ref_c),
                   axis=1)
    assert close.mean() >= CLOSE_FRAC, f"only {close.mean():.3f} close"
    np.testing.assert_allclose(got_c.mean(0), ref_c.mean(0), rtol=5e-3,
                               atol=5e-3)


def assert_close_but_grazes(got, want, tol, what):
    """At least 99.5 % of entries within ``tol`` (abs + rel), all within
    100 x ``tol``: a hit nearly tangent to a surface (a far point of an
    infinite plane, the rim of a sphere) magnifies f32 rounding, and the two
    packages round differently there."""
    if got.size == 0:
        return
    err = np.abs(got - want)
    close = err <= tol + tol * np.abs(want)
    assert close.mean() >= 0.995, f"{what}: only {close.mean():.4f} close"
    assert (err <= 100 * (tol + tol * np.abs(want))).all(), what


def assert_geometry_close(got, want, mask, what):
    """Hit geometry ``[bounces, R(, 3)]`` where ``mask``: the first bounce
    (camera rays, the same inputs on both sides) within 1e-4; later bounces
    within 1e-2, since a path inherits and amplifies its earlier rounding
    differences (a normal off by 1e-6 moves the next hit by 1e-6 x the
    distance, and curved mirrors magnify that bounce after bounce)."""
    assert_close_but_grazes(got[0][mask[0]], want[0][mask[0]], 1e-4,
                            f"{what}, bounce 0")
    assert_close_but_grazes(got[1:][mask[1:]], want[1:][mask[1:]], 1e-2,
                            f"{what}, later bounces")


def assert_tapes_match(jtape, ttape):
    code_ref = np.asarray(jtape.flags) & PathTape.CODE_MASK
    code_got = ttape.flags.numpy() & PathTape.CODE_MASK
    agree = code_ref == code_got
    assert agree.mean() >= 0.99, f"only {agree.mean():.3f} of codes match"
    live = agree & (code_ref != BounceType.SKIPPED)
    assert live.any()
    np.testing.assert_array_equal(ttape.prim.numpy()[live],
                                  np.asarray(jtape.prim)[live])
    bounced = agree & np.isin(code_ref, (BounceType.DIFFUSE,
                                         BounceType.SPECULAR,
                                         BounceType.TRANSMITTED))
    assert bounced.any()
    np.testing.assert_array_equal(ttape.flags.numpy()[bounced],
                                  np.asarray(jtape.flags)[bounced])
    for k in ("nx", "ny", "nz"):
        assert_geometry_close(getattr(ttape, k).numpy(),
                              np.asarray(getattr(jtape, k)), bounced, k)


def assert_records_match(jrec, trec):
    btype_ref = np.asarray(jrec.btype)
    btype_got = trec.btype.numpy()
    agree = btype_ref == btype_got
    assert agree.mean() >= 0.99
    touched = agree & (btype_ref != BounceType.SKIPPED)
    assert touched.any()
    np.testing.assert_array_equal(trec.prim.numpy()[touched],
                                  np.asarray(jrec.prim)[touched])
    hit = touched & (btype_ref != BounceType.MISSED)
    np.testing.assert_array_equal(trec.inside.numpy()[hit],
                                  np.asarray(jrec.inside)[hit])
    for f in ("t", "position", "normal"):  # [R, B(, 3)] → bounce first
        assert_geometry_close(np.swapaxes(getattr(trec, f).numpy(), 0, 1),
                              np.swapaxes(np.asarray(getattr(jrec, f)), 0, 1),
                              hit.T, f)
    # Fresnel is NaN exactly where it was not evaluated.
    fr_ref, fr_got = np.asarray(jrec.fresnel), trec.fresnel.numpy()
    np.testing.assert_array_equal(np.isnan(fr_got)[agree],
                                  np.isnan(fr_ref)[agree])
    both = agree & ~np.isnan(fr_ref)
    assert_geometry_close(fr_got.T, fr_ref.T, both.T, "fresnel")
    # Untouched bounces keep the defaults of BounceRecords.create.
    untouched = btype_got == BounceType.SKIPPED
    assert (trec.prim.numpy()[untouched] == -1).all()
    assert (trec.t.numpy()[untouched] == 0).all()


@pytest.mark.parametrize("name,size,recursion,overrides,min_lit", [
    ("cornell", 24, 10, {}, 0.5),
    ("mesh-82", 32, 4, {}, 0.1),
    ("fused", 32, 4, {"ambient_rgb": None}, 0.5),   # `ambient miss`
    ("smooth", 24, 6, {}, 0.5),
])
def test_trace_matches_jax_trace(name, size, recursion, overrides, min_lit):
    ja, _, ta, _, jin, tin, _ = case(name, size, recursion, **overrides)
    assert ta.ambient_is_miss == ja.ambient_is_miss
    assert ta.ambient_is_miss == (name in ("fused", "smooth"))
    ref = jtrace(ja, jin[0], jin[1], None, uniforms=jin[2], record=True,
                 want_tape=True)
    got = trace(ta, tin[0], tin[1], None, uniforms=tin[2], record=True,
                want_tape=True)
    assert_colours_match(ref, got, min_lit)
    cls = fused.classify_mismatches(_as_port((ref[0], ref[1], ref[3])),
                                    (got[0], got[1], got[3]))
    assert not cls["samepick"].any()
    assert_tapes_match(ref[3], got[3])
    assert_records_match(ref[2], got[2])
    # Plain call: the same colours without the extras.
    plain = trace(ta, tin[0], tin[1], None, uniforms=tin[2])
    assert len(plain) == 2 and torch.equal(plain[0], got[0])
    # The whole-wavefront early exit changes nothing but the bounces run.
    early = trace(ta, tin[0], tin[1], None, uniforms=tin[2],
                  early_exit=True, want_tape=True)
    assert torch.equal(early[0], got[0]) and torch.equal(early[1], got[1])
    assert early[2].prim.shape == got[3].prim.shape


def test_trace_debug_geom_matches_jax():
    ja, _, ta, _, jin, tin, _ = case("cornell", 24, 3, debug_geom=True)
    assert ta.debug_geom
    ref = jtrace(ja, jin[0], jin[1], None, uniforms=jin[2], record=True,
                 want_tape=True)
    got = trace(ta, tin[0], tin[1], None, record=True, want_tape=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-6, atol=1e-6)
    assert float(got[0].max()) > 0.5
    jrec, jtape = ref[2], ref[3]
    for f in ("btype", "prim", "inside"):
        np.testing.assert_array_equal(getattr(got[2], f).numpy(),
                                      np.asarray(getattr(jrec, f)), f)
    np.testing.assert_allclose(got[2].t.numpy(), np.asarray(jrec.t),
                               rtol=1e-5, atol=1e-5)
    assert (got[2].btype.numpy()[:, 0] == BounceType.DEBUG).any()
    np.testing.assert_array_equal(got[3].prim.numpy(),
                                  np.asarray(jtape.prim))
    np.testing.assert_array_equal(got[3].flags.numpy(),
                                  np.asarray(jtape.flags))
    # trace_replay has no bounce loop to replay there: it returns trace.
    c, m = trace_replay(ta, tin[0], tin[1], seed=1)
    assert torch.equal(c, got[0]) and torch.equal(m, got[1])


def test_trace_draws_its_uniforms_from_the_generator():
    _, _, ta, _, _, tin, _ = case("fused", 16, 3)
    a = trace(ta, tin[0], tin[1], torch.Generator().manual_seed(5))
    b = trace(ta, tin[0], tin[1], torch.Generator().manual_seed(5))
    c = trace(ta, tin[0], tin[1], torch.Generator().manual_seed(6))
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    with pytest.raises(ValueError, match="generator or the uniforms"):
        trace(ta, tin[0], tin[1])


def test_trace_with_the_select_route_matches_the_grid_route():
    """``closest_hit_fused`` (the kernel's plain version on the CPU) in
    place of the grid ``closest_hit``: same paths but for knife edges."""
    _, _, ta, _, _, tin, _ = case("mesh-82", 24, 4)
    ref = trace(ta, tin[0], tin[1], None, uniforms=tin[2], want_tape=True)
    got = trace(ta, tin[0], tin[1], None, closest_fn=closest_hit_fused,
                uniforms=tin[2], want_tape=True)
    cls = fused.classify_mismatches(ref, got)
    assert cls["close"].mean() >= CLOSE_FRAC
    assert not cls["samepick"].any()
    assert torch.equal(ref[1], got[1])


@pytest.mark.parametrize("name,size,recursion", [
    ("rough", 12, 4), ("mesh-82", 16, 3)])
def test_trace_gradients_match_jax_grad(name, size, recursion):
    if name == "rough":
        from test_torch_train import _scenes
        ja, jc, ta, _ = _scenes(name, size, recursion)
        px, py = jcam.pixel_grid(size, size)
        k_cam, k_path = jax.random.split(jax.random.PRNGKey(3))
        ray_o, ray_d = jcam.camera_rays(jc, px, py, k_cam)
        u = jprep(k_path, size * size, recursion + 1, jnp.float32)
        jin, tin = (ray_o, ray_d, u), (_t(ray_o), _t(ray_d), _t(u))
    else:
        ja, _, ta, _, jin, tin, _ = case(name, size, recursion)
    want_c, want_m, want_g = jax_loss_grads(
        jtrace, ja, (jin[0], jin[1], None), uniforms=jin[2])
    got_c, got_m, got_g = port_loss_grads(
        trace, ta, (tin[0], tin[1], None), uniforms=tin[2])
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-5,
                               atol=1e-6)
    fields = MATERIAL_FIELDS if name == "rough" else (
        "emission", "diffuse")  # a diffuse mesh: the other four are zero
    assert_grads_match(got_g, want_g, fields)
    for k in MATERIAL_FIELDS:
        np.testing.assert_allclose(
            got_g[k], want_g[k], rtol=0,
            atol=1e-5 * np.abs(want_g[k]).max() + 1e-12, err_msg=k)


@pytest.mark.parametrize("name,size,recursion", [
    ("rough", 12, 4), ("mesh-82", 16, 3)])
def test_trace_replay_recorded_by_trace_equals_trace(name, size, recursion):
    """With the ``trace`` recorder, ``trace_replay`` is ``trace``'s
    estimator: equal values (1e-6: the replay re-walks the path in another
    tensor layout) and gradients (1e-5·max|g|), on a scene the megakernel
    could record (``rough``, with a caller's own ``closest_fn``) and on one
    above its cap (mesh-82); both replay through ``replay_fused``."""
    if name == "rough":
        from test_torch_train import _scenes
        _, _, ta, _ = _scenes(name, size, recursion)
        _, _, _, _, _, tin, _ = case("fused", size, recursion)

        def closest_fn(*args):  # a caller's own choice: not the default
            return closest_hit(*args)
    else:
        _, _, ta, _, _, tin, _ = case(name, size, recursion)
        closest_fn = closest_hit
        assert not fused.fits(ta)
    want_c, want_m, want_g = port_loss_grads(
        trace, ta, (tin[0], tin[1], None), uniforms=tin[2])
    got_c, got_m, got_g = port_loss_grads(
        trace_replay, ta, tin[:2], uniforms=tin[2], closest_fn=closest_fn)
    assert torch.equal(got_m, want_m)
    np.testing.assert_allclose(got_c.numpy(), want_c.numpy(), rtol=1e-6,
                               atol=1e-6)
    fields = MATERIAL_FIELDS if name == "rough" else ("emission", "diffuse")
    assert_grads_match(got_g, want_g, fields)
    # The recorder is the integrator's own loop.
    tape = record_tape(ta, tin[0], tin[1], tin[2], closest_fn=closest_fn)
    same = trace(ta, tin[0], tin[1], None, uniforms=tin[2], want_tape=True)
    for f in ("prim", "flags", "nx", "ny", "nz"):
        assert torch.equal(getattr(tape, f), getattr(same[2], f)), f
    c, m = replay(ta, tin[0], tin[1], tin[2], tape)
    np.testing.assert_allclose(c.numpy(), want_c.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_one_step_without_replay_matches_jax():
    """``make_train_step(use_replay=False)``: full AD through ``trace``,
    against JAX ``make_train_step(None, optax.sgd(1e-2),
    use_replay=False)`` on mesh-82 at 16x16: loss and params within 1e-5."""
    size, recursion = 16, 3
    ja, jc, ta, tc, _, _, jitter = case("mesh-82", size, recursion, seed=21)
    key = jax.random.PRNGKey(21)
    _, k_path = jax.random.split(key)
    uniforms = jprep(k_path, size * size, recursion + 1, jnp.float32)
    rng = np.random.default_rng(0)
    target = rng.uniform(0.0, 0.6, (size, size, 3)).astype(np.float32)

    optimizer = optax.sgd(1e-2)
    params = jget_params(ja)
    jstep = jmake_train_step(None, optimizer, use_replay=False)
    want_p, _, want_loss = jstep(params, ja, jc, jnp.asarray(target),
                                 optimizer.init(params), key)

    moved = 0
    for use_replay in (False, True):
        tparams = material_params_from_numpy(
            {k: np.asarray(v) for k, v in params.items()}, device="cpu")
        step = make_train_step(None, torch.optim.SGD(tparams.values(),
                                                     lr=1e-2),
                               use_replay=use_replay)
        loss = step(tparams, ta, tc, torch.tensor(target), seed=0,
                    jitter=_t(jitter), uniforms=_t(uniforms))
        assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
        for k in MATERIAL_FIELDS:
            got = tparams[k].detach().numpy()
            np.testing.assert_allclose(got, np.asarray(want_p[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
            moved += int((got != np.asarray(params[k])).sum())
    assert moved > 20


def test_train_loop_without_replay_equals_n_steps():
    _, _, ta, tc, _, _, _ = case("mesh-82", 8, 2)
    target = torch.full((8, 8, 3), 0.3)
    pa, pb = get_material_params(ta), get_material_params(ta)
    loop = make_train_loop(None, torch.optim.SGD(pa.values(), lr=1e-2), 2,
                           use_replay=False)
    losses = loop(pa, ta, tc, target, 5)
    step = make_train_step(None, torch.optim.SGD(pb.values(), lr=1e-2),
                           use_replay=False)
    want = [step(pb, ta, tc, target, pass_seed(5, i)) for i in range(2)]
    assert torch.equal(losses, torch.stack(want))
    for k in MATERIAL_FIELDS:
        assert torch.equal(pa[k], pb[k]), k


# ---------------------------------------------------------------------------
# Renderer and CLI on a scene above the megakernel's cap
# ---------------------------------------------------------------------------

def _lit_mesh(size=8, recursion=2):
    """mesh-82 from the port's generator with its light quad made two-sided
    (see ``scene_pair``): ``(SceneArrays, [HostCamera])``."""
    arrays, cam, _ = tmeshgen.make_mesh_scene(
        grid=1, subdiv=1, width=size, height=size, recursion=recursion,
        device="cpu")
    two_sided = arrays.materials.two_sided.clone()
    two_sided[-1] = True
    return dataclasses.replace(arrays, materials=dataclasses.replace(
        arrays.materials, two_sided=two_sided)), [cam]


# 66 spheres under a light sphere: a scene file above the megakernel's cap.
MID_SIZE_SCENE = (
    "size 8 8\nrecursion 2\ncamera 0 0 9  0 0 0  0 1 0  40\n"
    "emission 4 4 4\nsphere 0 0 40 30\nemission 0 0 0\ndiffuse .5 .6 .7\n"
    + "".join(f"sphere {i % 11 - 5} {i // 11 - 2.5} 0 .4\n"
              for i in range(66)))


def test_renderer_takes_frozen_arrays_with_their_cameras():
    """``Renderer(SceneArrays, cameras=[...])`` renders the film of
    ``Renderer(HostScene)`` for the same scene, cameras included."""
    _, host = host_scenes("cornell")
    host.width = host.height = 8
    a = Renderer(host, device="cpu", seed=2)
    b = Renderer(ttypes.freeze_scene(host, device="cpu"), device="cpu", seed=2,
                 cameras=host.cameras)
    assert a.route == b.route == "megakernel"
    for r in (a, b):
        r.step(2)
    assert torch.equal(a.film.color_sum, b.film.color_sum)
    np.testing.assert_array_equal(a.image(), b.image())
    assert a.next_camera() == b.next_camera()
    a.step(1)
    b.step(1)
    assert torch.equal(a.film.color_sum, b.film.color_sum)
    with pytest.raises(ValueError, match="cameras"):
        Renderer(ttypes.freeze_scene(host, device="cpu"), device="cpu")


def test_renderer_on_a_mesh_scene_takes_the_per_bounce_route(tmp_path):
    arrays, cams = _lit_mesh()
    assert not fused.fits(arrays)

    def renderer(**kw):
        return Renderer(arrays, device="cpu", cameras=cams, **kw)
    a = renderer(seed=3)
    assert a.route == "trace" and a.closest_fn is closest_hit_fused
    a.step(2)
    a.step(2)
    b = renderer(seed=3)
    b.step(4)
    for field in ("color_sum", "samples", "misses"):
        assert torch.equal(getattr(a.film, field), getattr(b.film, field))
    assert float(a.film.samples.sum() + a.film.misses.sum()) == 4 * 64
    assert bool(torch.isfinite(a.film.color_sum).all())
    assert a.image().shape == (8, 8, 4) and a.image()[..., :3].max() > 0

    # Checkpoint round trip, then both keep rendering the same film.
    path = str(tmp_path / "mesh.npz")
    a.save_checkpoint(path)
    c = renderer(seed=3)
    c.load_checkpoint(path)
    assert c.pass_index == 4
    a.step(1)
    c.step(1)
    assert torch.equal(a.film.color_sum, c.film.color_sum)

    # A caller's closest_fn runs through trace; the grid one gives the
    # same film but for knife edges.
    g = renderer(seed=3, closest_fn=closest_hit)
    assert g.route == "trace"
    g.step(4)
    assert torch.equal(g.film.misses, b.film.misses)
    np.testing.assert_allclose(g.film.color_sum.numpy(),
                               b.film.color_sum.numpy(), rtol=5e-2,
                               atol=5e-2)

    # The BVH route takes the same scene: same misses, same film but for
    # knife edges.
    v = renderer(seed=3, accelerator="bvh")
    assert v.route == "bvh" and v.bvh is not None
    v.step(4)
    assert torch.equal(v.film.misses, b.film.misses)
    np.testing.assert_allclose(v.film.color_sum.numpy(),
                               b.film.color_sum.numpy(), rtol=5e-2,
                               atol=5e-2)
    assert renderer(accelerator="brute").route == "trace"


def test_renderer_renders_debug_geom():
    host = tloader.parse(
        "size 8 8\ncamera 0 0 5  0 0 0  0 1 0  40\ndebug geom\n"
        "diffuse .2 .5 .7\nsphere 0 0 0 1\n")
    r = Renderer(host, device="cpu")
    assert r.route == "trace"
    r.step(2)
    hit = r.film.samples > 0
    assert bool(hit.any()) and bool((r.film.misses > 0).any())
    np.testing.assert_allclose(
        (r.film.color_sum[hit] / r.film.samples[hit][:, None]).numpy(),
        np.broadcast_to(np.float32([0.2, 0.5, 0.7]), (int(hit.sum()), 3)),
        rtol=1e-6)


def test_cli_on_a_mid_size_scene(tmp_path):
    scene = tmp_path / "mesh.txt"
    scene.write_text(MID_SIZE_SCENE)
    out = tmp_path / "mesh.png"
    base = [sys.executable, "-m", "raytracercore_tpu_torch.tools.cli"]
    common = [str(scene), "--device", "cpu"]
    subprocess.run(base + ["render", *common, "--spp", "2", "--accelerator",
                           "brute", "-o", str(out)],
                   check=True, cwd=REPO_ROOT, capture_output=True,
                   timeout=300)
    assert read_png(str(out)).shape == (8, 8, 4)
    res = subprocess.run(base + ["bench", *common, "--spp", "1"],
                         check=True, cwd=REPO_ROOT, capture_output=True,
                         text=True, timeout=300)
    assert '"route": "trace"' in res.stdout
    res = subprocess.run(base + ["bench", *common, "--spp", "1",
                                 "--accelerator", "bvh"],
                         check=True, cwd=REPO_ROOT, capture_output=True,
                         text=True, timeout=300)
    assert '"route": "bvh"' in res.stdout
    out_bvh = tmp_path / "mesh_bvh.png"
    subprocess.run(base + ["render", *common, "--spp", "2", "--accelerator",
                           "bvh", "-o", str(out_bvh)],
                   check=True, cwd=REPO_ROOT, capture_output=True,
                   timeout=300)
    assert read_png(str(out_bvh)).shape == (8, 8, 4)

    target = tmp_path / "target.png"
    target.write_bytes(out.read_bytes())
    params = tmp_path / "materials.npz"
    res = subprocess.run(
        base + ["optimize", *common, "--steps", "2", "--target", str(target),
                "-o", str(params)], check=True, cwd=REPO_ROOT,
        capture_output=True, text=True, timeout=300)
    with np.load(params) as data:
        assert data["diffuse"].shape == (67, 3)
        assert np.isfinite(data["diffuse"]).all()


@pytest.mark.cuda
def test_renderer_on_card_launches_the_select_kernel_per_bounce(  # noqa: F811
        cuda_device):
    arrays, cams = _lit_mesh(32, 3)
    r = Renderer(arrays, device="cuda", cameras=cams)
    before = closest_hit_fused.launches
    r.step(2)
    assert closest_hit_fused.launches == before + 2 * 4
    assert bool(torch.isfinite(r.film.color_sum).all())
