"""The bounce body of the port's ``trace`` (``render/integrator.py:
shade_bounce_reference``, the plain version of ``csrc/shade.cu``) and the
route ``trace`` picks for it (``render/shade_kernel.py``), against the JAX
package's ``trace``.

Both packages get the same scene arrays, camera rays and uniforms (numpy
from a seed).  The scene is the Cornell test scene with its material table
edited so that every branch of the bounce is reached: the glass ellipsoid
(a lens: transmission, total internal reflection inside it), the mirror
sphere with infinite shininess, the diffuse sphere with a refraction
colour but refractive index 0 (Fresnel never evaluated), and the rotated
cube pure black.  Tolerances:

* float32: those of tests/test_torch_trace.py (miss flags equal; at least
  0.97 of rays within 1e-3 + 1e-3·|ref| and channel means within 5e-3;
  tape codes on 0.99 of bounces, prim and flags where they agree; records
  likewise; geometry within 1e-4 on the first bounce and 1e-2 after);
* float64: the two run the same float64 operations on the same dense
  closest hit, so discrete outputs are equal and floats within
  1e-9·(1 + |ref|), as tests/test_torch_surface.py holds the f64 pass;
* gradients through the plain body under autograd: 1e-5·max|g| per field.

The kernel itself runs only on the card: its cases there are bit-equal to
the plain version on every output and every lane (NaN bits included), and
skip here through the ``cuda_device`` fixture.  The routing is tested with
the kernel's launcher mocked.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracercore_tpu.render import camera as jcam
from raytracercore_tpu.render.integrator import prepare_uniforms as jprep
from raytracercore_tpu.render.integrator import trace as jtrace
from raytracercore_tpu.scene import types as jtypes
from raytracercore_tpu_torch import kernels
from raytracercore_tpu_torch.diff import MATERIAL_FIELDS
from raytracercore_tpu_torch.intersect.cuda_select import closest_hit_fused
from raytracercore_tpu_torch.render import integrator
from raytracercore_tpu_torch.render import shade_kernel as sk
from raytracercore_tpu_torch.render.integrator import (BounceType,
                                                       shade_bounce_reference,
                                                       trace)
from raytracercore_tpu_torch.scene import types as ttypes
from test_torch_fused import cuda_device  # noqa: F401
from test_torch_replay import (assert_grads_match, jax_loss_grads,
                               port_loss_grads)
from test_torch_scene import host_scenes
from test_torch_trace import (assert_colours_match, assert_records_match,
                              assert_tapes_match)


def _edited(ja):
    """The Cornell scene's JAX arrays with the material rows edited (see
    the module docstring); returns (arrays, {feature: rows})."""
    m = ja.materials
    refr = np.asarray(m.refraction).sum(1)
    diff = np.asarray(m.diffuse)
    glass = np.nonzero(refr > 0)[0]
    mirror = np.array([m.shininess.shape[0] - 1])
    ior0 = np.nonzero(np.all(np.isclose(diff, [0.25, 0.35, 0.8]), 1))[0]
    black = np.nonzero(np.all(np.isclose(diff, [0.65, 0.6, 0.3]), 1))[0]
    assert len(glass) and len(ior0) and len(black)
    zero3 = jnp.zeros((len(black), 3), m.diffuse.dtype)
    m = m.replace(
        shininess=m.shininess.at[mirror].set(jnp.inf),
        refraction=m.refraction.at[ior0].set(0.5).at[black].set(zero3),
        refractive_index=m.refractive_index.at[ior0].set(0.0),
        emission=m.emission.at[black].set(zero3),
        diffuse=m.diffuse.at[black].set(zero3),
        specular=m.specular.at[black].set(zero3))
    return ja.replace(materials=m), {"glass": glass, "mirror": mirror,
                                     "ior0": ior0, "black": black}


def case(size, recursion, ambient_miss, f64, seed=11):
    """Both packages' edited scene and the same rays and uniforms:
    ``(ja, ta, rows, jax (o, d, u), port (o, d, u))``."""
    jhost, _ = host_scenes("cornell")
    jhost.width = jhost.height = size
    jhost.recursion = recursion
    if ambient_miss:
        jhost.ambient_rgb = None
    jdt = jnp.float64 if f64 else jnp.float32
    with jax.enable_x64() if f64 else contextlib.nullcontext():
        ja, rows = _edited(jtypes.freeze_scene(jhost, dtype=jdt))
        jc = jtypes.init_camera(jhost.cameras[0], size, size, dtype=jdt)
        px, py = jcam.pixel_grid(size, size)
        k_cam, k_path = jax.random.split(jax.random.PRNGKey(seed))
        ray_o, ray_d = jcam.camera_rays(jc, px, py, k_cam)
        uniforms = jprep(k_path, size * size, recursion + 1, jdt)
        arrays = jax.tree_util.tree_map(np.asarray, ja)
    tdt = torch.float64 if f64 else torch.float32
    ta = ttypes.scene_arrays_from_numpy(arrays, device="cpu", dtype=tdt)
    jin = (ray_o, ray_d, uniforms)
    tin = tuple(torch.tensor(np.asarray(a)) for a in jin)
    assert all(t.dtype == tdt for t in tin)
    return ja, ta, rows, jin, tin


def _jax_trace(ja, jin, f64, **kw):
    if not f64:
        return jtrace(ja, jin[0], jin[1], None, uniforms=jin[2], **kw)
    with jax.enable_x64():
        out = jtrace(ja, jin[0], jin[1], None, uniforms=jin[2], **kw)
        return jax.tree_util.tree_map(np.asarray, out)


def _assert_f64_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    if got.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                  err_msg=what)
    ok = ~np.isnan(want)
    assert np.all(np.abs(got[ok] - want[ok])
                  <= 1e-9 * (1 + np.abs(want[ok]))), what


# (recursion, ambient miss, float64): recursion 0 (every hit is the
# recursion cap), 1 and >= 5, ambient miss both ways, f32 and f64.
CASES = [(0, False, False), (1, True, False), (6, False, False),
         (6, True, False), (5, False, True), (1, True, True)]


@pytest.mark.parametrize("recursion,ambient_miss,f64", CASES)
def test_trace_through_the_plain_bounce_matches_jax(recursion, ambient_miss,
                                                    f64):
    size = 20 if f64 else 24
    ja, ta, rows, jin, tin = case(size, recursion, ambient_miss, f64)
    assert ta.ambient_is_miss == ambient_miss
    ref = _jax_trace(ja, jin, f64, record=True, want_tape=True)
    got = trace(ta, *tin[:2], None, uniforms=tin[2], record=True,
                want_tape=True, shade_fn=shade_bounce_reference)
    if f64:
        for k, (g, w) in enumerate(zip(got[:2], ref[:2])):
            _assert_f64_close(g.numpy(), w, f"output {k}")
        for name, jrec, trec in (("records", ref[2], got[2]),
                                 ("tape", ref[3], got[3])):
            for f in dataclasses.fields(trec):
                _assert_f64_close(getattr(trec, f.name).numpy(),
                                  getattr(jrec, f.name), f"{name}.{f.name}")
        assert float(got[0].max()) > 0.5
    else:
        assert_colours_match(ref, got)
        assert_records_match(ref[2], got[2])
        if recursion:
            assert_tapes_match(ref[3], got[3])
        else:  # no bounce goes on: every hit is the recursion cap
            code_ref = np.asarray(ref[3].flags)
            live = code_ref != BounceType.SKIPPED
            np.testing.assert_array_equal(got[3].flags.numpy(), code_ref)
            np.testing.assert_array_equal(got[3].prim.numpy()[live],
                                          np.asarray(ref[3].prim)[live])
    # The plain call through the default route (the wrapper runs the plain
    # version on the CPU) is the same, bit for bit.
    plain = trace(ta, *tin[:2], None, uniforms=tin[2], record=True,
                  want_tape=True)
    assert torch.equal(plain[0], got[0]) and torch.equal(plain[1], got[1])
    assert torch.equal(plain[3].flags, got[3].flags)
    # The edited rows are reached: the cap, the lens with its total internal
    # reflection, infinite shininess, IOR 0 and pure black.
    code = got[3].flags & 0xF
    prim, fr = got[2].prim, got[2].fresnel
    if recursion == 0:
        assert bool((code == BounceType.RECURSION_COMPLETE).any())
        return
    assert bool((code == BounceType.PURE_BLACK).any())
    mirror_hit = torch.isin(prim, torch.as_tensor(rows["mirror"]))
    assert bool(mirror_hit.any())
    assert bool(torch.isnan(fr[torch.isin(prim, torch.as_tensor(
        rows["ior0"]))]).all())
    assert bool(torch.isin(prim, torch.as_tensor(rows["ior0"])).any())
    if recursion >= 5:
        assert bool((code == BounceType.TRANSMITTED).any())
        assert bool((fr == 1.0).any())  # total internal reflection


def test_gradients_through_the_plain_bounce_match_jax_grad():
    """A gradient makes ``trace`` take the plain body under autograd on
    every bounce; its material gradients match ``jax.grad``."""
    ja, ta, _, jin, tin = case(12, 4, False, False)
    want_c, want_m, want_g = jax_loss_grads(
        jtrace, ja, (jin[0], jin[1], None), uniforms=jin[2])
    got_c, got_m, got_g = port_loss_grads(
        trace, ta, (tin[0], tin[1], None), uniforms=tin[2])
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-5,
                               atol=1e-6)
    assert_grads_match(got_g, want_g, MATERIAL_FIELDS)


def _spies(monkeypatch):
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kw):
            calls.append(name)
            return fn(*args, **kw)
        return wrapped
    monkeypatch.setattr(sk, "shade_bounce",
                        spy("kernel route", sk.shade_bounce))
    monkeypatch.setattr(integrator, "shade_bounce_reference",
                        spy("plain", integrator.shade_bounce_reference))
    return calls


def test_trace_picks_the_bounce_body_by_need(monkeypatch):
    """No gradient needed: ``shade_kernel.shade_bounce`` (the kernel on a
    CUDA device) on every bounce; a material, ray, ambient or air IOR
    tensor that requires grad while autograd records: the plain body on
    every bounce; an explicit ``shade_fn`` wins."""
    from raytracercore_tpu_torch.diff import (get_material_params,
                                              with_material_params)

    _, ta, _, _, tin = case(8, 3, False, False)
    calls = _spies(monkeypatch)
    bounces = ta.recursion + 1

    def run(scene, o, d, **kw):
        calls.clear()
        trace(scene, o, d, None, uniforms=tin[2], **kw)
        return list(calls)

    assert run(ta, *tin[:2]) == ["kernel route"] * bounces
    params = get_material_params(ta)
    s = with_material_params(ta, params)
    assert run(s, *tin[:2]) == ["plain"] * bounces
    with torch.no_grad():
        assert run(s, *tin[:2]) == ["kernel route"] * bounces
    d = tin[1].clone().requires_grad_(True)
    assert run(ta, tin[0], d) == ["plain"] * bounces
    for field in ("ambient_rgb", "air_refractive_index"):
        g = dataclasses.replace(ta, **{field: getattr(ta, field).clone()
                                       .requires_grad_(True)})
        assert run(g, *tin[:2]) == ["plain"] * bounces, field
    own = []
    assert run(ta, *tin[:2], shade_fn=lambda *a: own.append(1)
               or shade_bounce_reference(*a)) == []
    assert len(own) == bounces


def _bounce_inputs(scene, o, d, u):
    """The inputs of every bounce of a no-grad ``trace``: ``[(hit, state,
    d, u_i, i)]``, captured by a ``shade_fn`` that runs the plain body."""
    seen = []

    def spy(hit, state, d, u, matf, ambient, air, i, *rest):
        seen.append((hit, state, d, u, i))
        return shade_bounce_reference(hit, state, d, u, matf, ambient, air,
                                      i, *rest)
    with torch.no_grad():
        trace(scene, o, d, None, closest_fn=closest_hit_fused, uniforms=u,
              shade_fn=spy)
    return seen


class _FakeLib:
    """Stands in for the kernel library: records each ``rtc_shade`` call's
    arguments and returns ``err``."""

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def rtc_shade(self, *args):
        self.calls.append(args)
        return self.err


def test_launcher_passes_the_tensors_and_counts(monkeypatch):
    """``_launch`` (mocked library and stream, CPU tensors): 42 pointers
    in the C order — tape and record pointers null where off —, the
    sizes, the bounce and the dtype flag; fresh output tensors; one count
    a launch; a failing launch raises and is not counted; an input that
    requires grad, or a wrong dtype, is refused before the launch."""
    _, ta, _, _, tin = case(8, 3, False, False)
    hit, state, d, u, i = _bounce_inputs(ta, *tin)[1]
    matf = integrator._material_matrix(ta.materials)
    ambient, air = ta.ambient_rgb, ta.air_refractive_index
    lib = _FakeLib()
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(sk, "_stream", lambda device: 1234)
    before = sk.shade_bounce.launches
    out = sk._launch(hit, state, d, u, matf, ambient, air, i, 3, False,
                     None, None)
    assert sk.shade_bounce.launches == before + 1
    (args,) = lib.calls
    assert len(args) == 42 + 7 + 1
    assert args[:2] == (hit.prim.data_ptr(), hit.t.data_ptr())
    assert args[5] == d.data_ptr() and args[15] == u.data_ptr()
    assert args[19] == out.ray_o.data_ptr()
    assert args[30:42] == (None,) * 12
    R = d.shape[0]
    assert args[42:] == (R, matf.shape[0], i, 4, 3, 0, 0, 1234)
    assert out.ray_o.data_ptr() not in (state.ray_o.data_ptr(),
                                        d.data_ptr())
    tape = integrator.PathTape.create(R, 4, torch.float32, "cpu")
    records = integrator.BounceRecords.create(R, 4, torch.float32, "cpu")
    lib.calls.clear()
    sk._launch(hit, state, d, u, matf, ambient, air, i, 3, True, tape,
               records)
    (args,) = lib.calls
    assert args[30] == tape.prim.data_ptr()
    assert args[35] == records.btype.data_ptr()
    assert args[47] == 1  # ambient_is_miss
    lib.err = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        sk._launch(hit, state, d, u, matf, ambient, air, i, 3, False, None,
                   None)
    assert sk.shade_bounce.launches == before + 2
    with pytest.raises(ValueError, match="requires grad"):
        sk._launch(hit, state, d, u, matf.clone().requires_grad_(True),
                   ambient, air, i, 3, False, None, None)
    with pytest.raises(ValueError, match="dtype"):
        sk._launch(hit, state, d, u, matf.double(), ambient, air, i, 3,
                   False, None, None)
    assert sk.shade_bounce.launches == before + 2


def test_wrapper_on_cpu_tensors_runs_the_plain_version(monkeypatch):
    """``shade_bounce`` on CPU tensors never reaches the launcher and
    returns the plain version's state; it writes only row / column ``i``
    of the tape and records and none of its inputs."""
    _, ta, _, _, tin = case(10, 4, True, False)
    launched = []
    monkeypatch.setattr(sk, "_launch", lambda *a: launched.append(a))
    matf = integrator._material_matrix(ta.materials)
    for hit, state, d, u, i in _bounce_inputs(ta, *tin):
        R = d.shape[0]
        before = [t.clone() for t in (state.ray_o, d, state.tint)]
        tapes, recs = [], []
        outs = []
        for fn in (sk.shade_bounce, shade_bounce_reference):
            tapes.append(integrator.PathTape.create(R, 5, torch.float32,
                                                    "cpu"))
            recs.append(integrator.BounceRecords.create(R, 5, torch.float32,
                                                        "cpu"))
            outs.append(fn(hit, state, d, u, matf, ta.ambient_rgb,
                           ta.air_refractive_index, i, 4, True, tapes[-1],
                           recs[-1]))
        for a, b in zip(_flat(outs[0]) + _flat(tapes[0]) + _flat(recs[0]),
                        _flat(outs[1]) + _flat(tapes[1]) + _flat(recs[1])):
            assert bits_equal(a, b)
        others = [k for k in range(5) if k != i]
        assert bool((tapes[0].prim[others] == -1).all())
        assert bool(torch.isnan(recs[0].fresnel[:, others]).all())
        for t, b in zip((state.ray_o, d, state.tint), before):
            assert torch.equal(t, b)
    assert not launched


def _flat(x):
    """The tensors of a PathState / PathTape / BounceRecords, in order."""
    out = []
    for f in dataclasses.fields(x):
        v = getattr(x, f.name)
        out += _flat(v) if dataclasses.is_dataclass(v) else [v]
    return out


def bits_equal(a, b):
    """Equal shapes, dtypes and bits (NaN payloads and signed zeros
    included)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        view = torch.int64 if a.element_size() == 8 else torch.int32
        return torch.equal(a.contiguous().view(view),
                           b.contiguous().view(view))
    return torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("f64", [False, True])
def test_kernel_matches_plain_on_card(cuda_device, f64):  # noqa: F811
    """Every bounce of a Cornell trace (the select kernel's hits): the
    kernel bit-equal to the plain version on the state, the tape and the
    records, with and without them."""
    _, ta, _, _, tin = case(64, 6, False, f64)
    ta = ta.to(cuda_device)
    tin = tuple(t.to(cuda_device) for t in tin)
    dt = tin[0].dtype
    matf = integrator._material_matrix(ta.materials)
    amb, air = ta.ambient_rgb, ta.air_refractive_index
    for hit, state, d, u, i in _bounce_inputs(ta, *tin):
        R = d.shape[0]
        for extras in (False, True):
            res = []
            for fn in (sk.shade_bounce, shade_bounce_reference):
                tape = integrator.PathTape.create(R, 7, dt, cuda_device)
                rec = integrator.BounceRecords.create(R, 7, dt, cuda_device)
                out = fn(hit, state, d, u, matf, amb, air, i, 6, False,
                         tape if extras else None, rec if extras else None)
                res.append(_flat(out) + _flat(tape) + _flat(rec))
            for a, b in zip(*res):
                assert bits_equal(a, b), (i, extras)


@pytest.mark.cuda
def test_trace_launches_the_kernel_once_a_bounce_on_card(
        cuda_device):  # noqa: F811
    _, ta, _, _, tin = case(32, 4, False, False)
    ta = ta.to(cuda_device)
    tin = tuple(t.to(cuda_device) for t in tin)
    before = sk.shade_bounce.launches
    with torch.no_grad():
        got = trace(ta, *tin[:2], None, closest_fn=closest_hit_fused,
                    uniforms=tin[2], want_tape=True)
    assert sk.shade_bounce.launches == before + 5
    want = trace(ta, *tin[:2], None, closest_fn=closest_hit_fused,
                 uniforms=tin[2], want_tape=True,
                 shade_fn=shade_bounce_reference)
    for a, b in zip((got[0], got[1], *_flat(got[2])),
                    (want[0], want[1], *_flat(want[2]))):
        assert bits_equal(a, b)
