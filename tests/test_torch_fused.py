"""The port's megakernel plain version (``trace_fused_reference``) vs the
JAX integrator ``trace`` (dense XLA closest hit, as the JAX package's own
CPU tests run it), at the same camera rays and ``prepare_uniforms``
channels.

Tolerances are those of tests/test_fused.py: the two follow the same
stochastic paths, and the only allowed differences are knife-edge f32
branch flips (the JAX ``trace`` also renormalizes camera rays at bounce 0,
which the megakernel does not), so miss flags are equal, at least 0.97 of
rays agree to 1e-3 + 1e-3·|ref| and channel means to 5e-3.

The CUDA kernel itself has no CPU mode: its cases need a CUDA device and
skip without one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracercore_tpu.render import camera as jcam
from raytracercore_tpu.render.integrator import PathTape as JTape
from raytracercore_tpu.render.integrator import prepare_uniforms as jprep
from raytracercore_tpu.render.integrator import trace as jtrace
from raytracercore_tpu.scene import types as jtypes
from raytracercore_tpu_torch.render import fused
from raytracercore_tpu_torch.render.integrator import PathTape
from raytracercore_tpu_torch.scene import types as ttypes
from test_torch_scene import host_scenes

CLOSE_FRAC = 0.97


def _t(a):
    return torch.tensor(np.asarray(a))


def traced_pair(name, size, recursion, seed, ambient_miss=False):
    """JAX ``trace`` and the port's plain megakernel on the same rays and
    uniforms; returns (jax (color, miss, tape), port (color, miss, tape))
    as numpy/torch, plus the port inputs."""
    jhost, thost = host_scenes(name)
    for host in (jhost, thost):
        host.width = host.height = size
        host.recursion = recursion
        if ambient_miss:
            host.ambient_rgb = None
    ja = jtypes.freeze_scene(jhost)
    jc = jtypes.init_camera(jhost.cameras[0], size, size)
    px, py = jcam.pixel_grid(size, size)
    k_cam, k_path = jax.random.split(jax.random.PRNGKey(seed))
    ray_o, ray_d = jcam.camera_rays(jc, px, py, k_cam)
    uniforms = jprep(k_path, ray_o.shape[0], recursion + 1, jnp.float32)
    ref = jtrace(ja, ray_o, ray_d, None, uniforms=uniforms, want_tape=True)

    ta = ttypes.freeze_scene(thost)
    inputs = (ta, _t(ray_o), _t(ray_d), _t(uniforms))
    got = fused.trace_fused_reference(*inputs, want_tape=True)
    return ref, got, inputs


def _as_port(ref):
    """JAX (color, miss, PathTape) → the port's tensors."""
    color, miss, tape = ref
    return (_t(color), _t(miss), PathTape(
        prim=_t(tape.prim), flags=_t(tape.flags), nx=_t(tape.nx),
        ny=_t(tape.ny), nz=_t(tape.nz)))


def assert_matches(ref, got, min_lit=0.5):
    ref_c, got_c = np.asarray(ref[0]), got[0].numpy()
    assert ref_c.max() > min_lit  # the scene lights up: no vacuous agreement
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    close = np.all(np.abs(ref_c - got_c) <= 1e-3 + 1e-3 * np.abs(ref_c),
                   axis=1)
    assert close.mean() >= CLOSE_FRAC, f"only {close.mean():.3f} close"
    np.testing.assert_allclose(got_c.mean(0), ref_c.mean(0), rtol=5e-3,
                               atol=5e-3)
    # Every mismatch is a branch flip or a graze, never the same path with
    # a different colour.
    cls = fused.classify_mismatches(_as_port(ref), got)
    assert not cls["samepick"].any()


@pytest.mark.parametrize("name,size,recursion", [
    ("fused", 32, 4), ("fused", 32, 10), ("cornell", 24, 10),
    ("smooth", 32, 6)])
def test_reference_matches_jax_trace(name, size, recursion):
    ref, got, _ = traced_pair(name, size, recursion, seed=7)
    assert_matches(ref, got)


def test_reference_matches_jax_trace_ambient_miss():
    # `ambient miss`: secondary misses count as miss samples.
    ref, got, _ = traced_pair("fused", 32, 4, seed=11, ambient_miss=True)
    assert np.asarray(ref[1]).any()
    assert_matches(ref, got)


@pytest.mark.parametrize("recursion", [4, 10])
def test_reference_tape_matches_jax_tape(recursion):
    """Codes agree near-universally; prim wherever the path is live and the
    full flag word wherever a replay reads it (bounced codes)."""
    ref, got, _ = traced_pair("fused", 32, recursion, seed=3)
    code_ref = np.asarray(ref[2].flags & JTape.CODE_MASK)
    code_got = got[2].flags.numpy() & PathTape.CODE_MASK
    agree = code_ref == code_got
    assert agree.mean() >= 0.99, f"only {agree.mean():.3f} of codes match"
    nonskip = agree & (code_ref != 0)
    assert nonskip.any()
    np.testing.assert_array_equal(got[2].prim.numpy()[nonskip],
                                  np.asarray(ref[2].prim)[nonskip])
    bounced = agree & np.isin(code_ref, (1, 2, 4))
    assert bounced.any()
    np.testing.assert_array_equal(got[2].flags.numpy()[bounced],
                                  np.asarray(ref[2].flags)[bounced])
    # Normals where they are defined (bounced codes).  JAX ``trace`` takes
    # them from its winner re-evaluation, a different formula than the
    # kernel body's pass, so they agree to f32 rounding, not bit for bit.
    for k in ("nx", "ny", "nz"):
        np.testing.assert_allclose(getattr(got[2], k).numpy()[bounced],
                                   np.asarray(getattr(ref[2], k))[bounced],
                                   rtol=0, atol=1e-4)
    # The megakernel's dead-lane rule: bounces a path never reached hold
    # prim -1, flags 0 and zero normals.
    unreached = code_got == 0
    assert unreached.any()
    assert (got[2].prim.numpy()[unreached] == -1).all()
    assert (got[2].flags.numpy()[unreached] == 0).all()
    assert (got[2].nx.numpy()[unreached] == 0).all()


def test_trace_fused_on_cpu_runs_the_reference():
    _, got, inputs = traced_pair("fused", 32, 4, seed=7)
    before = fused.trace_fused.launches
    color, miss = fused.trace_fused(*inputs)
    assert fused.trace_fused.launches == before  # no kernel on the CPU
    assert torch.equal(color, got[0]) and torch.equal(miss, got[1])


def test_classify_mismatches_counts_flips():
    _, got, _ = traced_pair("fused", 32, 4, seed=7)
    same = fused.classify_mismatches(got, got)
    assert same["close"].all() and not same["flip"].any()
    # Change one ray's first-bounce pick: a flip, not a samepick.
    color, miss, tape = got
    flags = tape.flags.clone()
    r = int(torch.nonzero((flags[0] & PathTape.CODE_MASK) == 1)[0])
    flags[0, r] = (flags[0, r] & ~PathTape.CODE_MASK) | 2
    color2 = color.clone()
    color2[r] += 1.0
    cls = fused.classify_mismatches(
        got, (color2, miss, PathTape(tape.prim, flags, tape.nx, tape.ny,
                                     tape.nz)))
    assert cls["flip"][r] and cls["flip"].sum() == 1
    assert not cls["samepick"].any()
    # Same path, different colour: a samepick.
    cls = fused.classify_mismatches(got, (color2, miss, tape))
    assert cls["samepick"][r] and cls["samepick"].sum() == 1


def test_fits_routes_like_jax():
    from raytracercore_tpu.render.fused import fits as jfits
    for name in ("fused", "cornell", "stress"):
        jhost, thost = host_scenes(name)
        assert fused.fits(ttypes.freeze_scene(thost)) == jfits(
            jtypes.freeze_scene(jhost)) is True
        jhost.debug_geom = thost.debug_geom = True
        assert fused.fits(ttypes.freeze_scene(thost)) == jfits(
            jtypes.freeze_scene(jhost)) is False


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the megakernel is CUDA C++ for "
                    "sm_90a and has no CPU mode (chip_smoke.py runs these "
                    "checks on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,recursion,want_tape", [
    ("fused", 4, True), ("fused", 10, False), ("cornell", 10, True),
    ("smooth", 6, True)])
def test_kernel_matches_reference_on_card(cuda_device, name, recursion,
                                          want_tape):
    _, _, inputs = traced_pair(name, 64, recursion, seed=5)
    scene, ray_o, ray_d, uniforms = (x.to(cuda_device) for x in inputs)
    ref = fused.trace_fused_reference(scene, ray_o, ray_d, uniforms,
                                      want_tape=True)
    before = fused.trace_fused.launches
    got = fused.trace_fused(scene, ray_o, ray_d, uniforms,
                            want_tape=want_tape)
    torch.cuda.synchronize()
    assert fused.trace_fused.launches == before + 1
    if not want_tape:
        got = (got[0], got[1], ref[2])
    cls = fused.classify_mismatches(ref, got)
    assert np.all(cls["miss_eq"] | cls["flip"])
    assert cls["close"].mean() >= CLOSE_FRAC
    assert not cls["samepick"].any()


def test_kernel_wrapper_rejects_bad_inputs():
    """The wrapper's checks run before anything reaches the GPU, so they
    are exercised here on CPU tensors through the launch path itself."""
    _, _, (scene, ray_o, ray_d, uniforms) = traced_pair("fused", 32, 4, 7)
    bad = [
        (ray_o.double(), ray_d, uniforms),             # dtype
        (ray_o, ray_d[:-1], uniforms),                 # shape
        (ray_o, ray_d, uniforms[:-1]),                 # bounces
        (ray_o.t().contiguous().t(), ray_d, uniforms),  # layout
    ]
    for args in bad:
        with pytest.raises(ValueError):
            fused._launch(scene, *args, want_tape=False)
    debug_scene = dataclasses.replace(scene, debug_geom=True)
    with pytest.raises(ValueError, match="megakernel cannot trace"):
        fused._launch(debug_scene, ray_o, ray_d, uniforms, want_tape=False)
