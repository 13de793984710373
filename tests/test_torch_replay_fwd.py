"""What the replay forward kernel's design rests on, on the CPU.

* The forward kernel stops a path at its end (``csrc/replay.cu``
  ``fwd_path``): after the first code that does not bounce (Emission,
  SpecularFail, PureBlack, RecursionComplete, Missed) it reads nothing more
  of the path.  That equals the plain replay, which walks every bounce,
  only because every recorder writes Diffuse, Specular or Transmitted on
  each bounce before that code and Skipped on each bounce after it.  The
  tests hold the megakernel's plain recorder, the port's ``trace`` and the
  JAX ``trace`` to that, on Cornell and on mesh-82 from ``meshgen``, with
  rays and uniforms made from numpy seeds; and the JAX ``replay`` (and the
  port's plain replay) to ignoring whatever else lies past a path's end.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracercore_tpu.render.integrator import PathTape as JTape
from raytracercore_tpu.render.integrator import trace as jtrace
from raytracercore_tpu.render.replay import replay as jreplay
from raytracercore_tpu_torch.render import fused
from raytracercore_tpu_torch.render.camera import camera_rays, pixel_grid
from raytracercore_tpu_torch.render.integrator import (BounceType,
                                                       PathTape,
                                                       preprocess_uniforms,
                                                       trace)
from raytracercore_tpu_torch.render.replay import replay
from raytracercore_tpu_torch.scene import types as ttypes
from test_torch_dispatch import scene_pair
from test_torch_scene import host_scenes
from test_torch_trace import _close_camera

BOUNCE_CODES = (BounceType.DIFFUSE, BounceType.SPECULAR,
                BounceType.TRANSMITTED)
END_CODES = (BounceType.SPECULAR_FAIL, BounceType.EMISSION,
             BounceType.PURE_BLACK, BounceType.RECURSION_COMPLETE,
             BounceType.MISSED)
SIZE = 24


def inputs(name, recursion, seed):
    """Both packages' scene and the same camera rays and uniforms, made
    from numpy draws: ``(jax scene, port scene, o, d, u)`` (torch)."""
    ja, ta = scene_pair(name, width=SIZE, height=SIZE, recursion=recursion)
    host_cam = (_close_camera(ttypes) if name == "mesh-82"
                else host_scenes(name)[1].cameras[0])
    cam = ttypes.init_camera(host_cam, SIZE, SIZE, device="cpu")
    px, py = pixel_grid(SIZE, SIZE, device="cpu")
    rng = np.random.default_rng(seed)
    jitter = torch.tensor(rng.random((SIZE * SIZE, 4), dtype=np.float32))
    o, d = camera_rays(cam, px, py, jitter)
    raw = rng.random((recursion + 1, 5, SIZE * SIZE), dtype=np.float32)
    return ja, ta, o, d, preprocess_uniforms(torch.tensor(raw))


def record(recorder, ja, ta, o, d, u):
    """The tape's codes ``[B, R]`` (numpy) as ``recorder`` writes them."""
    if recorder == "megakernel plain":
        tape = fused.trace_fused_reference(ta, o, d, u, want_tape=True)[2]
    elif recorder == "trace":
        tape = trace(ta, o, d, None, uniforms=u, want_tape=True)[2]
    else:
        tape = jtrace(ja, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                      None, uniforms=jnp.asarray(u.numpy()),
                      want_tape=True)[2]
        return np.asarray(tape.flags) & PathTape.CODE_MASK
    return (tape.flags & PathTape.CODE_MASK).numpy()


def path_ends(codes):
    """Each path's end: the bounce of its first code that does not
    bounce."""
    return np.argmax(~np.isin(codes, BOUNCE_CODES), axis=0)


@pytest.mark.parametrize("name", ["cornell", "mesh-82"])
@pytest.mark.parametrize("recorder", ["megakernel plain", "trace",
                                      "JAX trace"])
def test_every_path_ends_once_then_skips(recorder, name):
    """Each path's codes are Diffuse, Specular or Transmitted up to one
    end code, then Skipped to the last bounce: the forward kernel may stop
    a path after its end code and read no code past it."""
    recursion = 6
    codes = record(recorder, *inputs(name, recursion, seed=11))
    B, R = codes.shape
    assert B == recursion + 1
    end = path_ends(codes)
    at = np.arange(B)[:, None]
    assert np.isin(codes[at < end], BOUNCE_CODES).all()
    assert np.isin(codes[end, np.arange(R)], END_CODES).all()
    assert (codes[at > end] == BounceType.SKIPPED).all()
    # Not vacuous: paths end on different bounces, some at the last.
    assert len(np.unique(end)) >= 3 and (end == B - 1).any()


@pytest.mark.parametrize("name", ["cornell", "mesh-82"])
def test_what_lies_past_a_path_end_changes_no_replay(name):
    """Past each path's end, the tape's prim, normals and flag bits (all
    but the code, Skipped) replaced by random values: the JAX ``replay``
    gives the same colour and miss bit for bit, and the port's plain
    replay agrees with it as on the recorded tape.  So a forward that reads
    nothing past a path's end computes the replay."""
    ja, ta, o, d, u = inputs(name, 6, seed=5)
    tape = trace(ta, o, d, None, uniforms=u, want_tape=True)[2]
    codes = (tape.flags & PathTape.CODE_MASK).numpy()
    past = np.arange(codes.shape[0])[:, None] > path_ends(codes)
    assert past.mean() > 0.2
    rng = np.random.default_rng(9)
    n_rows = int(ta.materials.emission.shape[0])

    def scrambled(x, fill):
        return torch.where(torch.tensor(past), torch.tensor(fill), x)

    junk = PathTape(
        prim=scrambled(tape.prim, rng.integers(
            -1, n_rows, past.shape).astype(np.int32)),
        flags=scrambled(tape.flags, (rng.integers(0, 4, past.shape)
                                     << 4).astype(np.int32)),
        nx=scrambled(tape.nx, rng.normal(size=past.shape).astype(
            np.float32)),
        ny=scrambled(tape.ny, rng.normal(size=past.shape).astype(
            np.float32)),
        nz=scrambled(tape.nz, rng.normal(size=past.shape).astype(
            np.float32)))
    assert not torch.equal(junk.nx, tape.nx)
    jo, jd, ju = (jnp.asarray(t.numpy()) for t in (o, d, u))
    want, got = (jreplay(ja, jo, jd, ju, JTape(*(
        jnp.asarray(getattr(t, f).numpy())
        for f in ("prim", "flags", "nx", "ny", "nz"))))
        for t in (tape, junk))
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    assert float(np.asarray(want[0]).max()) > 0.1
    for t in (tape, junk):
        c, m = replay(ta, o, d, u, t)
        np.testing.assert_array_equal(m.numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(c.numpy(), np.asarray(want[0]),
                                   rtol=1e-6, atol=1e-6)

