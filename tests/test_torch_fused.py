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

    ta = ttypes.freeze_scene(thost, device="cpu")
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
        assert fused.fits(ttypes.freeze_scene(thost, device="cpu")) == jfits(
            jtypes.freeze_scene(jhost)) is True
        jhost.debug_geom = thost.debug_geom = True
        assert fused.fits(ttypes.freeze_scene(thost, device="cpu")) == jfits(
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


# --- the kernel's inputs -------------------------------------------------

def test_kernel_tables():
    """The megakernel reads ``SceneArrays.fused_tables``: the
    ``pack_tables`` rows, the ``[N, 14]`` material rows and ``(air ior,
    ambient rgb)``, in that order, each dtype and width the C side reads,
    contiguous; a train step's ``with_materials`` repacks only the
    material rows."""
    from raytracercore_tpu_torch.intersect import kernel_body as kb

    for name in ("fused", "cornell", "smooth"):
        _, thost = host_scenes(name)
        ta = ttypes.freeze_scene(thost, device="cpu")
        tables = fused.kernel_tables(ta)
        tf, ti, sf, si, pf, pi, mf, scf = tables
        for got, want in zip(tables[:6], kb.pack_tables(ta)):
            assert torch.equal(got, want)
        assert torch.equal(mf, fused.pack_materials(ta.materials))
        assert torch.equal(scf, torch.cat([
            ta.air_refractive_index.reshape(1), ta.ambient_rgb.reshape(3)]))
        assert [t.dtype for t in tables] == [torch.float32, torch.int32] * 3 \
            + [torch.float32] * 2
        assert all(t.is_contiguous() for t in tables)
        T, S, P, N = tf.shape[0], sf.shape[0], pf.shape[0], mf.shape[0]
        assert [tuple(t.shape) for t in tables] == [
            (T, kb.TRI_F), (T, kb.INT_F), (S, kb.SPH_F), (S, kb.INT_F),
            (P, kb.PL_F), (P, kb.INT_F), (N, 14), (4,)]
        mats = dataclasses.replace(ta.materials,
                                   diffuse=ta.materials.diffuse * 0.5)
        swapped = fused.kernel_tables(ta.with_materials(mats))
        assert all(a is b for a, b in zip(swapped[:6], tables[:6]))
        assert torch.equal(swapped[6], fused.pack_materials(mats))


# --- the division-free pre-reject of the triangle test -------------

def _exact_u(num, det):
    """``triangle_pass``'s u: ``inv * num``, ``inv = 1 / det`` (0 where
    det == 0), in f32."""
    nz = det != 0
    inv = torch.where(nz, 1.0 / torch.where(nz, det, torch.ones_like(det)),
                      torch.zeros_like(det))
    return inv * num


def _ulps(x, k):
    """``x`` moved ``k`` f32 ulps."""
    x = np.float32(x)
    for _ in range(abs(k)):
        x = np.nextafter(x, np.float32(np.inf if k > 0 else -np.inf),
                         dtype=np.float32)
    return x


_EDGE_F32 = [0.0, -0.0, 1e-45, -1e-45, 2.0 ** -149, 2.0 ** -126,
             -(2.0 ** -126), 2.0 ** -100, 1e-30, 1.0, -1.0, 2.0, 1e20,
             3.4e38, -3.4e38, float("inf"), float("-inf"), float("nan")]


def _f32s(**kw):
    """f32 floats; bounds rounded to f32 first."""
    from hypothesis import strategies as st
    return st.floats(width=32, **{k: float(np.float32(v))
                                  for k, v in kw.items()})


def _det_strategy():
    from hypothesis import strategies as st
    return st.one_of(st.sampled_from(_EDGE_F32), _f32s(),
                     _f32s(min_value=-1e-30, max_value=1e-30),
                     _f32s(min_value=-4.0, max_value=4.0))


def _ratio_strategy():
    from hypothesis import strategies as st
    return st.one_of(st.sampled_from([0.0, -0.0, 1.0, -1.0]),
                     _f32s(min_value=-1e-6, max_value=1e-6),
                     _f32s(min_value=1 - 1e-5, max_value=1 + 1e-5),
                     _f32s(min_value=-1e-40, max_value=1e-40), _f32s())


def test_pre_reject_never_rejects_an_accepted_u():
    """``kernel_body.surely_outside`` (the kernel's pre-reject, before the
    division) rejects a (numerator, det) pair only where the exact
    ``u = (1 / det) * num`` of ``triangle_pass`` falls outside [0, 1] (or
    is NaN): u near 0 and near 1 to a few ulps, det near ±0, subnormal,
    huge, infinite, NaN, ±0.0."""
    from hypothesis import given, settings
    from hypothesis import strategies as st

    from raytracercore_tpu_torch.intersect.kernel_body import surely_outside

    @settings(max_examples=600, deadline=None)
    @given(st.lists(st.tuples(_det_strategy(), _ratio_strategy(),
                              st.integers(-3, 3), _f32s()),
                    min_size=1, max_size=32))
    def check(cases):
        dets, nums = [], []
        for det, ratio, k, free in cases:
            with np.errstate(all="ignore"):
                num = np.float32(det) * np.float32(ratio)
            dets += [det, det]
            nums += [_ulps(num, k), free]
        det = torch.tensor(dets, dtype=torch.float32)
        num = torch.tensor(np.asarray(nums, np.float32))
        u = _exact_u(num, det)
        accepted = (u >= 0) & (u <= 1)
        bad = surely_outside(num, det) & accepted
        assert not bad.any(), (num[bad], det[bad], u[bad])

    check()


def test_pre_reject_keeps_every_row_triangle_pass_accepts():
    """On single triangle rows hit near their edges (u, v at 0 or 1 to a
    few ulps, rays from any direction, both triangle-branch settings), no
    row that ``triangle_pass`` accepts is pre-rejected on u."""
    from hypothesis import given, settings
    from hypothesis import strategies as st

    from raytracercore_tpu_torch.intersect import kernel_body as kb

    bary = st.one_of(st.sampled_from([0.0, 1.0, 0.5]),
                     _f32s(min_value=0.0, max_value=1e-6),
                     _f32s(min_value=1 - 1e-6, max_value=1.0),
                     _f32s(min_value=0.0, max_value=1.0))
    coord = _f32s(min_value=-8.0, max_value=8.0)

    @settings(max_examples=300, deadline=None)
    @given(st.lists(coord, min_size=9, max_size=9), bary, bary,
           st.integers(-2, 2), st.lists(coord, min_size=3, max_size=3),
           _f32s(min_value=0.01, max_value=20.0), st.booleans(),
           st.booleans())
    def check(tri, bu, bv, k, dvec, t, mirror, coplanar):
        v0, e1, e2 = (np.asarray(tri[3 * i:3 * i + 3], np.float32)
                      for i in range(3))
        if not mirror:
            bv = min(bv, 1.0 - bu)
        bu = _ulps(bu, k)
        p = v0 + e1 * np.float32(bu) + e2 * np.float32(bv)
        d = np.asarray(dvec, np.float32)
        if not np.any(d):
            return
        o = (p - d * np.float32(t)).astype(np.float32)
        n = np.cross(e1, e2).astype(np.float32)
        tf = torch.tensor(np.concatenate([v0, e1, e2, n, n, n, n])[None])
        ti = torch.tensor([[0, int(mirror), 0, 1]], dtype=torch.int32)
        o3 = tuple(torch.tensor([x]) for x in o)
        d3 = tuple(torch.tensor([x]) for x in d)
        got = {}

        def emit(row, ok, *_):
            got["ok"] = ok
        kb.triangle_pass(tf, ti, o3, d3, 1e-4, None, emit,
                         coplanar=coplanar, any_smooth=False)
        f = [o3[c] - tf[0, c] for c in range(3)]
        e1t, e2t = tf[0, 3:6], tf[0, 6:9]
        sx = d3[1] * e2t[2] - d3[2] * e2t[1]
        sy = d3[2] * e2t[0] - d3[0] * e2t[2]
        sz = d3[0] * e2t[1] - d3[1] * e2t[0]
        det = e1t[0] * sx + e1t[1] * sy + e1t[2] * sz
        num = f[0] * sx + f[1] * sy + f[2] * sz
        assert not (got["ok"] & kb.surely_outside(num, det)).any()

    check()


def test_pre_reject_sweep_near_u_one():
    """A sweep that hypothesis's draws rarely reach: 2^20 dets of random
    mantissa (the quotient's rounding at its worst near the top of a
    binade) and exponent, numerators 0-3 ulps from ±det and from ±tiny:
    no pre-rejected pair is accepted by the exact test."""
    from raytracercore_tpu_torch.intersect.kernel_body import surely_outside

    rng = np.random.default_rng(7)
    n = 1 << 20
    mant = rng.integers(0, 1 << 23, n, dtype=np.int64)
    mant[: n // 4] = (1 << 23) - 1 - mant[: n // 4] % 64   # top of binade
    expo = rng.integers(-140, 130, n)
    det = np.ldexp((1 + mant / 2.0 ** 23), expo).astype(np.float32)
    det *= rng.choice(np.float32([-1, 1]), n)
    det_t = torch.tensor(det)
    for base in (det, np.float32(2.0 ** -149) * np.sign(det)):
        for k in range(-3, 4):
            for sign in (1, -1):
                num = np.float32(sign) * base
                step = np.float32(np.inf if k > 0 else -np.inf)
                for _ in range(abs(k)):
                    num = np.nextafter(num, step, dtype=np.float32)
                num_t = torch.tensor(num)
                u = _exact_u(num_t, det_t)
                bad = surely_outside(num_t, det_t) & (u >= 0) & (u <= 1)
                assert not bad.any(), (num_t[bad][:4], det_t[bad][:4])
