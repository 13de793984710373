"""Port camera rays, film, tonemap and uniform channels vs the JAX package,
at the same random numbers (drawn with ``jax.random`` and handed to both
packages)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracercore_tpu.core import color as jcolor
from raytracercore_tpu.render import camera as jcam
from raytracercore_tpu.render.film import Film as JFilm
from raytracercore_tpu.render.integrator import prepare_uniforms as jprep
from raytracercore_tpu.scene import types as jtypes
from raytracercore_tpu_torch.core import color as tcolor
from raytracercore_tpu_torch.render import camera as tcam
from raytracercore_tpu_torch.render.film import Film as TFilm
from raytracercore_tpu_torch.render.integrator import (prepare_uniforms,
                                                       preprocess_uniforms)
from raytracercore_tpu_torch.scene import types as ttypes
from test_torch_scene import host_scenes


def _t(a):
    return torch.tensor(np.asarray(a))


# (scene, camera index): a pinhole camera, a thin-lens (DoF) camera and an
# orthographic camera.
CAMERAS = [("fused", 0), ("dof", 0), ("dof", 1), ("cornell", 1)]


@pytest.mark.parametrize("name,index", CAMERAS)
def test_camera_rays_match_jax(name, index):
    jhost, thost = host_scenes(name)
    w, h = jhost.width, jhost.height
    jc = jtypes.init_camera(jhost.cameras[index], w, h)
    tc = ttypes.init_camera(thost.cameras[index], w, h, device="cpu")
    if name == "dof":
        assert float(tc.dof_amount) != 0

    jpx, jpy = jcam.pixel_grid(w, h)
    tpx, tpy = tcam.pixel_grid(w, h, device="cpu")
    np.testing.assert_array_equal(tpx.numpy(), np.asarray(jpx))
    np.testing.assert_array_equal(tpy.numpy(), np.asarray(jpy))

    key = jax.random.PRNGKey(5)
    # camera_rays draws exactly this [R, 4] block from its key.
    u = jax.random.uniform(key, (w * h, 4), dtype=jnp.float32)
    jo, jd = jcam.camera_rays(jc, jpx, jpy, key)
    to, td = tcam.camera_rays(tc, tpx, tpy, _t(u))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)

    jo, jd = jcam.center_rays(jc, jpx, jpy)
    to, td = tcam.center_rays(tc, tpx, tpy)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)


def test_jittered_rays_draw_from_generator():
    _, thost = host_scenes("dof")
    tc = ttypes.init_camera(thost.cameras[0], thost.width, thost.height,
                            device="cpu")
    px, py = tcam.pixel_grid(thost.width, thost.height, device="cpu")
    g = torch.Generator().manual_seed(3)
    o, d = tcam.jittered_rays(tc, px, py, g)
    u = torch.rand((px.shape[0], 4), generator=torch.Generator().manual_seed(3))
    o2, d2 = tcam.camera_rays(tc, px, py, u)
    assert torch.equal(o, o2) and torch.equal(d, d2)


def _frames(h, w, n, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        color = rng.uniform(0, 3, (h * w, 3)).astype(np.float32)
        color[rng.random(h * w) < 0.05] *= 1e4  # fireflies: large sums
        miss = rng.random(h * w) < 0.2
        yield color, miss


@pytest.mark.parametrize("compensated", [False, True])
def test_add_full_frame_matches_jax(compensated):
    h, w = 6, 5
    jf = JFilm.create(h, w, compensated=compensated)
    tf = TFilm.create(h, w, compensated=compensated, device="cpu")
    for color, miss in _frames(h, w, 4, 1):
        jf = jf.add_full_frame(jnp.asarray(color), jnp.asarray(miss))
        tf = tf.add_full_frame(_t(color), _t(miss))
    for field in ("color_sum", "samples", "misses", "color_c",
                  "corrected_sum"):
        got, want = getattr(tf, field), getattr(jf, field)
        if want is None:
            assert got is None
            continue
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tonemap_and_to_uint8_match_jax():
    h, w = 6, 5
    jf = JFilm.create(h, w)
    tf = TFilm.create(h, w, device="cpu")
    for color, miss in _frames(h, w, 3, 2):
        color = np.minimum(color, 2.0)
        miss[0] = True  # a pixel with misses only shows the background
        jf = jf.add_full_frame(jnp.asarray(color), jnp.asarray(miss))
        tf = tf.add_full_frame(_t(color), _t(miss))
    assert float(tf.samples[0, 0]) == 0
    bg, alpha = np.array([0.2, 0.3, 0.4], np.float32), np.float32(0.7)
    j_rgb, j_a = jf.to_image(jnp.asarray(bg), jnp.asarray(alpha), 1.5)
    t_rgb, t_a = tf.to_image(_t(bg), _t(alpha), 1.5)
    np.testing.assert_allclose(t_rgb.numpy(), np.asarray(j_rgb), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(t_a.numpy(), np.asarray(j_a), rtol=0,
                               atol=1e-6)
    # to_uint8 truncates; feed both the same floats.
    np.testing.assert_array_equal(
        tcolor.to_uint8(_t(j_rgb), _t(j_a)).numpy(),
        np.asarray(jcolor.to_uint8(j_rgb, j_a)))
    np.testing.assert_array_equal(
        tf.to_uint8(_t(bg), _t(alpha)).numpy()[..., 3],
        np.asarray(jf.to_uint8(jnp.asarray(bg), jnp.asarray(alpha)))[..., 3])


@pytest.mark.parametrize("bounces", [1, 5])
def test_preprocess_uniforms_matches_jax(bounces):
    n = 2048
    key = jax.random.PRNGKey(11)
    # The raw per-bounce draws prepare_uniforms makes: uniform(fold_in(key,
    # i), (n, 5)) for bounce i.
    raw = np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(key, i), (n, 5), dtype=jnp.float32)).T
        for i in range(bounces)])                      # [B, 5, n]
    want = np.asarray(jprep(key, n, bounces))            # [B, 7, n]
    got = preprocess_uniforms(_t(raw)).numpy()
    assert got.shape == want.shape == (bounces, 7, n)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_prepare_uniforms_from_generator():
    g = torch.Generator().manual_seed(0)
    u = prepare_uniforms(g, 4096, 3)
    assert u.shape == (3, 7, 4096) and u.dtype == torch.float32
    assert torch.isfinite(u).all()
    assert (u[:, 0] <= 0).all()                       # ln u
    assert ((u[:, 3] >= 0) & (u[:, 3] < 1)).all()       # branch variate
    assert ((u[:, 4] >= 0) & (u[:, 4] <= 1)).all()      # 2 acos(u) / pi
    for c, s in ((1, 2), (5, 6)):                        # cos/sin pairs
        torch.testing.assert_close(u[:, c] ** 2 + u[:, s] ** 2,
                                   torch.ones(3, 4096), rtol=0, atol=1e-5)
    again = prepare_uniforms(torch.Generator().manual_seed(0), 4096, 3)
    assert torch.equal(u, again)
