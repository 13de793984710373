"""The port's forward render slice as a whole: ``render_pass`` against the
JAX chain camera_rays → trace → add_full_frame at the same random numbers,
the progressive ``Renderer`` (chunk invariance, checkpoints shared with the
JAX ``Renderer``, device and scene-size guards), the CLI, and the rule that
the port never imports JAX."""

import json
import subprocess
import sys

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
from raytracercore_tpu.scene import types as jtypes
from raytracercore_tpu_torch.parallel.worker import CORNELL_SCENE
from raytracercore_tpu_torch.render import renderer as trenderer
from raytracercore_tpu_torch.render.film import Film as TFilm
from raytracercore_tpu_torch.render.renderer import Renderer, render_pass
from raytracercore_tpu_torch.scene import loader as tloader
from raytracercore_tpu_torch.scene import types as ttypes
from raytracercore_tpu_torch.tools.png import read_png
from test_torch_scene import REPO_ROOT, host_scenes


def _t(a):
    return torch.tensor(np.asarray(a))


def _small(name, size, recursion):
    jhost, thost = host_scenes(name)
    for host in (jhost, thost):
        host.width = host.height = size
        host.recursion = recursion
    return jhost, thost


@pytest.mark.parametrize("name,size,recursion", [
    ("fused", 16, 4), ("cornell", 16, 10)])
def test_render_pass_matches_jax_chain(name, size, recursion):
    jhost, thost = _small(name, size, recursion)
    ja = jtypes.freeze_scene(jhost)
    jc = jtypes.init_camera(jhost.cameras[0], size, size)
    px, py = jcam.pixel_grid(size, size)
    k_cam, k_path = jax.random.split(jax.random.PRNGKey(4))
    jitter = jax.random.uniform(k_cam, (size * size, 4), dtype=jnp.float32)
    uniforms = jprep(k_path, size * size, recursion + 1, jnp.float32)
    ray_o, ray_d = jcam.camera_rays(jc, px, py, k_cam)
    color, miss = jtrace(ja, ray_o, ray_d, None, uniforms=uniforms)
    jf = JFilm.create(size, size).add_full_frame(color, miss)

    ta = ttypes.freeze_scene(thost, device="cpu")
    tc = ttypes.init_camera(thost.cameras[0], size, size, device="cpu")
    tf = render_pass(ta, tc, TFilm.create(size, size,
                                          device="cpu"), _t(jitter),
                     _t(uniforms))

    # Discrete outputs exactly; colours to the megakernel tolerances.
    np.testing.assert_array_equal(tf.samples.numpy(), np.asarray(jf.samples))
    np.testing.assert_array_equal(tf.misses.numpy(), np.asarray(jf.misses))
    want = np.asarray(jf.color_sum).reshape(-1, 3)
    got = tf.color_sum.numpy().reshape(-1, 3)
    assert want.max() > 0.5
    close = np.all(np.abs(want - got) <= 1e-3 + 1e-3 * np.abs(want), axis=1)
    assert close.mean() >= 0.97, f"only {close.mean():.3f} close"
    np.testing.assert_allclose(got.mean(0), want.mean(0), rtol=5e-3,
                               atol=5e-3)


def test_step_chunking_is_bit_exact():
    _, thost = _small("fused", 8, 4)
    a = Renderer(thost, device="cpu", seed=3)
    a.step(4)
    a.step(4)
    b = Renderer(thost, device="cpu", seed=3)
    b.step(8)
    for field in ("color_sum", "samples", "misses"):
        assert torch.equal(getattr(a.film, field), getattr(b.film, field))
    assert a.pass_index == b.pass_index == 8
    assert float(a.film.samples.sum() + a.film.misses.sum()) == 8 * 64
    c = Renderer(thost, device="cpu", seed=4)
    c.step(8)
    assert not torch.equal(a.film.color_sum, c.film.color_sum)


def test_pass_seeds_differ():
    seeds = {trenderer.pass_seed(s, k) for s in range(4) for k in range(64)}
    assert len(seeds) == 4 * 64
    assert len({x & 0xFFFFFFFF for x in seeds}) == 4 * 64


@pytest.mark.parametrize("compensated", [False, True])
def test_jax_checkpoint_loads_and_round_trips(tmp_path, compensated):
    jhost, thost = _small("fused", 8, 2)
    jr = JRenderer(jhost, seed=1, compensated=compensated)
    jr.step(2)
    path = str(tmp_path / "jax.npz")
    jr.save_checkpoint(path)

    tr = Renderer(thost, device="cpu")
    tr.load_checkpoint(path)
    assert tr.pass_index == 2 and tr.camera_index == 0
    assert tr.compensated == compensated
    for field in ("color_sum", "samples", "misses", "color_c"):
        want = getattr(jr.film, field)
        got = getattr(tr.film, field)
        if want is None:
            assert got is None
            continue
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    # The port keeps rendering from there, and its checkpoint loads back
    # into the JAX renderer unchanged.
    tr.step(1)
    path2 = str(tmp_path / "port.npz")
    tr.save_checkpoint(path2)
    jr2 = JRenderer(jhost)
    jr2.load_checkpoint(path2)
    assert jr2.pass_index == 3
    for field in ("color_sum", "samples", "misses", "color_c"):
        got = getattr(jr2.film, field)
        want = getattr(tr.film, field)
        if want is None:
            assert got is None
            continue
        np.testing.assert_array_equal(np.asarray(got), want.numpy())


def test_renderer_status_image_and_cameras():
    thost = tloader.parse(CORNELL_SCENE)
    thost.width, thost.height, thost.recursion = 12, 10, 3
    r = Renderer(thost, device="cpu")
    r.run(3, status_every=2)
    st = r.status()
    assert st["samples_per_px"] == 3 and st["samples_per_px_per_sec"] > 0
    assert st["paths_per_sec"] == pytest.approx(
        st["samples_per_px_per_sec"] * 120)
    img = r.image()
    assert img.shape == (10, 12, 4) and img.dtype == np.uint8
    assert img[..., :3].max() > 0
    assert r.next_camera() is False and r.camera_index == 1
    assert r.pass_index == 0 and float(r.film.samples.sum()) == 0
    assert r.next_camera() is True and r.camera_index == 0


def test_renderer_cuda_device_needs_a_card():
    _, thost = _small("fused", 8, 2)
    if torch.cuda.is_available():
        assert Renderer(thost, device="cuda").film.samples.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Renderer(thost, device="cuda")


def test_renderer_rejects_scenes_the_megakernel_cannot_trace():
    """Scenes the megakernel cannot trace take the per-bounce route, and
    ``accelerator="bvh"`` or a scene above the dense tier's cap the BVH
    route; what is still rejected is ``"brute"`` above that cap."""
    from raytracercore_tpu_torch.config import SELECT_MAX_PRIMS
    from raytracercore_tpu_torch.intersect.dispatch import n_table_rows

    _, thost = _small("fused", 8, 2)
    assert Renderer(thost, device="cpu").route == "megakernel"
    thost.debug_geom = True
    assert Renderer(thost, device="cpu").route == "trace"
    spheres = "size 4 4\ncamera 0 0 5  0 0 0  0 1 0  40\n" + "".join(
        f"sphere {i} 0 0 .1\n" for i in range(65))
    assert Renderer(tloader.parse(spheres), device="cpu").route == "trace"
    assert Renderer(thost, device="cpu", accelerator="bvh").route == "bvh"
    with pytest.raises(ValueError, match="accelerator"):
        Renderer(thost, device="cpu", accelerator="kd-tree")
    big = "size 4 4\ncamera 0 0 5  0 0 0  0 1 0  40\n" + "".join(
        f"sphere {i} 0 0 .1\n" for i in range(SELECT_MAX_PRIMS))
    field = Renderer(tloader.parse(big), device="cpu", accelerator="auto")
    assert field.route == "bvh"
    field.step(1)
    assert float(field.film.samples.sum() + field.film.misses.sum()) == 16
    with pytest.raises(NotImplementedError, match="SELECT_MAX_PRIMS"):
        Renderer(tloader.parse(big), device="cpu", accelerator="brute")
    # The boundary: a scene of SELECT_MAX_PRIMS table rows (the spheres, a
    # padding triangle row and a padding plane row) stays in the dense
    # tier, one more row takes the BVH.
    for rows, route in ((SELECT_MAX_PRIMS, "trace"),
                        (SELECT_MAX_PRIMS + 1, "bvh")):
        text = "size 4 4\ncamera 0 0 5  0 0 0  0 1 0  40\n" + "".join(
            f"sphere {i} 0 0 .1\n" for i in range(rows - 2))
        r = Renderer(tloader.parse(text), device="cpu")
        assert n_table_rows(r.arrays) == rows
        assert r.route == route, rows


def test_cli_render_and_bench(tmp_path):
    scene = tmp_path / "scene.txt"
    scene.write_text(CORNELL_SCENE)
    out = tmp_path / "out.png"
    base = [sys.executable, "-m", "raytracercore_tpu_torch.tools.cli"]
    common = [str(scene), "--device", "cpu", "--size", "8",
              "--recursion", "3"]
    subprocess.run(base + ["render", *common, "--spp", "2", "-o", str(out)],
                   check=True, cwd=REPO_ROOT, capture_output=True,
                   timeout=300)
    assert read_png(str(out)).shape == (8, 8, 4)
    res = subprocess.run(base + ["bench", *common, "--spp", "2"],
                         check=True, cwd=REPO_ROOT, capture_output=True,
                         text=True, timeout=300)
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["device"] == "cpu" and line["size"] == [8, 8]
    assert line["samples_per_px_per_sec"] > 0
    assert line["route"] == "megakernel"


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import raytracercore_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'raytracercore_tpu')]\n"
        "need = {p.__name__ + m for m in ('.intersect.dispatch', "
        "'.intersect.torch_ref', '.intersect.cuda_select', "
        "'.scene.meshgen', '.render.integrator', '.render.replay')}\n"
        "print(len(names), bad, need - set(names))\n"
        "sys.exit(1 if bad or len(names) < 21 or need - set(names) "
        "else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
