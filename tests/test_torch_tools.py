"""The port's debug views (``tools/debug.py``), tree dumps
(``tools/inspect_tree.py``) and CLI ``inspect`` against the JAX package's,
on the inline Cornell scene at 24 x 24 (the counterpart of
``tests/test_tools.py``, which reads the reference scene files).

The port's closest hit (the select kernel's plain version here) and the
JAX package's dense ``closest_hit`` may name different primitives where a
ray grazes coplanar surfaces (the rotated cube standing on the floor):
such pixels are counted and must stay a handful."""

import numpy as np
import pytest

from raytracercore_tpu.bvh.builder import build_bvh as jbuild_bvh
from raytracercore_tpu.scene import loader as jloader
from raytracercore_tpu.tools import debug as jdebug
from raytracercore_tpu.tools import inspect_tree as jinspect
from raytracercore_tpu_torch.bvh.builder import build_bvh
from raytracercore_tpu_torch.parallel.worker import (CORNELL_SCENE,
                                                    FUSED_TEST_SCENE)
from raytracercore_tpu_torch.render.integrator import BounceType
from raytracercore_tpu_torch.scene import loader
from raytracercore_tpu_torch.tools import cli, debug, inspect_tree, png

SIZE = 24
MAX_FLIPS = 3      # pixels of 576 where the two closest hits may differ
LEAF = 4
# Two spheres and a light quad, without the back plane: rays miss.
OPEN_SCENE = FUSED_TEST_SCENE.replace("plane -1  0 0 1", "")


def _scenes(size=SIZE, recursion=None, text=CORNELL_SCENE):
    jhost, thost = jloader.parse(text), loader.parse(text)
    for host in (jhost, thost):
        host.width = host.height = size
        if recursion is not None:
            host.recursion = recursion
    return jhost, thost


def _trees(jhost, thost):
    return (jbuild_bvh(jhost, leaf_size=LEAF),
            build_bvh(thost, leaf_size=LEAF, backend="numpy"))


def _differ(got, want):
    """Pixels where two images differ."""
    return np.any(got != want, axis=-1)


@pytest.mark.parametrize("text", [CORNELL_SCENE, OPEN_SCENE],
                         ids=["cornell", "open"])
def test_primitive_id_map_matches_jax(text):
    """In the closed Cornell room every pixel hits; the open scene has
    misses, which are black."""
    jhost, thost = _scenes(text=text)
    want = jdebug.primitive_id_map(jhost)
    got = debug.primitive_id_map(thost, device="cpu")
    assert got.shape == (SIZE, SIZE, 3) and got.dtype == np.uint8
    assert _differ(got, want).sum() <= MAX_FLIPS
    flat = got.reshape(-1, 3)
    assert len(np.unique(flat, axis=0)) > 3
    assert (flat.sum(-1) == 0).any() == (text is OPEN_SCENE)


def _visible_prims(jhost):
    import jax

    from raytracercore_tpu.intersect import closest_hit
    from raytracercore_tpu.scene.types import freeze_scene
    o, d = jdebug._center_rays(jhost, 0)
    prims = np.asarray(jax.jit(closest_hit)(freeze_scene(jhost), o, d,
                                            None).prim)
    ids, counts = np.unique(prims[prims >= 0], return_counts=True)
    return ids[np.argsort(-counts)], prims.reshape(SIZE, SIZE)


def test_selection_map_prim_matches_jax():
    jhost, thost = _scenes()
    ids, prims = _visible_prims(jhost)
    for sel in ids[:3]:
        want = jdebug.selection_map(jhost, f"prim:{sel}")
        got = debug.selection_map(thost, f"prim:{sel}", device="cpu")
        assert got.shape == (SIZE, SIZE, 4)
        assert _differ(got, want).sum() <= MAX_FLIPS
        mask = got[..., 3] == 255
        # Occluders are ignored: the overlay covers every visible pixel.
        assert mask.sum() >= ((prims == sel) & mask).sum() > 0


def test_selection_map_node_matches_jax():
    jhost, thost = _scenes()
    jbvh, tbvh = _trees(jhost, thost)
    assert tbvh.n_nodes == jbvh.n_nodes > 4
    for node in (0, 1, tbvh.n_nodes // 2, tbvh.n_nodes - 1):
        want = jdebug.selection_map(jhost, f"node:{node}", bvh=jbvh)
        got = debug.selection_map(thost, f"node:{node}", bvh=tbvh,
                                  device="cpu")
        np.testing.assert_array_equal(got, want)
    assert (debug.selection_map(thost, "node:0", bvh=tbvh, device="cpu")
            [..., 3] == 255).any()
    with pytest.raises(ValueError, match="out of range"):
        debug.selection_map(thost, f"node:{tbvh.n_nodes}", bvh=tbvh,
                            device="cpu")
    with pytest.raises(ValueError, match="prim:<id> or node:<i>"):
        debug.selection_map(thost, "box:1", device="cpu")


def test_bvh_heatmap_matches_jax(monkeypatch):
    jhost, thost = _scenes()
    jbvh, tbvh = _trees(jhost, thost)
    want = jdebug.bvh_heatmap(jhost, bvh=jbvh)
    got = debug.bvh_heatmap(thost, bvh=tbvh, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 3
    # In chunks of a few rays (as a 700 x 700 view walks them): the same.
    monkeypatch.setattr(debug, "_HEATMAP_CELLS", 7 * tbvh.n_nodes)
    np.testing.assert_array_equal(
        debug.bvh_heatmap(thost, bvh=tbvh, device="cpu"), want)


def _tags_and_prims(lines):
    return [tuple(tok for tok in ln.split() if "=" not in tok
                  or tok.startswith("prim="))
            for ln in lines[:-1]]


def test_trace_pixel_matches_jax_on_the_same_draws():
    import jax
    import jax.numpy as jnp
    import torch

    from raytracercore_tpu.render.integrator import prepare_uniforms
    jhost, thost = _scenes(recursion=5)
    n, seed = 6, 3
    want = jdebug.trace_pixel(jhost, 12, 14, n_traces=n, seed=seed)
    k_cam, k_path = jax.random.split(jax.random.PRNGKey(seed))
    jitter = np.asarray(jax.random.uniform(k_cam, (n, 4), dtype=jnp.float32))
    uniforms = np.asarray(prepare_uniforms(k_path, n, 6, jnp.float32))
    got = debug.trace_pixel(thost, 12, 14, n_traces=n, device="cpu",
                            jitter=torch.tensor(jitter),
                            uniforms=torch.tensor(uniforms))
    assert len(got) == n
    for g, w in zip(got, want):
        assert _tags_and_prims(g) == _tags_and_prims(w)
        assert g[-1].startswith("color=")
    assert sum(len(g) for g in got) > 2 * n


def test_trace_pixel_listing_uses_the_bounce_names():
    _, thost = _scenes()
    traces = debug.trace_pixel(thost, 12, 12, n_traces=3, seed=1,
                               device="cpu")
    assert len(traces) == 3
    for lines in traces:
        assert lines[-1].startswith("color=")
        for ln in lines[:-1]:
            assert ln.split()[0] in BounceType.NAMES
    assert traces == debug.trace_pixel(thost, 12, 12, n_traces=3, seed=1,
                                       device="cpu")


def test_scene_and_bvh_trees_match_jax():
    jhost, thost = _scenes()
    assert inspect_tree.scene_tree(thost) == jinspect.scene_tree(jhost)
    jbvh, tbvh = _trees(jhost, thost)
    text = inspect_tree.bvh_tree(tbvh)
    assert text == jinspect.bvh_tree(jbvh)
    assert text.count("leaf") > 2
    assert (inspect_tree.describe_primitive(3, thost.primitives[3])
            == jinspect.describe_primitive(3, jhost.primitives[3]))


@pytest.fixture
def scene_file(tmp_path):
    path = tmp_path / "cornell.txt"
    path.write_text(CORNELL_SCENE)
    return str(path)


@pytest.mark.parametrize("flags,channels", [
    ([], 3), (["--mode", "heatmap"], 3), (["--select", "prim:2"], 4),
    (["--select", "node:0"], 4)])
def test_cli_inspect_writes_png(scene_file, tmp_path, capsys, flags,
                                channels):
    out = str(tmp_path / "view.png")
    cli.main(["inspect", scene_file, "--size", "16", "--device", "cpu",
              "-o", out, *flags])
    img = png.read_png(out)
    assert img.shape == (16, 16, channels)
    assert img.any()
    assert f"wrote {out}" in capsys.readouterr().out


def test_cli_inspect_pixel_prints_traces(scene_file, capsys):
    cli.main(["inspect", scene_file, "--size", "16", "--device", "cpu",
              "--pixel", "8,8", "--traces", "2", "--recursion", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "trace 0:" and "trace 1:" in lines
    assert sum(ln.strip().startswith("color=") for ln in lines) == 2
