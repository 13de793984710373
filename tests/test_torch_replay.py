"""The port's path replay (``render/replay.py``, ``render/replay_kernel.py``)
against the JAX package's.

One tape, recorded by the port's ``trace_fused_reference(want_tape=True)``
and carried over as a JAX ``PathTape``, feeds both packages together with
the same rays and ``prepare_uniforms`` channels, so every difference is the
replay's own:

* forward: miss equal, colour within 1e-6 abs + 1e-6 rel (same operations,
  f32);
* material gradients: within ``1e-5·max|g| + 1e-12`` per field (sums over
  rays in another order);
* the hand-written adjoint (``_bounce_bwd`` / ``replay_bwd_reference``)
  against torch autograd of the plain replay in float64, within 1e-10
  relative, where f32 round-off cannot hide a wrong derivative;
* central finite differences of the replay loss in float64.

The CUDA kernels have no CPU mode: their cases need a card and skip here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracercore_tpu.diff import get_material_params as jget_params
from raytracercore_tpu.diff import with_material_params as jwith_params
from raytracercore_tpu.render import camera as jcam
from raytracercore_tpu.render.integrator import PathTape as JTape
from raytracercore_tpu.render.integrator import prepare_uniforms as jprep
from raytracercore_tpu.render.replay import replay as jreplay
from raytracercore_tpu.render.replay_kernel import \
    replay_fused as jreplay_fused
from raytracercore_tpu.scene import loader as jloader
from raytracercore_tpu.scene import types as jtypes
from raytracercore_tpu_torch.diff import (MATERIAL_FIELDS,
                                          get_material_params,
                                          with_material_params)
from raytracercore_tpu_torch.render import fused
from raytracercore_tpu_torch.render import replay_kernel as rk
from raytracercore_tpu_torch.render.integrator import (PathTape,
                                                       _material_matrix)
from raytracercore_tpu_torch.render.replay import (record_tape_fused,
                                                   replay, trace_replay)
from raytracercore_tpu_torch.scene import loader as tloader
from raytracercore_tpu_torch.scene import types as ttypes
from test_torch_fused import cuda_device  # noqa: F401
from test_torch_scene import FUSED_SCENE, ROUGH_SCENE, host_scenes

# A white diffuse wall: its luminance is exactly 1.0f, so total_lum ties
# the 1 of max(total_lum, 1) and the derivative splits 0.5/0.5.
TIE_SCENE = FUSED_SCENE.replace("diffuse .7 .6 .5", "diffuse 1 1 1")

# Row 0 (the light) with shininess 0: every path that hits the light, and
# every bounce a path never reached, reads it.
SHIN0_SCENE = FUSED_SCENE.replace(
    "emission 6 6 6", "emission 6 6 6\nshininess 0").replace(
    "emission 0 0 0", "emission 0 0 0\nshininess 100")

TEXTS = {"rough": ROUGH_SCENE, "tie": TIE_SCENE, "shin0": SHIN0_SCENE}


def _t(a):
    return torch.tensor(np.asarray(a))


def _hosts(name):
    if name in TEXTS:
        return jloader.parse(TEXTS[name]), tloader.parse(TEXTS[name])
    return host_scenes(name)


@functools.lru_cache(maxsize=None)
def case(name, size, recursion, seed=3, ambient_miss=False):
    """Both packages' scenes and the same rays, uniforms and tape:
    ``(jax scene, port scene, jax (o, d, u, tape), port (o, d, u, tape))``.
    """
    jhost, thost = _hosts(name)
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
    ta = ttypes.freeze_scene(thost, device="cpu")
    o, d, u = _t(ray_o), _t(ray_d), _t(uniforms)
    tape = record_tape_fused(ta, o, d, u)
    jtape = JTape(*(jnp.asarray(getattr(tape, f).numpy())
                    for f in ("prim", "flags", "nx", "ny", "nz")))
    return ja, ta, (ray_o, ray_d, uniforms, jtape), (o, d, u, tape)


def jax_loss_grads(fn, ja, jin, **kw):
    def loss(p):
        color, miss = fn(jwith_params(ja, p), *jin, **kw)
        img = jnp.where(miss[:, None], 0.0, color)
        return jnp.mean(img ** 2), (color, miss)
    (_, (color, miss)), g = jax.value_and_grad(loss, has_aux=True)(
        jget_params(ja))
    return color, miss, {k: np.asarray(v) for k, v in g.items()}


def port_loss_grads(fn, ta, tin, **kw):
    params = get_material_params(ta)
    color, miss = fn(with_material_params(ta, params), *tin, **kw)
    img = torch.where(miss[:, None], 0.0, color)
    torch.mean(img ** 2).backward()
    return color.detach(), miss, {k: v.grad.numpy() for k, v in
                                  params.items()}


def assert_grads_match(got, want, fields=MATERIAL_FIELDS):
    nonzero = 0
    for k in fields:
        assert np.isfinite(got[k]).all(), k
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-5 * scale + 1e-12, err_msg=k)
        nonzero += int((want[k] != 0).sum())
    assert nonzero > 10  # the comparison must not be vacuous


@pytest.mark.parametrize("name,size,recursion,ambient_miss", [
    ("fused", 16, 4, False), ("cornell", 16, 10, False),
    ("rough", 16, 4, False), ("smooth", 16, 6, True)])
def test_replay_forward_matches_jax(name, size, recursion, ambient_miss):
    ja, ta, jin, tin = case(name, size, recursion, ambient_miss=ambient_miss)
    want_c, want_m = jreplay(ja, *jin)
    got_c, got_m = replay(ta, *tin)
    assert np.asarray(want_c).max() > 0.5  # lit: no vacuous agreement
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,size,recursion", [
    ("rough", 16, 4), ("cornell", 16, 10), ("tie", 16, 3)])
def test_replay_grads_match_jax(name, size, recursion):
    ja, ta, jin, tin = case(name, size, recursion)
    _, _, want = jax_loss_grads(jreplay, ja, jin)
    _, _, got = port_loss_grads(replay, ta, tin)
    assert_grads_match(got, want)
    if name == "rough":
        # Fresnel and the shine cone carry gradient here.
        assert (want["refractive_index"] != 0).any()
        assert (want["shininess"] != 0).any()


def test_tie_scene_ties():
    """The white wall's total luminance is exactly 1.0f on real bounces,
    so the tie rule of max(total, 1) is exercised above."""
    _, ta, _, (_, _, _, tape) = case("tie", 16, 3)
    matf = _material_matrix(ta.materials)
    diff_lum = 0.299 * matf[:, 3] + 0.587 * matf[:, 4] + 0.114 * matf[:, 5]
    white = torch.nonzero(diff_lum == 1.0).flatten()
    assert white.numel() == 1
    assert not matf[white, :3].any() and not matf[white, 6:12].any()
    code = tape.flags & PathTape.CODE_MASK
    assert ((tape.prim == white) & (code == 1)).sum() > 10


def test_replay_fused_matches_jax_kernel_route():
    """The port's kernel route (plain versions on the CPU: the forward
    reference, and the hand-written backward) against JAX ``replay_fused``
    in interpret mode, with the forward kernel and with record-as-primal."""
    ja, ta, jin, tin = case("rough", 16, 2)
    want_c, want_m, want = jax_loss_grads(jreplay_fused, ja, jin,
                                          interpret=True)
    got_c, got_m, got = port_loss_grads(rk.replay_fused, ta, tin)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                               rtol=1e-6, atol=1e-6)
    assert_grads_match(got, want)
    # Record-as-primal: JAX's own identity test shows its gradients are the
    # forward route's; the port's must match the same numbers.
    rec_c, rec_m, _ = fused.trace_fused_reference(ta, *tin[:3],
                                                  want_tape=True)
    p_c, p_m, p_got = port_loss_grads(rk.replay_fused, ta, tin,
                                      primal=(rec_c, rec_m))
    assert torch.equal(p_c, rec_c) and torch.equal(p_m, rec_m)
    assert_grads_match(p_got, want)


def test_record_as_primal_is_exact():
    """The recorder's colour comes back bit for bit, and the gradients are
    the forward route's exactly (the backward runs the same sweep)."""
    _, ta, _, tin = case("rough", 16, 4)
    rec_c, rec_m, _ = fused.trace_fused_reference(ta, *tin[:3],
                                                  want_tape=True)
    c0, m0, g0 = port_loss_grads(rk.replay_fused, ta, tin)
    c1, m1, g1 = port_loss_grads(rk.replay_fused, ta, tin,
                                 primal=(rec_c, rec_m))
    assert torch.equal(c1, rec_c) and torch.equal(m1, m0)
    np.testing.assert_allclose(c0.numpy(), rec_c.numpy(), rtol=1e-5,
                               atol=1e-6)
    for k in g0:
        np.testing.assert_array_equal(g1[k], g0[k], err_msg=k)


def _f64(tin, ta):
    o, d, u, tape = tin
    tape64 = PathTape(tape.prim, tape.flags, tape.nx.double(),
                      tape.ny.double(), tape.nz.double())
    matf, scf = rk.material_table(ta, torch.float64)
    return d.double(), u.double(), tape64, matf, scf


@pytest.mark.parametrize("name,size,recursion,ambient_miss", [
    ("rough", 16, 4, False), ("cornell", 16, 10, False),
    ("smooth", 16, 6, True), ("shin0", 16, 4, False), ("tie", 16, 3, False)])
def test_hand_adjoint_matches_autograd_f64(name, size, recursion,
                                           ambient_miss):
    _, ta, _, tin = case(name, size, recursion, ambient_miss=ambient_miss)
    d, u, tape, matf, scf = _f64(tin, ta)
    matf = matf.requires_grad_(True)
    color, miss = rk.replay_fwd_reference(d, u, tape, matf, scf,
                                          ta.ambient_is_miss)
    img = torch.where(miss[:, None], 0.0, color)
    loss = torch.mean(img ** 2) + torch.mean(color[:, 1])
    color_ct, g_auto = torch.autograd.grad(loss, (color, matf))
    g_hand = rk.replay_bwd_reference(d, u, tape, matf.detach(), scf,
                                     ta.ambient_is_miss, color_ct)
    assert torch.isfinite(g_hand).all()
    assert int((g_auto != 0).sum()) > 10
    err = (g_hand - g_auto).abs().max() / g_auto.abs().max()
    assert err <= 1e-10, float(err)


@pytest.mark.parametrize("i,ambient_is_miss", [
    (0, False), (1, False), (3, True), (4, False)])
def test_bounce_bwd_matches_autograd_per_bounce(i, ambient_is_miss):
    """Every output of ``_bounce_bwd`` (direction, tint, result and the 14
    material planes) against autograd of ``_bounce_fwd`` on one bounce,
    float64, with random cotangents on every output."""
    _, ta, _, tin = case("rough", 16, 4)
    d, u, tape, matf, scf = _f64(tin, ta)
    b = min(i, tape.prim.shape[0] - 1)
    rng = np.random.default_rng(i)
    R = d.shape[0]

    def rnd(*shape):
        return torch.tensor(rng.uniform(0.2, 1.0, shape))

    d_in = tuple(d[:, k] * (1.0 + 0.1 * rnd(R)) for k in range(3))
    tint = tuple(rnd(R) for _ in range(3))
    result = tuple(rnd(R) for _ in range(3))
    g = tuple(x.clone() for x in rk._gather(matf, tape.prim[b]))
    inputs = [x.requires_grad_(True) for x in (*d_in, *tint, *result, *g)]
    air, ambient = scf[0], (scf[1], scf[2], scf[3])
    normal = (tape.nx[b], tape.ny[b], tape.nz[b])
    out = rk._bounce_fwd(i, tuple(inputs[0:3]), tuple(inputs[3:6]),
                         tuple(inputs[6:9]), tuple(inputs[9:]), u[b],
                         tape.flags[b], normal, air, ambient,
                         ambient_is_miss)[:3]
    cts = [rnd(R) for _ in range(9)]
    auto = torch.autograd.grad([x for o in out for x in o], inputs,
                               grad_outputs=cts, allow_unused=True)
    with torch.no_grad():
        d_ct, t_ct, r_ct, g_ct = rk._bounce_bwd(
            i, d_in, tint, g, u[b], tape.flags[b], normal, air,
            ambient_is_miss, tuple(cts[0:3]), tuple(cts[3:6]),
            tuple(cts[6:9]))
    hand = (*d_ct, *t_ct, *r_ct, *g_ct)
    for k, (h, a) in enumerate(zip(hand, auto)):
        a = torch.zeros_like(h) if a is None else a
        scale = max(float(a.abs().max()), 1e-300)
        assert float((h - a).abs().max()) <= 1e-10 * scale, k


def test_replay_grad_matches_finite_differences():
    """Central differences of the port's replay loss in float64 at the
    largest-gradient entry of every field."""
    _, ta, _, tin = case("rough", 16, 4)
    d, u, tape, matf0, scf = _f64(tin, ta)

    def loss(matf):
        color, miss = rk.replay_fwd_reference(d, u, tape, matf, scf,
                                              ta.ambient_is_miss)
        return torch.mean(torch.where(miss[:, None], 0.0, color) ** 2)

    matf = matf0.clone().requires_grad_(True)
    g = torch.autograd.grad(loss(matf), matf)[0]
    cols = {"emission": [0, 1, 2], "diffuse": [3, 4, 5],
            "specular": [6, 7, 8], "refraction": [9, 10, 11], "ior": [12],
            "shininess": [13]}
    for field, cs in cols.items():
        sub = g[:, cs].abs()
        row, c = np.unravel_index(int(sub.argmax()), sub.shape)
        col = cs[c]
        assert g[row, col] != 0, field
        eps = 1e-6 * max(1.0, abs(float(matf0[row, col])))
        plus, minus = matf0.clone(), matf0.clone()
        plus[row, col] += eps
        minus[row, col] -= eps
        fd = (float(loss(plus)) - float(loss(minus))) / (2 * eps)
        assert float(g[row, col]) == pytest.approx(fd, rel=1e-5), field


def test_shininess_zero_at_row_0():
    """Shininess 0 on row 0: the forward stays finite and equal to JAX,
    and every gradient is finite.  The JAX replay's derivative there is
    ``0 · inf`` = NaN (in the shininess column only); the port gives the
    limit, 0.  Every other field matches JAX."""
    ja, ta, jin, tin = case("shin0", 16, 4)
    assert float(ta.materials.shininess[0]) == 0.0
    want_c, want_m, want = jax_loss_grads(jreplay, ja, jin)
    got_c, got_m, got = port_loss_grads(replay, ta, tin)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-6,
                               atol=1e-6)
    assert np.isfinite(got_c.numpy()).all()
    assert_grads_match(got, want, [f for f in MATERIAL_FIELDS
                                   if f != "shininess"])
    assert np.isfinite(got["shininess"]).all()
    assert got["shininess"][0] == 0.0
    _, _, k_got = port_loss_grads(rk.replay_fused, ta, tin)
    assert all(np.isfinite(v).all() for v in k_got.values())


def test_with_material_params_repacks_only_materials():
    _, ta, _, tin = case("rough", 16, 4)
    base = ta.fused_tables
    params = get_material_params(ta)
    with torch.no_grad():
        params["diffuse"] *= 0.5
    s = with_material_params(ta, params)
    for k in range(8):
        if k == 6:
            assert torch.equal(s.fused_tables[6],
                               fused.pack_materials(s.materials))
            assert not torch.equal(s.fused_tables[6], base[6])
            assert not s.fused_tables[6].requires_grad
        else:
            assert s.fused_tables[k] is base[k]
    # The recorder traces with the new materials: the colour changes.
    c0, _ = trace_replay(ta, *tin[:2], uniforms=tin[2])
    c1, _ = trace_replay(s, *tin[:2], uniforms=tin[2])
    assert not torch.equal(c0, c1)
    assert float(c1.sum()) < float(c0.sum())


def test_trace_replay_rejects_scenes_the_recorder_cannot_trace():
    """A scene above the megakernel's cap is no longer rejected: the
    integrator's own loop records it, and the replay kernels' route takes
    its 66 material rows.  Rejected still: neither a seed nor uniforms; and
    with the default closest hit a scene above the dense tier's cap, which
    needs the BVH.  A caller's own closest hit may bring a material table
    the replay kernels cannot take: on CPU tensors the plain versions run."""
    big = ("size 4 4\ncamera 0 0 5  0 0 0  0 1 0  40\n"
           "emission 4 4 4\nsphere 0 0 40 30\nemission 0 0 0\n"
           "diffuse .5 .5 .5\n"
           + "".join(f"sphere {i - 32} 0 0 .4\n" for i in range(65)))
    ta = ttypes.freeze_scene(tloader.parse(big), device="cpu")
    assert not fused.fits(ta)
    assert fused.MAX_PRIMS < ta.materials.emission.shape[0] \
        <= rk.MAX_KERNEL_MATS
    o = torch.tensor([[0.0, 0.0, 5.0]]).repeat(16, 1)
    o[:, 0] = torch.linspace(-3, 3, 16)
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(16, 1)
    params = get_material_params(ta)
    color, miss = trace_replay(with_material_params(ta, params), o, d,
                               seed=0)
    assert color.shape == (16, 3) and not bool(miss.any())
    assert bool(torch.isfinite(color).all())
    color.sum().backward()
    assert bool(torch.isfinite(params["diffuse"].grad).all())
    assert bool((params["diffuse"].grad != 0).any())
    with pytest.raises(ValueError, match="seed or the uniforms"):
        trace_replay(ta, o, d)

    from raytracercore_tpu_torch.config import SELECT_MAX_PRIMS
    from raytracercore_tpu_torch.intersect.dispatch import closest_hit
    from raytracercore_tpu_torch.scene import meshgen
    huge = meshgen.make_mesh_scene(grid=4, subdiv=1, recursion=2,
                                   device="cpu")[0]
    assert huge.materials.emission.shape[0] > max(SELECT_MAX_PRIMS,
                                                  rk.MAX_KERNEL_MATS)
    with pytest.raises(NotImplementedError, match="make_bvh_closest_fn"):
        trace_replay(huge, o, d, seed=0)
    color, _ = trace_replay(huge, o, d, seed=0,
                            closest_fn=lambda *a: closest_hit(*a))
    assert bool(torch.isfinite(color).all())


def test_kernel_wrappers_reject_bad_inputs():
    """The launch checks run before anything reaches the GPU, so they are
    exercised here on CPU tensors."""
    _, ta, _, (_, d, u, tape) = case("rough", 16, 4)
    matf, scf = rk.material_table(ta)
    bad = [
        (d.double(), u, tape, matf, scf),                       # dtype
        (d[:-1], u, tape, matf, scf),                           # shape
        (d, u[:-1], tape, matf, scf),                           # bounces
        (d, u, tape, matf[:0], scf),                            # no rows
        (d.t().contiguous().t(), u, tape, matf, scf),           # layout
    ]
    for args in bad:
        with pytest.raises(ValueError):
            rk._kernel_args(*args)
    long_tape = PathTape(*(t.repeat(9, 1) for t in
                           (tape.prim, tape.flags, tape.nx, tape.ny,
                            tape.nz)))
    with pytest.raises(ValueError, match="bounces"):
        rk._kernel_args(d, u.repeat(9, 1, 1), long_tape, matf, scf)
    # A table above the shared-memory cap is taken (the global-table mode).
    big = matf.repeat(rk.MAX_KERNEL_MATS // 4 + 1, 1)
    assert rk._kernel_args(d, u, tape, big, scf)[2] == big.shape[0]


def test_replay_on_cpu_runs_the_plain_versions():
    _, ta, _, (o, d, u, tape) = case("rough", 16, 4)
    before = (rk.replay_fwd.launches, rk.replay_bwd.launches)
    color, miss = rk.replay_fused(ta, o, d, u, tape)
    assert (rk.replay_fwd.launches, rk.replay_bwd.launches) == before
    want_c, want_m = replay(ta, o, d, u, tape)
    assert torch.equal(miss, want_m)
    np.testing.assert_allclose(color.numpy(), want_c.detach().numpy(),
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name,recursion,ambient_miss", [
    ("rough", 4, False), ("cornell", 10, False), ("smooth", 6, True)])
def test_replay_kernels_match_reference_on_card(  # noqa: F811
        cuda_device, name, recursion, ambient_miss):
    _, ta, _, tin = case(name, 32, recursion, ambient_miss=ambient_miss)
    scene = ta.to(cuda_device)
    o, d, u = (x.to(cuda_device) for x in tin[:3])
    tape = record_tape_fused(scene, o, d, u)
    matf, scf = rk.material_table(scene)
    ref_c, ref_m = rk.replay_fwd_reference(d, u, tape, matf, scf,
                                           scene.ambient_is_miss)
    got_c, got_m = rk.replay_fwd(d, u, tape, matf, scf,
                                 scene.ambient_is_miss)
    assert torch.equal(got_m, ref_m)
    torch.testing.assert_close(got_c, ref_c, rtol=1e-5, atol=1e-6)
    ct = torch.where(ref_m[:, None], 0.0, 2.0 * ref_c) / ref_c.numel()
    want = rk.replay_bwd_reference(d, u, tape, matf, scf,
                                   scene.ambient_is_miss, ct)
    got = rk.replay_bwd(d, u, tape, matf, scf, scene.ambient_is_miss, ct)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


@pytest.mark.parametrize("R", [490_000, 262_144])
@pytest.mark.parametrize("N", [24, 722, 46_082])
def test_launch_blocks_per_table_mode(monkeypatch, R, N):
    """The backward's grid in each of the three table modes (the forward
    keeps no table in shared memory and has one block per 128 paths in all
    three): up to 64 material rows one block per 128 paths; 65-768 rows
    (the table in shared memory; it regenerates paths) the blocks that stay
    resident, as many on each SM as the card reports (here 1); above 768
    rows (the global table) one per 128 paths.  The SM count and the
    occupancy are asked of the card only in the middle mode (mocked here:
    132 SMs)."""
    asked, asked_bwd = [], []

    class Props:
        multi_processor_count = 132

    def props(device):
        asked.append(device)
        return Props()

    def bwd_per_sm():
        asked_bwd.append(True)
        return 1

    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    per_128 = -(-R // rk.REPLAY_BLOCK)
    n_bwd = rk.bwd_launch_blocks(R, N, "cuda", bwd_per_sm)
    if rk.SMALL_TABLE_MATS < N <= rk.MAX_KERNEL_MATS:
        assert n_bwd == 132 and asked_bwd == [True]
        assert asked == ["cuda"] and rk._regenerates(N)
    else:
        assert n_bwd == per_128
        assert not asked and not asked_bwd and not rk._regenerates(N)
    assert per_128 == {490_000: 3829, 262_144: 2048}[R]


@pytest.mark.parametrize("N", [24, 722, 46_082])
def test_bwd_blocks_per_sm_asks_the_card_once(monkeypatch, N):
    """The backward's resident blocks come from the kernel library's
    occupancy query, with the table mode of N (global table above 768
    rows, regeneration at 65-768), once per device and arguments; the
    bounce entries go to shared memory where that keeps as many blocks
    resident as local memory (here at 11 bounces, not at 32), unless
    ``STASH_IN_SHARED`` forces a place."""
    from raytracercore_tpu_torch import kernels

    calls = []

    class Lib:
        @staticmethod
        def rtc_replay_bwd_blocks_per_sm(n, bounces, aim, global_table,
                                         regen, shared, out):
            calls.append((n, bounces, aim, global_table, regen, shared))
            out._obj.value = 2 if shared and bounces > 11 else 3
            return 0

    monkeypatch.setattr(kernels, "load", lambda: Lib)
    monkeypatch.setattr(rk, "_bwd_per_sm", {})
    for _ in range(2):
        assert rk.shared_stash(N, 11, True, "cuda:0")
        assert not rk.shared_stash(N, 32, True, "cuda:0")
        assert rk.bwd_blocks_per_sm(N, 11, True, "cuda:0") == 3
        assert rk.bwd_blocks_per_sm(N, 32, True, "cuda:0") == 3
    mode = (1, int(N > rk.MAX_KERNEL_MATS), int(rk._regenerates(N)))
    assert sorted(calls) == sorted((N, b, *mode, sh) for b in (11, 32)
                                   for sh in (1, 0))
    monkeypatch.setattr(rk, "STASH_IN_SHARED", True)
    assert rk.shared_stash(N, 32, True, "cuda:0")
    assert rk.bwd_blocks_per_sm(N, 32, True, "cuda:0") == 2
