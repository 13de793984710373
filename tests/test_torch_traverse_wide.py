"""The wide tree of the BVH traversal (``bvh/cuda_traverse.py``:
``pack_wide_nodes``, ``traverse_wide_reference``, the plain version of the
kernel's walk) against the binary skip-link walk ``traverse_reference`` and
the JAX package.

The kernel walks 4-wide nodes collapsed from the binary preorder tree, its
children kept in preorder and their boxes copied bit for bit.  A box holds
its subtree's boxes, the rounded slab test is monotone under containment,
and the one test that depends on time (``near <= best t``) is repeated
with the child's own ``near`` when it is popped: so the wide walk tests
the same leaves in the same order as the binary walk, and its 12 outputs
and the records-tested counter are bit-equal to the binary walk's.  What
is held here, on small trees (a random triangle soup, a grid whose
triangles lie on the boxes' faces, a skewed soup whose tree is deep, the
sphere and ellipsoid fields of ``test_torch_traverse.field_case``, leaf
sizes 1, 2 and 4):

* the packer's invariants: each box bit-equal to its binary node's,
  children in preorder, every leaf reachable exactly once, a parent's box
  holding its children's, the level-wise collapse equal to the rule
  stated node by node, and a tree deeper than the kernel's stack walked on
  the CPU and refused at the kernel's launch;
* ``traverse_wide_reference`` against ``traverse_reference``: all 12
  outputs and the records tested bit-equal, with and without a bounce's
  skip record, with parked rays, zero direction components, a ragged R and
  a given ``order``;
* ``CudaBVH.select`` on the CPU (the wide walk) against the JAX
  ``PallasBVH.select(interpret=True)`` at leaf size 2, with the tolerances
  of ``test_torch_traverse.py``;
* on the card, the kernel against the wide plain version on all outputs and
  both counters (skipped without one).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracercore_tpu.bvh import builder as jbuilder
from raytracercore_tpu.bvh import pallas_traverse as jpt
from raytracercore_tpu.intersect import dispatch as jdispatch
from raytracercore_tpu_torch.bvh import build_bvh, bvh_arrays_from_numpy
from raytracercore_tpu_torch.bvh import cuda_traverse as ct
from raytracercore_tpu_torch.bvh.builder import BVHArrays
from raytracercore_tpu_torch.intersect.dispatch import HitRecord
from raytracercore_tpu_torch.scene import loader
from raytracercore_tpu_torch.scene import types as ttypes
from test_torch_bvh import EPS_B, EPS_P, bounce_of, mesh_case
from test_torch_fused import cuda_device  # noqa: F401
from test_torch_livelist import park
from test_torch_traverse import (SPHERE_TOL, TRI_TOL, _t,
                                 assert_select_matches, field_case)


def _scene(lines):
    head = ["size 8 8", "camera 0 0 9  0 0 0  0 1 0  40",
            "diffuse .5 .5 .5"]
    return ttypes.freeze_scene(loader.parse("\n".join(head + lines) + "\n"),
                               device="cpu")


def soup_scene(n=300, seed=3):
    """``n`` small triangles at random in [-2, 2]^3."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform(-2.0, 2.0, (n, 1, 3))
    verts = (centre + rng.normal(0.0, 0.25, (n, 3, 3))).reshape(-1, 3)
    lines = [f"vertex {x:.6f} {y:.6f} {z:.6f}" for x, y, z in verts]
    lines += [f"tri {3 * i} {3 * i + 1} {3 * i + 2}" for i in range(n)]
    return _scene(lines)


def grid_scene(n=8):
    """Two grids of unit squares (two triangles each), one in the plane
    z = 0 and one in x = 0, on integer coordinates: the boxes are flat and
    share faces, and rays start on those faces."""
    lines, k = [], 0
    for i in range(n):
        for j in range(n):
            a, b = i - n // 2, j - n // 2
            for quad in (
                    [(a, b, 0), (a + 1, b, 0), (a, b + 1, 0),
                     (a + 1, b + 1, 0)],
                    [(0, a, b), (0, a + 1, b), (0, a, b + 1),
                     (0, a + 1, b + 1)]):
                lines += [f"vertex {x} {y} {z}" for x, y, z in quad]
                lines += [f"tri {k} {k + 1} {k + 2}",
                          f"tri {k + 1} {k + 3} {k + 2}"]
                k += 4
    return _scene(lines)


def skewed_scene(n=48):
    """Triangles at geometrically growing distances along x, each as large
    as its distance: the binned SAH splits one or two off at a time, so the
    tree is some n / 2 levels deep and its walks need deep stacks."""
    lines = []
    for i in range(n):
        x, s = 1.25 ** i, 0.5 * 1.25 ** i
        lines += [f"vertex {x:.6f} 0 0", f"vertex {x:.6f} {s:.6f} 0",
                  f"vertex {x:.6f} 0 {s:.6f}",
                  f"tri {3 * i} {3 * i + 1} {3 * i + 2}"]
    return _scene(lines)


def case(name, leaf_size):
    """``(CudaBVH of the tree, the BVHArrays it was packed from)``."""
    if name == "soup":
        scene = soup_scene()
    elif name == "grid":
        scene = grid_scene()
    elif name == "skewed":
        scene = skewed_scene()
    else:
        ja, ta, _, _, _, _ = field_case(name == "spht")
        sph = ja.spheres
        valid = np.asarray(sph.prim_id) >= 0
        if name == "spht":
            jbvh = jbuilder.build_ellipsoid_bvh(
                np.asarray(sph.center), np.asarray(sph.radius),
                np.asarray(sph.obj_to_world), valid, leaf_size=leaf_size,
                backend="numpy")
            cls = ct.CudaEllipsoidBVH
        else:
            jbvh = jbuilder.build_sphere_bvh(
                np.asarray(sph.center), np.asarray(sph.radius), valid,
                leaf_size=leaf_size, backend="numpy")
            cls = ct.CudaSphereBVH
        bvh = bvh_arrays_from_numpy(
            {f.name: np.asarray(getattr(jbvh, f.name))
             for f in dataclasses.fields(BVHArrays)}, device="cpu")
        return cls(bvh, ta.spheres, ta.materials, ta.n_prims), bvh
    bvh = build_bvh(scene, leaf_size=leaf_size, backend="numpy")
    return (ct.CudaBVH(bvh, scene.triangles, scene.materials, scene.n_prims),
            bvh)


CASES = [("soup", 2), ("soup", 4), ("grid", 2), ("grid", 4), ("skewed", 1),
         ("skewed", 2), ("sph", 4), ("spht", 2)]


# ---------------------------------------------------------------------------
# the packer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,leaf_size", CASES)
def test_pack_wide_nodes_invariants(name, leaf_size):
    _, bvh = case(name, leaf_size)
    wide = ct.pack_wide_nodes(bvh)
    table, depth, width = wide.table.numpy(), wide.depth, ct.WIDE_WIDTH
    M = table.shape[0]
    assert table.shape == (M, 8 * width) and table.dtype == np.float32
    node = table.reshape(M, 8, width)
    binary = node[:, 7].astype(np.int64)
    ref = node[:, 6].astype(np.int64)
    used = binary >= 0
    lo, hi = bvh.bmin.numpy(), bvh.bmax.numpy()
    slot = bvh.leaf_slot.numpy()
    # Node 0 holds the root alone; every other node at least two children,
    # in binary preorder, the empty slots last with NaN boxes.
    assert binary[0].tolist() == [0] + [-1] * (width - 1)
    assert (used.sum(1)[1:] >= 2).all()
    for i in range(M):
        kids = binary[i][used[i]]
        assert (np.diff(kids) > 0).all()
        assert not used[i, len(kids):].any()
    assert np.isnan(node[:, :6][~np.broadcast_to(used[:, None], (M, 6, width))]
                    ).all()
    # Each box is its binary node's f32 box, bit for bit.
    b = np.maximum(binary, 0)
    for k in range(3):
        for plane, src in ((k, lo), (3 + k, hi)):
            got = node[:, plane][used].view(np.uint32)
            assert np.array_equal(got, src[b[used], k].view(np.uint32))
    # References: a leaf child is -(slot + 1), an inner one its wide node;
    # every leaf and every wide node but the root's holder reached once.
    is_leaf = used & (slot[b] >= 0)
    assert (ref[is_leaf] == -(slot[b[is_leaf]] + 1)).all()
    inner = used & ~is_leaf
    assert (ref[inner] >= 1).all() and (ref[~used] == 0).all()
    assert sorted(-ref[is_leaf] - 1) == list(range(bvh.leaf_prims.shape[0]))
    assert sorted(ref[inner]) == list(range(1, M))
    # A parent's box holds its children's: the box of the slot that refers
    # to wide node j holds the boxes of j's children.
    for i, c in zip(*np.nonzero(inner)):
        j = ref[i, c]
        kids = used[j]
        for k in range(3):
            assert (node[j, k][kids] >= node[i, k, c]).all()
            assert (node[j, 3 + k][kids] <= node[i, 3 + k, c]).all()
    assert 0 <= depth <= ct.WIDE_STACK


def collapse_by_rule(bvh):
    """The wide tree stated node by node: breadth first from the root, each
    wide node's children collapsed one split at a time (the inner child of
    largest area, the earliest in preorder on a tie), then sorted; the
    stack need bottom up.  ``(binary [M, W], refs [M, W], depth)``."""
    W = ct.WIDE_WIDTH
    lo, hi = bvh.bmin.numpy(), bvh.bmax.numpy()
    skip, slot = bvh.skip.tolist(), bvh.leaf_slot.tolist()
    ext = hi.astype(np.float64) - lo.astype(np.float64)
    area = (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
            + ext[:, 2] * ext[:, 0]).tolist()

    def inner(p):
        return slot[p] < 0 and p + 1 < skip[p]

    def collapse(p):
        kids = [p + 1, skip[p + 1]]
        while len(kids) < W:
            split = [c for c in kids if inner(c)]
            if not split:
                break
            c = max(split, key=lambda c: (area[c], -c))
            i = kids.index(c)
            kids[i:i + 1] = [c + 1, skip[c + 1]]
        return sorted(kids)

    children = [[0] if slot[0] >= 0 or inner(0) else []]
    refs = []
    for kids in children:
        row = []
        for c in kids:
            if slot[c] >= 0:
                row.append(-(slot[c] + 1))
            else:
                row.append(len(children))
                children.append(collapse(c))
        refs.append(row)
    need = [0] * len(children)
    for i in reversed(range(len(children))):
        row = refs[i]
        need[i] = max((len(row) - 1 - j + (need[r] if r > 0 else 0)
                       for j, r in enumerate(row)), default=0)

    def pad(rows, fill):
        return np.array([r + [fill] * (W - len(r)) for r in rows])
    return pad(children, -1), pad(refs, 0), need[0]


@pytest.mark.parametrize("name,leaf_size", CASES + [("chain-20", 0),
                                                    ("chain-300", 0)])
def test_pack_wide_nodes_follows_the_rule(name, leaf_size):
    """The packer collapses a whole level at a time; its tree and stack
    need are those of the rule stated node by node."""
    bvh = (chain_bvh(int(name[6:])) if name.startswith("chain")
           else case(name, leaf_size)[1])
    wide = ct.pack_wide_nodes(bvh)
    node = wide.table.numpy().reshape(-1, 8, ct.WIDE_WIDTH)
    binary, refs, depth = collapse_by_rule(bvh)
    assert np.array_equal(node[:, 7].astype(np.int64), binary)
    assert np.array_equal(node[:, 6].astype(np.int64), refs)
    assert wide.depth == depth


def test_pack_wide_nodes_on_one_leaf_and_an_empty_tree():
    one = build_bvh(_scene(["vertex 0 0 0", "vertex 1 0 0", "vertex 0 1 0",
                            "tri 0 1 2"]), backend="numpy")
    wide = ct.pack_wide_nodes(one)
    assert wide.table.shape == (1, 32) and wide.depth == 0
    assert wide.table.view(8, 4)[6].tolist() == [-1, 0, 0, 0]
    empty = build_bvh(_scene([]), backend="numpy")
    wide = ct.pack_wide_nodes(empty)
    assert wide.table.shape == (1, 32) and wide.depth == 0
    assert not wide.table.view(8, 4)[6].any()
    o = torch.zeros((3, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]] * 3)
    leaves = torch.zeros((1, 2 * ct.TRI_F))
    out = ct.traverse_wide_reference(wide, leaves, "tri", o, d, None, EPS_B,
                                     EPS_P, want_stats=True)
    assert (out.row == -1).all() and out.stats.tolist() == [[1, 0]] * 3


def chain_bvh(n_leaves):
    """A left-deep binary tree: every inner node's first child is the rest
    of the chain, its second a leaf.  All boxes are the unit cube, so the
    collapse expands the earliest (deepest) child, and a walk may hold
    width - 1 pending leaves on every level."""
    skip, slot = [], []

    def emit(n):
        i = len(skip)
        skip.append(-1)
        if n == 1:
            slot.append(sum(s >= 0 for s in slot))
        else:
            slot.append(-1)
            emit(n - 1)
            emit(1)
        skip[i] = len(skip)
    emit(n_leaves)
    N = len(skip)
    return BVHArrays(
        bmin=torch.zeros((N, 3)), bmax=torch.ones((N, 3)),
        skip=torch.tensor(skip, dtype=torch.int32),
        leaf_slot=torch.tensor(slot, dtype=torch.int32),
        leaf_prims=torch.zeros((n_leaves, 2), dtype=torch.int32))


def test_pack_wide_nodes_refuses_a_tree_deeper_than_the_stack():
    """The packer reports the stack a walk needs; the kernel's launch
    refuses a tree that needs more than ``WIDE_STACK`` (the check runs
    before anything reaches the card, so it is exercised here on CPU
    tensors), while the plain walk on the CPU takes it."""
    refs = ct.pack_wide_nodes(chain_bvh(20)).table.view(-1, 8, 4)[:, 6]
    assert ct.pack_wide_nodes(chain_bvh(20)).depth == 19
    assert sorted((-refs[refs < 0] - 1).tolist()) == list(range(20))
    soup = soup_scene(4)
    deep = chain_bvh(ct.WIDE_STACK + 2)
    sel = ct.CudaBVH(deep, soup.triangles, soup.materials, soup.n_prims)
    assert sel.wide.depth == ct.WIDE_STACK + 1
    rng = np.random.default_rng(4)
    o = _t(rng.uniform(-1.0, 2.0, (16, 3)))
    d = _t(rng.normal(size=(16, 3)))
    d = (d / d.norm(dim=1, keepdim=True)).contiguous()
    args = (sel.leaves, "tri", o, d, None, EPS_B, EPS_P, True)
    got = ct.traverse(sel.wide, *args)
    want = ct.traverse_reference(sel.nodes, *args)
    for name in ct.TraverseOut._fields[:-1]:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert torch.equal(got.stats[:, 1], want.stats[:, 1])
    assert int(got.stats[:, 1].max()) > 0
    with pytest.raises(ValueError, match="stack"):
        ct._launch(sel.wide, *args)


# ---------------------------------------------------------------------------
# the wide walk against the binary walk
# ---------------------------------------------------------------------------

def random_rays(sel, n, seed):
    """``n`` rays from a box around the root's, in random directions; one
    in eight with one zero direction component, one in eight with two, and
    one in eight starting on a node's box face."""
    rng = np.random.default_rng(seed)
    lo, hi = sel.root_min.numpy(), sel.root_max.numpy()
    ext = hi - lo
    o = rng.uniform(lo - 0.5 * ext, hi + 0.5 * ext, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    k = n // 8
    each = np.arange(k)
    d[each, rng.integers(0, 3, k)] = 0.0
    d[k:2 * k, :2] = 0.0
    nodes = sel.nodes.numpy()
    face = nodes[rng.integers(0, len(nodes), k)]
    axis = rng.integers(0, 3, k)
    o[2 * k + each, axis] = face[each, axis]
    o[3 * k:4 * k] = face[:, :3]
    d[3 * k:4 * k, 1:] = 0.0
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-30)
    d[np.linalg.norm(d, axis=1) == 0, 2] = 1.0
    return _t(o), _t(d)


def record_of(out):
    return HitRecord(prim=out.prim, t=out.t, position=out.position,
                     normal=out.normal, inside=(out.flags & 1) != 0)


def bounce(o, d, out):
    """Mirror bounce off the hits of ``out``, its record as the skip."""
    hit = (out.row >= 0)[:, None]
    dn = (d * out.normal).sum(1, keepdim=True)
    o2 = torch.where(hit, out.position, o).contiguous()
    d2 = torch.where(hit, d - 2.0 * dn * out.normal, d).contiguous()
    return o2, d2, record_of(out)


def assert_walks_equal(sel, wide, o, d, skip, order=None):
    args = (sel.leaves, sel.leaf_kind, o, d, skip, EPS_B, EPS_P, True,
            order)
    want = ct.traverse_reference(sel.nodes, *args)
    got = ct.traverse_wide_reference(wide, *args)
    for name in ct.TraverseOut._fields[:-1]:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert torch.equal(got.stats[:, 1], want.stats[:, 1])
    # The root test is one fetch, as it is one visit.
    assert torch.equal(got.stats[:, 0] == 1, want.stats[:, 0] == 1)
    assert bool((got.stats[:, 0] <= want.stats[:, 0]).all())
    return want


@pytest.mark.parametrize("name,leaf_size", CASES)
def test_wide_walk_equals_binary_walk(name, leaf_size):
    sel, _ = case(name, leaf_size)
    wide = sel.wide
    o, d = random_rays(sel, 640, 15)
    first = assert_walks_equal(sel, wide, o, d, None)
    assert bool((first.row >= 0).any()) and bool((first.row < 0).any())
    # A bounce with its skip record; some lanes parked.
    o2, d2, skip = bounce(o, d, first)
    assert_walks_equal(sel, wide, o2, d2, skip)
    mask = _t(np.random.default_rng(5).random(len(o)) < 0.3)
    po, pd = park(o2, d2, mask)
    parked = assert_walks_equal(sel, wide, po, pd, skip)
    assert (parked.row[mask] == -1).all()
    got = ct.traverse_wide_reference(wide, sel.leaves, sel.leaf_kind, po,
                                     pd, skip, EPS_B, EPS_P, True)
    assert got.stats[mask].tolist() == [[1, 0]] * int(mask.sum())
    # A ragged R, and the rays walked in a given order.
    assert_walks_equal(sel, wide, o2[:37], d2[:37],
                       HitRecord(*(getattr(skip, f.name)[:37]
                                   for f in dataclasses.fields(skip))))
    order = torch.randperm(len(o), generator=torch.Generator().manual_seed(7))
    assert_walks_equal(sel, wide, o2, d2, skip, order)


@pytest.mark.parametrize("name", ["soup", "grid"])
def test_wide_walk_fetches_fewer_nodes(name):
    """The point of the wide tree: fewer dependent fetches a ray than the
    binary walk's visits, the same records tested."""
    sel, _ = case(name, 2)
    o, d = random_rays(sel, 512, 3)
    want = ct.traverse_reference(sel.nodes, sel.leaves, "tri", o, d, None,
                                 EPS_B, EPS_P, True)
    got = ct.traverse(sel.wide, sel.leaves, "tri", o, d, None, EPS_B, EPS_P,
                      True)
    walked = want.stats[:, 0] > 1
    visits = float(want.stats[walked, 0].float().mean())
    fetches = float(got.stats[walked, 0].float().mean())
    assert fetches * 1.5 < visits
    assert torch.equal(got.stats[:, 1], want.stats[:, 1])


# ---------------------------------------------------------------------------
# select on the CPU (the wide walk) against the JAX kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["tri", "spht"])
def test_select_wide_walk_matches_pallas_at_leaf_size_2(kind):
    """``CudaBVH.select`` on CPU tensors walks the wide tree; against
    ``PallasBVH.select(interpret=True)`` on one tree at leaf size 2, primary
    rays and a skip-carrying bounce.  (Leaf size 4, all three kinds:
    ``test_torch_traverse.py``, whose ``select`` now walks the wide tree
    too; the sphere kind at leaf size 2 takes minutes in interpret mode.)"""
    if kind == "tri":
        ja, ta, jbvh, tbvh, o, d = mesh_case(leaf_size=2, two_sided=True)
        jsel = jpt.PallasBVH(jbvh, ja.triangles, ja.materials, ja.n_prims)
        tsel = ct.CudaBVH(tbvh, ta.triangles, ta.materials, ta.n_prims)
        tol = TRI_TOL
    else:
        ja, ta, _, _, o, d = field_case(True)
        sph = ja.spheres
        valid = np.asarray(sph.prim_id) >= 0
        jbvh = jbuilder.build_ellipsoid_bvh(
            np.asarray(sph.center), np.asarray(sph.radius),
            np.asarray(sph.obj_to_world), valid, leaf_size=2,
            backend="numpy")
        jsel = jpt.PallasEllipsoidBVH(jbvh, sph, ja.materials, ja.n_prims)
        tbvh = bvh_arrays_from_numpy(
            {f.name: np.asarray(getattr(jbvh, f.name))
             for f in dataclasses.fields(BVHArrays)}, device="cpu")
        tsel = ct.CudaEllipsoidBVH(tbvh, ta.spheres, ta.materials,
                                   ta.n_prims)
        tol = SPHERE_TOL
    assert tsel.K == 2
    before = ct.traverse.launches
    hit = assert_select_matches(jsel, tsel, o, d, None, tol)
    assert hit.any() and not hit.all()
    jhit = jdispatch.closest_hit(ja, jnp.asarray(o), jnp.asarray(d), None)
    o2, d2 = bounce_of(jhit, o, d)
    assert assert_select_matches(jsel, tsel, o2, d2, jhit, tol).any()
    assert ct.traverse.launches == before   # CPU tensors: the plain walk


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name,leaf_size", CASES)
def test_wide_kernel_matches_wide_plain_on_card(cuda_device, name,  # noqa: F811
                                                leaf_size):
    sel, _ = case(name, leaf_size)
    wide = sel.wide.to(cuda_device)
    leaves = sel.leaves.to(cuda_device)
    nodes = sel.nodes.to(cuda_device)
    o, d = (x.to(cuda_device) for x in random_rays(sel, 4099, 17))
    first = ct.traverse_reference(nodes, leaves, sel.leaf_kind, o, d, None,
                                  EPS_B, EPS_P, True)
    o2, d2, skip = bounce(o, d, first)
    mask = (torch.rand(len(o), generator=torch.Generator().manual_seed(2))
            < 0.3).to(cuda_device)
    po, pd = park(o2, d2, mask)
    for qo, qd, sk in ((o, d, None), (o2, d2, skip), (po, pd, skip)):
        args = (leaves, sel.leaf_kind, qo, qd, sk, EPS_B, EPS_P, True)
        before = ct.traverse.launches
        got = ct.traverse(wide, *args)
        assert ct.traverse.launches == before + 1
        want = ct.traverse_wide_reference(wide, *args)
        binary = ct.traverse_reference(nodes, *args)
        torch.cuda.synchronize()
        for f in ct.TraverseOut._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        for f in ct.TraverseOut._fields[:-1]:
            assert torch.equal(getattr(got, f), getattr(binary, f)), f
        assert torch.equal(got.stats[:, 1], binary.stats[:, 1])


@pytest.mark.cuda
def test_wide_kernel_refuses_a_deep_tree_on_card(cuda_device):  # noqa: F811
    """On CUDA tensors a tree that needs more stack than the kernel has
    raises; nothing gives way to the plain walk or the binary kernel."""
    soup = soup_scene(4)
    sel = ct.CudaBVH(chain_bvh(ct.WIDE_STACK + 2), soup.triangles,
                     soup.materials, soup.n_prims)
    o = torch.zeros((8, 3), device=cuda_device)
    d = torch.tensor([[0.0, 0.0, 1.0]] * 8, device=cuda_device)
    before = ct.traverse.launches
    with pytest.raises(ValueError, match="stack"):
        ct.traverse(sel.wide.to(cuda_device), sel.leaves.to(cuda_device),
                    "tri", o, d, None, EPS_B, EPS_P)
    assert ct.traverse.launches == before
