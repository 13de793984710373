"""The plain path tracer the benchmark holds the program to.

Plain torch on ``[R]`` ray tensors, written from the semantics of the
reference renderer (``Raytracer.GetColor``, ``Raytracer.cs:65-246``) as
``raytracercore_tpu_torch`` states them, in the operation order of its
plain versions (``intersect/kernel_body.py``, ``intersect/dispatch.py``
``_tri_smooth_fixup``, ``render/integrator.py`` ``trace`` and
``shade_bounce_reference``, ``render/camera.py``, ``render/film.py``,
``core/color.py`` at commit 25c2873), so that float32 runs agree with the
program's kernels to the last bits on nearly every path.  Nothing of the
program is imported: every table, draw and ray is worked out again here.

The closest hit tests every ray against every table row in ``[R, N]``
grids.  A triangle or sphere table of more than ``CLUSTER`` rows is cut
into clusters of consecutive rows, each bounded by a box; a ray tests the
rows of the clusters whose box it enters, which is exact because the box
bounds every row of its cluster.  Ties go to the first table (triangles,
spheres, planes) and within it to the first row.

Everything computes in ``scene``'s dtype: float32 for the reference,
bfloat16 for its control.
"""

from __future__ import annotations

import numpy as np
import torch

from .tables import Scene

LUM = (0.299, 0.587, 0.114)
TWO_PI = 6.283185307179586
NEAR_ENOUGH = 1e-7       # behind-ray tolerance (float32)
POSITION_EPS = 1e-4      # skip-record position tolerance (relative)
F32_TINY = 1.1754943508222875e-38
CLUSTER = 256            # table rows a cluster holds
GRID_CELLS = 1 << 23     # (ray, row) cells one grid may hold


def pass_seed(seed: int, k: int) -> int:
    """The generator seed of pass (or step part) ``k`` of a run seeded
    ``seed``: a SeedSequence mix, low word first."""
    state = np.random.SeedSequence([seed, k]).generate_state(2, np.uint32)
    return int(state[0]) | (int(state[1]) << 32)


def preprocess(raw):
    """Raw uniforms ``[B, 5, R]`` → the 7 channels ``[B, 7, R]``."""
    t1 = raw[:, 1] * TWO_PI
    t2 = raw[:, 4] * TWO_PI
    return torch.stack([
        torch.log(torch.clamp(raw[:, 0], 1e-20, 1.0)),
        torch.cos(t1), torch.sin(t1), raw[:, 2],
        2.0 * torch.acos(torch.clamp(raw[:, 3], 0.0, 1.0)) / torch.pi,
        torch.cos(t2), torch.sin(t2)], dim=1)


def pass_draws(seed: int, k: int, n: int, bounces: int, pix, device,
               dtype):
    """Pass ``k``'s camera jitter ``[len(pix), 4]`` and raw uniforms
    ``[bounces, 5, len(pix)]`` at the pixels ``pix``: the whole frame's
    draws from a generator on ``device`` seeded ``pass_seed(seed, k)``
    (float32, as the renderer draws them), then taken at ``pix``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(pass_seed(seed, k))
    jitter = torch.rand((n, 4), generator=gen, device=device)
    raw = torch.rand((bounces, 5, n), generator=gen, device=device)
    return jitter[pix].to(dtype), raw[:, :, pix].to(dtype)


def camera_rays(cam: dict, px, py, u):
    """Frustum camera rays through pixels ``(px, py)`` jittered by ``u``
    ``[R, 4]`` (Camera.GetRay, Raytracer.GetCameraRay): ``(o3, d3)``."""
    dtype = cam["position"].dtype
    x = px.to(dtype) + u[:, 0]
    y = py.to(dtype) + u[:, 1]
    off_x = cam["ax"] * ((x - cam["w2"]) / cam["w2"])
    off_y = cam["ay"] * ((y - cam["h2"]) / cam["h2"])
    d = [cam["look"][k] + cam["side"][k] * off_x + cam["up"][k] * off_y
         for k in range(3)]
    n = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    d = tuple(c / n for c in d)
    o = tuple(cam["position"][k] + d[k] * cam["image_plane"]
              for k in range(3))
    return o, d


# -- closest hit ---------------------------------------------------------

def _skip(d3, skip, eps_pos):
    """Util.RayHitMatches as ``match(prim, px, py, pz, inside)``; the
    skip fields broadcast against the grid (``[R, 1]``)."""
    if skip is None:
        return None
    leaving = (d3[0] * skip["n"][0] + d3[1] * skip["n"][1]
               + d3[2] * skip["n"][2]) > 0
    kp = skip["p"]
    scale = 1.0 + kp[0] * kp[0] + kp[1] * kp[1] + kp[2] * kp[2]

    def match(prim, px, py, pz, inside):
        dx, dy, dz = px - kp[0], py - kp[1], pz - kp[2]
        close = dx * dx + dy * dy + dz * dz <= (eps_pos * eps_pos) * scale
        return ((skip["prim"] == prim) & (skip["prim"] >= 0) & close
                & (leaving ^ (inside == skip["inside"])))
    return match


def _tri_test(c, o, d, match, detail):
    """Möller–Trumbore over broadcast rays ``o, d`` and rows ``c`` (no
    coplanar branch, as the megakernel): ``(ok, t, extra)`` with, under
    ``detail``, position, normal and inside."""
    v0x, v0y, v0z = c["v0x"], c["v0y"], c["v0z"]
    e1x, e1y, e1z = c["e1x"], c["e1y"], c["e1z"]
    e2x, e2y, e2z = c["e2x"], c["e2y"], c["e2z"]
    sx = d[1] * e2z - d[2] * e2y
    sy = d[2] * e2x - d[0] * e2z
    sz = d[0] * e2y - d[1] * e2x
    det = e1x * sx + e1y * sy + e1z * sz
    fx, fy, fz = o[0] - v0x, o[1] - v0y, o[2] - v0z
    nz = det != 0
    inv = torch.where(nz, 1.0 / torch.where(nz, det, torch.ones_like(det)),
                      torch.zeros_like(det))
    u = inv * (fx * sx + fy * sy + fz * sz)
    ocx = fy * e1z - fz * e1y
    ocy = fz * e1x - fx * e1z
    ocz = fx * e1y - fy * e1x
    v = inv * (d[0] * ocx + d[1] * ocy + d[2] * ocz)
    t = inv * (e2x * ocx + e2y * ocy + e2z * ocz)
    inside_geo = inv < 0
    lim = torch.where(c["mirror"], v, u + v)
    ok = ((u >= 0) & (u <= 1) & (v >= 0) & (lim <= 1)
          & (t >= -NEAR_ENOUGH) & nz & (c["prim"] >= 0))
    inside = inside_geo ^ c["invert"]
    ok = ok & (c["two_sided"] | ~inside)
    hx = v0x + e1x * u + e2x * v
    hy = v0y + e1y * u + e2y * v
    hz = v0z + e1z * u + e2z * v
    if match is not None:
        ok = ok & ~match(c["prim"], hx, hy, hz, inside)
    if not detail:
        return ok, t, None
    flip = 1.0 - 2.0 * inside_geo.to(t.dtype)
    fn = (c["normalx"], c["normaly"], c["normalz"])
    nrm = tuple(a * flip for a in fn)
    # Smooth rows (the BVH route's fix-up, dispatch._tri_smooth_fixup).
    w2 = u + v
    n_int = [c["n0" + a] * u + c["n1" + a] * v + c["n2" + a] * w2
             for a in "xyz"]
    length = torch.sqrt(n_int[0] * n_int[0] + n_int[1] * n_int[1]
                        + n_int[2] * n_int[2])
    length = torch.maximum(length, torch.full_like(length, 1e-30))
    n_int = [a / length for a in n_int]
    fu = tuple(a * flip for a in nrm)  # the face normal again
    k2 = 2.0 * (n_int[0] * fu[0] + n_int[1] * fu[1] + n_int[2] * fu[2])
    sm = tuple(torch.where(inside_geo, n_int[k] - fu[k] * k2, n_int[k])
               for k in range(3))
    nrm = tuple(torch.where(c["smooth"], sm[k], nrm[k]) for k in range(3))
    return ok, t, ((hx, hy, hz), nrm, inside)


def _sph_test(c, o, d, match, detail):
    """Two-root transformed sphere (Sphere.cs:156-209): the near root
    where it survives the filters, else the far one; t in world space."""
    def m(k):
        return c[f"w{k}"]

    def w(k):
        return c[f"o{k}"]
    oo = [m(4 * r) * o[0] + m(4 * r + 1) * o[1] + m(4 * r + 2) * o[2]
          + m(4 * r + 3) for r in range(3)]
    dd = [m(4 * r) * d[0] + m(4 * r + 1) * d[1] + m(4 * r + 2) * d[2]
          for r in range(3)]
    dl = dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2]
    dlen = 1.0 / torch.sqrt(torch.clamp(dl, min=1e-30))
    dd = [a * dlen for a in dd]
    cx, cy, cz, rad = c["cx"], c["cy"], c["cz"], c["radius"]
    fx, fy, fz = oo[0] - cx, oo[1] - cy, oo[2] - cz
    b = -2.0 * (fx * dd[0] + fy * dd[1] + fz * dd[2])
    cc = fx * fx + fy * fy + fz * fz - rad * rad
    disc = b * b - 4.0 * cc
    has = disc >= 0
    radix = torch.sqrt(torch.where(has, disc, torch.zeros_like(disc)))
    any_hit = has & (radix >= -b) & (c["prim"] >= 0)
    inv_rad = 1.0 / rad

    def root(t_obj, valid, geo_inside):
        ts = torch.where(valid, t_obj, torch.zeros_like(t_obj))
        p = [oo[k] + dd[k] * ts for k in range(3)]
        wp = [w(4 * r) * p[0] + w(4 * r + 1) * p[1] + w(4 * r + 2) * p[2]
              + w(4 * r + 3) for r in range(3)]
        q = [(p[0] - cx) * inv_rad, (p[1] - cy) * inv_rad,
             (p[2] - cz) * inv_rad]
        nw = [m(r) * q[0] + m(4 + r) * q[1] + m(8 + r) * q[2]
              for r in range(3)]
        nl = 1.0 / torch.sqrt(torch.clamp(
            nw[0] * nw[0] + nw[1] * nw[1] + nw[2] * nw[2], min=1e-30))
        nw = [a * nl for a in nw]
        inside = (~c["invert"] if geo_inside else c["invert"]).expand(
            valid.shape)
        valid = valid & (c["two_sided"] | ~inside)
        if match is not None:
            valid = valid & ~match(c["prim"], *wp, inside)
        tw = (d[0] * (wp[0] - o[0]) + d[1] * (wp[1] - o[1])
              + d[2] * (wp[2] - o[2]))
        flip = -1.0 if geo_inside else 1.0
        return tw, valid, inside, wp, [a * flip for a in nw]

    near = root((b - radix) / 2.0, any_hit & (radix < b), False)
    far = root((b + radix) / 2.0, any_hit, True)
    vn = near[1]

    def pick(a, b_):
        return torch.where(vn, a, b_)
    t = pick(near[0], far[0])
    ok = vn | far[1]
    if not detail:
        return ok, t, None
    return ok, t, (tuple(pick(near[3][k], far[3][k]) for k in range(3)),
                   tuple(pick(near[4][k], far[4][k]) for k in range(3)),
                   pick(near[2], far[2]))


def _pln_test(c, o, d, match, detail):
    """Infinite plane with the coplanar case (Plane.cs:36-66)."""
    nx, ny, nz, dist0 = c["nx"], c["ny"], c["nz"], c["dist"]
    ray_dist = nx * o[0] + ny * o[1] + nz * o[2]
    denom = nx * d[0] + ny * d[1] + nz * d[2]
    nzd = denom != 0
    coplanar = ~nzd & (torch.abs(dist0 - ray_dist)
                       <= NEAR_ENOUGH * (1.0 + torch.abs(dist0)))
    tt = torch.where(nzd, (dist0 - ray_dist)
                     / torch.where(nzd, denom, torch.ones_like(denom)),
                     torch.zeros_like(denom))
    ahead = nzd & (tt >= -NEAR_ENOUGH)
    t = torch.where(coplanar, torch.zeros_like(tt), torch.abs(tt))
    inside_geo = coplanar | (denom > 0)
    ok = (coplanar | ahead) & (c["prim"] >= 0)
    inside = inside_geo ^ c["invert"]
    ok = ok & (c["two_sided"] | ~inside)
    h = (o[0] + d[0] * t, o[1] + d[1] * t, o[2] + d[2] * t)
    if match is not None:
        ok = ok & ~match(c["prim"], *h, inside)
    if not detail:
        return ok, t, None
    flip = 1.0 - 2.0 * inside_geo.to(t.dtype)
    return ok, t, (h, (nx * flip, ny * flip, nz * flip), inside)


_TESTS = {"tri": _tri_test, "sph": _sph_test, "pln": _pln_test}


def _rows(cols, idx):
    return {k: v[idx] for k, v in cols.items()}


def _col(x):
    return x[:, None]


def _best_dense(test, cols, o, d, skip):
    """Per ray: ``(t, row)`` of the closest surviving row of a small table
    (inf and -1 where none), in grid chunks."""
    n_rows = cols["prim"].shape[0]
    R = o[0].shape[0]
    step = max(1, GRID_CELLS // max(n_rows, 1))
    ts, rows = [], []
    for lo in range(0, R, step):
        sl = slice(lo, lo + step)
        oc = tuple(_col(a[sl]) for a in o)
        dc = tuple(_col(a[sl]) for a in d)
        sk = None if skip is None else _skip_rows(skip, sl)
        ok, t, _ = test({k: v[None, :] for k, v in cols.items()}, oc, dc,
                        _skip(dc, sk, POSITION_EPS), False)
        t = torch.where(ok & ~torch.isnan(t), t, torch.inf)
        tb, ib = torch.min(t, dim=1)
        ts.append(tb)
        rows.append(torch.where(torch.isfinite(tb), ib, -1))
    return torch.cat(ts), torch.cat(rows)


def _skip_rows(skip, idx):
    return {"prim": _col(skip["prim"][idx]), "inside": _col(
        skip["inside"][idx]), "p": tuple(_col(a[idx]) for a in skip["p"]),
        "n": tuple(_col(a[idx]) for a in skip["n"])}


class _Clusters:
    """Boxes over clusters of ``CLUSTER`` consecutive table rows, from the
    boxes of the ``n`` rows in use (per axis ``[n]``), widened by a slack;
    kept in float32."""

    def __init__(self, row_lo, row_hi):
        self.n = row_lo[0].shape[0]
        self.k = -(-self.n // CLUSTER)
        pad = self.k * CLUSTER - self.n
        self.lo, self.hi = [], []
        for lo, hi in zip(row_lo, row_hi):
            lo = torch.nn.functional.pad(lo, (0, pad), value=float("inf"))
            hi = torch.nn.functional.pad(hi, (0, pad), value=float("-inf"))
            lo = lo.view(self.k, CLUSTER).amin(1)
            hi = hi.view(self.k, CLUSTER).amax(1)
            slack = 1e-3 * (hi - lo) + 1e-4 * (lo.abs() + hi.abs()) + 1e-6
            self.lo.append((lo - slack).float())
            self.hi.append((hi + slack).float())

    def pairs(self, o, d):
        """``(ray, cluster)`` index pairs of the boxes each ray enters
        (in float32, from the ray's origin on)."""
        o = [a.float() for a in o]
        d = [a.float() for a in d]
        rays, clus = [], []
        R = o[0].shape[0]
        step = max(1, GRID_CELLS // self.k)
        for lo in range(0, R, step):
            sl = slice(lo, lo + step)
            t0 = torch.zeros((min(step, R - lo), 1), device=o[0].device)
            t1 = torch.full_like(t0, float("inf"))
            for a in range(3):
                inv = 1.0 / _col(d[a][sl])
                ta = (self.lo[a][None, :] - _col(o[a][sl])) * inv
                tb = (self.hi[a][None, :] - _col(o[a][sl])) * inv
                ta = torch.nan_to_num(ta, nan=-float("inf"))
                tb = torch.nan_to_num(tb, nan=float("inf"))
                t0 = torch.maximum(t0, torch.minimum(ta, tb))
                t1 = torch.minimum(t1, torch.maximum(ta, tb))
            r, k = torch.nonzero(t0 <= t1, as_tuple=True)
            rays.append(r + lo)
            clus.append(k)
        return torch.cat(rays), torch.cat(clus)


class TriangleClusters(_Clusters):
    """Boxes over the first ``n_rows`` triangle rows (those in use), in
    float32."""

    def __init__(self, tri: dict, n_rows: int):
        lo, hi = [], []
        for a in "xyz":
            v0 = tri["v0" + a][:n_rows].float()
            e1 = tri["e1" + a][:n_rows].float()
            e2 = tri["e2" + a][:n_rows].float()
            # A mirrored row spans the parallelogram up to v0 + e1 + e2.
            pts = torch.stack([v0, v0 + e1, v0 + e2, v0 + e1 + e2])
            lo.append(pts.amin(0))
            hi.append(pts.amax(0))
        super().__init__(lo, hi)


class SphereClusters(_Clusters):
    """Boxes over every sphere row, each worked out in float64 from the
    row's centre, radius and object-to-world matrix: around the matrix
    applied to the centre, the half-extent on world axis ``i`` is the
    radius times the length of row ``i`` of the matrix's 3x3 part, which
    bounds the ball's image exactly."""

    def __init__(self, sph: dict):
        o = [sph[f"o{k}"].double() for k in range(12)]
        c = [sph["c" + a].double() for a in "xyz"]
        r = sph["radius"].double()
        lo, hi = [], []
        for i in range(3):
            row = o[4 * i:4 * i + 4]
            centre = row[0] * c[0] + row[1] * c[1] + row[2] * c[2] + row[3]
            ext = r * torch.sqrt(row[0] * row[0] + row[1] * row[1]
                                 + row[2] * row[2])
            lo.append(centre - ext)
            hi.append(centre + ext)
        super().__init__(lo, hi)


def scene_clusters(scene: Scene) -> dict:
    """The clusters :func:`closest_hit` scans a scene's tables through:
    ``{"tri": TriangleClusters, "sph": SphereClusters}``, each only where
    its table has more than ``CLUSTER`` rows (smaller tables are scanned
    whole)."""
    out = {}
    if scene.n_tri > CLUSTER:
        out["tri"] = TriangleClusters(scene.tri, scene.n_tri)
    if scene.sph["prim"].shape[0] > CLUSTER:
        out["sph"] = SphereClusters(scene.sph)
    return out


def _best_clustered(clusters, test, cols, o, d, skip):
    """:func:`_best_dense` for a large table through its clusters, by the
    row test ``test``: the closest row of every (ray, cluster) pair, then
    per ray the closest pair, and among equally close pairs the lowest
    row."""
    R = o[0].shape[0]
    dev = o[0].device
    ray_i, clu_i = clusters.pairs(o, d)
    local = torch.arange(CLUSTER, device=dev)
    step = max(1, GRID_CELLS // CLUSTER)
    ts, rows = [], []
    for lo in range(0, ray_i.shape[0], step):
        r = ray_i[lo:lo + step]
        row = clu_i[lo:lo + step, None] * CLUSTER + local[None, :]
        row = torch.clamp(row, max=clusters.n - 1)  # pad repeats the last
        oc = tuple(_col(a[r]) for a in o)
        dc = tuple(_col(a[r]) for a in d)
        sk = None if skip is None else _skip_rows(skip, r)
        ok, t, _ = test(_rows(cols, row), oc, dc,
                        _skip(dc, sk, POSITION_EPS), False)
        t = torch.where(ok & ~torch.isnan(t), t, torch.inf)
        tb, ib = torch.min(t, dim=1)
        ts.append(tb)
        rows.append(torch.gather(row, 1, ib[:, None])[:, 0])
    tb = torch.cat(ts) if ts else torch.zeros(0, dtype=o[0].dtype,
                                              device=dev)
    rb = torch.cat(rows) if rows else torch.zeros(0, dtype=torch.int64,
                                                  device=dev)
    best_t = torch.full((R,), torch.inf, dtype=o[0].dtype, device=dev)
    best_t.scatter_reduce_(0, ray_i, tb, "amin")
    never = torch.iinfo(torch.int64).max
    cand = torch.where(torch.isfinite(tb) & (tb == best_t[ray_i]), rb,
                       never)
    best_row = torch.full((R,), never, dtype=torch.int64, device=dev)
    best_row.scatter_reduce_(0, ray_i, cand, "amin")
    return best_t, torch.where(best_row == never, -1, best_row)


def closest_hit(scene: Scene, o, d, skip, clusters=None):
    """The closest surviving hit of rays ``o, d`` (3-tuples of ``[R]``):
    ``{"prim", "found", "p", "n", "inside"}``; ``skip`` is the previous
    bounce's hit (None on bounce 0); ``clusters`` is
    :func:`scene_clusters`'s, or None to scan every table whole."""
    R = o[0].shape[0]
    best = {}
    for kind, test in _TESTS.items():
        cols = getattr(scene, kind)
        if clusters and kind in clusters:
            best[kind] = _best_clustered(clusters[kind], test, cols, o, d,
                                         skip)
        else:
            best[kind] = _best_dense(test, cols, o, d, skip)
    (t_tri, r_tri), (t_sph, r_sph), (t_pln, r_pln) = (
        best["tri"], best["sph"], best["pln"])
    is_tri = (r_tri >= 0) & ~(t_sph < t_tri) & ~(t_pln < t_tri)
    is_sph = ~is_tri & (r_sph >= 0) & ~(t_pln < t_sph)
    is_pln = ~is_tri & ~is_sph & (r_pln >= 0)
    recs = []
    match = _skip(d, skip, POSITION_EPS)
    for kind, rows in (("tri", r_tri), ("sph", r_sph), ("pln", r_pln)):
        cols = _rows(getattr(scene, kind), torch.clamp(rows, min=0))
        _, _, det = _TESTS[kind](cols, o, d, match, True)
        recs.append((cols["prim"], det))
    found = is_tri | is_sph | is_pln

    def pick(get):
        a, b, c = (get(r) for r in recs)
        return torch.where(is_tri, a, torch.where(is_sph, b, c))
    prim = torch.where(found, pick(lambda r: r[0]), -1)
    zero = torch.zeros(R, dtype=o[0].dtype, device=o[0].device)
    p = tuple(torch.where(found, pick(lambda r, k=k: r[1][0][k]), zero)
              for k in range(3))
    n = tuple(torch.where(found, pick(lambda r, k=k: r[1][1][k]), zero)
              for k in range(3))
    inside = found & pick(lambda r: r[1][2])
    return {"prim": prim, "found": found, "p": p, "n": n, "inside": inside}


# -- shading -------------------------------------------------------------

def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _where3(c, a, b):
    return tuple(torch.where(c, a[k], b[k]) for k in range(3))


def _safe_sqrt(x):
    return torch.sqrt(torch.maximum(x, torch.full_like(x, 1e-20)))


def _horizon(pole, z, ct, st):
    """CreateHorizon (Vec4D.cs:52-58): a point on the cone of height
    ``z`` around unit ``pole`` at azimuth cos/sin ``ct, st``."""
    cx, cy = pole[1], -pole[0]
    sq = cx * cx + cy * cy
    good = sq > F32_TINY
    inv = 1.0 / torch.sqrt(torch.where(good, sq, torch.ones_like(sq)))
    one, zero = torch.ones_like(cx), torch.zeros_like(cx)
    horiz = (torch.where(good, cx * inv, one),
             torch.where(good, cy * inv, zero), zero)
    s = _safe_sqrt(1.0 - z * z)
    base = tuple(pole[k] * z + horiz[k] * s for k in range(3))
    # Rodrigues rotation of base about pole.
    kxv = (pole[1] * base[2] - pole[2] * base[1],
           pole[2] * base[0] - pole[0] * base[2],
           pole[0] * base[1] - pole[1] * base[0])
    kd = _dot(pole, base) * (1.0 - ct)
    return tuple(base[k] * ct + kxv[k] * st + pole[k] * kd
                 for k in range(3))


def _lum(c):
    return LUM[0] * c[0] + LUM[1] * c[1] + LUM[2] * c[2]


def material_matrix(mats: dict):
    """``[N, 14]``: emission, diffuse, specular, refraction, ior,
    shininess (infinite shininess clamped to the float32 maximum)."""
    shin = mats["shininess"]
    shin = torch.where(torch.isinf(shin), torch.finfo(shin.dtype).max,
                       shin)
    return torch.cat([mats["emission"], mats["diffuse"], mats["specular"],
                      mats["refraction"], mats["refractive_index"][:, None],
                      shin[:, None]], dim=1)


def trace(scene: Scene, o, d, u, matf, clusters=None):
    """Paths from rays ``o, d`` (3-tuples of ``[R]``) with preprocessed
    uniforms ``u`` ``[B, 7, R]`` through the materials ``matf``
    (:func:`material_matrix`): ``(color 3-tuple, miss [R] bool, reached
    [R])``, ``reached`` the bounces each path reached.  The hits are taken
    without gradients; the shading is differentiable in ``matf``."""
    R = o[0].shape[0]
    dtype, dev = o[0].dtype, o[0].device
    zero = torch.zeros(R, dtype=dtype, device=dev)
    one = torch.ones_like(zero)
    tint = (one, one, one)
    result = (zero, zero, zero)
    alive = torch.ones(R, dtype=torch.bool, device=dev)
    miss = torch.zeros(R, dtype=torch.bool, device=dev)
    reached = torch.zeros(R, dtype=torch.int32, device=dev)
    prev = None
    gather_dtype = torch.float64 if dtype == torch.float32 else dtype
    matg = matf.to(gather_dtype)
    for i in range(scene.recursion + 1):
        if i % 3 == 0:  # renormalized every third bounce, the first too
            n = torch.sqrt(_dot(d, d))
            d = tuple(a / n for a in d)
        with torch.no_grad():
            hit = _hit_alive(scene, o, d, prev, alive, clusters)
        active = alive
        reached = reached + active.to(torch.int32)
        found = hit["found"]
        was_missed = active & ~found
        if i == 0 or scene.ambient_is_miss:
            miss = miss | was_missed
        else:
            result = _where3(was_missed, scene.ambient, result)
        alive = active & found
        m = matg[torch.clamp(hit["prim"], min=0).long()].to(dtype)
        emission = (m[:, 0], m[:, 1], m[:, 2])
        te = tuple(tint[k] * emission[k] for k in range(3))
        if i >= scene.recursion:
            result = _where3(alive, te, result)
            break
        diffuse = (m[:, 3], m[:, 4], m[:, 5])
        spec = (m[:, 6], m[:, 7], m[:, 8])
        refr = (m[:, 9], m[:, 10], m[:, 11])
        ior, shin = m[:, 12], m[:, 13]
        nrm, inside = hit["n"], hit["inside"]
        ui = u[i]
        z = torch.where(torch.isinf(shin), one, torch.exp(ui[0] / shin))
        rough = _horizon(nrm, z, ui[1], ui[2])
        l_d, l_s, l_r, l_e = _lum(diffuse), _lum(spec), _lum(refr), \
            _lum(emission)
        cos = -_dot(rough, d)
        can_refract = ((l_r > 0) | (l_s > 0)) & (ior != 0) & (cos >= 0)
        air = scene.air
        ior_in = torch.where(inside, ior, air)
        ior_out = torch.where(inside, air, ior)
        safe_out = torch.where(ior_out == 0, one, ior_out)
        ratio = ior_in / safe_out
        sin_out = ratio * _safe_sqrt(1.0 - cos * cos)
        tir = sin_out >= 1.0
        cos_out = _safe_sqrt(1.0 - sin_out * sin_out)
        f_live = can_refract & ~tir
        cos_f = torch.where(f_live, cos, one)
        cos_out_f = torch.where(f_live, cos_out, one)
        rs = ((ior_out * cos_f) - (ior_in * cos_out_f)) / \
            ((ior_out * cos_f) + (ior_in * cos_out_f))
        rp = ((ior_in * cos_f) - (ior_out * cos_out_f)) / \
            ((ior_in * cos_f) + (ior_out * cos_out_f))
        fresnel = (rs * rs + rp * rp) / 2.0
        l_s = torch.where(f_live, l_s * fresnel, l_s)
        l_r = torch.where(f_live, l_r * (1.0 - fresnel), zero)
        total = l_d + l_s + l_r + l_e

        black = alive & (total <= 0)
        result = _where3(black, te, result)
        alive = alive & ~black

        rnd = ui[3] * total
        pick_refr = (l_r != 0) & (rnd - l_r <= 0)
        r2 = rnd - l_r
        pick_spec = ~pick_refr & (l_s != 0) & (r2 - l_s <= 0)
        r3 = r2 - l_s
        pick_diff = ~pick_refr & ~pick_spec & (l_d != 0) & (r3 - l_d <= 0)
        pick_emit = ~pick_refr & ~pick_spec & ~pick_diff

        refr_dir = tuple(rough[k] * (-cos_out) + (d[k] + rough[k] * cos)
                         * ratio for k in range(3))
        refr_tint = _where3(inside, (one, one, one), refr)
        k2 = 2.0 * cos
        spec_dir = tuple(d[k] + rough[k] * k2 for k in range(3))
        spec_ok = _dot(spec_dir, nrm) > 0
        diff_dir = _horizon(nrm, ui[4], ui[5], ui[6])

        terminal = alive & (pick_emit | (pick_spec & ~spec_ok))
        result = _where3(terminal, te, result)
        alive = alive & ~terminal

        out_dir = _where3(pick_refr, refr_dir,
                          _where3(pick_spec, spec_dir, diff_dir))
        new_tint = _where3(pick_refr, refr_tint,
                           _where3(pick_spec, spec, diffuse))
        gain = torch.maximum(total, one)
        new_tint = tuple(a * gain for a in new_tint)
        o = _where3(alive, hit["p"], o)
        d = _where3(alive, out_dir, d)
        tint = _where3(alive, tuple(tint[k] * new_tint[k]
                                    for k in range(3)), tint)
        keep = prev if prev is not None else {
            "prim": torch.full((R,), -1, dtype=torch.int32, device=dev),
            "p": (zero, zero, zero), "n": (zero, zero, zero),
            "inside": torch.zeros(R, dtype=torch.bool, device=dev)}
        prev = {"prim": torch.where(alive, hit["prim"], keep["prim"]),
                "p": _where3(alive, hit["p"], keep["p"]),
                "n": _where3(alive, nrm, keep["n"]),
                "inside": torch.where(alive, inside, keep["inside"])}
    return result, miss, reached


def _hit_alive(scene, o, d, prev, alive, clusters):
    """:func:`closest_hit` of the live rays, the no-hit record elsewhere."""
    R = alive.shape[0]
    idx = torch.nonzero(alive)[:, 0]
    dev, dtype = alive.device, o[0].dtype
    zero = torch.zeros(R, dtype=dtype, device=dev)
    out = {"prim": torch.full((R,), -1, dtype=torch.int32, device=dev),
           "found": torch.zeros(R, dtype=torch.bool, device=dev),
           "p": [zero.clone() for _ in range(3)],
           "n": [zero.clone() for _ in range(3)],
           "inside": torch.zeros(R, dtype=torch.bool, device=dev)}
    if idx.numel() == 0:
        return {k: tuple(v) if isinstance(v, list) else v
                for k, v in out.items()}
    skip = None if prev is None else {
        "prim": prev["prim"][idx], "inside": prev["inside"][idx],
        "p": tuple(a.detach()[idx] for a in prev["p"]),
        "n": tuple(a.detach()[idx] for a in prev["n"])}
    hit = closest_hit(scene, tuple(a.detach()[idx] for a in o),
                      tuple(a.detach()[idx] for a in d), skip, clusters)
    for key in ("prim", "found", "inside"):
        out[key][idx] = hit[key].to(out[key].dtype)
    for key in ("p", "n"):
        for k in range(3):
            out[key][k][idx] = hit[key][k]
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in out.items()}


# -- film ----------------------------------------------------------------

def tonemap_uint8(color_sum, samples, misses, background, background_alpha):
    """SampleSet.GetOutput and the reference's ``(int)(x * 255)``:
    ``[..., 4]`` uint8 from ``color_sum [..., 3]`` and the counts."""
    total = samples + misses
    no_samples = samples == 0
    mult = 1.0 / torch.clamp(samples, min=1.0)
    rgb = color_sum * mult[..., None]
    back_alpha = torch.where(total > 0, misses / torch.clamp(total, min=1.0),
                             torch.zeros_like(total))
    rgb = rgb + (background - rgb) * (back_alpha * background_alpha)[
        ..., None]
    alpha = 1.0 + (background_alpha - 1.0) * back_alpha
    rgb = torch.where(no_samples[..., None], background * 1.0, rgb)
    alpha = torch.where(no_samples, background_alpha, alpha)
    rgb = torch.clamp(torch.pow(torch.clamp(rgb, min=0.0), 1.0 / 2.2),
                      0.0, 1.0)
    alpha = torch.clamp(alpha, 0.0, 1.0)
    out = torch.clamp(rgb * 255.0, 0, 255).to(torch.uint8)
    a = torch.clamp(alpha * 255.0, 0, 255).to(torch.uint8)
    return torch.cat([out, a[..., None]], dim=-1)
