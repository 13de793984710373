"""Batched camera ray generation (counterpart of
``raytracercore_tpu.render.camera``).

Mirrors ``Raytracer.GetCameraRay`` (Raytracing/Raytracer.cs:262-282):
uniform sub-pixel jitter, the per-mode ``Camera.GetRay``
(FrustumCamera.cs:33-41 / OrthoCamera.cs:33-38), the image-plane origin
offset (Ray.Offset, Ray.cs:59) and thin-lens depth of field re-aimed at the
focal point.  :func:`camera_rays` takes the ``[R, 4]`` jitter tensor itself
so tests can feed both packages the same numbers; :func:`jittered_rays`
draws it from a generator.
"""

from __future__ import annotations

import torch

from ..core import vecmath as vm
from ..core.device import DEFAULT_DEVICE, resolve_device
from ..scene.types import CameraRT

TWO_PI = 6.283185307179586


def _get_ray(cam: CameraRT, x, y):
    """Camera.GetRay for fractional pixel coordinates [R]."""
    if cam.mode == 0:  # frustum
        off_x = cam.ax * ((x - cam.w2) / cam.w2)
        off_y = cam.ay * ((y - cam.h2) / cam.h2)
        d = (cam.look[None, :] + cam.side[None, :] * off_x[:, None]
             + cam.up[None, :] * off_y[:, None])
        d = vm.normalize(d)
        o = cam.position[None, :].expand(d.shape)
    else:  # ortho
        o = (cam.position[None, :]
             + cam.side[None, :] * ((x - cam.w2) * cam.ax)[:, None]
             + cam.up[None, :] * ((y - cam.h2) * cam.ay)[:, None])
        d = cam.look[None, :].expand(o.shape)
    return o, d


def camera_rays(cam: CameraRT, px, py, u):
    """Jittered (and optionally defocused) camera rays for pixel indices.

    Args:
      cam: render-ready camera.
      px, py: [R] integer pixel coordinates.
      u: [R, 4] uniforms in [0, 1): sub-pixel x, y, lens radius, lens angle.

    Returns: (ray_o [R, 3], ray_d [R, 3]).
    """
    dtype = cam.position.dtype
    sub_x = px.to(dtype) + u[:, 0]
    sub_y = py.to(dtype) + u[:, 1]

    o, d = _get_ray(cam, sub_x, sub_y)
    o = o + d * cam.image_plane

    # Depth of field (Raytracer.cs:269-279): sample the lens disc with
    # sqrt-radius, re-trace through the jittered pixel, aim at the focus
    # point of the undisturbed ray.
    focus = o + d * (cam.focal_length - cam.image_plane)
    dist = torch.sqrt(u[:, 2]) * cam.dof_amount
    angle = u[:, 3] * TWO_PI
    off_x = torch.cos(angle) * dist
    off_y = torch.sin(angle) * dist
    o2, d2 = _get_ray(cam, sub_x + off_x, sub_y + off_y)
    o2 = o2 + d2 * cam.image_plane
    d2 = vm.normalize(focus - o2)

    use_dof = cam.dof_amount != 0
    return torch.where(use_dof, o2, o), torch.where(use_dof, d2, d)


def jittered_rays(cam: CameraRT, px, py, generator: torch.Generator):
    """:func:`camera_rays` with the 4 uniforms per ray drawn from
    ``generator`` (on the generator's device)."""
    u = torch.rand((px.shape[0], 4), generator=generator,
                   device=generator.device, dtype=cam.position.dtype)
    return camera_rays(cam, px, py, u)


def center_rays(cam: CameraRT, px, py):
    """Deterministic rays through pixel centers — no jitter, no DoF.

    Returns: (ray_o [R, 3], ray_d [R, 3]) with the image-plane offset
    applied (Ray.Offset, Ray.cs:59).
    """
    dtype = cam.position.dtype
    o, d = _get_ray(cam, px.to(dtype) + 0.5, py.to(dtype) + 0.5)
    return o + d * cam.image_plane, d


def pixel_grid(width: int, height: int, device=DEFAULT_DEVICE):
    """Linear pixel index grids [H*W] in row-major (y, x) order."""
    device = resolve_device(device, "pixel_grid")
    ys, xs = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device),
                            indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)


def pixel_grid_tiled(width: int, height: int, tile: int,
                     device=DEFAULT_DEVICE):
    """Pixel index grids [H*W] in square-tile order: tiles row-major over
    the tile grid, pixels row-major within each tile (the JAX package's
    order, which traced tiles for its block-beam BVH walk): consecutive
    rays then come from one square patch of the image.  Raises
    ``ValueError`` unless ``tile`` divides ``width`` and ``height``;
    :func:`untile` restores row-major order."""
    if tile <= 0 or width % tile or height % tile:
        raise ValueError(f"pixel_grid_tiled: tile {tile} does not divide "
                         f"{width}x{height}")
    device = resolve_device(device, "pixel_grid_tiled")
    ar = [torch.arange(n, device=device)
          for n in (height // tile, width // tile, tile, tile)]
    ty, tx, iy, ix = torch.meshgrid(*ar, indexing="ij")
    return (tx * tile + ix).reshape(-1), (ty * tile + iy).reshape(-1)


def untile(a, width: int, height: int, tile: int):
    """A [H*W, ...] tensor in :func:`pixel_grid_tiled` order back in
    row-major order."""
    if tile <= 0 or width % tile or height % tile:
        raise ValueError(f"untile: tile {tile} does not divide "
                         f"{width}x{height}")
    rest = a.shape[1:]
    a = a.reshape(height // tile, width // tile, tile, tile, *rest)
    return a.transpose(1, 2).reshape(height * width, *rest)
