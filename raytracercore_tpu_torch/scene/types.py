"""Scene data model: host-side records and the frozen SoA device tensors.

Counterpart of ``raytracercore_tpu.scene.types``:

* **Host records** (plain dataclasses, numpy f64) produced by the loader,
  mutated while transforms/materials are baked — identical to the JAX
  package's.
* **``SceneArrays``** — a frozen SoA dataclass of torch tensors, one table
  per primitive type plus a unified material table indexed by global
  primitive id.  Padding rows carry ``prim_id == -1`` and are masked out by
  the intersectors.  ``.to(device)`` moves every tensor.
"""

from __future__ import annotations

import dataclasses
import functools
from collections.abc import Mapping
from typing import List, Optional

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from . import transforms as T

AIR_REFRACTIVE_INDEX = 1.000293  # Scene.cs:35


# ---------------------------------------------------------------------------
# Host-side records (numpy, f64)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Material:
    """Per-primitive material record (Primitive.cs:96-133).

    Defaults mirror the Primitive constructor (Primitive.cs:23-32):
    all colors black, shininess 100, refractive index 0.
    """

    emission: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    diffuse: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    specular: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    refraction: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    refractive_index: float = 0.0
    shininess: float = 100.0
    two_sided: bool = False
    invert: bool = False


@dataclasses.dataclass
class HostTriangle:
    """Triangle / mirrored-quad (Primitives/Triangle.cs:11-74).

    ``mirror=True`` turns the UV test into ``v <= 1`` making the primitive a
    parallelogram (Triangle.cs:118,167).  ``has_normals`` selects smooth
    shading (barycentric-interpolated vertex normals, Triangle.cs:209-224).
    """

    v0: np.ndarray
    v1: np.ndarray
    v2: np.ndarray
    mirror: bool = False
    has_normals: bool = False
    n0: Optional[np.ndarray] = None
    n1: Optional[np.ndarray] = None
    n2: Optional[np.ndarray] = None
    material: Material = dataclasses.field(default_factory=Material)

    def transform(self, forward: np.ndarray, inverse: np.ndarray) -> None:
        # Vertex.Transformed applies the forward matrix to positions and (for
        # smooth triangles) to normals, re-normalizing (Vertex.cs:25-28).
        self.v0 = T.transform_point(forward, self.v0)
        self.v1 = T.transform_point(forward, self.v1)
        self.v2 = T.transform_point(forward, self.v2)
        if self.has_normals:
            for attr in ("n0", "n1", "n2"):
                n = T.transform_dir(forward, getattr(self, attr))
                setattr(self, attr, n / np.linalg.norm(n))

    @property
    def edge01(self) -> np.ndarray:
        return self.v1 - self.v0

    @property
    def edge02(self) -> np.ndarray:
        return self.v2 - self.v0

    @property
    def face_normal(self) -> np.ndarray:
        n = np.cross(self.edge01, self.edge02)
        return n / np.linalg.norm(n)


@dataclasses.dataclass
class HostSphere:
    """Sphere with optional affine transform → ellipsoid
    (Primitives/Sphere.cs:10-48).

    ``obj_to_world`` is the reference's ``MatrixToObject`` and
    ``world_to_obj`` its ``MatrixToWorld`` (the reference names are inverted
    relative to what they do; we use direction-of-application names).
    """

    center: np.ndarray
    radius: float
    obj_to_world: np.ndarray = dataclasses.field(default_factory=T.identity)
    world_to_obj: np.ndarray = dataclasses.field(default_factory=T.identity)
    transformed: bool = False
    material: Material = dataclasses.field(default_factory=Material)

    def transform(self, forward: np.ndarray, inverse: np.ndarray) -> None:
        # Sphere.Transform (Sphere.cs:29-37).
        if not np.array_equal(forward, T.identity()):
            self.transformed = True
        self.obj_to_world = self.obj_to_world @ forward
        self.world_to_obj = inverse @ self.world_to_obj

    @property
    def normal_matrix(self) -> np.ndarray:
        return T.transpose3x3(self.world_to_obj)


@dataclasses.dataclass
class HostPlane:
    """Infinite plane {normal, origin_distance} (Primitives/Plane.cs:11-34)."""

    normal: np.ndarray
    origin_distance: float
    material: Material = dataclasses.field(default_factory=Material)

    def transform(self, forward: np.ndarray, inverse: np.ndarray) -> None:
        # Plane.Transform (Plane.cs:30-35).
        center = T.transform_point(
            forward, self.normal * self.origin_distance)
        n = T.transpose3x3(inverse)[:3, :3] @ self.normal
        self.normal = n / np.linalg.norm(n)
        self.origin_distance = float(center @ self.normal)


@dataclasses.dataclass
class HostCamera:
    """Camera definition (Cameras/Camera.cs:8-81).

    ``mode``: "frustum" (perspective pinhole) or "ortho".
    ``fov_or_size``: vertical FOV in radians (frustum) or size multiplier
    (ortho).  DoF state per SceneLoader.cs:203-225, 372-386.
    """

    mode: str
    position: np.ndarray
    look_at: np.ndarray
    up: np.ndarray
    fov_or_size: float
    image_plane: float = 0.0
    dof_amount: float = 0.0
    focal_length: float = 0.0


@dataclasses.dataclass
class HostScene:
    """Mutable scene under construction (Scene.cs:14-63)."""

    width: int = 0
    height: int = 0
    background_rgb: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    background_alpha: float = 0.0
    # None ⇒ "ambient miss": secondary misses count as miss samples
    # (the Placeholder sentinel, SceneLoader.cs:182-189).  Default black.
    ambient_rgb: Optional[np.ndarray] = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    recursion: int = 3
    debug_geom: bool = False
    air_refractive_index: float = AIR_REFRACTIVE_INDEX
    cameras: List[HostCamera] = dataclasses.field(default_factory=list)
    primitives: list = dataclasses.field(default_factory=list)

    def add_primitive(self, prim) -> None:
        self.primitives.append(prim)

    @property
    def triangles(self) -> List[HostTriangle]:
        return [p for p in self.primitives if isinstance(p, HostTriangle)]

    @property
    def spheres(self) -> List[HostSphere]:
        return [p for p in self.primitives if isinstance(p, HostSphere)]

    @property
    def planes(self) -> List[HostPlane]:
        return [p for p in self.primitives if isinstance(p, HostPlane)]


# ---------------------------------------------------------------------------
# Frozen device-side SoA (dataclasses of tensors)
# ---------------------------------------------------------------------------

class _Tensors:
    """Mixin: ``.to(device[, dtype])`` moves every tensor field
    (recursively), and casts the floating-point ones to ``dtype``."""

    def to(self, device, dtype=None):
        moved = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, _Tensors):
                v = v.to(device, dtype)
            elif isinstance(v, torch.Tensor):
                v = v.to(device, dtype if v.is_floating_point() else None)
            moved[f.name] = v
        return dataclasses.replace(self, **moved)


@dataclasses.dataclass(frozen=True)
class Materials(_Tensors):
    """Unified material table, row = global primitive id.

    The ``IsReflective ⇒ Shininess > 0`` gating of specular/refraction
    (Primitive.cs:111-128) is baked in at freeze time.
    """

    emission: torch.Tensor          # [N, 3]
    diffuse: torch.Tensor           # [N, 3]
    specular: torch.Tensor          # [N, 3]
    refraction: torch.Tensor        # [N, 3]
    refractive_index: torch.Tensor  # [N]
    shininess: torch.Tensor         # [N]
    two_sided: torch.Tensor         # [N] bool
    invert: torch.Tensor            # [N] bool


@dataclasses.dataclass(frozen=True)
class Triangles(_Tensors):
    v0: torch.Tensor       # [T, 3]
    e1: torch.Tensor       # [T, 3]  edge 0→1
    e2: torch.Tensor       # [T, 3]  edge 0→2
    normal: torch.Tensor   # [T, 3]  unit face normal
    n0: torch.Tensor       # [T, 3]  vertex normals (face normal when flat)
    n1: torch.Tensor       # [T, 3]
    n2: torch.Tensor       # [T, 3]
    mirror: torch.Tensor   # [T] bool — parallelogram UV rule
    smooth: torch.Tensor   # [T] bool — interpolate vertex normals
    prim_id: torch.Tensor  # [T] int32, -1 = padding


@dataclasses.dataclass(frozen=True)
class Spheres(_Tensors):
    center: torch.Tensor        # [S, 3] object-space center
    radius: torch.Tensor        # [S]
    obj_to_world: torch.Tensor  # [S, 4, 4]
    world_to_obj: torch.Tensor  # [S, 4, 4]
    normal_mat: torch.Tensor    # [S, 3, 3]
    transformed: torch.Tensor   # [S] bool
    prim_id: torch.Tensor       # [S] int32, -1 = padding


@dataclasses.dataclass(frozen=True)
class Planes(_Tensors):
    normal: torch.Tensor       # [P, 3]
    origin_dist: torch.Tensor  # [P]
    prim_id: torch.Tensor      # [P] int32, -1 = padding


@dataclasses.dataclass(frozen=True)
class CameraRT(_Tensors):
    """Render-ready camera: orthonormal basis + projection scalars, the
    output of Camera.InitRender (Camera.cs:54-63, FrustumCamera.cs:24-31,
    OrthoCamera.cs:22-31)."""

    position: torch.Tensor   # [3]
    look: torch.Tensor       # [3]
    side: torch.Tensor       # [3]
    up: torch.Tensor         # [3]
    w2: torch.Tensor         # scalar: width / 2
    h2: torch.Tensor         # scalar: height / 2
    ax: torch.Tensor         # frustum: tanFOVX2;  ortho: hMult
    ay: torch.Tensor         # frustum: -tanFOVY2; ortho: -vMult (sign baked)
    image_plane: torch.Tensor
    dof_amount: torch.Tensor
    focal_length: torch.Tensor
    mode: int = 0            # 0 = frustum, 1 = ortho


@dataclasses.dataclass(frozen=True)
class SceneArrays(_Tensors):
    """The frozen scene: everything the render step needs.

    Tensor fields hold the tables; the plain fields (``width`` …
    ``any_smooth``) are host metadata that select kernel specializations.
    """

    triangles: Triangles
    spheres: Spheres
    planes: Planes
    materials: Materials
    background_rgb: torch.Tensor        # [3]
    background_alpha: torch.Tensor      # scalar
    ambient_rgb: torch.Tensor           # [3] (zeros when ambient_is_miss)
    air_refractive_index: torch.Tensor  # scalar

    width: int = 0
    height: int = 0
    recursion: int = 3
    ambient_is_miss: bool = False
    debug_geom: bool = False
    n_prims: int = 0
    # True when ANY triangle interpolates vertex normals; the megakernel
    # drops the smooth-normal block when False (exact: with no smooth rows
    # the interpolation is the face normal).
    any_smooth: bool = True

    @functools.cached_property
    def fused_tables(self):
        """The packed tables the megakernel reads (render/fused.py:
        ``pack_scene``), built once per scene: the dataclass is frozen, so
        they cannot go stale, and ``.to(device)`` makes a new scene."""
        from ..render.fused import pack_scene
        return pack_scene(self)

    @functools.cached_property
    def material_rows(self):
        """The ``[N, 14]`` float32 material rows (render/fused.py:
        ``pack_materials``), built once per scene: the megakernel's and
        the trace route's shading kernel's table.  An infinite shininess
        stays infinite; the kernels and ``shade_bounce_reference`` shade
        it as they shade the f32 maximum that
        ``integrator._material_matrix`` puts there (an unperturbed
        normal, exactly)."""
        from ..render.fused import pack_materials
        return pack_materials(self.materials).detach().contiguous()

    @functools.cached_property
    def select_tables(self):
        """The select kernel's layout of the geometry tables
        (intersect/cuda_select.py: ``pack_select_tables``), built once per
        scene from :attr:`fused_tables`."""
        from ..intersect.cuda_select import pack_select_tables
        return pack_select_tables(self.fused_tables[:6])

    def with_materials(self, materials: "Materials") -> "SceneArrays":
        """The same scene with another material table.  The packed
        geometry tables (built once for this scene: the megakernel's and
        the select kernel's) carry over and only the ``[N, 14]`` material
        rows are packed again, so a train step that swaps the materials on
        every step does not repack the geometry."""
        from ..render.fused import with_material_rows

        new = dataclasses.replace(self, materials=materials)
        new.__dict__["fused_tables"] = with_material_rows(self.fused_tables,
                                                          materials)
        new.__dict__["select_tables"] = self.select_tables
        return new


def _pad_to(n: int, pad: int) -> int:
    if n == 0:
        return pad
    return ((n + pad - 1) // pad) * pad


def freeze_scene(scene: HostScene, device=DEFAULT_DEVICE,
                 dtype=torch.float32,
                 pad: int = 1) -> SceneArrays:
    """Convert a HostScene into padded SoA tensors on ``device``.

    Same padding and the same baked ``IsReflective`` gating as the JAX
    ``freeze_scene``: ``pad`` is the table-size granularity (1 keeps tables
    exact-sized), and empty tables still get one masked row.
    """
    device = resolve_device(device, "freeze_scene")
    def f(x):
        return torch.tensor(np.asarray(x, dtype=np.float64), dtype=dtype,
                            device=device)

    def b(x):
        return torch.tensor(np.asarray(x, dtype=bool), device=device)

    def i32(x):
        return torch.tensor(np.asarray(x, dtype=np.int32), device=device)

    prims = scene.primitives
    n = len(prims)

    # Material table in primitive-id order, with IsReflective gating baked.
    def stack3(attr):
        if not n:
            return np.zeros((0, 3))
        return np.stack([getattr(p.material, attr) for p in prims])

    shininess = np.array([p.material.shininess for p in prims],
                         dtype=np.float64)
    reflective = shininess > 0  # Primitive.cs:111
    specular = np.where(reflective[:, None], stack3("specular"), 0.0)
    refraction = np.where(reflective[:, None], stack3("refraction"), 0.0)

    materials = Materials(
        emission=f(stack3("emission")),
        diffuse=f(stack3("diffuse")),
        specular=f(specular),
        refraction=f(refraction),
        refractive_index=f(np.array(
            [p.material.refractive_index for p in prims], dtype=np.float64)),
        shininess=f(shininess),
        two_sided=b([p.material.two_sided for p in prims]),
        invert=b([p.material.invert for p in prims]),
    )

    # --- triangles -------------------------------------------------------
    tris = [(i, p) for i, p in enumerate(prims) if isinstance(p, HostTriangle)]
    tn = _pad_to(len(tris), pad)

    def tri_field(fn):
        out = np.zeros((tn, 3), dtype=np.float64)
        for j, (_, p) in enumerate(tris):
            out[j] = fn(p)
        return out

    tri_ids = np.full(tn, -1, dtype=np.int32)
    for j, (i, _) in enumerate(tris):
        tri_ids[j] = i
    # Degenerate padding rows get a non-zero normal to avoid NaNs.
    v0 = tri_field(lambda p: p.v0)
    e1 = tri_field(lambda p: p.edge01)
    e2 = tri_field(lambda p: p.edge02)
    nrm = tri_field(lambda p: p.face_normal)
    nrm[len(tris):] = (0.0, 0.0, 1.0)
    n0 = tri_field(lambda p: p.n0 if p.has_normals else p.face_normal)
    n1 = tri_field(lambda p: p.n1 if p.has_normals else p.face_normal)
    n2 = tri_field(lambda p: p.n2 if p.has_normals else p.face_normal)
    for a in (n0, n1, n2):
        a[len(tris):] = (0.0, 0.0, 1.0)

    mirror = np.zeros(tn, dtype=bool)
    smooth = np.zeros(tn, dtype=bool)
    for j, (_, p) in enumerate(tris):
        mirror[j] = p.mirror
        smooth[j] = p.has_normals

    triangles = Triangles(
        v0=f(v0), e1=f(e1), e2=f(e2), normal=f(nrm),
        n0=f(n0), n1=f(n1), n2=f(n2),
        mirror=b(mirror), smooth=b(smooth), prim_id=i32(tri_ids),
    )

    # --- spheres ---------------------------------------------------------
    sps = [(i, p) for i, p in enumerate(prims) if isinstance(p, HostSphere)]
    sn = _pad_to(len(sps), pad)
    s_center = np.zeros((sn, 3))
    s_radius = np.full(sn, 1.0)
    s_o2w = np.tile(np.eye(4), (sn, 1, 1))
    s_w2o = np.tile(np.eye(4), (sn, 1, 1))
    s_nm = np.tile(np.eye(3), (sn, 1, 1))
    s_tr = np.zeros(sn, dtype=bool)
    s_ids = np.full(sn, -1, dtype=np.int32)
    for j, (i, p) in enumerate(sps):
        s_center[j] = p.center
        s_radius[j] = p.radius
        s_o2w[j] = p.obj_to_world
        s_w2o[j] = p.world_to_obj
        s_nm[j] = p.normal_matrix[:3, :3]
        s_tr[j] = p.transformed
        s_ids[j] = i

    spheres = Spheres(
        center=f(s_center), radius=f(s_radius),
        obj_to_world=f(s_o2w), world_to_obj=f(s_w2o), normal_mat=f(s_nm),
        transformed=b(s_tr), prim_id=i32(s_ids),
    )

    # --- planes ----------------------------------------------------------
    pls = [(i, p) for i, p in enumerate(prims) if isinstance(p, HostPlane)]
    pn = _pad_to(len(pls), pad) if pls else pad
    p_norm = np.tile(np.array([0.0, 0.0, 1.0]), (pn, 1))
    p_dist = np.zeros(pn)
    p_ids = np.full(pn, -1, dtype=np.int32)
    for j, (i, p) in enumerate(pls):
        p_norm[j] = p.normal
        p_dist[j] = p.origin_distance
        p_ids[j] = i

    planes = Planes(normal=f(p_norm), origin_dist=f(p_dist),
                    prim_id=i32(p_ids))

    ambient_is_miss = scene.ambient_rgb is None
    ambient = np.zeros(3) if ambient_is_miss else scene.ambient_rgb

    return SceneArrays(
        triangles=triangles,
        spheres=spheres,
        planes=planes,
        materials=materials,
        background_rgb=f(scene.background_rgb),
        background_alpha=f(scene.background_alpha),
        ambient_rgb=f(ambient),
        air_refractive_index=f(scene.air_refractive_index),
        width=scene.width,
        height=scene.height,
        recursion=scene.recursion,
        ambient_is_miss=ambient_is_miss,
        debug_geom=scene.debug_geom,
        n_prims=n,
        any_smooth=bool(smooth.any()),
    )


def init_camera(cam: HostCamera, width: int, height: int,
                device=DEFAULT_DEVICE,
                dtype=torch.float32) -> CameraRT:
    """Build the render-ready camera basis (Camera.InitRender,
    Camera.cs:54-63) plus per-mode projection scalars."""
    device = resolve_device(device, "init_camera")
    pos = np.asarray(cam.position, dtype=np.float64)
    look_at = np.asarray(cam.look_at, dtype=np.float64)
    up0 = np.asarray(cam.up, dtype=np.float64)

    look = look_at - pos
    look = look / np.linalg.norm(look)
    side = np.cross(look, -up0)
    side = side / np.linalg.norm(side)
    up = np.cross(look, side)
    up = up / np.linalg.norm(up)
    side = -side

    w2 = width / 2.0
    h2 = height / 2.0

    if cam.mode == "frustum":
        tan_y = np.tan(cam.fov_or_size / 2.0)
        ax = tan_y * (width / float(height))
        ay = -tan_y
        mode = 0
    else:  # ortho — OrthoCamera.InitRender (OrthoCamera.cs:22-31)
        cam_w = 1.0 / w2
        cam_h = (1.0 / h2) * (height / float(width))
        ax = cam_w * cam.fov_or_size
        ay = -cam_h * cam.fov_or_size
        mode = 1

    def f(x):
        return torch.tensor(np.asarray(x, dtype=np.float64), dtype=dtype,
                            device=device)

    return CameraRT(
        position=f(pos), look=f(look), side=f(side), up=f(up),
        w2=f(w2), h2=f(h2), ax=f(ax), ay=f(ay),
        image_plane=f(cam.image_plane), dof_amount=f(cam.dof_amount),
        focal_length=f(cam.focal_length), mode=mode,
    )


# ---------------------------------------------------------------------------
# State carried across from the JAX package
# ---------------------------------------------------------------------------

def _field(d, name):
    return d[name] if isinstance(d, Mapping) else getattr(d, name)


def _tensors_from_numpy(cls, d, device, float_dtype):
    out = {}
    for f in dataclasses.fields(cls):
        a = np.asarray(_field(d, f.name))
        if a.dtype == np.bool_:
            out[f.name] = torch.tensor(a, device=device)
        elif np.issubdtype(a.dtype, np.integer):
            out[f.name] = torch.tensor(a.astype(np.int32), device=device)
        else:
            out[f.name] = torch.tensor(a, dtype=float_dtype, device=device)
    return cls(**out)


def scene_arrays_from_numpy(d, device=DEFAULT_DEVICE, dtype=torch.float32
                            ) -> SceneArrays:
    """Build a :class:`SceneArrays` from the JAX package's ``SceneArrays``
    fields given as numpy arrays (``d`` is a nested mapping or any object
    with those attributes, e.g. the JAX pytree with numpy leaves).  Values
    are copied bit for bit, so both packages compute on the same scene."""
    device = resolve_device(device, "scene_arrays_from_numpy")
    tables = {
        "triangles": Triangles, "spheres": Spheres, "planes": Planes,
        "materials": Materials}
    kw = {k: _tensors_from_numpy(cls, _field(d, k), device, dtype)
          for k, cls in tables.items()}
    for k in ("background_rgb", "background_alpha", "ambient_rgb",
              "air_refractive_index"):
        kw[k] = torch.tensor(np.asarray(_field(d, k)), dtype=dtype,
                             device=device)
    for k, cast in (("width", int), ("height", int), ("recursion", int),
                    ("ambient_is_miss", bool), ("debug_geom", bool),
                    ("n_prims", int), ("any_smooth", bool)):
        kw[k] = cast(_field(d, k))
    return SceneArrays(**kw)


def camera_from_numpy(d, device=DEFAULT_DEVICE,
                      dtype=torch.float32) -> CameraRT:
    """Build a :class:`CameraRT` from the JAX package's ``CameraRT`` fields
    given as numpy arrays (mapping or attributes, like
    :func:`scene_arrays_from_numpy`)."""
    device = resolve_device(device, "camera_from_numpy")
    kw = {f.name: torch.tensor(np.asarray(_field(d, f.name)), dtype=dtype,
                               device=device)
          for f in dataclasses.fields(CameraRT) if f.name != "mode"}
    return CameraRT(mode=int(_field(d, "mode")), **kw)
