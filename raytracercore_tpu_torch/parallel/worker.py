"""One rank of a sharded render (counterpart of
``scripts/multihost_worker.py``): initialise the process group, render a
scene sharded over the ranks, gather the film, and rank 0 writes it::

    python -m raytracercore_tpu_torch.parallel.worker RANK WORLD INIT_FILE \
        OUT.npz [--device cpu|cuda] [--backend gloo|nccl] \
        [--scene cornell|mesh-722] [--size N] [--recursion N] \
        [--passes N] [--seed N] [--prims N]

Start one process per rank with the same ``INIT_FILE`` (a path to a file
that does not exist yet: the ranks meet through it).  ``--prims N`` splits
the triangle table over ``N`` ranks
(:func:`.shard.make_prims_sharded_render_pass`), the remaining ranks split
the image rows.  The scenes are built in
memory: ``cornell`` from the text below, ``mesh-722`` from
:func:`..scene.meshgen.make_mesh_scene` (nine icospheres over a floor,
its light made two-sided so that it lights them).
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib

import numpy as np
import torch
import torch.distributed as dist

# A Cornell-class scene in the reference's text format (an inverted room of
# differently coloured walls, an emissive light box, a rotated diffuse cube,
# a diffuse sphere, a glass ellipsoid, a mirror sphere and one two-sided
# plane): the scene of chip_smoke.py and of the port's tests.
CORNELL_SCENE = """
size 700 700
recursion 10
background 0 0 0 1
ambient color .03 .03 .04
camera 0 2 6.5  0 1.8 0  0 1 0  45
camera 2.5 3 6  0 1.2 0  0 1 0  50

# Room: single-sided inverted walls, each side its own colour.
twosided false
invert true
diffuse .75 .75 .75
cube 0 2 0  4 4 4 only +y -z
diffuse .75 .12 .12
instance -x
diffuse .12 .7 .15
instance +x
invert false

# Floor: a two-sided plane.
twosided true
diffuse .7 .7 .65
plane 0  0 1 0

# Light box at the ceiling.
emission 9 9 8
diffuse 0 0 0
cube 0 3.85 -.2  1.2 .3 1.2 not +y
emission 0 0 0

# Rotated diffuse cube.
diffuse .65 .6 .3
pushtransform
translate -1 .6 -.9
rotate 0 1 0 30
cube 0 0 0  1.2 1.2 1.2 all
poptransform

# Pedestal for the lens.
diffuse .5 .5 .55
cube .4 .25 .6  .9 .5 .9 not -y

# Diffuse sphere.
diffuse .25 .35 .8
sphere 1.3 .5 -1.2 .5

# Glass ellipsoid (a scaled sphere).
diffuse 0 0 0
specular .9 .9 .9
shininess 100000
refraction .9 .9 .9, 1.52
pushtransform
translate .4 1 .6
scale 1 .6 1
sphere 0 0 0 .5
poptransform

# Mirror sphere.
refraction off
shininess 1000000
sphere -1.1 .45 1.1 .45
"""

# The small scene of the JAX package's megakernel test (every branch of the
# bounce loop: emissive quad, two-sided plane, glass and mirror spheres),
# shared by chip_smoke.py and the port's tests.
FUSED_TEST_SCENE = """
size 16 16
recursion 4
ambient color 0.05 0.05 0.05
camera 0 1 4  0 1 0  0 1 0  60
emission 6 6 6
vertex -1 2.5 -1
vertex 1 2.5 -1
vertex -1 2.5 1
tri 0 1 2 mirrored
emission 0 0 0
diffuse .7 .6 .5
twosided true
plane -1  0 0 1
diffuse 0 0 0
specular .9 .9 .9
shininess 100000
refraction .9 .9 .9, 1.52
sphere -0.8 1 0.5 0.6
refraction off
shininess 1000000
sphere 0.8 1 0.5 0.6
"""

# The same scene in `ambient miss` mode with a smooth-shaded quad
# (vertex normals) in front of the back plane: the megakernel's other
# specializations (ambient-miss, smooth normals).
SMOOTH_SCENE = FUSED_TEST_SCENE.replace(
    "ambient color 0.05 0.05 0.05", "ambient miss") + """
diffuse .6 .6 .6
specular 0 0 0
shininess 100
vertexnormal -1.5 0 -.9  -.3 .3 1
vertexnormal 1.5 0 -.9  .3 .3 1
vertexnormal -1.5 2.5 -.9  -.3 -.2 1
vertexnormal 1.5 2.5 -.9  .3 -.2 1
trinormal 0 1 2
trinormal 1 3 2
"""


def load_scene(name: str, size: int, recursion: int, device):
    """``(SceneArrays, HostCamera)`` of a named scene at ``size`` x
    ``size`` on ``device``."""
    from ..scene import loader, meshgen
    from ..scene.types import freeze_scene

    if name == "cornell":
        host = loader.parse(CORNELL_SCENE)
        host.width = host.height = size
        host.recursion = recursion
        arrays, cam = freeze_scene(host, device=device), host.cameras[0]
    elif name == "mesh-722":
        arrays, cam, _ = meshgen.make_mesh_scene(
            grid=3, subdiv=1, recursion=recursion, width=size, height=size,
            device=device)
        two_sided = arrays.materials.two_sided.clone()
        two_sided[-1] = True
        arrays = dataclasses.replace(arrays, materials=dataclasses.replace(
            arrays.materials, two_sided=two_sided))
    else:
        raise ValueError(f"worker: unknown scene {name!r}")
    return arrays, cam


def render_film(mesh, arrays, camera, passes: int, seed: int):
    """``passes`` sharded passes of a placed scene on ``mesh``
    (prims-sharded when the mesh has a ``prims`` axis; the triangle table
    is padded here): this rank's block of the film."""
    from ..render.film import Film
    from .shard import (make_prims_sharded_render_pass,
                        make_sharded_render_pass, pad_triangles_for_prims,
                        place_film)

    if mesh.n_prims > 1:
        arrays = pad_triangles_for_prims(arrays, mesh.n_prims)
        render_pass = make_prims_sharded_render_pass(mesh)
    else:
        render_pass = make_sharded_render_pass(mesh)
    film = place_film(mesh, Film.create(arrays.height, arrays.width,
                                        device=mesh.device))
    for k in range(passes):
        film = render_pass(arrays, camera, film, seed, k)
    return film


def render(mesh, name: str, size: int, recursion: int, passes: int,
           seed: int):
    """``passes`` sharded passes of a named scene on ``mesh``, gathered: a
    numpy ``Film`` on every rank."""
    from ..scene.types import init_camera
    from .distributed import gather_film
    from .shard import place_scene

    arrays, cam = load_scene(name, size, recursion, mesh.device)
    camera = init_camera(cam, size, size, device=mesh.device)
    film = render_film(mesh, place_scene(mesh, arrays), camera, passes, seed)
    return gather_film(film, mesh)


def main(argv=None):
    from .distributed import init_distributed
    from .mesh import make_mesh

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("init_file")
    ap.add_argument("out")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    ap.add_argument("--scene", default="cornell",
                    choices=("cornell", "mesh-722"))
    ap.add_argument("--size", type=int, default=700)
    ap.add_argument("--recursion", type=int, default=10)
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prims", type=int, default=1)
    args = ap.parse_args(argv)
    if args.device == "cpu":
        torch.set_num_threads(1)
    init_distributed(num_processes=args.world, process_id=args.rank,
                     backend=args.backend, device=args.device,
                     init_method=pathlib.Path(args.init_file).resolve()
                     .as_uri())
    try:
        mesh = make_mesh(n_prims=args.prims, device=args.device)
        film = render(mesh, args.scene, args.size, args.recursion,
                      args.passes, args.seed)
        if args.rank == 0:
            np.savez(args.out, color_sum=film.color_sum,
                     samples=film.samples, misses=film.misses)
            print(f"saved {args.out} mean {float(film.color_sum.mean())}",
                  flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
