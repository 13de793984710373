"""Headless CLI (counterpart of ``raytracercore_tpu.tools.cli``).

Subcommands:
  render    progressive-render a scene to PNG
  bench     throughput measurement (samples/px/sec, the reference's metric)
  inspect   debug views: primitive-id map, BVH heat map, selection
            overlay, or the bounce listings of one pixel
  optimize  fit the material table to a target PNG (Adam on the train step)

Usage:
  python -m raytracercore_tpu_torch.tools.cli render scene.txt -o out.png
  python -m raytracercore_tpu_torch.tools.cli bench scene.txt --spp 8
  python -m raytracercore_tpu_torch.tools.cli inspect scene.txt -o ids.png \
      [--mode prims|heatmap] [--select prim:<id>|node:<i>]
  python -m raytracercore_tpu_torch.tools.cli inspect scene.txt \
      --pixel x,y [--traces 4]
  python -m raytracercore_tpu_torch.tools.cli optimize scene.txt \
      --target target.png --steps 100 -o materials.npz
All run on ``--device cuda`` (the default) or ``--device cpu``.  Scenes of
at most 64 table rows go through the megakernel, scenes of up to 768 rows
bounce by bounce through the select kernel, larger ones through the BVH
traversal kernel (``--accelerator auto|brute|bvh``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _load(args):
    from ..scene import loader

    scene = loader.from_file(args.scene)
    if args.size:
        scene.width = scene.height = args.size
    if args.recursion is not None:
        scene.recursion = args.recursion
    return scene


def cmd_render(args):
    from ..render import Renderer
    from .png import write_png

    scene = _load(args)
    r = Renderer(scene, device=args.device, seed=args.seed,
                 camera_index=args.camera, accelerator=args.accelerator)

    def status(st):
        print(f"spp={st['samples_per_px']} "
              f"{st['samples_per_px_per_sec']:.3f}/px/sec "
              f"progress={st['progress']:.1%}", file=sys.stderr)

    r.run(args.spp, status_cb=status if args.verbose else None)
    write_png(args.output, r.image(exposure=args.exposure))
    print(f"wrote {args.output} ({scene.width}x{scene.height}, "
          f"{args.spp} spp)")


def cmd_bench(args):
    import torch

    from ..render import Renderer

    scene = _load(args)
    r = Renderer(scene, device=args.device, seed=args.seed,
                 camera_index=args.camera, accelerator=args.accelerator)
    r.step(1)  # builds and loads the kernels on first use
    r.reset()
    t0 = time.perf_counter()
    r.step(args.spp)
    dt = time.perf_counter() - t0
    st = r.status()
    device = (torch.cuda.get_device_name(r.device)
              if r.device.type == "cuda" else "cpu")
    print(json.dumps({
        "samples_per_px_per_sec": st["samples_per_px_per_sec"],
        "paths_per_sec": st["paths_per_sec"],
        "elapsed_sec": dt,
        "spp": args.spp,
        "size": [scene.width, scene.height],
        "device": device,
        "route": r.route,
        "graphed": r.graphs,
    }))


def cmd_inspect(args):
    from .debug import (bvh_heatmap, primitive_id_map, selection_map,
                        trace_pixel)
    from .png import write_png

    scene = _load(args)
    if args.pixel:
        x, y = (int(v) for v in args.pixel.split(","))
        traces = trace_pixel(scene, x, y, camera_index=args.camera,
                             n_traces=args.traces, seed=args.seed,
                             device=args.device, accelerator=args.accelerator)
        for t_i, bounces in enumerate(traces):
            print(f"trace {t_i}:")
            for b in bounces:
                print("  " + b)
        return
    if args.select:
        img = selection_map(scene, args.select, camera_index=args.camera,
                            device=args.device, accelerator=args.accelerator)
    elif args.mode == "heatmap":
        img = bvh_heatmap(scene, camera_index=args.camera, device=args.device)
    else:
        img = primitive_id_map(scene, camera_index=args.camera,
                               device=args.device,
                               accelerator=args.accelerator)
    write_png(args.output, img)
    print(f"wrote {args.output}")


def cmd_optimize(args):
    import numpy as np
    import torch

    from ..bvh.builder import build_bvh
    from ..config import SELECT_MAX_PRIMS
    from ..diff import get_material_params
    from ..intersect.dispatch import (closest_hit, make_bvh_closest_fn,
                                      n_table_rows)
    from ..parallel import make_train_step
    from ..core.device import resolve_device
    from ..render.renderer import pass_seed
    from ..scene.types import freeze_scene, init_camera
    from .png import read_png

    device = resolve_device(args.device, "cli")
    scene = _load(args)
    arrays = freeze_scene(scene, device=device)
    camera = init_camera(scene.cameras[args.camera], scene.width,
                         scene.height, device=device)
    target = read_png(args.target)[..., :3].astype(np.float32) / 255.0
    target = torch.tensor(target, device=device) ** 2.2  # undo gamma

    params = get_material_params(arrays)
    optimizer = torch.optim.Adam(params.values(), lr=args.lr)
    closest_fn = closest_hit
    if n_table_rows(arrays) > SELECT_MAX_PRIMS:  # above the dense tier
        closest_fn = make_bvh_closest_fn(build_bvh(arrays), arrays,
                                         traversal="kernel")
    step = make_train_step(None, optimizer, closest_fn=closest_fn)
    for i in range(args.steps):
        loss = step(params, arrays, camera, target, pass_seed(args.seed, i))
        if i % 10 == 0:
            print(f"step {i} loss {float(loss):.6f}", file=sys.stderr)
    np.savez(args.output, **{k: v.detach().cpu().numpy()
                             for k, v in params.items()})
    print(f"wrote {args.output}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="raytracercore_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("scene")
        sp.add_argument("--camera", type=int, default=0)
        sp.add_argument("--size", type=int, default=None,
                        help="override square render size")
        sp.add_argument("--recursion", type=int, default=None)
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--device", default="cuda",
                        help="torch device: cuda (the kernels) or cpu")

    def accelerator(sp):
        sp.add_argument("--accelerator", default="auto",
                        choices=("auto", "brute", "bvh"),
                        help="closest-hit tier: brute (dense, up to 768 "
                        "table rows), bvh, or auto (bvh above 768)")

    sp = sub.add_parser("render")
    common(sp)
    accelerator(sp)
    sp.add_argument("-o", "--output", default="out.png")
    sp.add_argument("--spp", type=int, default=16)
    sp.add_argument("--exposure", type=float, default=1.0)
    sp.add_argument("-v", "--verbose", action="store_true")
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("bench")
    common(sp)
    accelerator(sp)
    sp.add_argument("--spp", type=int, default=8)
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser("inspect")
    common(sp)
    accelerator(sp)
    sp.add_argument("--pixel", default=None, help="x,y bounce trace")
    sp.add_argument("--traces", type=int, default=4)
    sp.add_argument("--mode", default="prims", choices=["prims", "heatmap"],
                    help="overlay: primitive-id map or BVH heat map")
    sp.add_argument("--select", default=None,
                    help="Selection mode: prim:<id> or node:<index>")
    sp.add_argument("-o", "--output", default="debug.png")
    sp.set_defaults(fn=cmd_inspect)

    sp = sub.add_parser("optimize")
    common(sp)
    sp.add_argument("--target", required=True, help="target PNG")
    sp.add_argument("--steps", type=int, default=100)
    sp.add_argument("--lr", type=float, default=1e-2)
    sp.add_argument("-o", "--output", default="materials.npz")
    sp.set_defaults(fn=cmd_optimize)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
