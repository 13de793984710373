"""Headless CLI (counterpart of ``raytracercore_tpu.tools.cli``).

Subcommands:
  render    progressive-render a scene to PNG
  bench     throughput measurement (samples/px/sec, the reference's metric)

Usage:
  python -m raytracercore_tpu_torch.tools.cli render scene.txt -o out.png
  python -m raytracercore_tpu_torch.tools.cli bench scene.txt --spp 8
Both run on ``--device cuda`` (the default) or ``--device cpu``.
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
                 camera_index=args.camera)

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
                 camera_index=args.camera)
    r.step(1)  # builds and loads the kernel on first use
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
    }))


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
                        help="torch device: cuda (the kernel) or cpu")

    sp = sub.add_parser("render")
    common(sp)
    sp.add_argument("-o", "--output", default="out.png")
    sp.add_argument("--spp", type=int, default=16)
    sp.add_argument("--exposure", type=float, default=1.0)
    sp.add_argument("-v", "--verbose", action="store_true")
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("bench")
    common(sp)
    sp.add_argument("--spp", type=int, default=8)
    sp.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
