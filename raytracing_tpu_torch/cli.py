"""Command-line batch renderer of the port.

Usage:
  python -m raytracing_tpu_torch --config data/config/world.config.json \\
      --width 1200 --spp 8 --out render.png

Renders on the CUDA card by default (``--device cuda``) and exits non-zero
when CUDA is not available; ``--device cpu`` runs the kernels' plain PyTorch
versions instead, which is meant for small checks.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="raytracing_tpu_torch",
        description="PyTorch/CUDA batch path tracer (RTiOW sphere scenes).",
    )
    ap.add_argument(
        "--config",
        default="data/config/world.config.json",
        help="world/camera JSON (reference-compatible schema)",
    )
    ap.add_argument(
        "--stress",
        type=int,
        metavar="N",
        help="use the procedural N-sphere stress scene instead of --config",
    )
    ap.add_argument("--out", default="render.png", help="output PNG path")
    ap.add_argument("--width", type=int, help="override image width")
    ap.add_argument("--spp", type=int, help="override samples per pixel")
    ap.add_argument("--depth", type=int, help="override max bounce depth")
    ap.add_argument("--seed", type=int, default=0, help="RNG seed")
    ap.add_argument(
        "--device",
        default="cuda",
        help="torch device to render on (default cuda; cpu runs the plain "
        "PyTorch versions of the kernels)",
    )
    ap.add_argument(
        "--log-dir",
        help="write a timestamped structured log file",
    )
    ap.add_argument(
        "--quiet", action="store_true", help="suppress the summary line"
    )
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_arg_parser().parse_args(argv)

    from .utils import logging as rlogging

    log_path = None
    if args.log_dir:
        log_path = rlogging.setup(args.log_dir, console=False)
    log = rlogging.get_logger("cli")

    import torch

    from .runtime.renderer import Renderer
    from .scene import config as rconfig
    from .utils import png as rpng

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print(
            f"--device {args.device}: CUDA is not available "
            "(torch.cuda.is_available() is False); pass --device cpu to run "
            "the plain PyTorch versions of the kernels",
            file=sys.stderr,
        )
        return 2

    if args.stress:
        cam, scene = rconfig.make_world_stress(args.stress)
        source = f"stress:{args.stress}"
    else:
        world = rconfig.load_world(args.config)
        cam = world.camera
        source = args.config
    if args.width:
        cam = dataclasses.replace(cam, image_width=args.width)
    if args.spp:
        cam = dataclasses.replace(cam, samples_per_pixel=args.spp)
    if args.depth:
        cam = dataclasses.replace(cam, max_depth=args.depth)
    if not args.stress:
        _, scene = rconfig.build_world(dataclasses.replace(world, camera=cam))
    log.info(
        "scene %s: %d spheres; %dx%d @ %d spp depth %d on %s",
        source, scene.num_objects, cam.image_width, cam.image_height,
        cam.samples_per_pixel, cam.max_depth, args.device,
    )

    renderer = Renderer(scene, cam, seed=args.seed, device=args.device)
    image = renderer.render()
    rpng.write_png(args.out, image)
    log.info(
        "done: %s (%.2f s, %.1f Mrays/s, %d segments)",
        args.out, renderer.render_time(), renderer.mrays_per_sec(),
        renderer.segments_traced,
    )
    if not args.quiet:
        print(
            f"{args.out}: {image.shape[1]}x{image.shape[0]} "
            f"@ {renderer.samples_done} spp in {renderer.render_time():.2f} s "
            f"({renderer.mrays_per_sec():.1f} Mrays/s, "
            f"{renderer.segments_traced} segments, {args.device}"
            + (f"; log {log_path}" if log_path else "")
            + ")"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
