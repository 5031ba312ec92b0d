"""Command-line batch renderer of the port.

Usage:
  python -m raytracing_tpu_torch --config data/config/world.config.json \\
      --width 1200 --spp 8 --out render.png
  python -m raytracing_tpu_torch --gltf model.glb:2.0:0,1,-3 --out mesh.png

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
        description="PyTorch/CUDA batch path tracer (RTiOW sphere scenes, "
        "textured spheres, triangle meshes).",
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
    ap.add_argument(
        "--gltf",
        action="append",
        default=[],
        metavar="PATH[:SCALE[:TX,TY,TZ]]",
        help="add every mesh primitive of a .gltf/.glb asset to the --config "
        "scene (repeatable), with an optional uniform scale and "
        "translation, e.g. --gltf model.glb:2.0:0,1,-3",
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


def parse_gltf_spec(spec: str) -> tuple[str, float, tuple[float, float, float]]:
    """``PATH[:SCALE[:TX,TY,TZ]]`` -> (path, scale, translation); raises
    ValueError on a malformed spec."""
    parts = spec.rsplit(":", 2)
    path = parts[0]
    try:
        scale = float(parts[1]) if len(parts) > 1 else 1.0
        values = parts[2].split(",") if len(parts) > 2 else ["0", "0", "0"]
        if len(values) != 3:
            raise ValueError(f"{len(values)} translation values, need 3")
        translate = tuple(float(v) for v in values)
    except ValueError as e:
        raise ValueError(
            f"--gltf {spec!r}: expected PATH[:SCALE[:TX,TY,TZ]] ({e})"
        ) from None
    if not path:
        raise ValueError(f"--gltf {spec!r}: empty path")
    return path, scale, translate


def main(argv: list[str] | None = None) -> int:
    args = build_arg_parser().parse_args(argv)
    try:
        gltf_specs = [parse_gltf_spec(spec) for spec in args.gltf]
    except ValueError as e:
        print(f"raytracing_tpu_torch: {e}", file=sys.stderr)
        return 2
    if gltf_specs and args.stress:
        print("raytracing_tpu_torch: --gltf adds to the --config scene, not "
              "to --stress", file=sys.stderr)
        return 2

    from .utils import logging as rlogging

    log_path = None
    if args.log_dir:
        log_path = rlogging.setup(args.log_dir, console=False)
    log = rlogging.get_logger("cli")

    import torch

    from .runtime.renderer import Renderer
    from .scene import config as rconfig
    from .scene.gltf import GLTFError
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
        def extra(builder):
            for path, scale, translate in gltf_specs:
                builder.add_gltf(path, scale=scale, translate=translate)

        try:
            _, scene = rconfig.build_world(
                dataclasses.replace(world, camera=cam), extra=extra
            )
        except (OSError, GLTFError) as e:
            print(f"raytracing_tpu_torch: {e}", file=sys.stderr)
            return 2
    log.info(
        "scene %s: %d spheres, %d triangles; %dx%d @ %d spp depth %d on %s",
        source, scene.num_objects, scene.num_triangles, cam.image_width,
        cam.image_height, cam.samples_per_pixel, cam.max_depth, args.device,
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
