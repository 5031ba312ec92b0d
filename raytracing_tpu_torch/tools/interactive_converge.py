"""Converge-while-interactive at the reference's shipped configuration.

Usage (from the repository root, on a machine with a CUDA card):

  python -m raytracing_tpu_torch.tools.interactive_converge \\
      [--width 1200] [--spp 2] [--depth 8] [--orbit-frames 60] \\
      [--converge-spp 64] [--pipeline 2] [--out converge.png] \\
      [--cull-order] [--device cuda]

Drives the real ``InteractiveSession`` on ``data/config/world.config.json``
(1200 wide, depth 8) through two phases, after a warm-up motion frame and
idle frame (which also build the kernel):

1. orbit: one orbit keystroke a frame, so the camera moves and the
   accumulation restarts every frame: frames per second;
2. idle: no keys, every frame folds more samples into the held pose until
   ``--converge-spp``: frames per second, seconds to 8 spp (the shipped
   configuration's quality) and to the target, each counted when the
   frame is presented.

It prints one JSON line with the card's name and power limit (``nvidia-smi``)
and writes the converged preview to ``--out``. ``--cull-order`` adds the
cost of the packed tables' stale cull order: CUDA-event milliseconds of 8
accumulating 4-spp frames at the first pose, at a pose orbited 90 degrees
with the first pose's tables, and there with tables packed from the new
pose (the images must be byte-equal), for the world and ``stress:8192``.
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from .. import Renderer, build_world, derive, load_world
from ..ops import trace as rtrace
from ..runtime.interactive import InteractiveSession, OrbitState, _orbit_from_params
from . import profile_render

WORLD = (pathlib.Path(__file__).resolve().parents[2]
         / "data" / "config" / "world.config.json")


def world(width: int, spp: int, depth: int):
    """(params, scene) of the shipped world at ``width``."""
    w = load_world(WORLD)
    params = dataclasses.replace(
        w.camera, image_width=width, samples_per_pixel=spp, max_depth=depth
    )
    _, scene = build_world(dataclasses.replace(w, camera=params))
    return params, scene


def measure(scene, params, *, spp: int = 2, converge_spp: int = 64,
            pipeline: int = 2, orbit_frames: int = 60, device="cuda",
            seed: int = 0):
    """Run the two phases; returns (result dict, the session)."""
    s = InteractiveSession(
        scene, params, seed=seed, device=device, spp=spp,
        converge_spp=converge_spp, pipeline=pipeline, stream=io.StringIO(),
    )
    t0 = time.perf_counter()
    s.step("d")
    s.step()
    s.flush()
    warmup = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(orbit_frames):
        s.step("d")
        assert s.samples_at_pose == spp  # motion resets the accumulation
    s.flush()
    orbit_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    t_to_8 = None
    climb = []
    while not s.converged:
        s.step()
        climb.append(s.samples_at_pose)
        if t_to_8 is None and s.samples_at_pose >= 8:
            s.flush()  # counted when presented
            t_to_8 = time.perf_counter() - t0
    s.flush()
    converge_s = time.perf_counter() - t0
    assert climb == sorted(climb) and climb[-1] == converge_spp, climb
    cam = s.renderer.camera
    return {
        "config": f"{cam.image_width}x{cam.image_height}@{spp}spp "
                  f"depth{params.max_depth} converge{converge_spp}",
        "pipeline": pipeline,
        "fps_orbit": orbit_frames / orbit_s,
        "fps_idle": len(climb) / converge_s,
        "s_to_8spp": t_to_8,
        "s_to_converge": converge_s,
        "idle_frames": len(climb),
        "warmup_s": warmup,
    }, s


def _frames_ms(r: Renderer, frames: int, spp: int) -> tuple[float, np.ndarray]:
    """CUDA-event ms of ``frames`` accumulating frames from a fresh pose
    (after one warm-up frame), and the image."""
    r.frame_accum_reset()
    r.render_frame_accum(spp=spp)
    r.frame_accum_reset()
    (dev, _), ms = profile_render.device_ms(
        lambda: r.render_frame_accum(spp=spp), frames)
    return ms * frames, r.fetch_image(dev)


def cull_order(scene, params, *, frames: int = 8, spp: int = 4,
               device="cuda") -> dict:
    """Accumulating frames at the first pose, at a pose orbited 90 degrees
    with the first pose's tables (stale cull order), and there re-packed."""
    r = Renderer(scene, params, device=device)
    first, _ = _frames_ms(r, frames, spp)
    o = _orbit_from_params(params)
    o = OrbitState(o.azimuth + math.pi / 2, o.elevation, o.distance, o.lookat)
    moved = dataclasses.replace(params, lookfrom=o.lookfrom(), lookat=o.lookat)
    r.params, r.camera = moved, derive(moved)
    stale, img_stale = _frames_ms(r, frames, spp)
    r._tables = rtrace.pack_scene(r.scene, origin=r._cam_host[9:12])
    repacked, img_repacked = _frames_ms(r, frames, spp)
    if not np.array_equal(img_stale, img_repacked):
        raise AssertionError("stale and re-packed cull order differ in bits")
    return {
        "culled": r._tables.sph_bounds is not None
        or r._tables.tri_bounds is not None,
        "frames": frames, "spp": spp,
        "first_pose_ms": first, "orbited_stale_ms": stale,
        "orbited_repacked_ms": repacked,
    }


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--width", type=int, default=1200)
    ap.add_argument("--spp", type=int, default=2, help="samples a frame")
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--orbit-frames", type=int, default=60)
    ap.add_argument("--converge-spp", type=int, default=64)
    ap.add_argument("--pipeline", type=int, default=2,
                    help="preview copies in flight (0 = synchronous)")
    ap.add_argument("--out", help="write the converged preview here")
    ap.add_argument("--cull-order", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("interactive_converge: CUDA is not available", file=sys.stderr)
        return 1
    params, scene = world(args.width, args.spp, args.depth)
    result, session = measure(
        scene, params, spp=args.spp, converge_spp=args.converge_spp,
        pipeline=args.pipeline, orbit_frames=args.orbit_frames,
        device=args.device,
    )
    if args.out:
        from ..utils import png

        png.write_png(args.out, session.flush())
    if args.cull_order:
        from .profile_render import build

        result["cull_order"] = {
            "world": cull_order(*world(args.width, 4, args.depth)),
            "stress:8192": cull_order(*build("stress:8192", args.width, 4,
                                             args.depth)),
        }
    if args.device.startswith("cuda"):
        result["card"] = card_line()
    print(json.dumps({"metric": "interactive_converge", **result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
