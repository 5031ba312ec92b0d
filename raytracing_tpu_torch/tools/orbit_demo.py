"""Orbiting-camera demo: one frame a camera position over the shipped world.

Usage (from the repository root; the card by default):

  python -m raytracing_tpu_torch.tools.orbit_demo [--width 640] [--spp 4] \\
      [--frames 120] [--out-dir frames/] [--live] [--device cuda]

Every frame re-points the renderer's camera on a circle around the scene
and renders a low-spp frame in one kernel launch (``render_frame``), then
presents it: to numbered PNGs through the native frame pump
(``utils/native.py``; written directly where it is not available), to the
terminal as ANSI half-blocks (``--live``, from the device-side preview),
or both. Up to ``--max-inflight`` frames' copies are in flight while the
next frames launch (``HostCopies``); it prints the warm frames per second.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import math
import os
import sys
import time

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="data/config/world.config.json")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--orbit-radius", type=float, default=13.4)
    ap.add_argument("--out-dir", help="write frame_NNNN.png per frame")
    ap.add_argument("--live", action="store_true", help="ANSI terminal view")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-inflight", type=int, default=3,
                    help="frames whose copies are in flight while the next "
                    "frames launch (0 = synchronous)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("orbit_demo: CUDA is not available", file=sys.stderr)
        return 1

    from .. import Renderer, build_world, derive, load_world
    from ..runtime import display as rdisplay
    from ..runtime.interactive import HostCopies
    from ..runtime.renderer import RenderProgress, _slots_to_image
    from ..utils import native as rnative
    from ..utils import png

    w = load_world(args.config)
    params = dataclasses.replace(
        w.camera, image_width=args.width, samples_per_pixel=args.spp,
        max_depth=args.depth,
    )
    _, scene = build_world(dataclasses.replace(w, camera=params))
    renderer = Renderer(scene, params, seed=0, device=args.device)
    cam = renderer.camera
    pump = None
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        if rnative.available():
            pump = rnative.FramePump(os.path.join(args.out_dir, "frame_"),
                                     queue_depth=8)
    term = rdisplay.TerminalDisplay() if args.live else None
    copies = HostCopies(2 * (args.max_inflight + 1))
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    t_start = time.perf_counter()

    def emit(i, full, prev):
        if full is not None:
            img = _slots_to_image(HostCopies.wait(full), cam.image_width,
                                  cam.image_height)
            if pump is None or not pump.submit(img, i):
                # No pump, or its queue is full: write here, drop nothing.
                png.write_png(
                    os.path.join(args.out_dir, f"frame_{i:04d}.png"), img)
        if prev is not None:
            img = HostCopies.wait(prev)
            term(RenderProgress(
                samples_done=args.spp, samples_total=args.spp,
                pixels_count=renderer.pixels_count,
                segments_traced=renderer.segments_traced_ready,
                elapsed_s=time.perf_counter() - t_start,
                _preview=lambda im=img: im,
            ))

    elev = float(np.asarray(params.lookfrom, np.float64)[1])
    frame_times, pending = [], []
    try:
        for i in range(args.frames):
            theta = 2.0 * math.pi * i / args.frames
            look = (args.orbit_radius * math.cos(theta), elev,
                    args.orbit_radius * math.sin(theta))
            renderer.params = dataclasses.replace(params, lookfrom=look)
            renderer.camera = derive(renderer.params)
            t0 = time.perf_counter()
            if term is not None:
                dev, prev = renderer.render_frame_preview(spp=args.spp)
            else:
                dev, prev = renderer.render_frame(spp=args.spp), None
            full = copies.stage(dev) if args.out_dir else None
            prev = copies.stage(prev) if prev is not None else None
            pending.append(pool.submit(emit, i, full, prev))
            while len(pending) > args.max_inflight:
                pending.pop(0).result()
            frame_times.append(time.perf_counter() - t0)
        for f in pending:
            f.result()
    finally:
        pool.shutdown()
        if pump is not None:
            pump.close()
    if not frame_times:
        print("no frames requested")
        return 0
    total = time.perf_counter() - t_start
    warm = frame_times[1:] or frame_times
    fps = 1.0 / max(sum(warm) / len(warm), 1e-9)
    print(
        f"\n{args.frames} frames {cam.image_width}x{cam.image_height} "
        f"@ {args.spp} spp in {total:.2f} s -- {fps:.1f} fps warm "
        f"(first frame {frame_times[0]:.2f} s incl. the kernel build)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
