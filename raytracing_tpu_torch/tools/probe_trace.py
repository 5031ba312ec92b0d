"""The ray entry's persistent grid and its full-frame ray batches, on one
CUDA card.

For each scene (``tools/profile_render.py``'s names: ``cover``,
``textured``, ``mesh:S``, ``meshes:K``, ``stress:N``): every pixel-centre
ray of a 1920-wide frame (as ``chip_smoke.py``'s trace phase and
``tools/ab_trees.py`` build them), depth 8, seed 7, through
``trace_rays_fused`` on tables packed from the mean ray origin. It records
the persistent grid the launch takes (``ops/trace.py::trace_grid``: blocks,
blocks per SM, SMs, rays per thread), the kernel's ms (CUDA events around
each of ``--reps`` calls after a warm-up call; median), the segments,
Mrays/s and the SHA-256 of the radiance.

With ``--define MACRO=V`` (repeatable) it also runs each measurement build
of ``csrc/regen.cu`` with that ``-D`` macro through the port's own wrapper
(``ops/_build.py::swapped``), in the order base, build, build, base for
each (ABBA on one card), and checks that every build gives the base
build's bits and segments.

Usage (on the card, from the repository root)::

    python -m raytracing_tpu_torch.tools.probe_trace --scene cover \\
        --scene stress:8192 [--define RT_SOME_MACRO=1] [--reps 10] \\
        [--out chiprun_out/probe_trace.json]

Prints one JSON object per (pass, build, scene) and, last, a summary: per
build and scene the median ms and Mrays/s over its passes, the grid, and
whether the bits were equal. Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import statistics
import sys

import torch

from .. import derive
from ..ops import _build
from ..ops import trace as rtrace
from . import profile_render

DEPTH = 8
SEED = 7


def pixel_rays(params, dev):
    """Every pixel-centre ray of the frame, padded by repeating it to a
    multiple of 1,024: (origins, directions) f32[n, 3] on ``dev``."""
    cam = derive(params, dev)
    w, h = cam.image_width, cam.image_height
    n = -(-w * h // 1024) * 1024
    k = torch.arange(n, device=dev) % (w * h)
    px, py = (k % w).float(), (k // w).float()
    d = (cam.pixel00[None] + px[:, None] * cam.pixel_delta_u[None]
         + py[:, None] * cam.pixel_delta_v[None] - cam.center[None])
    return cam.center[None].expand(n, 3).contiguous(), d.contiguous()


def batch(name: str, dev) -> tuple:
    """(tables, origins, directions) of the scene's 1920-wide frame."""
    params, scene = profile_render.build(name, 1920, 1, DEPTH)
    o, d = pixel_rays(params, dev)
    tables = rtrace.pack_scene(scene.to(dev), origin=o.mean(dim=0))
    return tables, o, d


def time_batch(tables, o, d, reps: int) -> dict:
    """One warm-up call, then ``reps`` calls timed by CUDA events."""
    rad, seg = rtrace.trace_rays_fused(tables, o, d, SEED, 0, DEPTH)
    torch.cuda.synchronize()
    ms = [profile_render.device_ms(
        lambda: rtrace.trace_rays_fused(tables, o, d, SEED, 0, DEPTH))[1]
        for _ in range(reps)]
    seg = int(seg)
    med = statistics.median(ms)
    return {"ms": ms, "median_ms": med, "segments": seg,
            "mrays_per_s": seg / med / 1e3,
            "radiance_sha256": hashlib.sha256(
                rad.cpu().numpy().tobytes()).hexdigest()}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="probe_trace", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--scene", action="append", required=True)
    ap.add_argument("--define", action="append", default=[],
                    help="a -D macro of a measurement build of regen.cu")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", help="also write the summary here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_trace: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = profile_render.card_line()
    _build.build_all(["regen"], [("regen", (d,)) for d in args.define])
    batches = {name: batch(name, dev) for name in args.scene}
    grids = {name: rtrace.trace_grid(t, o.shape[0])
             for name, (t, o, _) in batches.items()}
    order = [("base", ())]
    for d in args.define:
        order += [(d, (d,)), (d, (d,)), ("base", ())]
    runs: dict = {}
    for step, (label, defines) in enumerate(order):
        swap = (_build.swapped("regen", defines) if defines
                else contextlib.nullcontext())
        with swap:
            for name, (tables, o, d) in batches.items():
                r = time_batch(tables, o, d, args.reps)
                rec = {"pass": step, "build": label, "scene": name,
                       "rays": o.shape[0], **r, "grid": grids[name],
                       "card": card}
                print(json.dumps(rec), flush=True)
                runs.setdefault(label, {}).setdefault(name, []).append(r)
    base = {name: rs[0] for name, rs in runs["base"].items()}
    summary = {"card": card, "grids": grids, "builds": {}}
    for label, by_scene in runs.items():
        summary["builds"][label] = {
            name: {
                "median_ms": statistics.median(
                    m for r in rs for m in r["ms"]),
                "mrays_per_s": statistics.median(
                    r["mrays_per_s"] for r in rs),
                "segments": rs[0]["segments"],
                "bits_equal": all(
                    r["radiance_sha256"] == base[name]["radiance_sha256"]
                    and r["segments"] == base[name]["segments"]
                    for r in rs),
            } for name, rs in by_scene.items()}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    ok = all(v["bits_equal"] for b in summary["builds"].values()
             for v in b.values())
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
