"""A/B of renders between source trees of the port, on one CUDA card.

Runs ``tools/profile_render.py`` from each tree (its own kernels, built
in the tree at first use) on the same scenes, once per fetch route, in
the given order of trees (``ABBA``: the first tree, the second twice,
the first again), so that both trees see the card in the same state. The
route is set through the environment as a user sets it: ``index`` is
the default route (``RT_GATHER=mxu``), ``radix`` is ``RT_GATHER=radix``,
``windows`` the radix route at the two-level windows alone
(``RT_TWO_LEVEL_MXU=0``). ``--width`` and ``--spp`` set the renders'
size (default 1920 and 64; the images below stay 1080p @ 64).

It also renders, once per tree, each scene at 1920x1080 @ 64 spp, depth
8, seed 0 through that tree's ``Renderer`` and records the SHA-256 of the
image bytes and the segments, so that the trees' images are compared
byte for byte.

With ``--rays SCENE`` it also times, in each pass, a ray batch of the
scene in that tree: ``trace_rays_fused`` on every pixel-centre ray of a
1920-wide frame (as chip_smoke.py's trace phase builds them), depth 8,
seed 7, CUDA events around each of ``--ray-reps`` calls after a warm-up
call, with the SHA-256 of the radiance so that the trees' bits can be
compared; and the host microseconds a launch of each entry's wrapper
(``host_us``: 200 calls back to back on small batches, the host's clock
around the calls).

Usage (on the card, from the repository root)::

    python -m raytracing_tpu_torch.tools.ab_trees \\
        --tree parent=PATH_TO_PARENT_TREE --tree change=. \\
        --scene cover --scene stress:8192 --scene mesh:3 \\
        --route index --route radix --order ABBA \\
        [--repeats 2] [--rays cover --rays stress:8192] [--ray-reps 5] \\
        [--width 1920] [--spp 64] [--out ab.jsonl]

(a tree is any checkout of the repository, e.g. unpacked from ``git
archive``).

Prints one JSON object per (pass, tree, route, scene), per (pass, tree,
ray scene) and per (tree, image scene), and, last, a summary object:
render seconds of every repeat by tree, route and scene, ray-batch ms by
tree and scene, and whether every tree gave every ray batch and every
image the same bits (and the same segments).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROUTES = {"index": {"RT_GATHER": "mxu", "RT_TWO_LEVEL_MXU": "1"},
          "radix": {"RT_GATHER": "radix", "RT_TWO_LEVEL_MXU": "1"},
          "windows": {"RT_GATHER": "mxu", "RT_TWO_LEVEL_MXU": "0"}}


# Run inside a tree (its own package on sys.path): argv = reps, scenes.
_RAYS_CHILD = """
import hashlib, json, sys, time
import torch
import raytracing_tpu_torch as rtt
from raytracing_tpu_torch.ops import trace as rtrace
from raytracing_tpu_torch.tools import profile_render
dev = torch.device("cuda")
for name in sys.argv[2:]:
    params, scene = profile_render.build(name, 1920, 1, 8)
    cam = rtt.derive(params, dev)
    w, h = cam.image_width, cam.image_height
    n = -(-w * h // 1024) * 1024
    k = torch.arange(n, device=dev) % (w * h)
    px, py = (k % w).float(), (k // w).float()
    d = (cam.pixel00[None] + px[:, None] * cam.pixel_delta_u[None]
         + py[:, None] * cam.pixel_delta_v[None] - cam.center[None])
    o = cam.center[None].expand(n, 3).contiguous()
    d = d.contiguous()
    tables = rtrace.pack_scene(scene.to(dev), origin=o.mean(dim=0))
    rad, seg = rtrace.trace_rays_fused(tables, o, d, 7, 0, 8)
    torch.cuda.synchronize()
    # Events inline, not profile_render.device_ms: a parent tree may
    # predate that helper.
    ms = []
    for _ in range(int(sys.argv[1])):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        rtrace.trace_rays_fused(tables, o, d, 7, 0, 8)
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    # Host microseconds a launch: 200 calls back to back on 8 tiles at
    # depth 1 (trace) and on 1,024 slots at 1 spp, depth 1 (regen), the
    # host's clock around the calls alone.
    ow, dw = o[:8192].contiguous(), d[:8192].contiguous()
    cam_host = cam.as_vector().cpu()
    done = torch.zeros(1024, dtype=torch.int32, device=dev)
    calls = {
        "trace": lambda: rtrace.trace_rays_fused(tables, ow, dw, 7, 0, 1),
        "regen": lambda: rtrace.render_pixels_fused(
            tables, cam_host, slot_base=0, map_param=-(-w // 32), seed=0,
            sample_start=0, spp=1, max_depth=1, t_end=1, done=done,
            num_slots=1024),
    }
    host_us = {}
    for what, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        host_us[what] = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
    print(json.dumps({
        "rays_scene": name, "rays": n, "ms": ms, "segments": int(seg),
        "host_us": host_us,
        "radiance_sha256": hashlib.sha256(rad.cpu().numpy().tobytes())
        .hexdigest(), "card": profile_render.card_line()}))
"""


# Run inside a tree: argv = scenes.
_IMAGE_CHILD = """
import hashlib, json, sys
import raytracing_tpu_torch as rtt
from raytracing_tpu_torch.tools import profile_render
for name in sys.argv[1:]:
    params, scene = profile_render.build(name, 1920, 64, 8)
    r = rtt.Renderer(scene, params, seed=0, device="cuda")
    img = r.render()
    print(json.dumps({
        "image_scene": name, "segments": r.segments_traced,
        "image_sha256": hashlib.sha256(img.tobytes()).hexdigest(),
        "card": profile_render.card_line()}))
"""


def run_images(path: str, route: str, scenes: list[str]) -> list:
    """The image objects of ``scenes`` in the tree at ``path``."""
    env = {**os.environ, **ROUTES[route]}
    out = subprocess.run([sys.executable, "-c", _IMAGE_CHILD, *scenes],
                         cwd=path, env=env, check=True, capture_output=True,
                         text=True).stdout
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def run_rays(path: str, route: str, scenes: list[str], reps: int) -> list:
    """The ray-batch objects of ``scenes`` in the tree at ``path``."""
    env = {**os.environ, **ROUTES[route]}
    out = subprocess.run([sys.executable, "-c", _RAYS_CHILD, str(reps),
                          *scenes], cwd=path, env=env, check=True,
                         capture_output=True, text=True).stdout
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def run_tree(path: str, route: str, scenes: list[str], repeats: int,
             width: int = 1920, spp: int = 64) -> list:
    """profile_render's objects for ``scenes`` in the tree at ``path``."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "profile.jsonl")
        cmd = [sys.executable, "-m", "raytracing_tpu_torch.tools.profile_render",
               "--repeats", str(repeats), "--width", str(width), "--spp",
               str(spp), "--out", out]
        for s in scenes:
            cmd += ["--scene", s]
        env = {**os.environ, **ROUTES[route]}
        subprocess.run(cmd, cwd=path, env=env, check=True,
                       stdout=subprocess.DEVNULL)
        with open(out) as f:
            return [json.loads(line) for line in f if line.strip()]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="ab_trees", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--tree", action="append", required=True,
                    help="NAME=PATH; the first is A, the second B")
    ap.add_argument("--scene", action="append", required=True)
    ap.add_argument("--route", action="append", choices=sorted(ROUTES),
                    required=True)
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--rays", action="append", default=[],
                    help="also time this scene's ray batch in each pass")
    ap.add_argument("--ray-reps", type=int, default=5)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--out", help="also append each object here")
    args = ap.parse_args(argv)
    trees = [t.split("=", 1) for t in args.tree]
    summary: dict = {}
    ray_ms: dict = {}
    host_us: dict = {}
    shas: dict = {}
    images: dict = {}
    imaged: set = set()

    def emit(rec: dict) -> None:
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    for step, letter in enumerate(args.order):
        name, path = trees[ord(letter) - ord("A")]
        for route in args.route:
            for obj in run_tree(path, route, args.scene, args.repeats,
                                args.width, args.spp):
                emit({"pass": step, "tree": name, "route": route, **obj})
                secs = [r["seconds"] for r in obj["repeats"]]
                (summary.setdefault(name, {}).setdefault(route, {})
                 .setdefault(obj["scene"], []).extend(secs))
        if name not in imaged:
            imaged.add(name)
            for obj in run_images(path, args.route[0], args.scene):
                emit({"tree": name, "route": args.route[0], **obj})
                images.setdefault(obj["image_scene"], set()).add(
                    (obj["image_sha256"], obj["segments"]))
        if args.rays:
            for obj in run_rays(path, args.route[0], args.rays,
                                args.ray_reps):
                emit({"pass": step, "tree": name, "route": args.route[0],
                      **obj})
                (ray_ms.setdefault(name, {})
                 .setdefault(obj["rays_scene"], []).extend(obj["ms"]))
                for what, us in obj["host_us"].items():
                    host_us.setdefault(name, {}).setdefault(what,
                                                            []).append(us)
                shas.setdefault(obj["rays_scene"], set()).add(
                    obj["radiance_sha256"])
    print(json.dumps({
        "render_seconds": summary, "ray_batch_ms": ray_ms,
        "host_us_a_launch": host_us,
        "ray_bits_equal": {k: len(v) == 1 for k, v in shas.items()},
        "image_bits_equal": {k: len(v) == 1 for k, v in images.items()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
