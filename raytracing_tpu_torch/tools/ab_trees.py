"""A/B of renders between source trees of the port, on one CUDA card.

Runs ``tools/profile_render.py`` from each tree (its own kernels, built
in the tree at first use) on the same scenes, once per fetch route, in
the given order of trees (``ABBA``: the first tree, the second twice,
the first again), so that both trees see the card in the same state. The
route is set through the environment as a user sets it: ``index`` is
the default route (``RT_GATHER=mxu``), ``radix`` is ``RT_GATHER=radix``.

Usage (on the card, from the repository root)::

    python -m raytracing_tpu_torch.tools.ab_trees \\
        --tree parent=PATH_TO_PARENT_TREE --tree change=. \\
        --scene cover --scene stress:8192 --scene mesh:3 \\
        --route index --route radix --order ABBA \\
        [--repeats 2] [--out ab.jsonl]

(a tree is any checkout of the repository, e.g. unpacked from ``git
archive``).

Prints one JSON object per (pass, tree, route, scene) and, last, a
summary object: render seconds of every repeat by tree, route and scene.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROUTES = {"index": {"RT_GATHER": "mxu", "RT_TWO_LEVEL_MXU": "1"},
          "radix": {"RT_GATHER": "radix", "RT_TWO_LEVEL_MXU": "1"}}


def run_tree(path: str, route: str, scenes: list[str], repeats: int) -> list:
    """profile_render's objects for ``scenes`` in the tree at ``path``."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "profile.jsonl")
        cmd = [sys.executable, "-m", "raytracing_tpu_torch.tools.profile_render",
               "--repeats", str(repeats), "--out", out]
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
    ap.add_argument("--out", help="also append each object here")
    args = ap.parse_args(argv)
    trees = [t.split("=", 1) for t in args.tree]
    summary: dict = {}
    for step, letter in enumerate(args.order):
        name, path = trees[ord(letter) - ord("A")]
        for route in args.route:
            for obj in run_tree(path, route, args.scene, args.repeats):
                rec = {"pass": step, "tree": name, "route": route, **obj}
                line = json.dumps(rec)
                print(line, flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(line + "\n")
                secs = [r["seconds"] for r in obj["repeats"]]
                (summary.setdefault(name, {}).setdefault(route, {})
                 .setdefault(obj["scene"], []).extend(secs))
    print(json.dumps({"render_seconds": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
