"""The megakernel's sweeps on the card: their SASS per swept row, and the
time of their parts on whole waves.

1. ``sass``: ``cuobjdump -sass`` of the built ``regen.cu`` and
   ``segment_split.cu`` libraries. In each kernel of ``SASS_KERNELS`` the
   sweep loops are the innermost loops (a backward branch and the
   instructions from its target to it) that hold one ``MUFU.RSQ`` a swept
   row (the sphere key's square root) and read the rows from shared
   (``LDS``) or global (``LDG``) memory. Per loop: the rows it sweeps per
   trip (its ``MUFU.RSQ`` count), and its instructions per row by opcode
   (``NOP`` left out; ``LDS`` and ``LDG`` keep their width); the main loop
   is the largest over shared memory (a sweep that met a root outside
   ``fast_root``'s range sweeps again in a loop of one row a trip).
   The triangle sweep's loops (``TRI_SASS_KERNELS``: the flat and
   two-level rules in the staged body of both entries and in the chunked
   body) hold one ``MUFU.RCP`` a row (the key's reciprocal) and no
   ``SHFL``; per loop, in address order: rows a trip, instructions and
   opcodes per row, and whether it branches out (``CALL``, ``BSSY``,
   ``BSYNC``: the loop of one row a trip that sweeps again with the IEEE
   divide may; a main loop of four may not).
2. ``parts``: one whole-budget wave of each scene (the ``Renderer``'s own
   tables and wave arguments over every slot, 1920x1080, depth 8) under
   measurement builds of ``regen.cu``: ``-DRT_SWEEP_PROBE=1`` copies every
   chunk of the chunked body twice, ``-DRT_SWEEP_PROBE=2`` sweeps every
   chunk (or the staged table) twice. Every build gives the same bits (the
   tool checks radiance, done and segments). The time a build adds is the
   cost of the part it doubles plus the stalls the doubling exposes, so
   it bounds the part's share from above; the rest (gate, barriers and
   the idle lanes at them, the fetch, the shade, the bookkeeping) is the
   full build's time less both, and goes negative where the two bounds
   overlap (stress:8192's wave). Builds run in the order full, stage,
   sweep, sweep, stage, full, each ``reps`` times; times are CUDA events.
3. ``tri_parts``: the same on the triangle scenes (mesh:3, meshes:4,
   mesh:5) under ``-DRT_SWEEP_PROBE=3`` (every loop of the triangle sweep
   twice) and ``-DRT_SWEEP_PROBE=4`` (every triangle row it sweeps loaded
   twice): what each adds to the full build's wave (``added_ms``).

Usage (on the card; prints one JSON object)::

    python -m raytracing_tpu_torch.tools.probe_sweep [--sass] [--parts]
        [--tri-parts] [--scene stress:8192 --scene stress:2048
        --scene cover] [--tri-scene mesh:3 ...] [--spp 8] [--reps 3]
        [--out probe_sweep.json] [--dump DIR]

(no mode: ``--sass`` and ``--parts``).
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import sys

import torch

from .. import Renderer
from ..ops import _build
from ..ops import trace as rtrace
from . import profile_render, sass

# The kernels whose sweep loops are counted: library and a pattern of the
# mangled name. regen: the cover variant (staged body); regen_chunked: the
# flat rule over chunks (stress:2048); regen_sph2l: the two-level rule
# (stress:8192); segment_full: the segment probe's full variant.
SASS_KERNELS = {
    "segment_full": ("segment_split", r"segment_splitILi0E"),
    "regen": ("regen", r"regen_stagedILb0ELi0EE"),
    "regen_chunked": ("regen", r"regen_chunkedILb0ELb0ELi0EE"),
    "regen_sph2l": ("regen", r"regen_chunkedILb1ELb0ELi0EE"),
}
PROBE_BUILDS = {"full": (), "stage_x2": ("RT_SWEEP_PROBE=1",),
                "sweep_x2": ("RT_SWEEP_PROBE=2",)}
SCENES = ("stress:8192", "stress:2048", "cover")
# The triangle sweep's loops: the flat rule (golden mesh, mesh:2) and the
# two-level rule (mesh:3, glTF) in the staged body of both entries, and
# both rules in the chunked body (the 4,200-sphere scenes).
TRI_SASS_KERNELS = {
    "regen_tri_flat": ("regen", r"regen_stagedILb0ELi1EE"),
    "regen_tri_2l": ("regen", r"regen_stagedILb0ELi2EE"),
    "trace_tri_flat": ("regen", r"trace_stagedILb0ELi1EE"),
    "trace_tri_2l": ("regen", r"trace_stagedILb0ELi2EE"),
    "regen_chunked_tri_flat": ("regen", r"regen_chunkedILb0ELb0ELi1EE"),
    "regen_chunked_tri_2l": ("regen", r"regen_chunkedILb0ELb0ELi2EE"),
}
# Triangle parts: -DRT_SWEEP_PROBE=3 runs each loop of the triangle sweep
# twice, -DRT_SWEEP_PROBE=4 loads each triangle row it sweeps twice.
TRI_PROBE_BUILDS = {"full": (), "tri_x2": ("RT_SWEEP_PROBE=3",),
                    "tri_load_x2": ("RT_SWEEP_PROBE=4",)}
TRI_SCENES = ("mesh:3", "meshes:4", "mesh:5")


def _innermost_loops(insns: list[tuple[int, str]]):
    """Each innermost loop of one function (a backward branch and the
    instructions from its target to it, holding no other loop): its first
    address and its opcodes, ``NOP`` left out."""
    back = sass.backward_branches(insns)
    for lo, hi in back:
        if any(lo <= lo2 and hi2 <= hi and (lo2, hi2) != (lo, hi)
               for lo2, hi2 in back):
            continue
        ops = [sass.opcode(t) for a, t in insns if lo <= a <= hi]
        yield lo, [o for o in ops if o != "NOP"]


def sweep_loops(insns: list[tuple[int, str]]) -> list[dict]:
    """The innermost loops of one function that sweep sphere rows (see the
    module docstring), largest first: rows per trip, instructions per row
    and opcodes per row."""
    loops = []
    for _, ops in _innermost_loops(insns):
        rows = ops.count("MUFU.RSQ")
        if rows == 0 or not any(o.startswith(("LDS", "LDG")) for o in ops):
            continue
        counts = collections.Counter(ops)
        loops.append({
            "rows_per_trip": rows,
            "instructions_per_row": len(ops) / rows,
            "opcodes_per_row": {k: v / rows for k, v in counts.most_common()},
            "memory": "shared" if any(o.startswith("LDS") for o in ops)
            else "global",
        })
    return sorted(loops, key=lambda r: -r["rows_per_trip"])


def tri_loops(insns: list[tuple[int, str]]) -> list[dict]:
    """The innermost loops of one function that sweep triangle rows, in
    address order: loops that read rows (``LDS`` or ``LDG``) and hold one
    ``MUFU.RCP`` a row (the key's reciprocal) and no ``SHFL`` (the radix
    route's exchange loops are not sweeps). Per loop: rows per trip,
    instructions and opcodes per row, the memory the rows come from, and
    whether it holds a ``CALL``, ``BSSY`` or ``BSYNC``."""
    loops = []
    for lo, ops in _innermost_loops(insns):
        rows = ops.count("MUFU.RCP")
        if (rows == 0 or "SHFL" in ops
                or not any(o.startswith(("LDS", "LDG")) for o in ops)):
            continue
        counts = collections.Counter(ops)
        loops.append({
            "address": lo,
            "rows_per_trip": rows,
            "instructions_per_row": len(ops) / rows,
            "opcodes_per_row": {k: v / rows for k, v in counts.most_common()},
            "memory": "shared" if any(o.startswith("LDS") for o in ops)
            else "global",
            "branches_out": any(o in ("CALL", "BSSY", "BSYNC") for o in ops),
        })
    return sorted(loops, key=lambda r: r["address"])


def tri_sass_counts(dump: str | None = None) -> dict:
    """Each kernel of ``TRI_SASS_KERNELS``: its triangle sweep loops."""
    tool = sass.cuobjdump()
    if tool is None:
        raise RuntimeError("probe_sweep: cuobjdump not found beside nvcc; "
                           "the triangle sweep's SASS cannot be counted")
    listing = sass.functions(sass.disassemble(tool, _build.build("regen")))
    out = {}
    for label, (_, pattern) in TRI_SASS_KERNELS.items():
        names = [f for f in listing if re.search(pattern, f)]
        if len(names) != 1:
            raise AssertionError(f"probe_sweep: {len(names)} functions match "
                                 f"{label} ({pattern})")
        loops = tri_loops(listing[names[0]])
        if not loops:
            raise AssertionError(f"probe_sweep: no triangle loop in {label}")
        if dump:
            with open(os.path.join(dump, f"{label}.sass"), "w") as f:
                f.writelines(f"{a:06x} {t}\n" for a, t in listing[names[0]])
        out[label] = {"function": names[0], "loops": loops}
    return out


def describe_tri_sass(label: str, r: dict) -> str:
    """One line: each triangle loop of the kernel per swept row."""
    parts = []
    for lp in r["loops"]:
        ops = " ".join(f"{k} {v:g}" for k, v in lp["opcodes_per_row"].items())
        parts.append(f"[{lp['rows_per_trip']} rows a trip, {lp['memory']}, "
                     f"{lp['instructions_per_row']:.2f} a row"
                     f"{', branches out' if lp['branches_out'] else ''}: "
                     f"{ops}]")
    return f"{label}: {len(r['loops'])} triangle loop(s) " + " ".join(parts)


def sass_counts(dump: str | None = None) -> dict:
    """Each kernel of ``SASS_KERNELS``: its sweep loops and the main one;
    ``dump`` is a directory to write each kernel's listing to."""
    tool = sass.cuobjdump()
    if tool is None:
        raise RuntimeError("probe_sweep: cuobjdump not found beside nvcc; "
                           "the sweep's SASS cannot be counted")
    out = {}
    listings = {}
    for label, (lib, pattern) in SASS_KERNELS.items():
        if lib not in listings:
            listings[lib] = sass.functions(
                sass.disassemble(tool, _build.build(lib)))
        names = [f for f in listings[lib] if re.search(pattern, f)]
        if len(names) != 1:
            raise AssertionError(f"probe_sweep: {len(names)} functions match "
                                 f"{label} ({pattern})")
        loops = sweep_loops(listings[lib][names[0]])
        if dump:
            with open(os.path.join(dump, f"{label}.sass"), "w") as f:
                f.writelines(f"{a:06x} {t}\n"
                             for a, t in listings[lib][names[0]])
        shared = [lp for lp in loops if lp["memory"] == "shared"]
        if not shared:
            raise AssertionError(f"probe_sweep: no shared-memory sweep loop "
                                 f"in {label}")
        out[label] = {"function": names[0], "loops": loops,
                      "main": shared[0]}
    return out


def describe_sass(label: str, r: dict) -> str:
    """One line: the kernel's main sweep loop (its largest over shared
    memory) per row."""
    main = r["main"]
    ops = " ".join(f"{k} {v:g}" for k, v in main["opcodes_per_row"].items())
    return (f"{label}: {len(r['loops'])} sweep loop(s); main "
            f"{main['rows_per_trip']} rows a trip, "
            f"{main['instructions_per_row']:.2f} instructions a row: {ops}")


def occupancy(tables: rtrace.SceneTables, entry: str = "regen") -> int:
    """Blocks per SM the occupancy API gives the kernel that ``tables``
    launch on ``entry`` (``regen`` or ``trace``)."""
    lib = _build.load("regen")
    blocks = ctypes.c_int(0)
    err = lib.rt_regen_occupancy(*rtrace._table_args(tables), 1, 0, 0,
                                 0 if entry == "regen" else 1,
                                 ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"occupancy query failed: "
                           f"{_build.error_string(lib, err)}")
    return blocks.value


def _wave(renderer: Renderer, spp: int):
    """One whole-budget wave over every slot with the renderer's tables and
    wave arguments: (radiance, segments, done)."""
    _, meta = renderer._waves(spp, renderer.params.max_depth)
    done = torch.zeros(meta["num_slots"], dtype=torch.int32,
                       device=renderer.device)
    return rtrace.render_pixels_fused(renderer._tables, renderer._cam_host,
                                      t_end=spp, done=done, **meta)


def _time_wave(renderer: Renderer, spp: int, reps: int) -> list[float]:
    """CUDA-event ms of ``reps`` waves."""
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _wave(renderer, spp)
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return out


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def parts(scenes=SCENES, spp: int = 8, reps: int = 3,
          builds: dict = PROBE_BUILDS) -> dict:
    """Each scene's wave under every build of ``builds`` (``PROBE_BUILDS``
    or ``TRI_PROBE_BUILDS``, see the module docstring): median ms by build,
    what each adds to the full build, and the parts."""
    _build.build_all(["regen"], [("regen", d) for d in builds.values()
                                 if d])
    order = list(builds) + list(reversed(builds))
    out = {}
    for name in scenes:
        params, scene = profile_render.build(name, 1920, spp, 8)
        renderer = Renderer(scene, params, seed=0, device="cuda")
        times = {b: [] for b in builds}
        ref = None
        for build in order:
            with _build.swapped("regen", builds[build]):
                res = _wave(renderer, spp)  # warm-up, and the bits
                torch.cuda.synchronize()
                if ref is None:
                    ref = res
                elif not _same(res, ref):
                    raise AssertionError(f"probe_sweep: {build} changed "
                                         f"the bits of {name}")
                times[build] += _time_wave(renderer, spp, reps)
        med = {b: sorted(t)[len(t) // 2] for b, t in times.items()}
        added = {b: med[b] - med["full"] for b in builds if b != "full"}
        out[name] = {
            "variant": rtrace.kernel_variant(renderer._tables),
            "blocks_per_sm": occupancy(renderer._tables),
            "slots": int(ref[2].numel()), "spp": spp,
            "segments": int(ref[1]), "ms": times, "median_ms": med,
            "added_ms": added,
        }
        if builds is PROBE_BUILDS:
            out[name].update(
                staging_ms=added["stage_x2"], sweep_ms=added["sweep_x2"],
                rest_ms=med["full"] - added["stage_x2"] - added["sweep_x2"])
    return out


def run(do_sass: bool = True, do_parts: bool = True, scenes=SCENES,
        spp: int = 8, reps: int = 3, dump: str | None = None,
        do_tri_parts: bool = False, tri_scenes=TRI_SCENES) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("probe_sweep measures the card: CUDA is not "
                           "available")
    res = {"device": torch.cuda.get_device_name(0),
           "card": profile_render.card_line()}
    if do_sass:
        res["sass"] = sass_counts(dump=dump)
        res["tri_sass"] = tri_sass_counts(dump=dump)
        _build.load("regen")
        kernels = {**SASS_KERNELS, **TRI_SASS_KERNELS}
        res["registers"] = {
            label: regs for label, (lib, pattern) in kernels.items()
            for name, regs in _build.registers(lib).items()
            if re.search(pattern, name)}
    if do_parts:
        res["parts"] = parts(scenes, spp, reps)
    if do_tri_parts:
        res["tri_parts"] = parts(tri_scenes, spp, reps, TRI_PROBE_BUILDS)
    return res


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="probe_sweep", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--parts", action="store_true")
    ap.add_argument("--tri-parts", action="store_true",
                    help="the triangle-twice and load-twice builds on the "
                    "triangle scenes (--tri-scene; default mesh:3, "
                    "meshes:4, mesh:5)")
    ap.add_argument("--scene", action="append")
    ap.add_argument("--tri-scene", action="append")
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", help="also write the result as JSON here")
    ap.add_argument("--dump", help="write each counted kernel's SASS here")
    args = ap.parse_args(argv)
    every = not (args.sass or args.parts or args.tri_parts)
    res = run(args.sass or every, args.parts or every,
              tuple(args.scene or SCENES), args.spp, args.reps, args.dump,
              args.tri_parts, tuple(args.tri_scene or TRI_SCENES))
    for label, r in res.get("sass", {}).items():
        print(describe_sass(label, r))
    for label, r in res.get("tri_sass", {}).items():
        print(describe_tri_sass(label, r))
    print(f"registers: {res.get('registers')}")
    for name, r in res.get("parts", {}).items():
        print(f"{name} [{r['variant']}, {r['blocks_per_sm']} blocks/SM] "
              f"{r['slots']} slots @ {r['spp']}: "
              f"full {r['median_ms']['full']:.3f} ms, staging "
              f"{r['staging_ms']:.3f}, sweep {r['sweep_ms']:.3f}, rest "
              f"{r['rest_ms']:.3f}")
    for name, r in res.get("tri_parts", {}).items():
        added = ", ".join(f"{b} +{v:.3f}" for b, v in r["added_ms"].items())
        print(f"{name} [{r['variant']}, {r['blocks_per_sm']} blocks/SM] "
              f"{r['slots']} slots @ {r['spp']}: "
              f"full {r['median_ms']['full']:.3f} ms, {added}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
