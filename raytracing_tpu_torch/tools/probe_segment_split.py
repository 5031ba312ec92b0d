"""Split the cost of one segment of the cover scene's regeneration loop
on the card (``csrc/segment_split.cu``, ``ops/segment_split.py``).

The Hopper counterpart of the JAX package's ``scripts/probe_segment_split.py``.
Each variant runs a fixed number of steps with every lane live, so the
slope between two step counts K1 and K2 is the cost of one segment with no
launch floor:

    ns per segment = (t(K2) - t(K1)) / ((K2 - K1) * slots)

where t is the median of ``reps`` CUDA-event timings of one launch, the
seed varied per call as the JAX tool varies it. SM cycles per segment come
two ways: from that time (ns per segment x the SM clock that
``nvidia-smi --query-gpu=clocks.sm`` reads beside the run x the SM count),
and from the kernel's own ``clock64()`` stamps: per SM, the span from its
first warp's start to its last warp's end, summed over the SMs, with the
same slope. ``warp_cycles_per_step`` is the slope of the mean per-warp
``clock64()`` delta: one step of one warp among the warps it shares its SM
with. The split, as the JAX tool prints it:

    fetch  = full - nogather         sweep = nogather - nosweep
    shade/rng/regen/loop = base      stand-in = nosweep - base
    radix fetch = full_radix - nogather

Cameras: ``cover`` (the world file's camera; the probe's 1,024 slots are
pixels x 0-399, y 0-2 of its frame, all sky) and ``hit`` (the same camera
at lookfrom (0, 12, 0.5) looking at the origin: down on the spheres). Each
run prints its hit share, the share of (slot, step) keys that hit a sphere
in the ``full`` variant. The body is branchless, so the two cameras' splits
should agree.

Usage (on the card; one JSON line per (camera, slots) run, then the whole
result as one JSON object)::

    python -m raytracing_tpu_torch.tools.probe_segment_split \\
        [--slots 65536 --slots 2073600] [--camera cover --camera hit] \\
        [--k1 64 --k2 320] [--reps 5] [--out probe_segment_split.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys

import torch

from ..core import camera as rcamera
from ..ops import segment_split as rseg
from ..ops import trace as rtrace
from ..scene import config as rconfig
from . import profile_render
from .probe_fetch import median_ms

HIT_LOOKFROM = (0.0, 12.0, 0.5)
HIT_LOOKAT = (0.0, 0.0, 0.0)
CAMERAS = ("cover", "hit")
SLOTS = (65_536, 2_073_600)
# FP32 operations of one step besides the sweep, read from
# csrc/segment_split.cu as tools/profile_render.py counts them (adds,
# subtracts, multiplies, divides, roots, sin and cos count one each;
# compares, selects, conversions and the integer hash do not): the ray
# invariants 16, the exact root and hit point 38, the shade 120, the
# radiance, offset and throughput 24, the camera ray 37. The material
# decode of full / full_radix adds 5, the synthetic columns of the other
# variants 9.
STEP_OPS = 16 + 38 + 120 + 24 + 37
DECODE_OPS = 5
SYNTHETIC_OPS = 9


def sm_clock_mhz() -> float:
    """The SM clock (MHz) ``nvidia-smi`` reads now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return float(out.stdout.strip().splitlines()[0])


def cameras() -> dict[str, rcamera.DerivedCamera]:
    """The probe's two cameras (see the module docstring)."""
    world = rconfig.load_world(str(profile_render.COVER))
    params = world.camera
    hit = dataclasses.replace(params, lookfrom=HIT_LOOKFROM,
                              lookat=HIT_LOOKAT)
    return {"cover": rcamera.derive(params), "hit": rcamera.derive(hit)}


def cover_tables(device) -> rtrace.SceneTables:
    """The cover scene's packed tables (512 rows, flat rule) on ``device``."""
    _, scene = rconfig.load_and_build(str(profile_render.COVER))
    return rtrace.pack_scene(scene.to(device), cull=False)


def bound_ms(tables: rtrace.SceneTables, variant: str, steps: int,
             slots: int) -> dict:
    """Least time of one launch: its FP32 operations over 67 TFLOP/s
    (``profile_render.FP32_PEAK``), the sweep counted on the scene's real
    rows as ``profile_render.bound`` counts it; the bytes (tables read once,
    outputs written once) are far below."""
    per = STEP_OPS
    if variant in ("full", "nogather", "full_radix"):
        per += tables.n_actual * profile_render.SPHERE_PAIR_OPS
    per += DECODE_OPS if variant in ("full", "full_radix") else SYNTHETIC_OPS
    ops = per * steps * slots
    nbytes = 4 * (tables.geom_h.numel() + tables.geom_c.numel()
                  + tables.shade.numel()) + slots * (12 + 4)
    ops_ms = ops / profile_render.FP32_PEAK * 1e3
    bytes_ms = nbytes / profile_render.HBM_RATE * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "fp32_ops": ops}


def _sm_span_cycles(clocks: torch.Tensor) -> float:
    """Sum over SMs of (last warp end - first warp start), in cycles."""
    c = clocks.cpu()
    total = 0
    for sm in torch.unique(c[:, 2]).tolist():
        rows = c[c[:, 2] == sm]
        total += int(rows[:, 1].max()) - int(rows[:, 0].min())
    return float(total)


def time_launch(tables, cam, variant: str, steps: int, slots: int,
                reps: int) -> dict:
    """Median CUDA-event ms of one launch over ``reps`` calls (seeds 1000,
    1001, ..., after a warm-up call with seed 999), with the SM-span and
    mean warp clock64() cycles and the hit share of the last call."""
    dev = tables.device
    clocks = torch.empty((slots // 32, 3), dtype=torch.int64, device=dev)
    seeds = iter(range(999, 1000 + reps))
    hits = []

    def launch():
        hits[:] = [rseg.segment_split(tables, cam, seed=next(seeds),
                                      steps=steps, slots=slots,
                                      variant=variant, clocks=clocks)[1]]

    ms = median_ms(launch, reps)
    return {"ms": ms, "sm_span_cycles": _sm_span_cycles(clocks),
            "warp_cycles": float((clocks[:, 1] - clocks[:, 0]).double().mean()),
            "hit_share": int(hits[0].sum()) / max(1, steps * slots)}


def probe(tables, cam, slots: int, k1: int, k2: int, reps: int) -> dict:
    """Every variant at K1 and K2 on ``slots`` lanes; per variant the two
    launches, ns and SM cycles per segment and warp cycles per step; then
    the split."""
    n_sm = torch.cuda.get_device_properties(tables.device).multi_processor_count
    out = {"slots": slots, "k1": k1, "k2": k2, "sms": n_sm, "variants": {}}
    segs = (k2 - k1) * slots
    for v in rseg.VARIANTS:
        a = time_launch(tables, cam, v, k1, slots, reps)
        b = time_launch(tables, cam, v, k2, slots, reps)
        mhz = sm_clock_mhz()  # read right after the card ran
        ns = (b["ms"] - a["ms"]) * 1e6 / segs
        out["variants"][v] = {
            "ms_k1": a["ms"], "ms_k2": b["ms"], "sm_clock_mhz": mhz,
            "ns_per_segment": ns,
            "sm_cycles_per_segment": ns * mhz * 1e-3 * n_sm,
            "sm_cycles_per_segment_clock64":
                (b["sm_span_cycles"] - a["sm_span_cycles"]) / segs,
            "warp_cycles_per_step":
                (b["warp_cycles"] - a["warp_cycles"]) / (k2 - k1),
            "hit_share": b["hit_share"],
            **bound_ms(tables, v, k2, slots),
        }
    c = {v: r["sm_cycles_per_segment"] for v, r in out["variants"].items()}
    out["split_sm_cycles"] = {
        "fetch": c["full"] - c["nogather"],
        "sweep": c["nogather"] - c["nosweep"],
        "shade_rng_regen_loop": c["base"],
        "stand_in": c["nosweep"] - c["base"],
        "radix_fetch": c["full_radix"] - c["nogather"],
    }
    out["hit_share"] = out["variants"]["full"]["hit_share"]
    return out


def run(slot_counts=SLOTS, camera_names=CAMERAS, k1: int = 64,
        k2: int = 320, reps: int = 5) -> dict:
    """``probe`` for every camera and slot count on the cover scene."""
    if not torch.cuda.is_available():
        raise RuntimeError("probe_segment_split measures the card: CUDA is "
                           "not available")
    dev = torch.device("cuda")
    tables = cover_tables(dev)
    cams = cameras()
    runs = []
    for name in camera_names:
        for slots in slot_counts:
            r = probe(tables, cams[name], slots, k1, k2, reps)
            runs.append({"camera": name, **r})
    return {"device": torch.cuda.get_device_name(0),
            "card": profile_render.card_line(), "n_pad": tables.n_pad,
            "n_actual": tables.n_actual, "runs": runs}


def describe(r: dict) -> str:
    """One run's split as the JAX tool prints it, in SM cycles."""
    s = r["split_sm_cycles"]
    return (f"{r['camera']} {r['slots']} slots (hit share "
            f"{r['hit_share']:.4f}): split fetch={s['fetch']:.2f} "
            f"sweep={s['sweep']:.2f} "
            f"shade/rng/regen/loop={s['shade_rng_regen_loop']:.2f} "
            f"(synthetic-winner stand-in {s['stand_in']:+.2f}) "
            f"radix fetch={s['radix_fetch']:.2f} SM cycles/segment")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="probe_segment_split",
                                 description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--slots", type=int, action="append")
    ap.add_argument("--camera", choices=CAMERAS, action="append")
    ap.add_argument("--k1", type=int, default=64)
    ap.add_argument("--k2", type=int, default=320)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", help="also write the result as JSON here")
    args = ap.parse_args(argv)
    res = run(tuple(args.slots or SLOTS), tuple(args.camera or CAMERAS),
              args.k1, args.k2, args.reps)
    for r in res["runs"]:
        for v, row in r["variants"].items():
            print(f"{r['camera']:5s} {r['slots']:8d} {v:10s} "
                  f"{row['ms_k1']:9.3f} / {row['ms_k2']:9.3f} ms  "
                  f"{row['ns_per_segment']:.5f} ns/segment  "
                  f"{row['sm_cycles_per_segment']:7.2f} SM cyc/segment "
                  f"(clock64 {row['sm_cycles_per_segment_clock64']:7.2f})  "
                  f"warp {row['warp_cycles_per_step']:9.1f} cyc/step")
        print(describe(r))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
