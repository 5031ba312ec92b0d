"""Price the granularity of a culled sweep's skips on the card
(``csrc/worklist.cu``, ``ops/worklist.py``).

The Hopper counterpart of the JAX package's ``scripts/probe_worklist.py``:
one vote per block with every warp sweeping (``static``), a warp-uniform
branch per group (``conds``), and a compacted list of (group, quarter) work
items that any warp may pull (``worklist``), over the same vote tables at
pass fractions 1/8, 2/8, 4/8 and 8/8 (``ops/worklist.py::inputs``).

First the modes' results: ``conds`` and ``worklist`` must be equal at every
fraction, and ``static`` equal to them at 8/8 (where every group votes for
every block). Then the timing: the unit (one CTA of 1,024 threads, one
4,096-row table, ``reps`` passes) is replicated over ``units`` CTAs (by
default two per SM), each with its own ray payload and the same votes; the
median of ``calls`` CUDA-event timings of one launch gives microseconds
per call, nanoseconds per block visit of one CTA (call / (reps x 8)), and
the card's rate of swept (ray, row) pairs.

Usage (on the card; one JSON line per pass fraction, then the whole result
as one JSON object)::

    python -m raytracing_tpu_torch.tools.probe_worklist [--units N]
        [--reps 40] [--calls 5] [--out probe_worklist.json]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..ops import worklist as rwl
from . import profile_render
from .probe_fetch import median_ms

FRACTIONS = (1, 2, 4, 8)


def bound_ms(votes: torch.Tensor, mode: str, units: int, reps: int) -> dict:
    """Least time of one launch: 19 FP32 operations per (ray, row) pair the
    mode sweeps (``profile_render.SPHERE_PAIR_OPS``; the pairs this vote
    table asks of the mode) over 67 TFLOP/s, or the table and rays read
    once and the sums written once over the memory rate."""
    pairs = rwl.swept_pairs(votes, mode) * rwl.LANES * rwl.BLK * reps * units
    ops = pairs * profile_render.SPHERE_PAIR_OPS
    nbytes = 4 * (rwl.NB * rwl.BLK * 7 + units * 6 * rwl.UNIT
                  + units * rwl.UNIT + rwl.NB * rwl.GROUPS)
    ops_ms = ops / profile_render.FP32_PEAK * 1e3
    bytes_ms = nbytes / profile_render.HBM_RATE * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "pairs": pairs}


def probe_fraction(pass_groups: int, units: int, reps: int,
                   calls: int) -> dict:
    """Every mode at one pass fraction: the results' equalities, then the
    timing."""
    dev = torch.device("cuda")
    tab, rays, votes = (t.to(dev) for t in rwl.inputs(pass_groups))
    pay = rwl.payloads(rays, units).contiguous()
    outs = {m: rwl.worklist_probe(tab, pay, votes, reps, m)
            for m in rwl.MODES}
    torch.cuda.synchronize()
    res = {"pass_groups": pass_groups, "units": units, "reps": reps,
           "conds_eq_worklist": bool(torch.equal(outs["conds"],
                                                 outs["worklist"])),
           "static_eq_conds": bool(torch.equal(outs["static"],
                                               outs["conds"])),
           "modes": {}}
    for m in rwl.MODES:
        ms = median_ms(lambda m=m: rwl.worklist_probe(tab, pay, votes, reps, m),
                       calls)
        b = bound_ms(votes, m, units, reps)
        res["modes"][m] = {
            "ms": ms, "us_per_call": ms * 1e3,
            "ns_per_block_visit": ms * 1e6 / (reps * rwl.NB),
            "pairs_per_ns": b["pairs"] / (ms * 1e6), **b,
        }
    return res


def run(units: int | None = None, reps: int = 40, calls: int = 5,
        fractions=FRACTIONS) -> dict:
    """``probe_fraction`` at every pass fraction; raises AssertionError if
    ``conds`` and ``worklist`` differ anywhere, or ``static`` and ``conds``
    at 8/8."""
    if not torch.cuda.is_available():
        raise RuntimeError("probe_worklist measures the card: CUDA is not "
                           "available")
    if units is None:
        units = 2 * torch.cuda.get_device_properties(0).multi_processor_count
    results = [probe_fraction(pg, units, reps, calls) for pg in fractions]
    for r in results:
        if not r["conds_eq_worklist"]:
            raise AssertionError(f"worklist {r['pass_groups']}/8: conds and "
                                 "worklist differ")
        if r["pass_groups"] == rwl.GROUPS and not r["static_eq_conds"]:
            raise AssertionError("worklist 8/8: static and conds differ")
    return {"device": torch.cuda.get_device_name(0),
            "card": profile_render.card_line(), "fractions": results}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="probe_worklist", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--units", type=int)
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--out", help="also write the result as JSON here")
    args = ap.parse_args(argv)
    res = run(args.units, args.reps, args.calls)
    for r in res["fractions"]:
        print(f"pass_groups={r['pass_groups']}/8 ({r['units']} units, "
              f"{r['reps']} passes): conds == worklist "
              f"{r['conds_eq_worklist']}, static == conds "
              f"{r['static_eq_conds']}")
        for m, row in r["modes"].items():
            print(f"  {m:9s}: {row['us_per_call']:9.1f} us/call  "
                  f"{row['ns_per_block_visit']:8.1f} ns/block  "
                  f"{row['pairs_per_ns']:8.1f} pairs/ns  "
                  f"(bound {row['bound_ms']:.4f} ms)")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
