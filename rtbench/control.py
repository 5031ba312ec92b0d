"""The control of a cell's comparison: the reference computed in bfloat16,
put in the program's place, checked as a run's window is checked.

    python3 -m rtbench.control --workload <name> --seeds 11,12,13

For each seed it makes the cell's requests as a run would (the same seeds,
pixels, rays and frames), computes what the window would have produced with
the bfloat16 reference (the path arithmetic in bfloat16; the sums over
samples and the colour pipe in float32), and prints the numbers the check
compares against the float32 reference, one JSON line a seed. A control
that passes a cell's every limit is a comparison that cannot see a lower
precision: the limits were set between these readings and the program's.
The benchmark's own runs never run this. Without a CUDA card it exits 2
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import drives, spec


def control_checks(cell, seed: int, device, log=print) -> list:
    """The numbers compared, with the control's readings, for one seed."""
    drive = drives.make(cell, seed, device, log)
    drive.plan()
    ref = drives.reference_tables(cell.config, device)
    low = drives.reference_tables(cell.config, device, torch.bfloat16)
    observed = drive.control_observed(low, int(drive.check[drive.count_key]))
    return drive.checks(observed, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rtbench.control",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, three or more")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("rtbench.control: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.resolve(spec.load_benchmark(), args.workload)
    for seed in (int(x) for x in args.seeds.split(",")):
        checks = control_checks(cell, seed, torch.device(args.device),
                                log=lambda m: print(m, file=sys.stderr))
        print(json.dumps({"workload": cell.name, "seed": seed, "control":
                          "bfloat16", "checks": {n: {"value": v, "limit": lim}
                                                 for n, v, lim in checks}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
