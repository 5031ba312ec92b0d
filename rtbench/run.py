"""Run one cell of the port's benchmark once.

    python3 -m rtbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks
for. It builds the cell's scene through the program, warms up the shapes
the cell's traffic uses (set-up, ``setup_s``), measures ``--seconds``
seconds of that traffic (traced by ``torch.profiler`` with ``--trace 1``),
checks what the window produced against the plain reference, and prints
one JSON line last on standard output. Without a CUDA card it exits 2
and prints no result; if JAX or the JAX package was loaded, 3.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(cell, seed: int, seconds: float, trace: bool, device=None,
             log=_log) -> tuple[int, dict | None]:
    """Run ``cell`` (``spec.Cell``) once; returns (exit code, result).
    ``device`` None takes the first CUDA card and refuses to run without
    enough cards; the tests pass "cpu" to drive the rest of a run on the
    program's plain versions."""
    import torch

    from . import drives, guard

    if device is None:
        if not torch.cuda.is_available():
            log("rtbench: torch.cuda.is_available() is False: no result")
            return 2, None
        if torch.cuda.device_count() < cell.chips:
            log(f"rtbench: {cell.name} needs {cell.chips} cards, "
                f"{torch.cuda.device_count()} found: no result")
            return 2, None
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cuda = device.type == "cuda"

    if cuda:
        torch.cuda.init()
    t_cuda = time.perf_counter() - START
    drive = drives.make(cell, seed, device, log)
    drive.setup()
    setup_s = time.perf_counter() - START
    log(f"setup_s {setup_s:.3f}: torch and the CUDA context {t_cuda:.3f}, "
        f"scene build and pack {drive.build_ms / 1e3:.3f}, the rest (the "
        f"kernel's build or load, the warm-up) "
        f"{setup_s - t_cuda - drive.build_ms / 1e3:.3f}")
    drive.run_window(seconds, trace)
    e2e = drive.results()
    e2e["setup_s"] = setup_s
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if trace:
        values = {}
        for entry, reader in cell.per_layer:
            v = reader.read(drive)
            if v is not None:
                values[entry["name"]] = v
        metrics = {e["name"]: {"value": values[e["name"]], "unit": e["unit"]}
                   for e, _ in cell.per_layer if e["name"] in values}
    else:
        metrics = {e["name"]: {"value": e2e[e["name"]], "unit": e["unit"]}
                   for e in cell.end_to_end}
    result = {
        "workload": cell.name, "seed": seed,
        "attempted": drive.attempted, "failed": 0,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else device.type,
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": cell.chips if cuda else 0,
            "memory_peak_bytes": int(peak),
        },
        "card": card_line() if cuda else "cpu",
    }
    if trace:
        rec = drive.record
        result["device"].update(busy_s=rec.busy_s(), window_s=rec.window_s)
        result["breakdown"] = {"device_ops": [list(x) for x in rec.top_device()],
                               "idle_gaps": [list(x) for x in rec.idle_gaps()]}
    drive.release()
    drive.record = None
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = drive.checks()
    log(f"check: {time.perf_counter() - t0:.1f} s on the reference")
    bad = guard.forbidden_modules(sys.modules)
    if bad:
        log(f"rtbench: forbidden modules loaded: {', '.join(bad)}: no result")
        return 3, None
    result["correct"] = all(v <= lim for _, v, lim in checks)
    for name, v, lim in checks:
        log(f"check {name} {v!r} limit {lim!r}")
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return 0, result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rtbench.run",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from . import spec

    cell = spec.resolve(spec.load_benchmark(), args.workload)
    code, result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    if result is not None:
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
