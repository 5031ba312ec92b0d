"""Measure how the card rounds an in-kernel reciprocal and quotient
(``csrc/divide.cu``, ``ops/divide.py``).

The Hopper counterpart of the JAX package's ``scripts/probe_divide.py``: the
max and mean ulp error of ``1/x`` and ``a/x`` against float64, computed as
that script's ``ulp_err`` does, on its 1,024 seeded inputs (magnitudes
2^-20..2^20, both signs, exact powers of two), for each mode of the
kernel: ``ieee`` (the megakernel's ``/``), ``rn`` (``__frcp_rn``,
``__fdiv_rn``), ``fast`` (``__fdividef``) and ``approx``
(``rcp.approx.f32``). Then the same on the edge set (values ``safe_inv``
can see: its clamp 1e-30 and magnitudes near 2^-126 and 2^126), printed on
its own line, with the count of quotients ``fast`` flushes to zero, and
on the timing set (``--large`` seeded values in [0.5, 1.5)). The ``ieee``
and ``rn`` modes must equal the plain version (``torch.reciprocal`` and
``torch.div`` on the card) bit for bit on all three sets.

Times, for each mode and for ``torch.reciprocal`` plus ``torch.div`` on
the same inputs, at the probe's 1,024 elements (a launch's latency) and
at ``--large`` elements (a rate of bytes), split three ways
(``probe_fetch.split``): ``ms`` / ``ms_large``, the median of ``calls``
CUDA-event timings of ``loops`` (at ``--large``: 5) back-to-back calls,
per call; ``host_us`` / ``host_us_large``, the host's µs a call with no
synchronise between calls; ``device_ms`` / ``device_ms_large``, the
card's ms a call from ``torch.profiler``'s device events. A call whose
host µs exceed its device time is held to the host in a back-to-back
loop. ``sass`` counts each mode's global loads and stores by width in
the built library (``tools/sass.py``; ``available`` false without
``cuobjdump``).

Usage (on the card; prints the ulp lines, then the whole result as one
JSON object)::

    python -m raytracing_tpu_torch.tools.probe_divide [--calls 5]
        [--loops 200] [--large 16777216] [--out probe_divide.json]
"""

from __future__ import annotations

import argparse
import json
import re
import sys

import numpy as np
import torch

from ..ops import _build
from ..ops import divide as rdiv
from . import profile_render, sass
from .probe_fetch import median_ms, split


def ulp_stats(x: torch.Tensor, num: torch.Tensor, recip: torch.Tensor,
              quot: torch.Tensor) -> dict:
    x64 = x.cpu().numpy().astype(np.float64)
    n64 = num.cpu().numpy().astype(np.float64)
    er = rdiv.ulp_error(recip.cpu().numpy(), 1.0 / x64)
    eq = rdiv.ulp_error(quot.cpu().numpy(), n64 / x64)
    return {"recip_max_ulp": float(er.max()), "recip_mean_ulp": float(er.mean()),
            "quot_max_ulp": float(eq.max()), "quot_mean_ulp": float(eq.mean())}


SETS = ("probe", "edge", "large")


def large_inputs(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The timing set: ``n`` divisors and numerators in [0.5, 1.5), seeded."""
    gen = torch.Generator(device="cpu").manual_seed(7)
    lx = (torch.rand(n, generator=gen) + 0.5).to(device)
    ln = (torch.rand(n, generator=gen) + 0.5).to(device)
    return lx, ln


def bound_ms(n: int) -> float:
    """Least time of one call on ``n`` elements: two floats read and two
    written each, over the memory rate (the divides are far below the FP32
    rate)."""
    return 16 * n / profile_render.HBM_RATE * 1e3


def mode_of(fname: str) -> str | None:
    """The divide mode of a kernel's (mangled) name, ``divide<mode, ...>``."""
    m = re.search(r"divide\w*?ILi(\d)E", fname)
    return rdiv.MODES[int(m.group(1))] if m else None


def _timed(row: dict, fn, loops: int, reps: int, suffix: str = "",
           prefix: str = "") -> None:
    t = split(fn, loops, reps)
    for key, value in t.items():
        row[f"{prefix}{key}{suffix}"] = value


def run(calls: int = 5, loops: int = 200, large: int = 1 << 24) -> dict:
    """Every mode's ulp errors and bit-equality on the probe's inputs, the
    edge set and the timing set, and the times; raises AssertionError
    where ``ieee`` or ``rn`` differ from the plain version."""
    if not torch.cuda.is_available():
        raise RuntimeError("probe_divide measures the card: CUDA is not "
                           "available")
    dev = torch.device("cuda")
    x, num = (t.to(dev).reshape(-1).contiguous() for t in rdiv.inputs())
    ex, en = (t.to(dev) for t in rdiv.edge_inputs())
    lx, ln = large_inputs(large, dev)
    res = {"device": torch.cuda.get_device_name(0),
           "card": profile_render.card_line(), "modes": {}}
    for mode in rdiv.MODES:
        row = {}
        for name, (a, b) in (("probe", (x, num)), ("edge", (ex, en)),
                             ("large", (lx, ln))):
            r, q = rdiv.divide(a, b, mode)
            pr, pq = rdiv.divide_reference(a, b, mode)
            torch.cuda.synchronize()
            row[name] = {
                **ulp_stats(a, b, r, q),
                "bit_equal_plain": bool(torch.equal(r, pr)
                                        and torch.equal(q, pq)),
                "max_abs_err": float(max((r - pr).abs().max(),
                                         (q - pq).abs().max())),
                "zeros": int((r == 0).sum() + (q == 0).sum()),
            }
        _timed(row, lambda m=mode: rdiv.divide(x, num, m), loops, calls)
        _timed(row, lambda m=mode: rdiv.divide(lx, ln, m), 5, calls,
               "_large")
        res["modes"][mode] = row
        if mode in ("ieee", "rn") and not all(
                row[name]["bit_equal_plain"] for name in SETS):
            raise AssertionError(f"divide {mode}: differs from the plain "
                                 "version")
    _timed(res, lambda: (torch.reciprocal(x), torch.div(num, x)), loops,
           calls, prefix="library_")
    _timed(res, lambda: (torch.reciprocal(lx), torch.div(ln, lx)), 5, calls,
           "_large", "library_")
    res["plain_ms"] = median_ms(lambda: rdiv.divide_reference(x, num),
                                calls, loops)
    res["bound_ms"] = bound_ms(x.numel())
    res["bound_ms_large"] = bound_ms(large)
    res["elements"] = x.numel()
    res["elements_large"] = large
    res["sass"] = sass.accesses_by_mode(_build.build("divide"), mode_of,
                                        rdiv.MODES)
    return res


def _dev(ms) -> str:
    return "not recorded" if ms is None else f"{ms * 1e3:.2f} us"


def describe(row: dict, prefix: str = "") -> str:
    """One line of a mode's (or, with ``prefix`` "library_", the
    library's) times at both sizes."""
    def get(key, suffix=""):
        return row[f"{prefix}{key}{suffix}"]

    return (f"{get('ms') * 1e3:.2f} us/call back to back, host "
            f"{get('host_us'):.2f} us, device {_dev(get('device_ms'))} at "
            f"the probe's size; {get('ms', '_large'):.4f} ms, host "
            f"{get('host_us', '_large'):.2f} us, device "
            f"{_dev(get('device_ms', '_large'))} at the large size")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="probe_divide", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--loops", type=int, default=200)
    ap.add_argument("--large", type=int, default=1 << 24)
    ap.add_argument("--out", help="also write the result as JSON here")
    args = ap.parse_args(argv)
    res = run(args.calls, args.loops, args.large)
    for mode, row in res["modes"].items():
        for name in SETS:
            s = row[name]
            print(f"{mode:6s} {name:5s} 1/x max ulp {s['recip_max_ulp']:.3f} "
                  f"mean {s['recip_mean_ulp']:.4f}; a/x max ulp "
                  f"{s['quot_max_ulp']:.3f} mean {s['quot_mean_ulp']:.4f}; "
                  f"bit-equal to plain {s['bit_equal_plain']}, zeros "
                  f"{s['zeros']}")
        print(f"{mode:6s} {describe(row)}")
    print(f"torch.reciprocal + torch.div: {describe(res, 'library_')} "
          f"(bound {res['bound_ms_large']:.4f} ms)")
    if res["sass"]["available"]:
        for mode, widths in res["sass"]["modes"].items():
            print(f"{mode:6s} SASS global accesses {widths}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
