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

Times: the median of ``calls`` CUDA-event timings of ``loops`` back-to-back
launches, per launch, for each mode and for ``torch.reciprocal`` plus
``torch.div`` on the same inputs, at the probe's 1,024 elements (a launch's
latency) and at ``--large`` elements (a rate of bytes).

Usage (on the card; prints the ulp lines, then the whole result as one
JSON object)::

    python -m raytracing_tpu_torch.tools.probe_divide [--calls 5]
        [--loops 200] [--large 16777216] [--out probe_divide.json]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..ops import divide as rdiv
from . import profile_render
from .probe_fetch import median_ms


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
        row["ms"] = median_ms(lambda m=mode: rdiv.divide(x, num, m), calls,
                              loops)
        row["ms_large"] = median_ms(lambda m=mode: rdiv.divide(lx, ln, m),
                                    calls, 5)
        res["modes"][mode] = row
        if mode in ("ieee", "rn") and not all(
                row[name]["bit_equal_plain"] for name in SETS):
            raise AssertionError(f"divide {mode}: differs from the plain "
                                 "version")
    res["library_ms"] = median_ms(
        lambda: (torch.reciprocal(x), torch.div(num, x)), calls, loops)
    res["library_ms_large"] = median_ms(
        lambda: (torch.reciprocal(lx), torch.div(ln, lx)), calls, 5)
    res["plain_ms"] = median_ms(lambda: rdiv.divide_reference(x, num),
                                calls, loops)
    res["bound_ms"] = bound_ms(x.numel())
    res["bound_ms_large"] = bound_ms(large)
    res["elements"] = x.numel()
    res["elements_large"] = large
    return res


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
        print(f"{mode:6s} {row['ms'] * 1e3:.2f} us/launch at "
              f"{res['elements']}, {row['ms_large']:.4f} ms at "
              f"{res['elements_large']}")
    print(f"torch.reciprocal + torch.div: {res['library_ms'] * 1e3:.2f} us at "
          f"{res['elements']}, {res['library_ms_large']:.4f} ms at "
          f"{res['elements_large']} (bound {res['bound_ms_large']:.4f} ms)")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
