"""Time the feature kernels on the card (``csrc/features.cu``,
``ops/features.py``).

Every mode on ``TILES`` seeded tiles (8,192, a working set below the
card's 50 MB L2 for bf16_cmp), and bf16_cmp also on ``LARGE_TILES``
(65,536: 384 MB, past the L2), each held to its plain version bit for
bit, then timed beside its plain version and one PyTorch call of the same
function (``library``: ``torch.gt(x, 0.5).float()``, ``torch.where`` on
int16 views, ``torch.gather``), split three ways (``probe_fetch.split``): ``ms``, the median of ``REPS`` (5)
CUDA-event timings of ``LOOPS`` (10) back-to-back calls, per call;
``host_us``, the host's µs a call with no synchronise between calls;
``device_ms``, the card's ms a call from ``torch.profiler``'s device
events. The library's are ``library_ms``, ``library_host_us``,
``library_device_ms``; a size past the first carries the suffix
``_large``. ``bound_ms`` is ``ops/features.py::nbytes`` over the memory
rate. ``sass`` counts each mode's global loads and stores by width in the
built library (``tools/sass.py``).

Usage (on the card; prints a line a mode and size, then the whole result
as one JSON object)::

    python -m raytracing_tpu_torch.tools.probe_features [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import re
import sys

import torch

from ..ops import _build
from ..ops import features as rfeat
from ..ops.dtype import bits_equal
from . import profile_render, sass
from .probe_fetch import median_ms, split

SEED = 0
# Tiles of every mode's timing, and of the LARGE_MODES' second one.
TILES = 8192
LARGE_TILES = 65536
LARGE_MODES = ("bf16_cmp",)
# Timings a median is taken over, and back-to-back calls in each.
REPS = 5
LOOPS = 10


def library(mode: str, args: list):
    """One PyTorch call of the feature mode's function on ``args`` (its
    mask or index prepared outside the call)."""
    if mode == "bf16_cmp":
        return lambda: torch.gt(args[0], 0.5).float()
    if mode == "dyn_gather":
        idx = args[1].long()
        return lambda: torch.gather(args[0], -2, idx)
    x16 = args[0].view(torch.int16)
    s = args[1]
    m = s > 0 if mode == "i16_relayout" else ((s >> 1) & 1) > 0
    m16 = m.repeat_interleave(2, -1)
    return lambda: torch.where(m16, x16[..., 4:, :], x16[..., :4, :])


def abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Max |a - b| (0 where bit-equal; infinite where one side is not
    finite)."""
    if bits_equal(a, b):
        return 0.0
    d = (a.double() - b.double()).abs()
    return float(torch.nan_to_num(d, nan=float("inf")).max())


def mode_of(fname: str) -> str | None:
    """The feature mode of a kernel's (mangled) name: ``bf16_cmp``,
    ``i16_select<1|2>`` (the mode's index), ``dyn_gather``."""
    m = re.search(r"(bf16_cmp|i16_select\w*?ILi(\d)E|dyn_gather)", fname)
    if m is None:
        return None
    return rfeat.MODES[int(m.group(2))] if m.group(2) else m.group(1)


def probe(mode: str, units: int) -> dict:
    """One mode on ``units`` seeded tiles: bit-equal to the plain
    version (raises AssertionError where not), timed."""
    dev = torch.device("cuda")
    args = [t.to(dev) for t in rfeat.seeded_inputs(mode, units, SEED)]
    got = rfeat.features(mode, *args)
    want = rfeat.features_reference(mode, *args)
    err = abs_err(got, want)
    if err != 0.0 or not bits_equal(got, want):
        raise AssertionError(f"features {mode} ({units} tiles): kernel "
                             "differs from the plain version")
    del got, want
    row = {"tiles": units, "max_abs_err": err,
           **split(lambda: rfeat.features(mode, *args), LOOPS, REPS),
           "plain_ms": median_ms(
               lambda: rfeat.features_reference(mode, *args), REPS, LOOPS),
           "bound_ms": rfeat.nbytes(mode, *args)
           / profile_render.HBM_RATE * 1e3,
           "bound_by": "bytes"}
    lib = split(library(mode, args), LOOPS, REPS)
    row.update({f"library_{k}": v for k, v in lib.items()})
    return row


def run() -> dict:
    """Every mode at ``TILES`` and the ``LARGE_MODES`` at ``LARGE_TILES``:
    ``{"modes": {mode: {"<tiles>": row, ...}}}``, rows as ``probe``."""
    if not torch.cuda.is_available():
        raise RuntimeError("probe_features measures the card: CUDA is not "
                           "available")
    res = {"device": torch.cuda.get_device_name(0),
           "card": profile_render.card_line(), "modes": {}}
    for mode in rfeat.MODES:
        sizes = (TILES, LARGE_TILES) if mode in LARGE_MODES else (TILES,)
        res["modes"][mode] = {str(u): probe(mode, u) for u in sizes}
    res["sass"] = sass.accesses_by_mode(_build.build("features"), mode_of,
                                        rfeat.MODES)
    return res


def _dev(ms) -> str:
    return "not recorded" if ms is None else f"{ms:.5f} ms"


def describe(mode: str, row: dict) -> str:
    """One line of a mode's times at one size."""
    return (f"{mode} on {row['tiles']} tiles: {row['ms']:.5f} ms back to "
            f"back, host {row['host_us']:.2f} us, device "
            f"{_dev(row['device_ms'])}; plain {row['plain_ms']:.5f} ms; "
            f"library {row['library_ms']:.5f} ms, host "
            f"{row['library_host_us']:.2f} us, device "
            f"{_dev(row['library_device_ms'])}; bound {row['bound_ms']:.5f} "
            f"ms by bytes")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="probe_features", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--out", help="also write the result as JSON here")
    args = ap.parse_args(argv)
    res = run()
    for mode, sizes in res["modes"].items():
        for row in sizes.values():
            print(describe(mode, row))
    if res["sass"]["available"]:
        for mode, widths in res["sass"]["modes"].items():
            print(f"{mode} SASS global accesses {widths}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
