"""Ask the dtype probe's questions of the card (``csrc/dtype.cu``,
``ops/dtype.py``).

The Hopper counterpart of the JAX package's ``scripts/probe_dtype.py``:

1. **The layout.** The bitcast kernel on ``bitcast_probe``'s input (word k:
   high half k, low half 7), named among that probe's four candidates;
   the layout of ``torch.Tensor.view(torch.int16)`` on the card (the
   halves of a word side by side in one row); and which half of a word
   ``__nv_bfloat162.x`` and ``short2.x`` read.
2. **The rates.** Each rate mode on ``rate_probe``'s tile (``inputs``)
   replicated over ``units`` tiles (by default two per SM), ``iters``
   steps: microseconds per call (CUDA events, the median of ``calls``),
   stream steps per second and per SM cycle (the SM clock that
   ``nvidia-smi`` reads after the mode's timing), against the least time:
   per stream step, the larger of the issued instructions over the 128
   an SM can issue a cycle (4 schedulers, one warp instruction each) and
   each instruction class over its row of the arithmetic-throughput table
   of the CUDA C++ Programming Guide for compute capability 9.0 (results
   per cycle per SM; ``RATE_BOUNDS`` names the rows), times 132 SMs at
   the 1,980 MHz boost clock (the clock of the published 67 TFLOP/s).
3. **The SASS.** Where the toolkit has ``cuobjdump``: the instructions of
   each rate kernel's main loop body (``ops/dtype.py::steps_per_body``,
   read from the built kernel, steps of the 8 streams), per stream step of one element, and their
   opcodes. This answers the JAX probe's question -- does a 16-bit select
   run at twice the 32-bit rate? -- with an instruction count beside the
   rate.

The bitcast is also timed on 8,192 tiles (8,388,608 words) and on one
tile (1,024 words), beside ``view`` + ``unflatten`` + ``transpose`` +
``contiguous`` (the one PyTorch call of the same function) and its bytes
bound, each call's time split three ways (``probe_fetch.split``): ``ms``
back to back, ``host_us`` the host's µs a call, ``device_ms`` the card's
ms a call (keys ``*_small`` at one tile, ``library_*`` for the library
call); ``bitcast["sass"]`` counts the bitcast kernels' global loads and
stores by width (``tools/sass.py``). The kernels' parity with their plain versions is held
by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``, not here.

Usage (on the card; prints the layout, the rate and SASS lines, then the
whole result as one JSON object)::

    python -m raytracing_tpu_torch.tools.probe_dtype [--units N]
        [--iters 2048] [--calls 5] [--out probe_dtype.json]
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys

import numpy as np
import torch

from ..ops import _build
from ..ops import dtype as rdt
from . import profile_render, sass
from .probe_fetch import device_text, split
from .probe_segment_split import sm_clock_mhz
from .sass import backward_branches, cuobjdump, functions

SMS = 132
BITCAST_UNITS = 8192  # 8,388,608 words: a rate of bytes, not a launch
BOOST_HZ = 1.98e9
ISSUE_PER_SM = 128
# Per mode: the instructions issued per stream step of one element in the
# design (csrc/dtype.cu), and per instruction class its count per step and
# its row of the Programming Guide's table (compute capability 9.0,
# results per cycle per SM; a 16-bit pair instruction gives 2 results).
RATE_BOUNDS = {
    "f32_fma": (1.0, [("FFMA", 1.0, "32-bit floating-point add, multiply, "
                       "multiply-add", 128)]),
    "f32_select": (2.0, [("FADD", 1.0, "32-bit floating-point add, "
                          "multiply, multiply-add", 128)]),
    "bf16_fma": (0.5, [("HFMA2.BF16", 1.0, "16-bit floating-point add, "
                        "multiply, multiply-add", 256)]),
    "bf16_select": (1.0, [("HADD2.BF16", 1.0, "16-bit floating-point add, "
                           "multiply, multiply-add", 256),
                          ("LOP3", 0.5, "32-bit bitwise AND, OR, XOR", 64)]),
    "i16_select": (1.0, [("LOP3", 0.5, "32-bit bitwise AND, OR, XOR", 64),
                         ("packed add", 0.5, "32-bit integer add, "
                          "subtract", 64)]),
}


def steps_per_cycle_bound(mode: str) -> float:
    """Stream steps an SM can finish a cycle at best in ``mode``."""
    issued, classes = RATE_BOUNDS[mode]
    rates = [ISSUE_PER_SM / issued] + [rate / count
                                       for _, count, _, rate in classes]
    return min(rates)


def rate_bound_ms(mode: str, steps: int, nbytes: int) -> dict:
    """Least time of a call of ``steps`` stream steps moving ``nbytes``."""
    ops_ms = steps / (steps_per_cycle_bound(mode) * SMS * BOOST_HZ) * 1e3
    bytes_ms = nbytes / profile_render.HBM_RATE * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def bitcast_bound_ms(words: int) -> float:
    """A word read and two halves written: 8 bytes a word over the memory
    rate."""
    return 8 * words / profile_render.HBM_RATE * 1e3


# ---------------------------------------------------------------- layout
def candidates(x: torch.Tensor) -> dict[str, np.ndarray]:
    """The JAX probe's four candidate int16 layouts of f32 ``x [8, 128]``."""
    w = x.cpu().contiguous().view(torch.int32).numpy().view(np.uint32)
    lo = (w & 0xFFFF).astype(np.uint16)
    hi = (w >> 16).astype(np.uint16)
    return {
        "interleave(lo,hi)": np.stack([lo, hi], 1).reshape(16, 128),
        "interleave(hi,lo)": np.stack([hi, lo], 1).reshape(16, 128),
        "concat(lo,hi)": np.concatenate([lo, hi], 0),
        "concat(hi,lo)": np.concatenate([hi, lo], 0),
    }


def name_layout(out: torch.Tensor, x: torch.Tensor) -> str:
    """Which of the JAX probe's candidates ``out`` (int16 [16, 128]) is."""
    got = out.cpu().numpy().astype(np.uint16)
    for name, want in candidates(x).items():
        if np.array_equal(got, want):
            return name
    return "unknown"


def name_view_layout(view: torch.Tensor, x: torch.Tensor) -> str:
    """The layout of ``x.view(torch.int16)`` ([8, 256]): the two halves of
    each word side by side in its row, low half first or high half first."""
    w = x.cpu().contiguous().view(torch.int32).numpy().view(np.uint32)
    lo = (w & 0xFFFF).astype(np.uint16)
    hi = (w >> 16).astype(np.uint16)
    got = view.cpu().numpy().astype(np.uint16)
    for name, pair in (("column-interleave(lo,hi)", (lo, hi)),
                       ("column-interleave(hi,lo)", (hi, lo))):
        if np.array_equal(got, np.stack(pair, -1).reshape(8, 256)):
            return name
    return "unknown"


def name_half(bits: int, word: int) -> str:
    return {word & 0xFFFF: "lo", word >> 16: "hi"}.get(bits, "unknown")


def layout(device) -> dict:
    """The kernel's bitcast layout, the plain version's, torch's int16 view
    on ``device``, and the half ``.x`` reads."""
    x = rdt.bitcast_input().to(device)
    out, halves = rdt.bitcast(x, halves=True)
    plain = rdt.bitcast_reference(x)
    word = int(x.cpu().view(torch.int32).numpy().view(np.uint32)[0, 0])
    hv = [int(v) for v in halves.cpu()]
    return {
        "shape": list(out.shape),
        "kernel": name_layout(out, x),
        "plain": name_layout(plain, x),
        "torch_view": name_view_layout(x.view(torch.int16), x),
        "bfloat162_x": name_half(hv[0], word),
        "short2_x": name_half(hv[1], word),
    }


# ---------------------------------------------------------------- SASS
def loop_bodies(listing: str) -> dict[str, list[str]]:
    """Per function of ``cuobjdump -sass`` output, the instructions of its
    largest loop: the body from a backward branch's target to the branch
    (plain ``BRA`` only)."""
    bodies = {}
    for fname, insns in functions(listing).items():
        best: list[str] = []
        for lo, hi in backward_branches(insns, uniform=False):
            body = [t for a, t in insns if lo <= a <= hi]
            if len(body) > len(best):
                best = body
        bodies[fname] = best
    return bodies


def sass_counts() -> dict:
    """Each rate mode's main loop body in the built library: instructions
    (NOPs left out) per stream step of one element, and its opcodes."""
    tool = cuobjdump()
    if tool is None:
        return {"available": False, "why": "cuobjdump not found"}
    proc = subprocess.run([tool, "-sass", str(_build.build("dtype"))],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        return {"available": False, "why": proc.stderr.strip()[-300:]}
    out = {"available": True, "modes": {}}
    per_body = rdt.steps_per_body()
    for fname, body in loop_bodies(proc.stdout).items():
        m = re.search(r"rate_kernelILi(\d)E", fname)
        if not m:
            continue
        mode = rdt.RATE_MODES[int(m.group(1))]
        ops = [t.split()[0] for t in body if t.split()[0] != "NOP"]
        per_word = 1 if mode.startswith("f32") else 2
        steps = per_body * rdt.STREAMS * per_word
        out["modes"][mode] = {
            "body_instructions": len(ops),
            "element_steps": steps,
            "instructions_per_step": len(ops) / steps if steps else None,
            "opcodes": dict(collections.Counter(ops).most_common()),
        }
    return out


# ---------------------------------------------------------------- rates
def probe_rate(mode: str, units: int, iters: int, calls: int) -> dict:
    """One rate mode on ``rate_probe``'s tile replicated over ``units``,
    timed."""
    dev = torch.device("cuda")
    a, b = (rdt.replicate(t, units).to(dev) for t in
            rdt.inputs(rdt.mode_dtype(mode)))
    ms = profile_render.median_ms(lambda: rdt.rate(a, b, mode, iters),
                                  calls)
    clock = sm_clock_mhz()
    steps = rdt.element_steps(a.numel(), iters)
    nbytes = 3 * a.numel() * a.element_size()
    return {
        "units": units, "iters": iters, "elements": a.numel(), "ms": ms,
        "us_per_call": ms * 1e3, "element_steps": steps,
        "steps_per_s": steps / (ms * 1e-3),
        "steps_per_sm_cycle": steps / (ms * 1e-3 * clock * 1e6 * SMS),
        "sm_clock_mhz": clock,
        "bound_steps_per_sm_cycle": steps_per_cycle_bound(mode),
        "table_rows": [row for _, _, row, _ in RATE_BOUNDS[mode][1]],
        **rate_bound_ms(mode, steps, nbytes),
    }


BITCAST_LOOPS = 200  # back-to-back calls a timing at one tile


def bitcast_library(x: torch.Tensor):
    """The one PyTorch call of the bitcast's function: ``view`` +
    ``unflatten`` + ``transpose`` + ``contiguous``."""
    return lambda: (x.view(torch.int16).unflatten(-1, (rdt.COLS, 2))
                    .transpose(-1, -2).contiguous())


def bitcast_mode_of(fname: str) -> str | None:
    """``bitcast`` for the library's bitcast kernels (every body), else
    None."""
    return "bitcast" if "bitcast" in fname else None


def probe_bitcast(units: int, calls: int) -> dict:
    """The bitcast at ``units`` tiles (a rate of bytes) and at one tile
    (1,024 words: a launch's latency and the host's work), each call's time
    split three ways (``probe_fetch.split``: back to back, host µs a call,
    device ms a call), beside the library call's, and the library's global
    loads and stores by width (``sass.accesses_by_mode``)."""
    dev = torch.device("cuda")
    x = rdt.replicate(rdt.bitcast_input(), units).to(dev)
    small = rdt.bitcast_input().to(dev)
    res = {"units": units, "words": x.numel(), "words_small": small.numel(),
           "bound_ms": bitcast_bound_ms(x.numel()), "bound_by": "bytes",
           "bound_ms_small": bitcast_bound_ms(small.numel())}
    for suffix, t, loops in (("", x, 10), ("_small", small, BITCAST_LOOPS)):
        for prefix, fn in (("", lambda t=t: rdt.bitcast(t)),
                           ("library_", bitcast_library(t))):
            for key, value in split(fn, loops, calls).items():
                res[f"{prefix}{key}{suffix}"] = value
    res["sass"] = sass.accesses_by_mode(_build.build("dtype"),
                                        bitcast_mode_of, ("bitcast",))
    return res


def run(units: int | None = None, iters: int = 2048,
        calls: int = 5) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("probe_dtype measures the card: CUDA is not "
                           "available")
    if units is None:
        units = 2 * torch.cuda.get_device_properties(0).multi_processor_count
    res = {"device": torch.cuda.get_device_name(0),
           "card": profile_render.card_line(),
           "layout": layout(torch.device("cuda")),
           "rates": {m: probe_rate(m, units, iters, calls)
                     for m in rdt.RATE_MODES},
           "bitcast": probe_bitcast(BITCAST_UNITS, calls),
           "sass": sass_counts()}
    return res


def describe_bitcast(bc: dict, suffix: str = "") -> str:
    """One line of the bitcast's times at one size (``suffix`` "" or
    "_small") beside the library call's and the bound."""
    def get(key, prefix=""):
        return bc[f"{prefix}{key}{suffix}"]

    return (f"{get('ms'):.5f} ms back to back, host {get('host_us'):.2f} "
            f"us, device {device_text(get('device_ms'))}; view + contiguous "
            f"{get('ms', 'library_'):.5f} ms, host "
            f"{get('host_us', 'library_'):.2f} us, device "
            f"{device_text(get('device_ms', 'library_'))}; bound "
            f"{get('bound_ms'):.5f} ms by bytes")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="probe_dtype", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--units", type=int)
    ap.add_argument("--iters", type=int, default=2048)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--out", help="also write the result as JSON here")
    args = ap.parse_args(argv)
    res = run(args.units, args.iters, args.calls)
    lay = res["layout"]
    print(f"bitcast f32(8,128)->i16 shape: {tuple(lay['shape'])}")
    print(f"  layout = {lay['kernel']} (plain version {lay['plain']}); "
          f"torch view(int16) = {lay['torch_view']}; __nv_bfloat162.x = "
          f"{lay['bfloat162_x']}, short2.x = {lay['short2_x']}")
    sass = res["sass"].get("modes", {})
    for mode, r in res["rates"].items():
        s = sass.get(mode)
        sass_txt = (f"; SASS {s['instructions_per_step']:.3f} insn/step "
                    f"{s['opcodes']}" if s else "; SASS not available")
        print(f"  {mode:11s} {r['units']} units x {r['iters']} steps: "
              f"{r['us_per_call']:9.1f} us  {r['steps_per_s'] / 1e12:7.3f} T "
              f"steps/s  {r['steps_per_sm_cycle']:7.2f} steps/SM cycle "
              f"(bound {r['bound_steps_per_sm_cycle']:.0f}, "
              f"{r['sm_clock_mhz']:.0f} MHz){sass_txt}")
    bc = res["bitcast"]
    for suffix in ("", "_small"):
        print(f"  bitcast {bc['words' + suffix]} words: "
              f"{describe_bitcast(bc, suffix)}")
    if bc["sass"]["available"]:
        print(f"  bitcast SASS global accesses {bc['sass']['modes']['bitcast']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
