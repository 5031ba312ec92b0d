"""Probes of the winner fetch on the card (``csrc/fetch.cu``).

The Hopper counterparts of the JAX package's fetch probes, on the packed
shade tables (6 words a row) of the cover scene (512 rows) and of
``stress:8192`` (8,192 rows), with seeded selections:

* ``probe_mxu_gather``: each mode's words against the indexed load's,
  with the first mismatching (column, lane, row) and both words;
* ``probe_mxu_chain``: a fetch, a selection derived from its words
  (``|w0 ^ w4| & (rows - 1)``), a fetch again;
* ``probe_mxu_loop``: 8 fetches, each selection fed back from the words
  so far, the card against the plain version (``ops/fetch.py``);
* ``probe_fold``: the cost of the fetch, ns per fetched word for every
  mode (CUDA events over back-to-back calls), the warp exchange keeping
  32-bit words ("radix") against two 16-bit halves per register selected
  with ``__byte_perm`` ("radix16"), and the one-hot mode with its plane
  prepass (and the prepass alone), beside ``torch.index_select`` on the
  same selections, the least time of the bytes moved, and each mode's own
  work bound (``work_bound_ms``).

Usage (on the card; prints one JSON line per table, and the whole result
as one JSON object last)::

    python -m raytracing_tpu_torch.tools.probe_fetch [--lanes 2073600]
        [--reps 5] [--out probe_fetch.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..ops import fetch as rfetch
from ..ops import trace as rtrace
from ..scene import config as rconfig

COVER = "data/config/world.config.json"
MODES = ("index", "radix", "radix16", "onehot")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA's data sheet)
BF16_TENSOR_FLOPS = 989e12  # dense bf16 on the tensor cores, same sheet
# Warp shuffles a SM retires per cycle (32 lanes: the CUDA C++
# Programming Guide's throughput table, compute capability 9.0), the
# card's SMs and its largest SM clock.
SHFL_PER_SM_CYCLE = 1
SMS = 132
SM_HZ = 1.98e9
LOOP_ITERS = 8
# Back-to-back calls a timing covers, so that the host's launch work
# overlaps the card's.
TIMING_LOOPS = 20


def tables(device) -> dict[str, torch.Tensor]:
    """The packed shade words (int32 [rows, 6]) of cover and stress:8192."""
    out = {}
    for name in ("cover", "stress:8192"):
        if name == "cover":
            _, scene = rconfig.load_and_build(COVER)
        else:
            _, scene = rconfig.make_world_stress(8192)
        t = rtrace.pack_scene(scene, cull=False)
        out[name] = t.shade.view(torch.int32)[:, :6].contiguous().to(device)
    return out


def selections(rows: int, lanes: int, device, seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(0, rows, size=lanes).astype(np.int32)
    ).to(device)


def first_mismatch(got, want, sel) -> dict | None:
    """The first differing (column, lane) of two [C, G] word arrays."""
    bad = (got != want).nonzero()
    if bad.numel() == 0:
        return None
    c, g = (int(v) for v in bad[0])
    return {"column": c, "lane": g, "row": int(sel[g]),
            "got": f"{int(got[c, g]) & 0xFFFFFFFF:#010x}",
            "want": f"{int(want[c, g]) & 0xFFFFFFFF:#010x}"}


def median_ms(fn, reps: int = 5, loops: int = 1) -> float:
    """Median over ``reps`` CUDA-event timings of ``loops`` back-to-back
    calls, per call, after a warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(loops):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / loops)
    return float(np.median(times))


def host_us(fn, calls: int = 200) -> float:
    """Host µs a call: a host clock over ``calls`` calls with no
    synchronise between them (after a warm-up call and a synchronise),
    then one synchronise outside the clock. Where a call costs the card
    less than the host, this is what back-to-back calls are held to."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / calls * 1e6


def device_ms(fn, calls: int = 20, tries: int = 3) -> float | None:
    """Device ms a call from ``torch.profiler`` over ``calls`` calls: per
    device event name (a kernel or a copy), the median time of its events,
    summed over the names. Every call timed here runs each of its kernels
    once; medians, not sums over calls, because the profiler drops some
    events in a long process (a quarter of them in chip_smoke's). None
    where ``tries`` profiles recorded no device event."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        times: dict[str, list[float]] = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                times.setdefault(e.name, []).append(
                    e.time_range.end - e.time_range.start)
        if times:
            return sum(float(np.median(t)) for t in times.values()) / 1e3
    return None


def split(fn, loops: int, reps: int = 5, calls: int = 20) -> dict:
    """A call's time three ways: the back-to-back median (``median_ms``
    over ``loops`` calls), the host µs a call (``host_us`` over 10 ×
    ``loops`` calls) and the device ms a call (``device_ms``)."""
    return {"ms": median_ms(fn, reps, loops),
            "host_us": host_us(fn, 10 * loops),
            "device_ms": device_ms(fn, calls)}


def bound_ms(rows: int, cols: int, lanes: int) -> float:
    """Least time of the fetch: the selections read, C words a lane
    written and the table read once, over the card's memory rate."""
    return (4 * lanes + 4 * cols * lanes + 4 * rows * cols) / HBM_BYTES_PER_S * 1e3


def planes_bound_ms(rows: int, cols: int) -> float:
    """Least time of the plane prepass: the table read once and the
    planes written once, over the card's memory rate."""
    k_pad, width = rfetch.plane_shape(rows, cols)
    return (4 * rows * cols + 2 * k_pad * width) / HBM_BYTES_PER_S * 1e3


def work_bound_ms(mode: str, rows: int, cols: int, lanes: int) -> float:
    """Least time of a mode's own work on these inputs: the one-hot
    product's FLOP (2 per lane, table row and byte plane) over the tensor
    cores' bf16 rate; the exchange's warp shuffles (one per word, chunk of
    32 rows and warp) over the SMs' shuffle rate; 0 for the indexed load,
    whose work is its bytes."""
    if mode == "onehot":
        return 2 * lanes * rows * 4 * cols / BF16_TENSOR_FLOPS * 1e3
    if mode in ("radix", "radix16"):
        shuffles = -(-lanes // 32) * -(-rows // 32) * cols
        return shuffles / (SHFL_PER_SM_CYCLE * SMS * SM_HZ) * 1e3
    return 0.0


def probe_table(name: str, table: torch.Tensor, lanes: int, reps: int,
                plain_lanes: int) -> dict:
    rows, cols = table.shape
    dev = table.device
    sel = selections(rows, lanes, dev)
    res = {"table": name, "rows": rows, "cols": cols, "lanes": lanes}

    # probe_mxu_gather: every mode against the indexed load.
    want = table[sel.long()].t()
    gather = {}
    for mode in MODES:
        got = rfetch.fetch_rows(table, sel, mode)
        torch.cuda.synchronize()
        gather[mode] = {"mismatches": int((got != want).sum()),
                        "first": first_mismatch(got, want, sel)}
    res["gather"] = gather

    # probe_mxu_chain: fetch, derive, fetch.
    chain = {}
    for mode in MODES:
        c1 = rfetch.fetch_rows(table, sel, mode)
        s2 = ((c1[0] ^ c1[4]).long().abs() & (rows - 1)).to(torch.int32)
        c2 = rfetch.fetch_rows(table, s2, mode)
        torch.cuda.synchronize()
        w1, w2 = table[sel.long()].t(), table[s2.long()].t()
        chain[mode] = {"mismatches": int((c1 != w1).sum() + (c2 != w2).sum())}
    res["chain"] = chain

    # probe_mxu_loop: 8 fed-back fetches, card against the plain version
    # (its indexed form on every lane, its literal modes on a window).
    loop = {}
    plain_all = rfetch.fetch_loop_reference(table, sel, "index", LOOP_ITERS)
    part = sel[:plain_lanes]
    for mode in MODES:
        got = rfetch.fetch_rows(table, sel, mode, LOOP_ITERS)
        torch.cuda.synchronize()
        plain = rfetch.fetch_loop_reference(table, part, mode, LOOP_ITERS)
        loop[mode] = {
            "mismatches": int((got != plain_all).sum()),
            "plain_window_mismatches": int((got[:, :plain_lanes] != plain).sum()),
        }
    res["loop"] = loop

    # probe_fold: ns per fetched word.
    timing = {}
    words = lanes * cols
    for mode in MODES:
        ms = median_ms(lambda m=mode: rfetch.fetch_rows(table, sel, m), reps,
                       TIMING_LOOPS)
        timing[mode] = {"ms": ms, "ns_per_word": ms * 1e6 / words,
                        "work_bound_ms": work_bound_ms(mode, rows, cols,
                                                       lanes)}
    ms = median_ms(lambda: rfetch.fetch_planes(table), reps, TIMING_LOOPS)
    timing["planes"] = {"ms": ms, "bound_ms": planes_bound_ms(rows, cols)}
    lib = median_ms(lambda: torch.index_select(table, 0, sel), reps,
                    TIMING_LOOPS)
    timing["index_select"] = {"ms": lib, "ns_per_word": lib * 1e6 / words}
    res["timing"] = timing
    res["bound_ms"] = bound_ms(rows, cols, lanes)
    res["fold_faster"] = ("radix" if timing["radix"]["ms"]
                          <= timing["radix16"]["ms"] else "radix16")
    return res


def plain_times(table: torch.Tensor, lanes: int) -> dict:
    """The plain version's time (ms, host clock around a synchronized
    call) of each mode on ``lanes`` selections of ``table``, and of the
    plane prepass's (``planes``)."""
    import time

    sel = selections(table.shape[0], lanes, table.device)
    out = {}
    for mode in ("index", "radix", "onehot", "planes"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "planes":
            rfetch.plane_tiles_reference(rfetch.plane_table_reference(table))
        else:
            rfetch.fetch_loop_reference(table, sel, mode)
        torch.cuda.synchronize()
        out[mode] = (time.perf_counter() - t0) * 1e3
    return out


def run(lanes: int = 2_073_600, reps: int = 5, plain_lanes: int = 4096) -> dict:
    """Every probe on both tables; fails (AssertionError) on any mismatch."""
    if not torch.cuda.is_available():
        raise RuntimeError("probe_fetch measures the card: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    results = [probe_table(name, t, lanes, reps, plain_lanes)
               for name, t in tables(dev).items()]
    for r in results:
        for probe in ("gather", "chain", "loop"):
            for mode, v in r[probe].items():
                bad = v["mismatches"] + v.get("plain_window_mismatches", 0)
                if bad:
                    raise AssertionError(
                        f"probe_fetch {r['table']} {probe} {mode}: {bad} "
                        f"mismatching words ({v.get('first')})"
                    )
    return {"device": torch.cuda.get_device_name(0), "tables": results}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="probe_fetch", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--lanes", type=int, default=2_073_600)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", help="also write the result as JSON here")
    args = ap.parse_args(argv)
    res = run(args.lanes, args.reps)
    for r in res["tables"]:
        print(json.dumps({k: r[k] for k in ("table", "rows", "lanes",
                                            "timing", "bound_ms",
                                            "fold_faster")}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
