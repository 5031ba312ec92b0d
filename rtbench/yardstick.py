"""The benchmark's own arithmetic: statistics, the busy-interval union and
the least time of a render's work.

Copies, so that a change to the program cannot move the yardstick:

* ``union_us``: ``tools/profile_render.py::_union_us`` (raytracing_tpu_torch
  at commit a1403821e8fd), the device's busy time as the union of its
  kernel and copy intervals.
* ``SPHERE_PAIR_OPS`` .. ``HBM_RATE`` and ``least_ms``:
  ``tools/profile_render.py::bound`` (same commit) for tables without the
  cull's bound tables: FP32 operations over 67 TFLOP/s, or bytes over
  3.35 TB/s, whichever is larger.
"""

from __future__ import annotations

import math

# FP32 operations of the regen kernel per (ray, sphere) pair of the sweep,
# per (ray, triangle) pair of the candidate key, per segment (the ray's
# invariants and the shading) and per exact re-test of a triangle winner.
SPHERE_PAIR_OPS = 19
TRIANGLE_PAIR_OPS = 48
SEGMENT_OPS = 200
TRI_EXACT_OPS = 75
# Published H100 SXM peaks at 700 W.
FP32_PEAK = 67.0e12
HBM_RATE = 3.35e12
# Bytes a pixel slot reads and writes (done count and running sums).
SLOT_BYTES = 4 + 4 + 12 + 12


def least_ms(segments: int, n_spheres: int, n_triangles: int,
             table_bytes: int, slots: int) -> tuple[float, str]:
    """Least time (ms) of ``segments`` segments against every real row of
    unculled tables, and what bounds it ("operations" or "bytes")."""
    ops = (segments * (SEGMENT_OPS + (TRI_EXACT_OPS if n_triangles else 0))
           + segments * n_spheres * SPHERE_PAIR_OPS
           + segments * n_triangles * TRIANGLE_PAIR_OPS)
    ops_ms = ops / FP32_PEAK * 1e3
    bytes_ms = (table_bytes + slots * SLOT_BYTES) / HBM_RATE * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def percentile(values, q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least ``q`` % of
    the values at or below it."""
    s = sorted(values)
    if not s:
        raise ValueError("percentile of no values")
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def beyond(n: int, q: float) -> int:
    """How many of ``n`` samples lie beyond the nearest-rank ``q``
    percentile."""
    return n - max(1, math.ceil(q / 100.0 * n))

