"""The least time of a culled render's work: the benchmark's own
arithmetic for sphere tables behind the box cull, beside ``yardstick.py``
(whose constants it takes).

A segment costs its own work (``SEGMENT_OPS``), the gate on every block of
the table (``GATE_OPS`` each) and the sweep of every real row of the
blocks whose gate passes (``SPHERE_PAIR_OPS`` a row). Which blocks pass is
the reference's replay of the gate (``reference/cull.py``), not the
kernel's schedule, so the count does not move with the implementation.
Operations over 67 TFLOP/s, or bytes over 3.35 TB/s, whichever is
larger.
"""

from __future__ import annotations

from .yardstick import (FP32_PEAK, HBM_RATE, SEGMENT_OPS, SLOT_BYTES,
                        SPHERE_PAIR_OPS)

# FP32 operations of ``cull_gate_box`` (``reference/cull.py``, one box a
# block) for one (ray, block) pair as it is written, an absolute value
# counted as no operation (it is an operand's sign):
#   ds = GRAZE * (so + bmag)                           2
#   per axis: t1, t2 (a multiply and a subtract each)  4
#             m = ds*|iv| + SLAB*(|t1| + |t2| + 2|oi|) 6
#             tn_j = min - m, tf_j = max + m           4
#   the axes' windows: two max and two min             4
#   reject: tn > tf, tf <= TF_MIN                      2
#           tn * a > cur_hi + 1e-3 + 1e-3 * |cur_hi|   5
#   valid > 0.5                                        1
# 2 + 3 * (4 + 6 + 4) + 4 + 2 + 5 + 1 = 56.
GATE_OPS = 56


def least_ms(segments: int, blocks: int, rows_per_segment: float,
             table_bytes: int, slots: int) -> tuple[float, str]:
    """Least time (ms) of ``segments`` segments against a table of
    ``blocks`` culled blocks, each segment sweeping ``rows_per_segment``
    real rows on average (those of the blocks whose gate it passes), and
    what bounds it ("operations" or "bytes")."""
    ops = segments * (SEGMENT_OPS + blocks * GATE_OPS
                      + rows_per_segment * SPHERE_PAIR_OPS)
    ops_ms = ops / FP32_PEAK * 1e3
    bytes_ms = (table_bytes + slots * SLOT_BYTES) / HBM_RATE * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"
