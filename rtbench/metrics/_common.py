"""What the per-layer readers share: the megakernel's kernel names as the
profiler shows them (``csrc/regen.cu``'s ``regen_staged``,
``regen_chunked``, ``trace_staged``, ``trace_chunked``) and device time
per launch."""

from __future__ import annotations

import re

REGEN = re.compile(r"\bregen_(staged|chunked)\b")
TRACE = re.compile(r"\btrace_(staged|chunked)\b")


def ms_per_launch(record, pattern) -> float | None:
    """Mean device milliseconds of the kernels ``pattern`` names."""
    ks = record.kernels(pattern)
    if not ks:
        return None
    return sum(b - a for _, a, b in ks) / len(ks) / 1e3


def idle_pct(record) -> float:
    return 100.0 * (1.0 - record.busy_s() / record.window_s)
