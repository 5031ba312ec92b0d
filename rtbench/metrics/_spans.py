"""What the program-span readers share: the port's own spans (``rt.*``,
catalogued in ``raytracing_tpu_torch/utils/spans.py``) as the traced
record holds them among its host events, kept where they lie inside the
measured window. A program without those spans leaves every reader
empty-handed, so each returns None there."""

from __future__ import annotations


def named(record, name: str) -> list:
    """(start, end) in microseconds of the spans called ``name`` that lie
    inside the window, in start order."""
    a0, b0 = record.window
    return sorted((a, b) for n, a, b in record.host
                  if n == name and a0 <= a and b <= b0)


def mean_us(record, name: str) -> float | None:
    """Mean microseconds of the spans called ``name`` in the window."""
    iv = named(record, name)
    if not iv:
        return None
    return sum(b - a for a, b in iv) / len(iv)

