"""The card's idle share of the traced window: 1 - (the union of its
kernel and copy intervals) / (the window's length), from the profiler."""

from rtbench.metrics._common import idle_pct

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "mpaths_per_s"
BETTER = "lower"


def read(run):
    if run.kind != "renders" or run.record is None:
        return None
    return idle_pct(run.record)
