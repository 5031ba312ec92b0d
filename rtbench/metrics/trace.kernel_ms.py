"""Device milliseconds of a trace-entry launch (one caller batch), the mean
over the traced window's batches (profiler, by kernel name)."""

from rtbench.metrics._common import TRACE, ms_per_launch

LAYER = "megakernel trace entry"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "trace_p95_ms"
BETTER = "lower"


def read(run):
    if run.kind != "ray_batches" or run.record is None:
        return None
    return ms_per_launch(run.record, TRACE)
