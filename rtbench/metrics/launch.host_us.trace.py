"""Host microseconds of a trace-entry launch: the mean over the traced
window's batches of the program's ``rt.launch.trace`` span
(``ops/trace.py::trace_rays_fused``, call to return: the argument checks,
the output allocation, the launch)."""

from rtbench.metrics._spans import mean_us

LAYER = "launch wrappers"
UNIT = "us"
SOURCE = "program_span"
MOVES = "trace_p95_ms"
BETTER = "lower"


def read(run):
    if run.kind != "ray_batches" or run.record is None:
        return None
    return mean_us(run.record, "rt.launch.trace")
