"""Host microseconds of a regen-entry launch: the mean over the traced
window's waves of the program's ``rt.launch.regen`` span
(``ops/trace.py::render_pixels_fused``, call to return: the argument
checks, the output allocation, the launch)."""

from rtbench.metrics._spans import mean_us

LAYER = "launch wrappers"
UNIT = "us"
SOURCE = "program_span"
MOVES = "mpaths_per_s"
BETTER = "lower"


def read(run):
    if run.kind != "renders" or run.record is None:
        return None
    return mean_us(run.record, "rt.launch.regen")
