"""Device milliseconds of a regen-entry launch (one wave of a render), the
mean over the traced window's waves (profiler, by kernel name)."""

from rtbench.metrics._common import REGEN, ms_per_launch

LAYER = "megakernel regen entry"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "mpaths_per_s"
BETTER = "lower"


def read(run):
    if run.kind != "renders" or run.record is None:
        return None
    return ms_per_launch(run.record, REGEN)
