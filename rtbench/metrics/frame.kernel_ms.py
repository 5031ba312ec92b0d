"""Device milliseconds of the regen-entry launch of an interactive frame
(the frame API), the mean over the traced window's frames."""

from rtbench.metrics._common import REGEN, ms_per_launch

LAYER = "megakernel regen entry"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "frames_per_s"
BETTER = "lower"


def read(run):
    if run.kind != "orbit_frames" or run.record is None:
        return None
    return ms_per_launch(run.record, REGEN)
