"""Per render, from the end of its last regen kernel on the device to
``render()`` returning the u8 image on the host (``_slots_to_u8``, the
copy, ``_slots_to_image``), from the profiler's timeline; the mean over
the traced window's renders."""

from rtbench.metrics._common import REGEN

LAYER = "readback"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "mpaths_per_s"
BETTER = "lower"


def read(run):
    if run.kind != "renders" or run.record is None:
        return None
    ends = [b for _, a, b in run.record.kernels(REGEN)]
    vals = []
    for a, b in run.record.spans_named("rtbench.render"):
        inside = [e for e in ends if a <= e <= b]
        if inside:
            vals.append((b - max(inside)) / 1e3)
    return sum(vals) / len(vals) if vals else None
