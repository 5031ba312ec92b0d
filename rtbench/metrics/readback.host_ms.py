"""Host milliseconds of a render's readback that the device does not do:
the program's ``rt.render.readback`` span (``Renderer._finish``) less its
``rt.readback.copy`` (the copy, which takes in the wait for the last
kernel), leaving the untile and the segment count's wait; the mean over
the traced window's renders."""

from rtbench.metrics._spans import named

LAYER = "readback"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "mpaths_per_s"
BETTER = "lower"


def read(run):
    if run.kind != "renders" or run.record is None:
        return None
    copies = named(run.record, "rt.readback.copy")
    vals = [(b - a - sum(d - c for c, d in copies if a <= c and d <= b)) / 1e3
            for a, b in named(run.record, "rt.render.readback")]
    return sum(vals) / len(vals) if vals else None
