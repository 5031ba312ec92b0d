"""Host milliseconds of a step's own work on the main thread: each window
step (the harness's ``rtbench.step`` around ``InteractiveSession.step``)
less the program's ``rt.frame.wait`` spans inside it, where the main
thread is blocked on the pipeline's pending presents; the mean over the
traced window's steps. While the device is the bottleneck the wait takes
up what this leaves, so it moves ``frames_per_s`` only once the device's
frame is shorter than the host's."""

from rtbench.metrics._spans import named

LAYER = "application shell"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"
BETTER = "lower"


def read(run):
    if run.kind != "orbit_frames" or run.record is None:
        return None
    a0, b0 = run.record.window
    waits = named(run.record, "rt.frame.wait")
    steps = [(a, b) for a, b in run.record.spans_named("rtbench.step")
             if a0 <= a and b <= b0]
    if not waits or not steps:
        return None
    vals = [b - a - sum(d - c for c, d in waits if a <= c and d <= b)
            for a, b in steps]
    return sum(vals) / len(vals) / 1e3
