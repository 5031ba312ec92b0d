"""The 95th percentile (nearest rank) of the presenter's host milliseconds
drawing a frame, over the frames the window's steps returned: the
session's ``presents`` counter (host clock; the presenter runs on the
pipeline's worker thread, where the profiler records no span), its entries
picked by frame index, so that frames presented after the window are left
out. The counter's wait for the frame's copy is left out: it ends when the
device's frame does."""

from rtbench.yardstick import percentile

LAYER = "application shell"
UNIT = "ms"
SOURCE = "program_counter"
MOVES = "frames_per_s"
BETTER = "lower"


def read(run):
    if run.kind != "orbit_frames":
        return None
    presents = getattr(getattr(run, "session", None), "presents", None)
    frames = {q[0] for q in getattr(run, "requests", ())}
    vals = [d for f, _, d in presents or () if f in frames]
    return percentile(vals, 95) if vals else None
