"""The (ray, block) pairs whose cull gate passed, per segment: the
program's ``lane_passes`` over its segments, both summed over the window's
renders (``Renderer.cull_counts``, taken with the segments). Each pass is
a 512-row block the kernel sweeps for that ray. Nothing to read from a
program without the counts, or where no block was gated."""

LAYER = "cull gate"
UNIT = "pairs"
SOURCE = "program_counter"
MOVES = "mpaths_per_s"
BETTER = "lower"


def read(run):
    counts = getattr(run, "cull", None)
    if run.kind != "renders" or not counts or None in counts:
        return None
    passes = sum(c["lane_passes"] for c in counts)
    segments = sum(q[1] for q in run.requests)
    if not passes or not segments:
        return None
    return passes / segments
