"""The 95th percentile (nearest rank) of the intervals between presented
frames over the traced window: the orbit's stutter, which the session's
presenter thread adds to the device's frame time (host clock)."""

LAYER = "application shell"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "frames_per_s"
BETTER = "lower"


def read(run):
    if run.kind != "orbit_frames":
        return None
    return run.frame_p95_ms
