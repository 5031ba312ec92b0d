"""The regen kernels' share of their roofline: the least time of the
window's segments against every real sphere row (``yardstick.least_ms``,
the copy of ``profile_render.bound``) over the regen kernels' device time.
Only for tables the program sweeps whole (spheres alone, at most 512
rows): a culled table's swept rows have no count that does not depend on
the implementation yet, so the reader finds nothing there."""

from rtbench.metrics._common import REGEN
from rtbench.yardstick import least_ms

LAYER = "megakernel regen entry"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "mpaths_per_s"
BETTER = "higher"
ROW_BYTES = 4 * (8 + 8 + 8)


def read(run):
    if run.kind != "renders" or run.record is None:
        return None
    c = run.scene_counts
    if c["m_actual"] or c["n_pad"] > 512:
        return None
    ks = run.record.kernels(REGEN)
    if not ks:
        return None
    busy_ms = sum(b - a for _, a, b in ks) / 1e3
    bound, _ = least_ms(run.segments, c["n_actual"], 0,
                        c["n_actual"] * ROW_BYTES, run.slots)
    return 100.0 * bound / busy_ms
