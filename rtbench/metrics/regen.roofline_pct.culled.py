"""The regen kernels' share of their roofline on a culled sphere table:
the least time of the window's culled work (``yardstick_cull.least_ms``:
the program's segments, each gating every block and sweeping the real
rows of the blocks that the reference's replay of the gate passes, taken
per segment on average over the replay's paths) over the regen kernels' device time in the window.
Only for sphere tables behind the cull (spheres alone, past 512 rows),
whose drive keeps the reference's replay (``culled_renders``)."""

from rtbench.metrics._common import REGEN
from rtbench.yardstick_cull import least_ms

LAYER = "megakernel regen entry"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "mpaths_per_s"
BETTER = "higher"
BLOCK_ROWS = 512
ROW_BYTES = 4 * (8 + 8 + 8)


def read(run):
    if (run.kind != "renders" or run.record is None
            or not hasattr(run, "reference_passes")):
        return None
    c = run.scene_counts
    if c["m_actual"] or c["n_pad"] <= BLOCK_ROWS:
        return None
    ks = run.record.kernels(REGEN)
    if not ks:
        return None
    busy_ms = sum(b - a for _, a, b in ks) / 1e3
    segments, _, swept = run.reference_passes
    bound, _ = least_ms(run.segments, c["n_pad"] // BLOCK_ROWS,
                        swept / segments, c["n_actual"] * ROW_BYTES,
                        run.slots)
    return 100.0 * bound / busy_ms
