"""The share of the chunked sweep's block visits whose thread-block vote
copied the chunk: the program's ``chunk_copies`` over its
``block_visits``, summed over the window's renders
(``Renderer.cull_counts``). A copy is taken, and swept by the warps with a
passing lane, when any live thread of the block passes the block's gate.
Nothing to read from a program without the counts, or with no visit."""

LAYER = "cull gate"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "mpaths_per_s"
BETTER = "lower"


def read(run):
    counts = getattr(run, "cull", None)
    if run.kind != "renders" or not counts or None in counts:
        return None
    visits = sum(c["block_visits"] for c in counts)
    if not visits:
        return None
    return 100.0 * sum(c["chunk_copies"] for c in counts) / visits
