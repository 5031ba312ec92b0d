"""Host milliseconds, with a synchronise on each side, to build the
configuration's scene through the program's builders and pack its tables
(``Renderer`` construction, or ``pack_scene`` for caller rays)."""

LAYER = "scene build and packing"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "setup_s"
BETTER = "lower"


def read(run):
    return run.build_ms
