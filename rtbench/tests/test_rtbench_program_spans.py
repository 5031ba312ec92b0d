"""The readers of the program's own spans and counter on synthetic records
(spans outside the window ignored, nothing to read without them), and a
tiny traced CPU run of each cell: the harness reports each metric, with a
value, in the cells its entry lists and nowhere else."""

import types

import pytest

from rtbench import drives, spec, tracing
from rtbench.tests.tiny import CELLS, tiny_cell

BENCH = spec.load_benchmark()
NEW = ("launch.host_us.trace", "launch.host_us.regen", "readback.host_ms",
       "frame.host_ms", "frame.draw_p95_ms")
WINDOW = (0.0, 10_000.0)


def _run(kind, host=(), spans=(), **kw):
    rec = tracing.Record([], list(spans), list(host), WINDOW)
    return types.SimpleNamespace(kind=kind, record=rec, **kw)


def _read(name, run):
    return spec.metric_module(name).read(run)


@pytest.mark.parametrize("name,kind,span", [
    ("launch.host_us.trace", "ray_batches", "rt.launch.trace"),
    ("launch.host_us.regen", "renders", "rt.launch.regen"),
])
def test_launch_host_us_is_the_mean_span_in_the_window(name, kind, span):
    run = _run(kind, [(span, 10.0, 110.0), ("aten::empty", 20.0, 30.0),
                      (span, 200.0, 500.0), ("rt.launch.checks", 210.0, 260.0),
                      (span, -50.0, 20.0), (span, 9_990.0, 10_100.0)])
    assert _read(name, run) == pytest.approx(200.0)
    other = "renders" if kind == "ray_batches" else "ray_batches"
    assert _read(name, _run(other, run.record.host)) is None
    assert _read(name, _run(kind)) is None
    assert _read(name, types.SimpleNamespace(kind=kind, record=None)) is None


def test_readback_host_ms_leaves_out_the_copy():
    run = _run("renders", [
        ("rt.render.readback", 100.0, 1_100.0),
        ("rt.readback.copy", 100.0, 600.0),
        ("rt.readback.untile", 610.0, 1_000.0),
        ("rt.render.readback", 2_000.0, 2_600.0),
        ("rt.readback.copy", 2_000.0, 2_100.0),
        # Outside the window: neither counts.
        ("rt.render.readback", 9_000.0, 10_500.0),
        ("rt.readback.copy", 9_000.0, 9_100.0),
    ])
    assert _read("readback.host_ms", run) == pytest.approx(0.5)
    assert _read("readback.host_ms", _run("renders")) is None
    assert _read("readback.host_ms", _run("orbit_frames",
                                          run.record.host)) is None


def test_frame_host_ms_is_each_step_less_its_wait():
    steps = [("rtbench.step", 0.0, 4_000.0), ("rtbench.step", 4_000.0, 6_000.0),
             ("rtbench.step", 6_000.0, 8_000.0),
             # Outside the window: neither counts.
             ("rtbench.step", 9_500.0, 11_000.0)]
    host = [("rt.frame.wait", 500.0, 3_500.0),
            ("rt.frame.wait", 5_000.0, 6_000.0),
            ("rt.frame.wait", 9_600.0, 10_900.0)]
    run = _run("orbit_frames", host, steps)
    # (1,000 + 1,000 + 2,000) us over three steps.
    assert _read("frame.host_ms", run) == pytest.approx(4.0 / 3.0)
    # The parent's program has no wait span: nothing to read.
    assert _read("frame.host_ms", _run("orbit_frames", (), steps)) is None
    assert _read("frame.host_ms", _run("renders", host, steps)) is None


def test_draw_p95_reads_the_window_frames():
    # Frames 0-79 before the window (slow), 80-99 in it, 100-101 presented
    # after it, while the profiler's record was digested (slow). The waits
    # are left out.
    ring = tuple([(f, 1.0, 50.0) for f in range(80)]
                 + [(80 + k, 14.0 + k, 1.0 + k / 100) for k in range(20)]
                 + [(100, 300.0, 90.0), (101, 200.0, 90.0)])
    session = types.SimpleNamespace(presents=ring)
    run = types.SimpleNamespace(kind="orbit_frames", record=None,
                                session=session,
                                requests=[(80 + k, 0.02) for k in range(20)])
    # Nearest rank: the 19th of 20 draws.
    assert _read("frame.draw_p95_ms", run) == pytest.approx(1.18)
    run.requests += [(78, 0.02), (79, 0.02)]
    assert _read("frame.draw_p95_ms", run) == pytest.approx(50.0)
    # A session without the counter, or no frames: nothing to read.
    run.session = types.SimpleNamespace()
    assert _read("frame.draw_p95_ms", run) is None
    run.session, run.requests = session, []
    assert _read("frame.draw_p95_ms", run) is None
    run.kind = "renders"
    assert _read("frame.draw_p95_ms", run) is None


def test_new_entries_list_their_cells_and_readers_agree():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    assert [m["name"] for m in BENCH["per_layer"][-len(NEW):]] == list(NEW)
    for name in NEW:
        mod = spec.metric_module(name)
        m = entries[name]
        assert m["workloads"]
        assert (m["layer"], m["unit"], m["source"], m["moves"], m["better"]) \
            == (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES, mod.BETTER)


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_traced_run_reads_each_metric_in_its_cells(cell):
    d = drives.make(tiny_cell(cell), 2**31 + 99, "cpu", log=lambda m: None)
    d.setup()
    d.run_window(0.2, True)
    d.results()
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    # As the harness reports them: the cell's metrics that read a value.
    reported = {e["name"] for e, reader in d.cell.per_layer
                if e["name"] in NEW and reader.read(d) is not None}
    assert reported == {n for n in NEW if cell in entries[n]["workloads"]}
    assert all(_read(n, d) > 0.0 for n in reported)
    # The program's spans are host events, never device work.
    assert not [e for e in d.record.device if e[0].startswith("rt.")]
    d.release()
