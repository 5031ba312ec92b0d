"""The metric arithmetic on synthetic windows: all work over all time, the
tail over every sample, the idle share over the whole window, and a stall
planted in a window moves each."""

import pytest

from rtbench import drives, spec, tracing, yardstick
from rtbench.tests.tiny import tiny_cell


def _drive(name):
    cell = tiny_cell(name)
    d = drives.make(cell, 7, "cpu", log=lambda m: None)
    d.plan()
    return d


def test_rate_takes_all_work_over_all_time():
    d = _drive("cover.north_star")
    d.requests = [(1, 4_000_000, None, None, None)] * 3
    d.window_s = 2.0
    paths = 3 * d.width * d.height * d.spp
    assert d.results()["mpaths_per_s"] == pytest.approx(paths / 2e6)
    assert d.segments == 12_000_000
    d.window_s = 3.0  # a one-second stall in the same window
    assert d.results()["mpaths_per_s"] == pytest.approx(paths / 3e6)


def _p95(d, name):
    out = d.results()
    if name == "mesh3.rays":
        return out["trace_p95_ms"]
    return spec.metric_module("frame_p95_ms").read(d)


@pytest.mark.parametrize("name", ["mesh3.rays", "cover.orbit"])
def test_tail_is_over_every_sample(name):
    d = _drive(name)
    d.window_s = 0.6
    d.requests = [(i, 0.003, 0) for i in range(200)]
    assert _p95(d, name) == pytest.approx(3.0)
    # Ten stalls in 200 samples (5%) stay at or below the 95th percentile;
    # eleven move it.
    for k in range(10):
        d.requests[k * 19] = (k * 19, 0.050, 0)
    assert _p95(d, name) == pytest.approx(3.0)
    d.requests[7] = (7, 0.050, 0)
    assert _p95(d, name) == pytest.approx(50.0)


def test_frame_rate_takes_all_frames_over_all_time():
    d = _drive("cover.orbit")
    d.requests = [(i, 0.02, None) for i in range(100)]
    d.window_s = 2.0
    assert d.results()["frames_per_s"] == pytest.approx(50.0)
    d.window_s = 2.5  # a half-second stall
    assert d.results()["frames_per_s"] == pytest.approx(40.0)


def test_percentile_nearest_rank():
    v = list(range(1, 101))
    assert yardstick.percentile(v, 95) == 95
    assert yardstick.beyond(100, 95) == 5
    assert yardstick.percentile([5.0], 95) == 5.0


def _record(device, spans=(), window=(0.0, 1e6)):
    return tracing.Record(list(device), list(spans), [], window)


def test_idle_share_and_a_planted_stall():
    rec = _record([("k", 0.0, 6e5), ("k", 5e5, 9e5), ("copy", 9e5, 1e6)])
    assert rec.busy_s() == pytest.approx(1.0)
    idle = spec.metric_module("device_idle_pct.render")
    run = type("R", (), {"kind": "renders", "record": rec})()
    assert idle.read(run) == pytest.approx(0.0)
    run.record = _record([("k", 0.0, 6e5), ("copy", 9e5, 1e6)])
    assert idle.read(run) == pytest.approx(30.0)
    gaps = run.record.idle_gaps()
    assert gaps == [("host between ops", pytest.approx(0.3))]


def test_readers_find_nothing_outside_their_drive():
    rec = _record([("void regen_staged<0>(Params, Camera)", 0.0, 8e5)],
                  [("rtbench.render", 0.0, 1e6)])
    run = type("R", (), {"kind": "ray_batches", "record": rec})()
    for name in ("render.readback_ms", "regen.kernel_ms.render",
                 "device_idle_pct.render", "frame.kernel_ms"):
        assert spec.metric_module(name).read(run) is None
    run.kind = "renders"
    assert spec.metric_module("render.readback_ms").read(run) == \
        pytest.approx(200.0)
    assert spec.metric_module("regen.kernel_ms.render").read(run) == \
        pytest.approx(800.0)


def test_roofline_is_the_least_time_over_the_kernel_time():
    d = _drive("cover.north_star")
    d.plan()
    d.segments = 10**9
    d.record = _record([("void regen_staged<0>(Params, Camera)", 0.0, 1e6)])
    d.window_s = 2.0
    least, by = yardstick.least_ms(10**9, 488, 0, 488 * 96, d.slots)
    assert by == "operations"
    roof = spec.metric_module("regen.roofline_pct").read(d)
    assert roof == pytest.approx(100.0 * least / 1000.0)
    # Culled tables (triangles) have no implementation-independent count.
    m = _drive("mesh3.render")
    m.plan()
    m.segments, m.record, m.window_s = d.segments, d.record, 2.0
    assert spec.metric_module("regen.roofline_pct").read(m) is None


class _Event:
    def __init__(self, name, a, b, device):
        import torch

        self.name = name
        self.time_range = type("T", (), {"start": a, "end": b})()
        self.device_type = (torch.autograd.DeviceType.CUDA if device
                            else torch.autograd.DeviceType.CPU)


def test_spans_mirrored_on_the_device_are_not_device_work():
    events = [_Event("rtbench.window", 0.0, 1e6, False),
              _Event("rtbench.window", 0.0, 1e6, True),
              _Event("rtbench.render", 1e5, 9e5, True),
              _Event("rtbench.render", 1e5, 9e5, False),
              _Event("void regen_staged<0>(Params, Camera)", 2e5, 7e5, True),
              _Event("aten::copy_", 7e5, 9.5e5, False)]
    prof = type("P", (), {"events": lambda self: events})()
    rec = tracing.digest(prof)
    assert rec.window == (0.0, 1e6)
    assert rec.busy_s() == pytest.approx(0.5)
    assert rec.spans_named("rtbench.render") == [(1e5, 9e5)]
    gaps = dict(rec.idle_gaps())
    assert gaps["aten::copy_"] == pytest.approx(0.3)
    assert gaps["rtbench.render"] == pytest.approx(0.2)
