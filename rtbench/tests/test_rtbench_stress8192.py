"""The cell stress8192.render at a tiny size on the program's plain
versions: a sound run is correct and each fault of
``test_rtbench_faults.py`` is not, the control fails a limit, a traced
run reads the cull's metrics; and the arithmetic of ``yardstick_cull.py``
and the three readers on hand-worked counts."""

import copy
import types

import pytest
import torch

from raytracing_tpu_torch.runtime.renderer import Renderer
from rtbench import control, drives, run, spec, tracing, yardstick
from rtbench import yardstick_cull
from rtbench.tests.test_rtbench_faults import (_render_altered, _render_half,
                                               _stale)

CELL = "stress8192.render"
SEED = 2**31 + 1_234_567
# The cell cut to a size the CPU runs in seconds: 32 x 18 pixels (one
# 32 x 32 tile of slots), the whole table of 8,192 rows. The faults and
# the control fail on the pixels (u8_gap), so a few segment paths do.
TINY = {"camera": {"image_width": 32}, "spp": 2, "max_depth": 8,
        "warmup_spp": 1,
        "check": {"renders": 2, "pixels": 16, "segment_paths": 2048,
                  "cull_paths": 1024}}
# The sound run's segment check compares the program's count of one tiny
# render with an estimate: both are samples of paths (about 2.4 segments
# a path), so it takes 16 spp (16,384 paths) and 32,768 paths of estimate
# for a spread well inside the 1% limit (0.17-0.24% on two seeds).
SOUND = {"spp": 16, "check": {"segment_paths": 32768}}


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_cell(*cuts):
    cell = spec.resolve(spec.load_benchmark(), CELL)
    t = copy.deepcopy(cell.traffic)
    for cut in (TINY,) + cuts:
        for k, v in cut.items():
            t[k] = {**t.get(k, {}), **v} if isinstance(v, dict) else v
    cell.traffic = t
    return cell


def _run(*cuts):
    code, result = run.run_cell(tiny_cell(*cuts), SEED, 0.3, False,
                                device="cpu", log=lambda m: None)
    assert code == 0
    return result


def test_sound_run_is_correct():
    result = _run(SOUND)
    assert result["correct"], result["checks"]
    assert result["checks"]["u8_gap"]["value"] == 0.0
    assert set(result["metrics"]) == {"mpaths_per_s", "setup_s"}


@pytest.mark.parametrize("fault", [_stale, _render_half, _render_altered],
                         ids=["unchanged", "half", "altered"])
def test_fault_is_not_correct(fault, monkeypatch):
    monkeypatch.setattr(Renderer, "render", fault(Renderer.render))
    result = _run()
    assert not result["correct"]
    gap = result["checks"]["u8_gap"]
    assert gap["value"] > gap["limit"], result["checks"]


def test_control_fails_a_limit():
    checks = control.control_checks(tiny_cell(), SEED + 2,
                                    torch.device("cpu"), log=lambda m: None)
    gap = {n: (v, lim) for n, v, lim in checks}["u8_gap"]
    assert gap[0] > gap[1], checks


def test_traced_run_reads_the_cull_metrics():
    d = drives.make(tiny_cell(), SEED, "cpu", log=lambda m: None)
    d.setup()
    d.run_window(0.2, True)
    d.results()
    values = {e["name"]: reader.read(d) for e, reader in d.cell.per_layer}
    # The program's counters and spans; the plain versions run no kernel,
    # so the readers of the device's trace find nothing here.
    for name in ("cull.passes_per_segment", "cull.copy_share",
                 "launch.host_us.regen", "readback.host_ms",
                 "scene.build_ms"):
        assert values[name] is not None and values[name] > 0.0, name
    for name in ("regen.roofline_pct.culled", "regen.kernel_ms.render",
                 "render.readback_ms"):
        assert values[name] is None, name
    assert "regen.roofline_pct" not in values
    # The program's counts, render by render, and the reference's replay.
    assert len(d.cull) == len(d.requests)
    segments, passes, swept = d.reference_passes
    assert segments > 0 and swept == 512 * passes
    assert 0.0 < values["cull.copy_share"] <= 100.0
    assert 0.0 < values["cull.passes_per_segment"] <= 16.0
    d.release()


def _synthetic(counts, requests, **kw):
    return types.SimpleNamespace(kind="renders", cull=counts,
                                 requests=requests, **kw)


def test_cull_readers_on_hand_worked_counts():
    passes = spec.metric_module("cull.passes_per_segment")
    share = spec.metric_module("cull.copy_share")
    c = [dict(lane_passes=300, chunk_copies=30, block_visits=160),
         dict(lane_passes=100, chunk_copies=10, block_visits=160)]
    run_ = _synthetic(c, [(1, 150, None, None, None), (2, 50, None, None,
                                                       None)])
    assert passes.read(run_) == pytest.approx(400 / 200)
    assert share.read(run_) == pytest.approx(100.0 * 40 / 320)
    # Nothing to read from a program without the counts (None), where no
    # block was gated, or outside the render drives.
    for counts in ([None, None], [], None):
        bare = _synthetic(counts, run_.requests)
        assert passes.read(bare) is None and share.read(bare) is None
    zero = [dict(lane_passes=0, chunk_copies=0, block_visits=0)]
    assert passes.read(_synthetic(zero, run_.requests)) is None
    assert share.read(_synthetic(zero, run_.requests)) is None
    run_.kind = "ray_batches"
    assert passes.read(run_) is None and share.read(run_) is None


def test_yardstick_cull_on_hand_worked_counts():
    # 10^9 segments, 16 blocks, 2.5 passing blocks of 512 rows a segment:
    # 200 + 16 * 56 + 1280 * 19 = 25,416 operations a segment.
    assert yardstick_cull.GATE_OPS == 56
    least, by = yardstick_cull.least_ms(10**9, 16, 2.5 * 512, 8192 * 96,
                                        2_088_960)
    assert by == "operations"
    assert least == pytest.approx(10**9 * 25_416 / 67e12 * 1e3)
    # Few segments: the bytes bound it (the table and the slots' state).
    least, by = yardstick_cull.least_ms(1, 16, 0.0, 8192 * 96, 2_088_960)
    assert by == "bytes"
    assert least == pytest.approx(
        (8192 * 96 + 2_088_960 * yardstick.SLOT_BYTES) / 3.35e12 * 1e3)


def test_culled_roofline_is_the_least_time_over_the_kernel_time():
    d = drives.make(tiny_cell(), 7, "cpu", log=lambda m: None)
    d.plan()
    d.segments = 10**9
    d.__dict__["reference_passes"] = (1000, 2500, 2500 * 512)
    d.record = tracing.Record(
        [("void regen_chunked<true, false, 0>(Params, Camera)", 0.0, 4e5),
         ("void regen_chunked<true, false, 0>(Params, Camera)", 5e5, 1e6)],
        [], [], (0.0, 1e6))
    roof = spec.metric_module("regen.roofline_pct.culled")
    least, _ = yardstick_cull.least_ms(10**9, 16, 2.5 * 512, 8192 * 96,
                                       d.slots)
    assert roof.read(d) == pytest.approx(100.0 * least / 900.0)
    # A sphere table the program sweeps whole has no cull to count.
    flat = drives.make(spec.resolve(spec.load_benchmark(),
                                    "cover.north_star"), 7, "cpu")
    flat.plan()
    flat.segments, flat.record = d.segments, d.record
    assert roof.read(flat) is None
