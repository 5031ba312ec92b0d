"""The benchmark's plain reference of stress:8192 against the port's plain
version on the CPU: the procedural scene field for field, the two-level
sphere rule bit for bit (radiance sums and segments) at stress:8192 and,
with many windows and near ties, at stress:1024 under
``RT_TWO_LEVEL_MIN=256``, the bfloat16 control apart, and the reference's
replay of the box cull against the port's gate passes. Also the port's
counts of the cull's work (``render_pixels_fused(counts=True)``,
``Renderer.cull_counts``) on the plain version."""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch.ops import trace as ttrace  # noqa: E402
from raytracing_tpu_torch.runtime import tiling  # noqa: E402
from rtbench import drives, spec  # noqa: E402
from rtbench.reference import cull as rcull  # noqa: E402
from rtbench.reference import scene as rs  # noqa: E402
from rtbench.reference import trace as rt  # noqa: E402

SEED = 2_000_000_011


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The plain versions run many small tensor ops: one intra-op thread a
    test process keeps a parallel test run from oversubscribing the cores
    (results do not depend on the thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(n_spheres=8192):
    with open(spec.ROOT / "configs" / "stress8192.json") as f:
        cfg = json.load(f)
    if n_spheres != 8192:
        cam, _ = rtt.make_world_stress(n_spheres)
        cfg["program"]["kwargs"]["n_spheres"] = n_spheres
        cfg["scene"]["n_spheres"] = n_spheres
        cfg["camera"] = {f.name: getattr(cam, f.name)
                         for f in dataclasses.fields(cam)}
    return cfg


# (n_spheres, width, spp, RT_TWO_LEVEL_MIN): bench.py's stress:8192, and
# stress:1024 under the two-level rule (8 windows of 128 rows, 2 culled
# blocks), where more rays see near ties between windows.
SIZES = {"stress8192": (8192, 32, 2, None), "stress1024": (1024, 48, 3, "256")}


@pytest.fixture(scope="module")
def waves():
    """Per size: the port's plain wave (radiance sums, segments, its gate
    tally by warp, its counts) and the reference's paths over the same
    slots and samples with the gate replayed; computed once."""
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for name, (n, width, spp, two_level_min) in SIZES.items():
            if two_level_min is None:
                mp.delenv("RT_TWO_LEVEL_MIN", raising=False)
            else:
                mp.setenv("RT_TWO_LEVEL_MIN", two_level_min)
            cfg = _config(n)
            cam = dict(cfg["camera"], image_width=width)
            params = drives.camera_params(cam)
            dc = rtt.derive(params)
            tables = ttrace.pack_scene(drives.program_scene(cfg),
                                       origin=dc.as_vector()[9:12])
            w, h = params.image_width, params.image_height
            s = tiling.num_slots(w, h)
            tally = ttrace.SweepTally(warp=32)
            rad, counts, _ = ttrace.render_pixels_fused_reference(
                tables, dc.as_vector(), slot_base=0,
                map_param=tiling.tiles_per_row(w), seed=SEED & 0x7FFFFFFF,
                sample_start=0, spp=spp, max_depth=8, t_end=spp,
                done=torch.zeros(s, dtype=torch.int32), num_slots=s,
                pixel_order="tiled", tally=tally, counts=True)
            ref = drives.reference_tables(cfg, "cpu")
            cam_v = torch.from_numpy(rs.camera_vector(cam))
            order, rows = rcull.block_bounds(ref.sph, cam_v[9:12])
            replay = rcull.Replay(ref.sphere_rule, order, rows)
            slots = torch.arange(s).repeat_interleave(spp)
            samples = torch.arange(spp).repeat(s)
            r2, s2 = rt.camera_paths(
                dataclasses.replace(ref, sphere_rule=replay), cam_v, w,
                SEED & 0x7FFFFFFF, slots, samples, 8)
            out[name] = dict(cfg=cfg, cam=cam, dc=dc, tables=tables,
                             spp=spp, rad=rad, counts=counts, tally=tally,
                             ref_rad=rt.pixel_sums(r2, spp),
                             ref_seg=int(s2.sum()), replay=replay,
                             bounds=(order, rows), slots=slots,
                             samples=samples)
    finally:
        mp.undo()
    return out


def test_reference_stress_scene_equals_the_programs():
    cfg = _config()
    scene = drives.program_scene(cfg)
    sph, tri = rs.scene_of(cfg)
    assert tri is None and len(sph.radii) == scene.num_objects == 8192
    f32 = torch.float32
    for mine, theirs in (
            (sph.centers, scene.centers), (sph.radii, scene.radii),
            (sph.albedo, scene.albedo), (sph.fuzz, scene.fuzz),
            (sph.ior, scene.ior)):
        assert torch.equal(torch.tensor(mine, dtype=f32), theirs)
    assert torch.equal(torch.tensor(sph.kind, dtype=torch.int32),
                       scene.mat_kind.to(torch.int32))
    # The tables, row for row.
    tables = ttrace.pack_scene(scene, cull=False)
    t = rs.sphere_table(sph)
    assert (tables.n_pad, tables.n_actual, tables.sphere_rule) == (
        t.n_pad, t.n_actual, "2l")
    assert torch.equal(tables.geom_h[:, 0], t.cx)
    assert torch.equal(tables.geom_c[:, 3], t.cm2)
    assert torch.equal(tables.shade[:, 3], t.r)
    # The configuration's camera is make_world_stress's, and its vector
    # derive's.
    params, _ = rtt.make_world_stress(8192)
    assert drives.camera_params(cfg["camera"]) == params
    cam = dict(cfg["camera"], image_width=1920)
    assert torch.equal(torch.from_numpy(rs.camera_vector(cam)),
                       rtt.derive(drives.camera_params(cam)).as_vector())


@pytest.mark.parametrize("name", sorted(SIZES))
def test_two_level_rule_bit_equal_to_the_plain_version(waves, name):
    w = waves[name]
    assert w["tables"].sphere_rule == "2l"
    assert w["tables"].sph_bounds is not None
    assert int(w["counts"][0]) == w["ref_seg"]
    assert torch.equal(w["ref_rad"], w["rad"])


def test_bfloat16_control_differs(waves):
    w = waves["stress8192"]
    low = drives.reference_tables(w["cfg"], "cpu", torch.bfloat16)
    cam_v = torch.from_numpy(rs.camera_vector(w["cam"]))
    r3, s3 = rt.camera_paths(low, cam_v, w["cam"]["image_width"],
                             SEED & 0x7FFFFFFF, w["slots"], w["samples"], 8)
    assert not torch.equal(rt.pixel_sums(r3, w["spp"]), w["rad"])


@pytest.mark.parametrize("name", sorted(SIZES))
def test_cull_replay_passes_equal_the_plain_gate(waves, name):
    w = waves[name]
    order, rows = w["bounds"]
    assert torch.equal(order, w["tables"].sph_order)
    assert torch.equal(rows, w["tables"].sph_bounds)
    assert w["replay"].segments == w["ref_seg"]
    assert w["replay"].passes == w["tally"].sphere_passes > 0
    nb = w["tables"].n_pad // 512
    assert w["replay"].swept == w["replay"].passes * 512
    assert w["tally"].sphere_votes == w["ref_seg"] * nb


@pytest.mark.parametrize("name", sorted(SIZES))
def test_plain_counts_are_the_gate_passes_and_the_block_votes(waves, name):
    w = waves[name]
    seg, passes, copies, visits = (int(v) for v in w["counts"])
    tally = w["tally"]
    assert passes == tally.sphere_passes
    assert copies == tally.sphere_cta_passes
    # Every thread block of the wave visits every block once a step.
    nb = w["tables"].n_pad // 512
    assert visits % nb == 0
    assert visits >= copies >= passes / 128 > 0


def test_plain_counts_without_bound_tables(waves):
    # Without bound tables every live (ray, block) pair is swept and every
    # visit of the lock step copies its chunk.
    w = waves["stress1024"]
    seg, _, _, visits = (int(v) for v in w["counts"])
    t = dataclasses.replace(w["tables"], sph_order=None, sph_bounds=None,
                            cull_kind=None)
    dc = w["dc"]
    s = w["slots"].numel() // w["spp"]
    rad, c2, _ = ttrace.render_pixels_fused_reference(
        t, dc.as_vector(), slot_base=0,
        map_param=tiling.tiles_per_row(dc.image_width),
        seed=SEED & 0x7FFFFFFF, sample_start=0, spp=w["spp"], max_depth=8,
        t_end=w["spp"], done=torch.zeros(s, dtype=torch.int32), num_slots=s,
        counts=True)
    assert torch.equal(rad, w["rad"])
    nb = t.n_pad // 512
    assert [int(v) for v in c2] == [seg, seg * nb, visits, visits]


def test_renderer_cull_counts_per_render():
    cfg = _config()
    params = drives.camera_params(dict(cfg["camera"], image_width=32))
    r = rtt.Renderer(drives.program_scene(cfg), params, seed=3,
                     device="cpu")
    r.render(spp=1, max_depth=2)
    first = r.cull_counts
    assert set(first) == set(ttrace.CULL_COUNTS)
    assert first["block_visits"] >= first["chunk_copies"] > 0
    assert first["lane_passes"] > 0
    r.render(spp=1, max_depth=2)
    assert r.cull_counts == first  # per render, not summed over renders
    r.reseed(4)
    assert set(r.cull_counts.values()) == {0}
    # A staged table counts segments alone.
    p2, s2 = rtt.make_world_stress(512, image_width=32)
    r2 = rtt.Renderer(s2, p2, device="cpu")
    r2.render(spp=1, max_depth=2)
    assert r2.segments_traced > 0
    assert set(r2.cull_counts.values()) == {0}
