"""The frozen reference against the port's plain version on the CPU, at a
tiny size of both configurations, and the bfloat16 control against it."""

import dataclasses
import json

import pytest
import torch

import raytracing_tpu_torch as rtt
from raytracing_tpu_torch.ops import trace as rtrace
from raytracing_tpu_torch.runtime import tiling
from rtbench import drives, plugins, spec
from rtbench.reference import scene as rs
from rtbench.reference import trace as rt


def _config(name):
    with open(spec.ROOT / "configs" / f"{name}.json") as f:
        return json.load(f)


def _program(name, width):
    cfg = _config(name)
    cam = dict(cfg["camera"], image_width=width)
    scene = drives.program_scene(cfg)
    params = drives.camera_params(cam)
    return cfg, cam, scene, params


@pytest.mark.parametrize("name", ["cover", "mesh3"])
def test_regen_paths_bit_equal_to_the_plain_version(name):
    cfg, cam, scene, params = _program(name, 48)
    dc = rtt.derive(params)
    tables = rtrace.pack_scene(scene, origin=dc.as_vector()[9:12])
    spp, depth, seed = 3, 8, 2_000_000_011
    w, h = params.image_width, params.image_height
    s = tiling.num_slots(w, h)
    rad, seg, _ = rtrace.render_pixels_fused_reference(
        tables, dc.as_vector(), slot_base=0, map_param=tiling.tiles_per_row(w),
        seed=seed & 0x7FFFFFFF, sample_start=0, spp=spp, max_depth=depth,
        t_end=spp, done=torch.zeros(s, dtype=torch.int32), num_slots=s,
        pixel_order="tiled")
    ref = drives.reference_tables(cfg, "cpu")
    cam_v = torch.from_numpy(rs.camera_vector(cam))
    assert torch.equal(cam_v, dc.as_vector())
    r2, s2 = rt.camera_paths(ref, cam_v, w, seed & 0x7FFFFFFF,
                             torch.arange(s).repeat_interleave(spp),
                             torch.arange(spp).repeat(s), depth)
    assert int(s2.sum()) == int(seg)
    assert torch.equal(rt.pixel_sums(r2, spp), rad)
    low = drives.reference_tables(cfg, "cpu", torch.bfloat16)
    r3, _ = rt.camera_paths(low, cam_v, w, seed & 0x7FFFFFFF,
                            torch.arange(s).repeat_interleave(spp),
                            torch.arange(spp).repeat(s), depth)
    assert not torch.equal(rt.pixel_sums(r3, spp), rad)


def test_caller_rays_bit_equal_to_the_plain_version():
    cfg, cam, scene, params = _program("mesh3", 64)
    pool = plugins.load(spec.ROOT, "drives", "ray_batches").camera_ray_pool
    origins, dirs = pool(dict(cam, image_width=128), 1, 5,
                                           "cpu")
    o, d = origins[0][:2048].contiguous(), dirs[0][:2048].contiguous()
    tables = rtrace.pack_scene(scene, origin=o.mean(dim=0))
    rad, seg = rtrace.trace_rays_fused(tables, o, d, seed=4_000_000_001,
                                       tile_offset=77, max_depth=8)
    ref = drives.reference_tables(cfg, "cpu")
    idx = torch.tensor([0, 5, 1023, 1024, 2047])
    r2, s2 = rt.caller_paths(ref, o[idx], d[idx], idx, 4_000_000_001, 77,
                             1024, 8)
    assert torch.equal(r2, rad[idx])
    r_all, s_all = rt.caller_paths(ref, o, d, torch.arange(2048),
                                   4_000_000_001, 77, 1024, 8)
    assert int(s_all.sum()) == int(seg)


def test_slot_and_pixel_maps_are_inverse():
    w, h = 100, 70
    px, py = torch.meshgrid(torch.arange(w), torch.arange(h), indexing="xy")
    slot = rt.slot_of_pixel(px.reshape(-1), py.reshape(-1), w)
    qx, qy = rt.pixel_of_slot(slot, w)
    assert torch.equal(qx, px.reshape(-1)) and torch.equal(qy, py.reshape(-1))
    ids = torch.from_numpy(tiling.tiled_pixel_ids(w, h)).long()
    assert torch.equal(ids[slot], torch.arange(w * h))


def test_reference_scene_equals_the_programs():
    for name in ("cover", "mesh3"):
        cfg = _config(name)
        scene = drives.program_scene(cfg)
        sph, tri = rs.scene_of(cfg)
        assert torch.equal(torch.tensor(sph.centers, dtype=torch.float32),
                           scene.centers)
        if tri is not None:
            assert torch.equal(torch.from_numpy(tri.v0), scene.tri_v0)
            assert torch.equal(torch.from_numpy(tri.e2), scene.tri_e2)
    assert dataclasses.is_dataclass(sph)
