"""Port vs JAX package: camera frame, color pipe, slot tiling, scene build
(spheres, textures, meshes, glTF), host mesh geometry, and the interop
carry-over."""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import raytracing_tpu as rt  # noqa: E402
from raytracing_tpu.core import color as jcolor  # noqa: E402
from raytracing_tpu.runtime import tiling as jtiling  # noqa: E402

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch import interop  # noqa: E402
from raytracing_tpu_torch.core import color as tcolor  # noqa: E402
from raytracing_tpu_torch.runtime import tiling as ttiling  # noqa: E402
from raytracing_tpu_torch.scene import config as tconfig  # noqa: E402
from raytracing_tpu_torch.scene import gltf as tgltf  # noqa: E402
from raytracing_tpu_torch.scene import mesh as tmesh  # noqa: E402
from raytracing_tpu_torch.utils import png as tpng  # noqa: E402

from torch_port_helpers import (  # noqa: E402
    COVER, golden_params, scene_arrays, to_port, write_icosphere_glb,
)

_VECTORS = (
    "pixel00", "pixel_delta_u", "pixel_delta_v", "center",
    "defocus_disk_u", "defocus_disk_v", "defocus_angle",
)

_CAMERAS = {
    "default": {},
    "cover": dict(
        aspect_ratio=1.7, image_width=1200, vertical_fov=20.0,
        defocus_angle=0.6, focus_distance=10.0, lookfrom=(13.0, 2.0, 3.0),
        lookat=(0.0, 0.0, 0.0),
    ),
    "golden": dataclasses.asdict(golden_params()),
}


@pytest.mark.parametrize("name", sorted(_CAMERAS))
def test_derive_equals_reference(name):
    jp = rt.CameraParameters(**_CAMERAS[name])
    tp = rtt.CameraParameters(**_CAMERAS[name])
    jc, tc = rt.derive(jp), rtt.derive(tp)
    assert (tc.image_width, tc.image_height) == (jc.image_width, jc.image_height)
    for n in _VECTORS:
        want = np.asarray(getattr(jc, n))
        got = getattr(tc, n).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=n)


def _color_vectors():
    # The vectors of tests/test_color.py plus the clamp/negative cases.
    v = np.concatenate(
        [
            np.linspace(-0.5, 2.0, 1002, dtype=np.float32),
            np.array([0.0, 1.0, 0.999, 0.9980013, 1e-8, np.float32(0.999**2)],
                     dtype=np.float32),
            np.array([10.0, 1.0, 0.9999, -1.0, -0.0, 0.0], dtype=np.float32),
        ]
    )
    return v.reshape(-1, 3)


def test_color_pipe_bit_equal():
    v = _color_vectors()
    want = np.asarray(jcolor.rgb_to_u8(jnp.asarray(v)))
    got = tcolor.rgb_to_u8(torch.from_numpy(v)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert got.max() == 255


@pytest.mark.parametrize("wh", [(64, 32), (100, 58), (1920, 1080), (33, 1)])
def test_tiled_pixel_ids_equal(wh):
    np.testing.assert_array_equal(
        ttiling.tiled_pixel_ids(*wh), jtiling.tiled_pixel_ids(*wh)
    )
    assert ttiling.num_slots(*wh) == jtiling.num_slots(*wh)


_BUILDS = {
    "cover": lambda m: m.load_and_build(COVER),
    "stress": lambda m: m.make_world_stress(300),
    "basic": lambda m: m.make_world_basic(),
    "textured": lambda m: m.make_world_textured(image_width=64),
    "mesh3": lambda m: m.make_world_mesh(image_width=64),
    "mesh1": lambda m: m.make_world_mesh(image_width=64, subdivisions=1),
    "meshes4": lambda m: m.make_world_meshes(4, image_width=64),
    "meshes3": lambda m: m.make_world_meshes(3, image_width=64, subdivisions=1),
}


def _assert_scenes_equal(js, ts):
    want = scene_arrays(js)
    got = interop.scene_to_numpy(ts)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (ts.has_textures, ts.has_triangles) == (js.has_textures, js.has_triangles)
    assert (ts.num_objects, ts.num_triangles) == (js.num_objects, js.num_triangles)


@pytest.mark.parametrize("name", sorted(_BUILDS))
def test_scene_arrays_equal(name):
    (jcam, js), (tcam, ts) = _BUILDS[name](rt), _BUILDS[name](rtt)
    assert dataclasses.asdict(tcam) == dataclasses.asdict(jcam)
    if name == "cover":
        assert ts.num_objects == 488
    if name in ("mesh3", "meshes4"):
        assert ts.num_triangles == 1280 and ts.has_textures
    _assert_scenes_equal(js, ts)


def test_center_filter_matches_reference():
    jw = rt.load_world(COVER)
    tw = tconfig.load_world(COVER)
    _, js = rt.build_world(jw, apply_center_filter=True)
    _, ts = tconfig.build_world(tw, apply_center_filter=True)
    assert ts.num_objects == js.num_objects
    np.testing.assert_array_equal(ts.centers.numpy(), np.asarray(js.centers))


def test_interop_round_trip():
    jp, js = rt.load_and_build(COVER)
    jcam = rt.derive(jp)
    ts, tcam = to_port(js, jcam)
    back = interop.scene_to_numpy(ts)
    for k, v in scene_arrays(js).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    moved = ts.to("cpu")
    assert moved.num_objects == 488
    for n in _VECTORS:
        np.testing.assert_array_equal(
            getattr(tcam, n).numpy(), np.asarray(getattr(jcam, n))
        )
    assert tcam.as_vector().shape == (20,)
    with pytest.raises(KeyError):
        interop.scene_from_numpy(
            {"centers": back["centers"]}, has_textures=False,
            has_triangles=False,
        )


def test_texture_material_defs_build_equal_scenes(tmp_path):
    # CheckerMatDef and ImageMatDef in a config file; the image path is
    # relative to the config, read with each package's PNG reader.
    img = np.random.default_rng(2).integers(0, 256, (24, 40, 3), np.uint8)
    tpng.write_png(tmp_path / "tex.png", img)
    data = {
        "camera": {"image_width": 64, "samples_per_pixel": 1},
        "a_min": 0, "a_max": 2, "b_min": 0, "b_max": 2,
        "objects": [
            [{"center": [0, -1000, 0], "radius": 1000.0},
             {"material_def": "CheckerMatDef", "scale": 0.7,
              "even_albedo": [0.2, 0.3, 0.1], "odd_albedo": [0.9, 0.9, 0.9]}],
            [{"center": [0, 1, 0], "radius": 1.0},
             {"material_def": "ImageMatDef", "file": "tex.png"}],
        ],
    }
    cfg = tmp_path / "world.json"
    cfg.write_text(json.dumps(data))
    jw, tw = rt.load_world(cfg), tconfig.load_world(cfg)
    assert isinstance(tw.objects[0][1], tconfig.CheckerMatDef)
    assert tw.objects[1][1].file == str(tmp_path / "tex.png")
    _, js = rt.build_world(jw)
    _, ts = tconfig.build_world(tw)
    assert ts.has_textures and ts.num_objects == 6
    _assert_scenes_equal(js, ts)
    with pytest.raises(ValueError):
        tconfig.world_from_dict(
            {"objects": [[{"center": [0, 0, 0], "radius": 1.0},
                          {"material_def": "Nope"}]]}
        )


def test_checker_scale_rounds_to_f16():
    ts = rtt.SceneBuilder().add_checker_sphere(
        (0, 0, 0), 1.0, 0.3, (1, 1, 1), (0, 0, 0)).build()
    inv = float(ts.tex_inv_scale[0])
    assert inv == float(np.float16(1 / 0.3)) and inv != np.float32(1 / 0.3)


@pytest.mark.parametrize("subdivisions", [0, 1, 2, 3])
def test_mesh_host_geometry_equal(subdivisions):
    from raytracing_tpu.scene import mesh as jmesh

    jv, jf = jmesh.make_icosphere(subdivisions)
    tv, tf = tmesh.make_icosphere(subdivisions)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    want = jmesh.faces_to_soa(jv + np.float32(0.25), jf)
    got = tmesh.faces_to_soa(tv + np.float32(0.25), tf)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    jb, tb = jmesh.build_bvh(*want), tmesh.build_bvh(*got)
    for f in ("node_min", "node_max", "skip", "first", "count", "order"):
        np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f), err_msg=f)


def test_bvh_order_equal_on_random_soup():
    from raytracing_tpu.scene import mesh as jmesh

    rng = np.random.default_rng(8)
    v0 = rng.normal(size=(777, 3)).astype(np.float32)
    e1 = (0.1 * rng.normal(size=(777, 3))).astype(np.float32)
    e2 = (0.1 * rng.normal(size=(777, 3))).astype(np.float32)
    jb, tb = jmesh.build_bvh(v0, e1, e2), tmesh.build_bvh(v0, e1, e2)
    np.testing.assert_array_equal(tb.order, jb.order)
    np.testing.assert_array_equal(tb.skip, jb.skip)
    assert sorted(tb.order.tolist()) == list(range(777))
    empty = tmesh.build_bvh(v0[:0], e1[:0], e2[:0])
    assert empty.skip.tolist() == [1] and empty.order.size == 0


def test_gltf_round_trip_equal(tmp_path):
    from raytracing_tpu.scene import gltf as jgltf

    glb = write_icosphere_glb(tmp_path / "ico.glb", 1)
    jp, tp = jgltf.load_gltf(glb), tgltf.load_gltf(glb)
    assert len(tp) == len(jp) == 1
    np.testing.assert_array_equal(tp[0].vertices, jp[0].vertices)
    np.testing.assert_array_equal(tp[0].faces, jp[0].faces)
    assert (tp[0].albedo, tp[0].metallic, tp[0].fuzz) == (
        jp[0].albedo, jp[0].metallic, jp[0].fuzz)
    assert tp[0].metallic and tp[0].fuzz == 0.15
    jb = rt.SceneBuilder().add_gltf(glb, scale=2.0, translate=(0, 1, 0))
    tb = rtt.SceneBuilder().add_gltf(glb, scale=2.0, translate=(0, 1, 0))
    _assert_scenes_equal(jb.build(), tb.build())
    (tmp_path / "bad.glb").write_bytes(b"NOPE" + b"\x00" * 64)
    with pytest.raises(tgltf.GLTFError):
        tgltf.load_gltf(tmp_path / "bad.glb")


@pytest.mark.parametrize("name", ["textured", "meshes4"])
def test_interop_round_trip_textured_and_mesh(name):
    _, js = _BUILDS[name](rt)
    ts = to_port(js)
    back = interop.scene_to_numpy(ts)
    for k, v in scene_arrays(js).items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert (ts.has_textures, ts.has_triangles) == (
        js.has_textures, js.has_triangles)
