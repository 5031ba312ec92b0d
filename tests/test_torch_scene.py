"""Port vs JAX package: camera frame, color pipe, slot tiling, scene build,
and the interop carry-over."""

import dataclasses

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

from torch_port_helpers import COVER, golden_params, scene_arrays, to_port  # noqa: E402

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


def _builds():
    return {
        "cover": (rt.load_and_build(COVER), rtt.load_and_build(COVER)),
        "stress": (rt.make_world_stress(300), rtt.make_world_stress(300)),
        "basic": (rt.make_world_basic(), rtt.make_world_basic()),
    }


@pytest.mark.parametrize("name", ["cover", "stress", "basic"])
def test_scene_arrays_equal(name):
    (jcam, js), (tcam, ts) = _builds()[name]
    assert dataclasses.asdict(tcam) == dataclasses.asdict(jcam)
    if name == "cover":
        assert ts.num_objects == 488
    want = scene_arrays(js)
    got = interop.scene_to_numpy(ts)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (ts.has_textures, ts.has_triangles) == (js.has_textures, js.has_triangles)


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


def test_texture_material_defs_refused():
    data = {
        "objects": [[
            {"center": [0, 0, 0], "radius": 1.0},
            {"material_def": "CheckerMatDef", "scale": 1.0,
             "even_albedo": [1, 1, 1], "odd_albedo": [0, 0, 0]},
        ]]
    }
    with pytest.raises(NotImplementedError):
        tconfig.world_from_dict(data)
    with pytest.raises(ValueError):
        tconfig.world_from_dict(
            {"objects": [[{"center": [0, 0, 0], "radius": 1.0},
                          {"material_def": "Nope"}]]}
        )
