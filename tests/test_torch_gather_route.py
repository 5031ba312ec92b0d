"""Port vs JAX package under the radix winner fetch (``RT_GATHER=radix``,
and ``RT_TWO_LEVEL_MXU=0`` alone on the two-level scenes).

The JAX package reads both variables when it traces its kernels, so each
test sets them, as ``tests/test_pallas.py`` does (``monkeypatch.setenv``
and ``jax.clear_caches()``), or hands them to a fresh process without
XLA-CPU's fused multiply-adds (``wave_jax_without_fma``,
``trace_jax_without_fma``). The port's plain version reads the same
environment (``ops/fetch.py::env_settings``) and runs its own radix
tournament at every fetch site.

Tolerances are test_torch_slice.py's and test_torch_large.py's: segments
equal (or within 0.1% where XLA-CPU's contraction moves a path) and slots
within atol 2e-4 / rtol 1e-3. The port's radix route must also give its
default route's bits on every scene: the fetch changes no word.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import raytracing_tpu as rt  # noqa: E402

from raytracing_tpu_torch.ops import trace as ttrace  # noqa: E402

from torch_port_helpers import (  # noqa: E402
    close_share, golden_mesh_scene_jax, golden_params,
    golden_textured_scene_jax, render_jax, render_port, to_port, trace_jax,
    trace_jax_without_fma, trace_port, wave_jax_without_fma,
)

RADIX = {"RT_GATHER": "radix"}
WINDOWS = {"RT_TWO_LEVEL_MXU": "0"}


@pytest.fixture
def route_env(monkeypatch):
    """Set the route variables for both packages; the JAX package's traced
    kernels are dropped before and after, so no other test sees them."""

    def set_env(env):
        for var in ("RT_GATHER", "RT_TWO_LEVEL_MXU"):
            monkeypatch.delenv(var, raising=False)
        for var, val in env.items():
            monkeypatch.setenv(var, val)
        jax.clear_caches()

    yield set_env
    jax.clear_caches()


def _camera_rays(params, seed, n=1024):
    """``n`` rays through seeded points of ``params``' image plane from its
    camera center (the JAX package's derived camera, in numpy)."""
    cam = rt.derive(params)
    rng = np.random.default_rng(seed)
    px = rng.uniform(0.0, cam.image_width, n).astype(np.float32)
    py = rng.uniform(0.0, cam.image_height, n).astype(np.float32)
    c = np.asarray(cam.center, np.float32)
    d = (np.asarray(cam.pixel00, np.float32)[None]
         + px[:, None] * np.asarray(cam.pixel_delta_u, np.float32)[None]
         + py[:, None] * np.asarray(cam.pixel_delta_v, np.float32)[None]
         - c[None]).astype(np.float32)
    return np.tile(c, (n, 1)), d


def _port_routes_agree(rad, seg, default):
    """The port's route under test against its default route: the same
    bits and segments."""
    rad_d, seg_d = default[0], default[1]
    np.testing.assert_array_equal(rad, rad_d)
    assert seg == seg_d


def test_cover_wave_matches_jax_under_radix(tmp_path, route_env):
    # The cover scene at 64x36 @ 1 spp, depth 4 (512 rows: the staged flat
    # sphere fetch), the JAX side without fused multiply-adds. Measured:
    # segments equal and every slot within tolerance.
    params, js = rt.load_and_build("data/config/world.config.json")
    rad_j, seg_j = wave_jax_without_fma(
        tmp_path, "rt.load_and_build('data/config/world.config.json')",
        width=64, spp=1, depth=4, seed=0, env=RADIX,
    )
    params = dataclasses.replace(params, image_width=64)
    default = render_port(js, params, spp=1, depth=4, seed=0)
    route_env(RADIX)
    assert ttrace.gather_route() == "radix"
    rad_t, seg_t, done_t = render_port(js, params, spp=1, depth=4, seed=0)
    assert seg_t == seg_j
    assert close_share(rad_t, rad_j) == 1.0
    assert (done_t == 1).all()
    _port_routes_agree(rad_t, seg_t, default)


@pytest.mark.parametrize("name", ["textured", "mesh"])
def test_golden_scene_wave_matches_jax_under_radix(route_env, name):
    # The golden textured scene (checker ground, image texels: the texel
    # fetch) and the golden mesh scene (80 triangles: the flat triangle
    # winner), 64x32 @ 1 spp, depth 6, both packages under RT_GATHER=radix.
    js = golden_textured_scene_jax() if name == "textured" \
        else golden_mesh_scene_jax()
    params = golden_params()
    default = render_port(js, params, spp=1, depth=6, seed=11)
    route_env(RADIX)
    rad_j, seg_j = render_jax(js, params, spp=1, depth=6, seed=11)
    rad_t, seg_t, _ = render_port(js, params, spp=1, depth=6, seed=11)
    assert abs(seg_t - seg_j) <= 1e-3 * seg_j
    assert close_share(rad_t, rad_j) >= 0.999
    _port_routes_agree(rad_t, seg_t, default)
    # The JAX package's radix route keeps its default route's words too:
    # the hazard words (a gray 0.5 albedo is 0x80008000) survive its f32
    # selects on XLA-CPU.
    route_env({})
    rad_m, seg_m = render_jax(js, params, spp=1, depth=6, seed=11)
    np.testing.assert_array_equal(rad_m, rad_j)
    assert seg_m == seg_j


@pytest.mark.parametrize("env", [RADIX, WINDOWS], ids=["radix", "windows"])
def test_mesh3_rays_match_jax(route_env, env):
    # mesh:3 (2,048 triangle rows: the two-level triangle windows, culled),
    # a window of 1,024 camera rays at depth 3: RT_GATHER=radix takes the
    # radix fetch everywhere, RT_TWO_LEVEL_MXU=0 at the windows alone.
    params, js = rt.make_world_mesh(image_width=64)
    o, d = _camera_rays(params, 11)
    tables = ttrace.pack_scene(to_port(js), origin=o.mean(0))
    assert tables.tri_rule == "2l" and tables.tri_bounds is not None
    default = trace_port(js, o, d, depth=3, seed=2)
    route_env(env)
    assert ttrace.gather_route() == ("radix" if env is RADIX else "windows")
    rad_j, seg_j = trace_jax(js, o, d, depth=3, seed=2)
    rad_t, seg_t = trace_port(js, o, d, depth=3, seed=2)
    assert abs(seg_t - seg_j) <= 1e-3 * seg_j
    assert close_share(rad_t, rad_j) >= 0.995
    _port_routes_agree(rad_t, seg_t, default)


@pytest.mark.parametrize("env", [RADIX, WINDOWS], ids=["radix", "windows"])
def test_stress_8192_rays_match_jax_without_fma(tmp_path, route_env, env):
    # stress:8192 (the two-level sphere rule over 16 culled blocks: the
    # radix window collapse and the winner folded out of it), a window of
    # 1,024 camera rays at depth 4, the JAX side without fused
    # multiply-adds. Measured: segments equal, every ray within tolerance.
    params, js = rt.make_world_stress(8192, image_width=64)
    o, d = _camera_rays(params, 11)
    default = trace_port(js, o, d, depth=4, seed=2)
    rad_j, seg_j = trace_jax_without_fma(
        tmp_path, "h.rt.make_world_stress(8192, image_width=64)[1]", o, d,
        depth=4, seed=2, env=env,
    )
    route_env(env)
    rad_t, seg_t = trace_port(js, o, d, depth=4, seed=2)
    assert seg_t == seg_j
    assert close_share(rad_t, rad_j) == 1.0
    _port_routes_agree(rad_t, seg_t, default)


@pytest.mark.parametrize("scene", ["textured", "mesh2", "stress2048"])
def test_port_radix_route_byte_equal_to_default(scene):
    # Every fetch site of the plain version on the radix route against the
    # default route: bench.py's textured (texels), mesh:2 (flat triangles
    # with textures) and stress:2048 (the flat sphere winner past 1,024
    # rows), both entries.
    params, js = {
        "textured": lambda: rt.make_world_textured(image_width=32),
        "mesh2": lambda: rt.make_world_mesh(image_width=32, subdivisions=2),
        "stress2048": lambda: rt.make_world_stress(2048, image_width=32),
    }[scene]()
    ts = to_port(js)
    o, d = _camera_rays(params, 4)
    for gather in ("radix", "windows"):
        rays = [ttrace.trace_rays_fused(ts, torch.from_numpy(o),
                                        torch.from_numpy(d), 3, 0, 4,
                                        gather=g)
                for g in ("index", gather)]
        assert torch.equal(rays[0][0], rays[1][0])
        assert int(rays[0][1]) == int(rays[1][1])
