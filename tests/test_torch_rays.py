"""Port vs JAX package: the ray-input entry (``trace_rays_fused``).

Caller rays traced for a fixed depth with the lane-keyed RNG: the JAX side
is ``raytracing_tpu.ops.pallas.trace.trace_rays_fused`` in TPU-interpret
mode (as tests/test_pallas.py runs it), the port's is its plain version
(the CPU path of ``raytracing_tpu_torch.ops.trace.trace_rays_fused``).
Rays are made with numpy from a seed.

Tolerances, as for the regen entry (test_torch_regen.py): radiance within
atol 2e-4 / rtol 1e-3. Deterministic scenes (fuzz-0 metal): segments equal
and every ray within tolerance. RNG-dependent scenes: segments within 0.1%
and at least 99.5% of rays within tolerance with XLA-CPU's default, which
contracts multiply-adds; with that taken away (``trace_jax_without_fma``)
segments equal and every ray within tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import raytracing_tpu as rt  # noqa: E402
from raytracing_tpu.ops.pallas import trace as ptrace  # noqa: E402
from raytracing_tpu.scene.types import SceneBuilder  # noqa: E402

from raytracing_tpu_torch.ops import trace as ttrace  # noqa: E402

from torch_port_helpers import (  # noqa: E402
    ATOL, RTOL, close_share, full_materials_scene_jax, metal_scene_jax,
    to_port, trace_jax, trace_jax_without_fma, trace_port,
)


def _random_rays(seed, n=1024):
    """``n`` rays from the origin in seeded directions (unnormalized)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return np.zeros_like(d), d


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


def _both(js, o, d, *, depth, seed=3, tile_offset=0, tile_rays=1024):
    kw = dict(depth=depth, seed=seed, tile_offset=tile_offset,
              tile_rays=tile_rays)
    return trace_jax(js, o, d, **kw), trace_port(js, o, d, **kw)


def _forward_rays(seed, n=2048):
    """Rays from the origin in a seeded cone about -z (into the scene)."""
    rng = np.random.default_rng(seed)
    d = np.tile(np.float32([0.0, 0.0, -1.0]), (n, 1))
    d[:, :2] += rng.normal(size=(n, 2)).astype(np.float32) * 0.6
    return np.zeros_like(d), d.astype(np.float32)


# ---------------------------------------------------------------------------
# Lane-keyed RNG
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tile_rays", [1024, 2048])
@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_lane_draws_bit_equal(tile_rays, seed):
    t_sub = tile_rays // 128
    lane_h = ptrace._lane_hash((t_sub, 128))
    got_lane = ttrace._lane_hash(torch.arange(tile_rays, dtype=torch.int64))
    np.testing.assert_array_equal(
        got_lane.numpy(),
        np.asarray(lane_h).reshape(-1).view(np.uint32).astype(np.int64),
    )
    seed_h = ptrace._fmix32(jnp.int32(seed) + jnp.int32(ptrace._GOLD))
    for tile_idx, bounce in ((0, 0), (5, 3), (2**31 - 1, 63)):
        s = ptrace._fmix32(
            jnp.int32(tile_idx) * jnp.int32(ptrace._GOLD) + bounce + seed_h
        )
        tiles = torch.full((tile_rays,), tile_idx, dtype=torch.int64)
        got_s = ttrace._trace_stream(tiles, bounce, seed)
        assert int(got_s[0]) == int(np.asarray(s).view(np.uint32))
        for j in range(3):
            want = ptrace._uniform01_from(lane_h, s, j)
            got = ttrace._uniform01_from(got_lane, got_s, j)
            np.testing.assert_array_equal(
                got.numpy().view(np.int32),
                np.asarray(want).reshape(-1).view(np.int32),
            )


# ---------------------------------------------------------------------------
# Scenes against the JAX package
# ---------------------------------------------------------------------------


def test_metal_fuzz0_scene_matches_jax():
    # No RNG on any path: equal segments, every ray within tolerance.
    o, d = _random_rays(1)
    (rad_j, seg_j), (rad_t, seg_t) = _both(metal_scene_jax(), o, d, depth=8)
    assert seg_t == seg_j
    np.testing.assert_allclose(rad_t, rad_j, atol=ATOL, rtol=RTOL)


def test_multi_block_scene_matches_jax():
    # tests/test_pallas.py's 150 fuzz-0 metal spheres (256 rows).
    rng = np.random.default_rng(8)
    b = SceneBuilder()
    for _ in range(150):
        b.add_metallic_sphere(rng.normal(size=3) * 4, rng.uniform(0.2, 0.8),
                              (0.9, 0.9, 0.9), 0.0)
    js = b.build()
    assert ttrace.pack_scene(to_port(js)).n_pad == 256
    o, d = _random_rays(4)
    (rad_j, seg_j), (rad_t, seg_t) = _both(js, o, d, depth=3)
    assert seg_t == seg_j
    np.testing.assert_allclose(rad_t, rad_j, atol=ATOL, rtol=RTOL)


def test_full_materials_scene_matches_jax():
    # RNG-dependent paths with XLA-CPU's fused multiply-adds on the JAX
    # side: a grazing path may part. Measured: see the no-FMA test.
    o, d = _forward_rays(5)
    (rad_j, seg_j), (rad_t, seg_t) = _both(full_materials_scene_jax(), o, d,
                                           depth=8, seed=5)
    assert abs(seg_t - seg_j) <= 1e-3 * seg_j
    assert close_share(rad_t, rad_j) >= 0.995


def test_full_materials_scene_matches_jax_without_fma(tmp_path):
    # The same rays with XLA-CPU unable to contract multiply-adds: every
    # ray within tolerance and equal segments.
    o, d = _forward_rays(5)
    rad_j, seg_j = trace_jax_without_fma(
        tmp_path, "h.full_materials_scene_jax()", o, d, depth=8, seed=5,
    )
    rad_t, seg_t = trace_port(full_materials_scene_jax(), o, d, depth=8,
                              seed=5)
    assert seg_t == seg_j
    assert close_share(rad_t, rad_j) == 1.0


_SCENES = {
    "textured": ("rt.make_world_textured(image_width=64)", None),
    "mesh2": ("rt.make_world_mesh(image_width=64, subdivisions=2)", "flat"),
    "mesh3": ("rt.make_world_mesh(image_width=64)", "2l"),
}


@pytest.mark.parametrize("name", sorted(_SCENES))
def test_scene_matches_jax(name):
    # bench.py's scenes from their cameras: textures, and the flat and the
    # two-level (culled) triangle rules. Measured: segments equal and every
    # ray within tolerance.
    expr, tri_rule = _SCENES[name]
    params, js = eval(expr)
    o, d = _camera_rays(params, 11)
    tables = ttrace.pack_scene(to_port(js), origin=o.mean(0))
    assert tables.tri_rule == tri_rule and tables.sphere_rule == "flat"
    assert (tables.tri_bounds is not None) == (name == "mesh3")
    (rad_j, seg_j), (rad_t, seg_t) = _both(js, o, d, depth=3, seed=2)
    assert abs(seg_t - seg_j) <= 1e-3 * seg_j
    assert close_share(rad_t, rad_j) >= 0.995
    assert np.isfinite(rad_t).all()


def test_stress_8192_matches_jax_without_fma(tmp_path):
    # bench.py's stress:8192: the two-level sphere rule over 16 culled
    # blocks (ordered from the rays' mean origin). Its radius-1000 ground
    # carries XLA-CPU's contracted roots into the bounces (86% of rays
    # within tolerance with XLA's default), so the JAX side runs without
    # fused multiply-adds. Measured: segments equal, every ray within
    # tolerance.
    params, js = rt.make_world_stress(8192, image_width=64)
    o, d = _camera_rays(params, 11)
    tables = ttrace.pack_scene(to_port(js), origin=o.mean(0))
    assert tables.sphere_rule == "2l" and tables.sph_bounds is not None
    rad_j, seg_j = trace_jax_without_fma(
        tmp_path, "h.rt.make_world_stress(8192, image_width=64)[1]", o, d,
        depth=4, seed=2,
    )
    rad_t, seg_t = trace_port(js, o, d, depth=4, seed=2)
    assert seg_t == seg_j
    assert close_share(rad_t, rad_j) == 1.0


# ---------------------------------------------------------------------------
# Edges, validation and the tile window
# ---------------------------------------------------------------------------


def test_sky_only():
    scene = SceneBuilder().build()  # every ray misses
    d = np.tile(np.float32([[0.0, 1.0, 0.0]]), (1024, 1))
    d[1] = [0.0, -1.0, 0.0]
    o = np.zeros_like(d)
    (rad_j, seg_j), (rad_t, seg_t) = _both(scene, o, d, depth=4)
    np.testing.assert_allclose(rad_t[0], [0.5, 0.7, 1.0], atol=1e-6)
    np.testing.assert_allclose(rad_t[1], [1.0, 1.0, 1.0], atol=1e-6)
    assert seg_t == seg_j == 1024
    np.testing.assert_array_equal(rad_t, rad_j)


def test_depth_zero_black():
    scene = to_port(metal_scene_jax())
    o = torch.zeros((1024, 3))
    d = torch.ones((1024, 3))
    rad, seg = ttrace.trace_rays_fused(scene, o, d, 0, 0, 0)
    assert int(seg) == 0 and (rad == 0).all() and rad.shape == (1024, 3)


def test_bad_ray_counts_and_tiles_raise():
    scene = to_port(metal_scene_jax())
    o = torch.zeros((1024, 3))
    with pytest.raises(ValueError, match="multiple of 1024"):
        ttrace.trace_rays_fused(scene, o, o, 0, 0, 2, tile_rays=512)
    with pytest.raises(ValueError, match="not divisible"):
        ttrace.trace_rays_fused(scene, o[:512], o[:512], 0, 0, 2)
    with pytest.raises(ValueError, match="not divisible"):
        ttrace.trace_rays_fused(scene, o, o, 0, 0, 2, tile_rays=2048)
    with pytest.raises(ValueError):
        ttrace.trace_rays_fused(scene, o, o[:, :2].contiguous(), 0, 0, 2)
    with pytest.raises(TypeError):
        ttrace.trace_rays_fused(scene, o.double(), o.double(), 0, 0, 2)


@pytest.mark.parametrize("tile_rays", [1024, 2048])
def test_window_equals_call_with_tile_offset(tile_rays):
    # A window of whole tiles of a call is the call on that window with
    # tile_offset advanced (the JAX package's chunked callers rely on it),
    # and the JAX package gives the same bits for the window.
    o, d = _forward_rays(9, 4 * tile_rays)
    js = full_materials_scene_jax()
    whole, seg_whole = trace_port(js, o, d, depth=5, seed=4,
                                  tile_rays=tile_rays)
    w = slice(2 * tile_rays, 4 * tile_rays)
    part, seg_part = trace_port(js, o[w], d[w], depth=5, seed=4,
                                tile_offset=2, tile_rays=tile_rays)
    np.testing.assert_array_equal(whole[w], part)
    assert 0 < seg_part < seg_whole
    # The tile index keys the stream: offset 0 draws other numbers.
    other, _ = trace_port(js, o[w], d[w], depth=5, seed=4,
                          tile_rays=tile_rays)
    assert not np.array_equal(other, part)
    if tile_rays == 1024:
        rad_j, seg_j = trace_jax(js, o[w], d[w], depth=5, seed=4,
                                 tile_offset=2)
        assert abs(seg_part - seg_j) <= 1e-3 * seg_j
        assert close_share(part, rad_j) >= 0.995
