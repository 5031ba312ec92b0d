"""Port vs JAX package on the textured and triangle-mesh scenes: one
regeneration wave of bench.py's ``textured``, ``mesh:3`` (two-level
triangle rule), ``mesh:2`` (flat rule, 512 rows) and ``meshes:4`` at
64x36 @ 1 spp, depth 4, and a multi-wave render through both renderers.

The JAX side runs in TPU-interpret mode. Tolerance, as for the cover scene
(test_torch_regen.py): segments within 0.1% and at least 99.9% of slots
within atol 2e-4 / rtol 1e-3. Measured here: segments equal on every
scene; every slot within tolerance on the mesh scenes, and all but one of
4,096 on ``textured``, where XLA-CPU's fused multiply-adds move a path
(without them every slot agrees: the no-FMA test below)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import raytracing_tpu as rt  # noqa: E402

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch.ops import trace as ttrace  # noqa: E402

from torch_port_helpers import (  # noqa: E402
    close_share, golden_mesh_scene_jax, golden_params, render_both,
    render_port, to_port, wave_jax_without_fma,
)

_SCENES = {
    "textured": "rt.make_world_textured(image_width=64)",
    "mesh3": "rt.make_world_mesh(image_width=64)",
    "mesh2": "rt.make_world_mesh(image_width=64, subdivisions=2)",
    "meshes4": "rt.make_world_meshes(4, image_width=64)",
}
_RULES = {"textured": None, "mesh3": "2l", "mesh2": "flat", "meshes4": "2l"}


@pytest.mark.parametrize("name", sorted(_SCENES))
def test_scene_wave_matches_jax(name):
    params, js = eval(_SCENES[name])
    assert ttrace.pack_scene(to_port(js)).tri_rule == _RULES[name]
    (rad_j, seg_j), (rad_t, seg_t, done_t) = render_both(
        js, params, spp=1, depth=4, seed=0
    )
    assert abs(seg_t - seg_j) <= 1e-3 * seg_j
    assert close_share(rad_t, rad_j) >= 0.999
    assert (done_t == 1).all() and np.isfinite(rad_t).all()


def test_textured_wave_matches_jax_without_fma(tmp_path):
    # With XLA-CPU unable to fuse multiply-adds, the textured wave agrees
    # on every slot (measured: segments equal, 100% within tolerance).
    expr = _SCENES["textured"]
    rad_j, seg_j = wave_jax_without_fma(
        tmp_path, expr, width=64, spp=1, depth=4, seed=0
    )
    params, js = eval(expr)
    rad_t, seg_t, _ = render_port(js, params, spp=1, depth=4, seed=0)
    assert seg_t == seg_j
    assert close_share(rad_t, rad_j) == 1.0


def test_multi_wave_mesh_render_matches_jax():
    # 8 spp in 4 waves of 2 through both renderers, on the golden mesh
    # scene (flat triangle rule, metal mesh, defocus): byte-equal images
    # and equal segments.
    jparams = golden_params(defocus_angle=0.5, focus_distance=2.0)
    jr = rt.Renderer(golden_mesh_scene_jax(), jparams, seed=11,
                     backend="pallas", max_rays_per_batch=64)
    want = jr.render(spp=8)
    params = rtt.CameraParameters(**dataclasses.asdict(jparams))
    r = rtt.Renderer(to_port(golden_mesh_scene_jax()), params, seed=11,
                     device="cpu", max_rays_per_batch=64)
    events = []
    got = r.render(spp=8, on_progress=events.append)
    assert [e.samples_done for e in events] == [2, 4, 6, 8]
    np.testing.assert_array_equal(got, want)
    assert r.segments_traced == jr.segments_traced
