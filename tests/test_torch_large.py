"""Port vs JAX package on large scenes: the two-level sphere closest hit.

The JAX package takes the two-level rule from 8,192 sphere rows
(``_two_level_enabled``): stage 1 keeps each 128-row window's key min with
the window id in 6 low bits, stage 2 sweeps the winning window again with
7-bit row ids. The flat rule at that size packs 13 id bits, so the two
rules break near ties (roots within about 0.1%) differently. The port
follows the JAX rule and its ``RT_TWO_LEVEL_MIN`` (``ops/trace.py``:
``env_settings``, ``SceneTables.sphere_rule``).

The JAX side runs in TPU-interpret mode. Tolerances are test_torch_slice's:
segments within 0.1% and at least 99.9% of slots within atol 2e-4 / rtol
1e-3; where XLA-CPU's fused multiply-adds would move grazing paths, the JAX
side runs in a process without them (``wave_jax_without_fma``).
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import raytracing_tpu as rt  # noqa: E402

from raytracing_tpu_torch.ops import trace as ttrace  # noqa: E402

from torch_port_helpers import (  # noqa: E402
    close_share, metal_cloud_scene_jax, near_tie_scene_jax, render_jax,
    render_port, to_port, wave_jax_without_fma,
)


def test_near_tie_winners_follow_the_two_level_rule(monkeypatch):
    # The fault witness: concentric sphere pairs whose near roots differ by
    # about 1e-4 relative, in an 8,192-row table. The port must pick the
    # JAX package's winners (the nearer, outer red spheres).
    params, js = near_tie_scene_jax()
    tables = ttrace.pack_scene(to_port(js))
    assert (tables.n_pad, tables.sphere_rule) == (8192, "2l")
    rad_j, seg_j = render_jax(js, params, spp=1, depth=4, seed=0)
    rad_t, seg_t, done_t = render_port(js, params, spp=1, depth=4, seed=0)
    # Measured: segments equal and every slot within tolerance.
    assert seg_t == seg_j
    assert close_share(rad_t, rad_j) == 1.0
    assert (done_t == 1).all()
    # Teeth: the flat rule at this size (the rule before the two-level
    # port) takes the inner blue spheres on most pair hits and fails.
    monkeypatch.setenv("RT_TWO_LEVEL_MIN", str(1 << 30))
    rad_f, _, _ = render_port(js, params, spp=1, depth=4, seed=0)
    assert close_share(rad_f, rad_j) < 0.9
    # Where the rules part, the two-level winner is the red outer sphere.
    part = ~np.isclose(rad_f, rad_t, atol=2e-4, rtol=1e-3).all(axis=1)
    redder = (rad_t[:, 0] - rad_t[:, 2]) > (rad_f[:, 0] - rad_f[:, 2])
    assert redder[part].mean() > 0.99


def test_stress_8192_wave_matches_jax(tmp_path):
    # bench.py's stress:8192 (8,192 rows, two-level rule, 16 culled blocks)
    # at 64x36 @ 1 spp, depth 4. Measured without XLA-CPU's FMA: segments
    # equal and every slot within tolerance.
    expr = "rt.make_world_stress(8192, image_width=64)"
    rad_j, seg_j = wave_jax_without_fma(
        tmp_path, expr, width=64, spp=1, depth=4, seed=0
    )
    params, js = rt.make_world_stress(8192, image_width=64)
    rad_t, seg_t, done_t = render_port(js, params, spp=1, depth=4, seed=0)
    assert abs(seg_t - seg_j) <= 1e-3 * seg_j
    assert close_share(rad_t, rad_j) >= 0.999
    assert (done_t == 1).all() and np.isfinite(rad_t).all()


def test_forced_two_level_metal_scene_matches_jax(tmp_path, monkeypatch):
    # 600 fuzz-0 metal spheres (1,024 rows) with the two-level rule forced
    # on both sides by the environment alone, as tests/test_pallas.py
    # forces it (RT_TWO_LEVEL_MIN). No RNG on any path. Measured without
    # FMA: segments equal, 2,047 of 2,048 slots within tolerance and 88%
    # bit-equal (XLA-CPU's sqrt and divide round differently from torch's
    # CPU kernels, and a grazing reflection carries that to one slot).
    params, js = metal_cloud_scene_jax()
    rad_f, seg_f, _ = render_port(js, params, spp=1, depth=4, seed=0)
    monkeypatch.setenv("RT_TWO_LEVEL_MIN", "513")
    rad_j, seg_j = wave_jax_without_fma(
        tmp_path, "h.metal_cloud_scene_jax()", width=64, spp=1, depth=4,
        seed=0,
    )
    assert ttrace.pack_scene(to_port(js)).sphere_rule == "2l"
    rad_t, seg_t, _ = render_port(js, params, spp=1, depth=4, seed=0)
    assert seg_t == seg_j
    assert close_share(rad_t, rad_j) >= 0.999
    # Here the two port rules pick the same winners: bit-equal radiance.
    assert seg_f == seg_t and np.array_equal(rad_f, rad_t)


@pytest.mark.parametrize("n, rule", [(1024, "flat"), (4096, "flat"),
                                     (8192, "2l"), (16384, "2l")])
def test_sphere_rule_threshold_and_variant_names(n, rule):
    # Padded rows: 1024 ... 16384 (a ground sphere plus n - 1 spheres).
    _, scene = rt.make_world_stress(n, image_width=64)
    tables = ttrace.pack_scene(to_port(scene))
    assert tables.n_pad == n and tables.sphere_rule == rule
    assert ttrace.kernel_variant(tables) == (
        "regen_sph2l" if rule == "2l" else "regen"
    )
    assert ttrace.kernel_variant(tables, "trace") == (
        "trace_sph2l" if rule == "2l" else "trace"
    )
    assert ttrace.kernel_variant(tables) in ttrace.VARIANTS
    # 12 compiled variants for each of the two entries (regen, trace).
    assert len(set(ttrace.VARIANTS)) == 24
