"""The culled sweeps' block schedule as redesigned for Hopper
(``csrc/regen.cu``: ``tri_stage1_warp``, ``sphere_chunk_warp``), held on the
CPU through its plain model ``ops/trace.py::warp_stage1_reference``:

* the model (each passing (ray, block) pair's rows split over a warp's 32
  lanes in the kernel's strided order, a reduction per window, flagged
  windows swept again) is bit-equal to the plain stage 1 it replaces on
  the card (``tri_stage1``, ``sphere_stage1``) on mesh:3, the 320-triangle
  mesh, a culled stress scene under the flat and the two-level sphere
  rule, tables whose last real window holds 1 to 128 rows, warps in which
  0, 1, 31 or 32 lanes pass, dead lanes, keys outside the fast forms'
  ranges, and every ``RT_CULL*`` setting;
* through the plain version it agrees with the JAX package's two-level
  closest hits (``_closest_tri_two_level``, ``_closest_sphere_two_level``):
  the port's trace and wave with the model in place of stage 1, and its
  folded stage-2 key (``fold=True``) in place of the two-level stage 2,
  against the JAX package's, as ``tests/test_torch_large.py`` compares
  them;
* ``SweepTally``'s per-warp counts (``tools/profile_render.py
  --divergence``) agree with the model's ballots.

The kernel itself is held against the plain version on a card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import raytracing_tpu as rt  # noqa: E402

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch.ops import trace as ttrace  # noqa: E402
from raytracing_tpu_torch.scene import config as tconfig  # noqa: E402
from raytracing_tpu_torch.scene import mesh as tmesh  # noqa: E402
from raytracing_tpu_torch.tools import profile_render  # noqa: E402
from raytracing_tpu_torch.tools import sweep_edges  # noqa: E402

from torch_port_helpers import (  # noqa: E402
    close_share, render_port, trace_jax, trace_port,
    wave_jax_without_fma,
)


def _camera_rays(params, n: int, seed: int = 0):
    """``n`` rays from the camera through seeded points of its frame, as
    the plain sweeps take them: (ox, oy, oz, dx, dy, dz)."""
    cam = rtt.derive(params, torch.device("cpu"))
    rng = np.random.default_rng(seed)
    px = torch.from_numpy(rng.uniform(0, cam.image_width, n).astype(np.float32))
    py = torch.from_numpy(rng.uniform(0, cam.image_height, n)
                          .astype(np.float32))
    d = (cam.pixel00[None] + px[:, None] * cam.pixel_delta_u[None]
         + py[:, None] * cam.pixel_delta_v[None] - cam.center[None])
    o = cam.center[None].expand(n, 3)
    return tuple(t.contiguous() for t in (*o.T, *d.T)), cam.center


def _partial_mesh_scene(m: int):
    """A ground sphere and the first ``m`` triangles of a 1,280-triangle
    icosphere (tests/test_torch_cuda.py's)."""
    verts, faces = tmesh.make_icosphere(3)
    b = rtt.SceneBuilder()
    b.add_lambertian_sphere((0.0, -100.5, -1.0), 100.0, (0.5, 0.5, 0.5))
    b.add_mesh(verts * 0.5 + np.float32([0.0, 0.0, -1.2]), faces[:m],
               albedo=(0.8, 0.6, 0.3), kind=rtt.MaterialKind.METALLIC,
               fuzz=0.1)
    return b.build()


def _case(name: str, monkeypatch):
    """(kind, tables, rays, hint) of a named case."""
    if name.startswith("mesh3") or name == "mesh2":
        if name == "mesh2":
            monkeypatch.setenv("RT_TWO_LEVEL_MIN", "1")
        sub = 2 if name == "mesh2" else 3
        params, scene = tconfig.make_world_mesh(image_width=64,
                                                subdivisions=sub)
        rays, center = _camera_rays(params, 1024, seed=sub)
        tables = ttrace.pack_scene(scene, origin=center)
        # Half the rays bound by a sphere hit at t = 4, the rest unbound.
        hint = torch.where(torch.arange(1024) % 2 == 0, 4.0, 3.0e38)
        return "tri", tables, rays, hint
    if name.startswith("rows"):
        monkeypatch.setenv("RT_TWO_LEVEL_MIN", "1")
        scene = _partial_mesh_scene(int(name[4:]))
        params = rtt.CameraParameters(
            aspect_ratio=2.0, image_width=64, samples_per_pixel=1,
            max_depth=4, vertical_fov=55.0, defocus_angle=0.0,
            focus_distance=1.0, lookfrom=(0.0, 0.3, 1.2),
            lookat=(0.0, 0.0, -1.2))
        rays, center = _camera_rays(params, 512, seed=5)
        return "tri", ttrace.pack_scene(scene, origin=center), rays, None
    if name.startswith("stress"):
        if name == "stress_2l":
            monkeypatch.setenv("RT_TWO_LEVEL_MIN", "2048")
        params, scene = tconfig.make_world_stress(2048, image_width=64)
        rays, center = _camera_rays(params, 1024, seed=7)
        return "sphere", ttrace.pack_scene(scene, origin=center), rays, None
    raise ValueError(name)


def _plain(kind, tables, rays, hint):
    if kind == "tri":
        return ttrace.tri_stage1(tables, rays, hint)
    return ttrace.sphere_stage1(tables, rays)


def _model_equals_plain(kind, tables, rays, hint, live=None):
    stats = {}
    got, mask = ttrace.warp_stage1_reference(tables, rays, kind, hint, live,
                                             stats)
    if live is None:
        want, want_mask = _plain(kind, tables, rays, hint)
        assert mask == want_mask
        assert torch.equal(got, want)
    else:
        sub = tuple(t[live] for t in rays)
        want, _ = _plain(kind, tables, sub,
                         None if hint is None else hint[live])
        assert torch.equal(got[live], want)
        # A dead lane keeps the initial best: it votes no everywhere.
        init = ttrace._BIGF_BITS & ~mask
        assert bool((got[~live] == init).all())
    return stats


# rowsM: the first M triangles under the two-level rule (from 256 rows),
# so that the last real window holds 1, 127 or 128 rows, in one block
# (129, 255, 256) or past the first of several culled ones (385, 511,
# 512, 641).
CASES = ["mesh3", "mesh2", "stress_flat", "stress_2l", "rows129", "rows255",
         "rows256", "rows385", "rows511", "rows512", "rows641"]


@pytest.mark.parametrize("name", CASES)
def test_warp_model_equals_plain_stage1(name, monkeypatch):
    kind, tables, rays, hint = _case(name, monkeypatch)
    if kind == "tri":
        assert tables.tri_rule == "2l"
        real = tables.m_actual
        if name.startswith("rows"):
            assert real == int(name[4:])
    else:
        assert tables.n_pad == 2048 and tables.sph_bounds is not None
        assert tables.sphere_rule == ("2l" if name == "stress_2l" else "flat")
    stats = _model_equals_plain(kind, tables, rays, hint)
    assert stats["reductions"] > 0
    if name.startswith("rows"):
        last = real - (real - 1) // ttrace.WIN * ttrace.WIN
        assert last == {129: 1, 255: 127, 256: 128, 385: 1, 511: 127,
                        512: 128, 641: 1}[real]
        assert (tables.tri_bounds is not None) == (real > 256)


@pytest.mark.parametrize("setting", ["sphere", "sub4", "hint0"])
@pytest.mark.parametrize("name", ["mesh3", "stress_2l"])
def test_warp_model_under_cull_settings(name, setting, monkeypatch):
    env = {"sphere": ("RT_CULL", "sphere"), "sub4": ("RT_CULL_SUB", "4"),
           "hint0": ("RT_CULL_HINT", "0")}[setting]
    monkeypatch.setenv(*env)
    kind, tables, rays, hint = _case(name, monkeypatch)
    if setting == "sphere":
        assert tables.cull_kind == "sphere"
    if setting == "sub4":
        assert (tables.sph_sub if kind == "sphere" else tables.tri_sub) == 4
    if setting == "hint0" and kind == "tri":
        assert not ttrace.cull_hint_default()
        hint = None  # the plain version drops the hint under RT_CULL_HINT=0
    _model_equals_plain(kind, tables, rays, hint)


def _aimed_rays(tables_scene_center, targets, away, passing, n_warps=16):
    """Rays in warps of 32: warp w sends ``passing[w % len(passing)]`` of
    its lanes at seeded ``targets`` and the rest along ``away``."""
    center = tables_scene_center
    rng = np.random.default_rng(3)
    o, d = [], []
    for w in range(n_warps):
        k = passing[w % len(passing)]
        for lane in range(32):
            if lane < k:
                t = targets[rng.integers(0, len(targets))]
                d.append(t - center)
            else:
                d.append(np.float32(away) + rng.normal(0, 0.01, 3)
                         .astype(np.float32))
            o.append(center)
    o = np.asarray(o, np.float32)
    d = np.asarray(d, np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(c))
                 for c in (*o.T, *d.T))


@pytest.mark.parametrize("kind", ["tri", "sphere"])
def test_constructed_warps_with_0_1_31_32_passing_lanes(kind, monkeypatch):
    # Warps whose lanes aim 0, 1, 31 or 32 rays at the culled table and
    # the rest at the sky: the model's ballots see every one of those
    # counts, and the stage 1 is the plain one's.
    if kind == "tri":
        params, scene = tconfig.make_world_mesh(image_width=32,
                                                subdivisions=3)
        center = np.float32(params.lookfrom)
        tables = ttrace.pack_scene(scene, origin=tuple(center))
        targets = scene.tri_v0.numpy() + 0.3 * (scene.tri_e1.numpy()
                                                + scene.tri_e2.numpy())
    else:
        params, scene = tconfig.make_world_stress(2048, image_width=32)
        center = np.float32(params.lookfrom)
        tables = ttrace.pack_scene(scene, origin=tuple(center))
        # The small spheres of the second block visited (Morton-ordered
        # rows: a compact box; the first holds the ground sphere, whose
        # box every ray here passes), so that a warp's aimed lanes pass it
        # together.
        b = int(tables.sph_order[1])
        rows = tables.geom_h[b * 512:(b + 1) * 512]
        targets = rows[rows[:, 1].abs() < 10, :3].numpy()
    rays = _aimed_rays(center, targets, (0.0, 1.0, 0.0), (0, 1, 31, 32))
    stats = _model_equals_plain(kind, tables, rays, None)
    pops = stats["popcounts"]
    for c in (0, 1, 31, 32):
        assert pops[c] > 0, (c, pops)
    # With dead lanes: every third lane has no ray.
    live = torch.arange(rays[0].shape[0]) % 3 != 0
    _model_equals_plain(kind, tables, rays, None, live=live)


def test_dead_lanes_vote_no(monkeypatch):
    kind, tables, rays, hint = _case("mesh3", monkeypatch)
    live = torch.from_numpy(np.random.default_rng(1).uniform(size=1024)
                            < 0.5)
    _model_equals_plain(kind, tables, rays, hint, live=live)


def test_reciprocal_outside_key_rcp_is_swept_again(monkeypatch):
    # A mesh scaled to 2^66: |det| = |e1 . (d x e2)| reaches past 2^126,
    # where key_rcp is not the IEEE reciprocal, so those windows are swept
    # again; the bits stay the plain version's.
    monkeypatch.setenv("RT_TWO_LEVEL_MIN", "1")
    scene = sweep_edges.scaled_mesh(rtt.SceneBuilder()).build()
    tables = ttrace.pack_scene(scene, origin=(0.0, 0.0, 0.0))
    assert tables.tri_rule == "2l" and tables.tri_bounds is not None
    rng = np.random.default_rng(4)
    d = rng.normal(0, 1, (512, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 1.0
    rays = tuple(torch.from_numpy(np.ascontiguousarray(c)) for c in
                 (*np.zeros_like(d).T, *d.T))
    stats = _model_equals_plain("tri", tables, rays, None)
    assert stats["resweeps"] > 0


def test_root_outside_fast_root_is_swept_again(monkeypatch):
    # sweep_edges' tiny camera on its 2,048-row table: every hit's
    # discriminant lies below 2^-101, outside fast_root's range.
    for rule, value in (("flat", None), ("2l", "2048")):
        if value:
            monkeypatch.setenv("RT_TWO_LEVEL_MIN", value)
        scene = sweep_edges.padded_spheres(rtt.SceneBuilder()).build()
        params = sweep_edges.tiny_camera()
        rays, center = _camera_rays(params, 512, seed=2)
        tables = ttrace.pack_scene(scene, origin=center)
        assert tables.sphere_rule == rule and tables.sph_bounds is not None
        stats = _model_equals_plain("sphere", tables, rays, None)
        assert stats["resweeps"] > 0


def test_tally_counts_agree_with_the_model():
    # SweepTally(warp=32)'s per-warp counts of the plain stage 1 on one
    # batch of rays (lanes 0..n-1) against the model's ballots.
    params, scene = tconfig.make_world_stress(2048, image_width=32)
    rays, center = _camera_rays(params, 1024, seed=9)
    tables = ttrace.pack_scene(scene, origin=center)
    tally = ttrace.SweepTally(warp=32)
    tally.lanes = torch.arange(1024)
    want, _ = ttrace.sphere_stage1(tables, rays, tally)
    stats = {}
    got, _ = ttrace.warp_stage1_reference(tables, rays, "sphere",
                                          stats=stats)
    assert torch.equal(got, want)
    pops = stats["popcounts"]
    assert pops[1:] == tally.sphere_popcounts[1:]
    assert sum(c * n for c, n in enumerate(pops)) == tally.sphere_passes
    assert stats["reductions"] == tally.sphere_coop_reductions
    assert tally.sphere_coop_steps == 4 * tally.sphere_coop_reductions
    assert tally.sphere_warp_passes == sum(pops[1:])


def test_divergence_counts_on_a_small_scene():
    one = profile_render.divergence("stress:2048", 32, 1, 3, device="cpu",
                                    warp=1)["sphere"]
    w32 = profile_render.divergence("stress:2048", 32, 1, 3,
                                    device="cpu")["sphere"]
    assert one["warp_passes"] == one["warp_lanes"] == one["lane_passes"] > 0
    assert one["popcounts"][1] == one["warp_passes"]
    assert (w32["votes"], w32["lane_passes"]) == (one["votes"],
                                                  one["lane_passes"])
    assert w32["warp_passes"] <= w32["lane_passes"] <= w32["warp_lanes"]
    assert sum(w32["popcounts"]) == w32["warp_passes"]
    assert sum(c * n for c, n in enumerate(w32["popcounts"])) == \
        w32["lane_passes"]
    # A 512-row chunk: 4 windows of 4 rows a lane for each lane pass,
    # against 512 rows for each warp pass.
    assert w32["coop_steps_per_segment"] == pytest.approx(
        16 * w32["lane_passes_per_segment"])
    assert 0.0 < w32["coop_over_warp_steps"] <= 1.0
    assert w32["cta_passes"] <= w32["warp_passes"]


def _with_model(monkeypatch):
    """The plain version with the model in place of its culled stage 1s,
    and of the two-level rules' stage 2 on the indexed route: the model's
    folded key (``fold=True``), as the kernel folds it."""
    tri_plain, sph_plain = ttrace.tri_stage1, ttrace.sphere_stage1
    tri_winner, sph_winner = ttrace._tri_winner, ttrace._sphere_winner
    rmask = ttrace.WIN - 1
    miss2 = ttrace._BIGF_BITS & ~rmask

    def tri(tables, rays, hint=None, tally=None):
        if tables.tri_rule != "2l":
            return tri_plain(tables, rays, hint, tally)
        return ttrace.warp_stage1_reference(tables, rays, "tri", hint)

    def sph(tables, rays, tally=None):
        if tables.n_pad <= 1024:  # the staged body gates per thread
            return sph_plain(tables, rays, tally)
        return ttrace.warp_stage1_reference(tables, rays, "sphere")

    def tri_win(tables, rays, hint=None, tally=None, route="index"):
        if tables.tri_rule != "2l" or route != "index":
            return tri_winner(tables, rays, hint, tally, route)
        best, mask, key2 = ttrace.warp_stage1_reference(
            tables, rays, "tri", hint, fold=True)
        row = (best & mask).long() * ttrace.WIN + (key2 & rmask).long()
        return tables.tri.view(torch.int32)[row, :11], key2 < miss2

    def sph_win(tables, rays, tally=None, route="index"):
        if tables.sphere_rule != "2l" or route != "index":
            return sph_winner(tables, rays, tally, route)
        best, mask, key2 = ttrace.warp_stage1_reference(
            tables, rays, "sphere", fold=True)
        row = (best & mask).long() * ttrace.WIN + (key2 & rmask).long()
        return key2 < miss2, row, ttrace._sphere_words(tables)[row]

    monkeypatch.setattr(ttrace, "tri_stage1", tri)
    monkeypatch.setattr(ttrace, "sphere_stage1", sph)
    monkeypatch.setattr(ttrace, "_tri_winner", tri_win)
    monkeypatch.setattr(ttrace, "_sphere_winner", sph_win)


def test_model_through_the_plain_version_matches_jax_triangles(monkeypatch):
    # The 320-triangle mesh under the two-level rule (RT_TWO_LEVEL_MIN=1 in
    # both packages; 512 rows, 2 culled blocks), as
    # test_torch_tri_sweep.py's partial-window case traces it.
    monkeypatch.setenv("RT_TWO_LEVEL_MIN", "1")
    params, js = rt.make_world_mesh(image_width=32, subdivisions=2)
    jcam = rt.derive(params)
    idx = np.arange(1024)
    px = (idx % jcam.image_width).astype(np.float32)
    py = (idx // jcam.image_width).astype(np.float32)
    c = np.asarray(jcam.center, np.float32)
    d = (np.asarray(jcam.pixel00)[None] + px[:, None]
         * np.asarray(jcam.pixel_delta_u)[None] + py[:, None]
         * np.asarray(jcam.pixel_delta_v)[None] - c[None]).astype(np.float32)
    o = np.ascontiguousarray(np.broadcast_to(c, d.shape))
    rad_j, seg_j = trace_jax(js, o, d, depth=3, seed=3)
    _with_model(monkeypatch)
    rad_t, seg_t = trace_port(js, o, d, depth=3, seed=3)
    assert seg_t == seg_j
    assert close_share(rad_t, rad_j) == 1.0


def test_model_through_the_plain_version_matches_jax_spheres(tmp_path,
                                                             monkeypatch):
    # bench.py's stress:8192 (two-level rule, 16 culled chunks) at 32x18 @
    # 1 spp, depth 3, the JAX side without XLA-CPU's FMA, held as
    # test_torch_large.py holds the plain version.
    expr = "rt.make_world_stress(8192, image_width=32)"
    rad_j, seg_j = wave_jax_without_fma(tmp_path, expr, width=32, spp=1,
                                        depth=3, seed=0)
    _with_model(monkeypatch)
    params, js = rt.make_world_stress(8192, image_width=32)
    rad_t, seg_t, done_t = render_port(js, params, spp=1, depth=3, seed=0)
    assert abs(seg_t - seg_j) <= 1e-3 * seg_j
    assert close_share(rad_t, rad_j) >= 0.999
    assert (done_t == 1).all() and np.isfinite(rad_t).all()
