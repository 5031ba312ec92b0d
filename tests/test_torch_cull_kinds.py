"""Port vs JAX package: the cull's bound shapes off the default.

``RT_CULL=sphere`` (one bounding sphere per block), ``RT_CULL_SUB`` > 1
(sub-boxes per block) and ``RT_CULL_HINT=0`` (no sphere-winner bound on
the triangle gate), in ``ops/cull.py`` and ``ops/trace.py``:

* the bound tables against ``_block_bounds`` / ``_tri_block_bounds`` /
  ``_box_block_bounds`` of the JAX package under the same environment;
* the bounding-sphere gate's vote against ``_gate_pre`` + ``_cull_gate``
  run in a test-only ``pl.pallas_call`` in TPU-interpret mode, on seeded
  and on the JAX package's hostile rays;
* bit-transparency: under every kind, sub-box count and hint setting the
  stage-1 keys, ``trace_rays_fused`` and a ``render_pixels_fused`` wave are
  the same bits as with the cull off, while the gate rejects some blocks;
* the environment reaches ``pack_scene`` and the wrappers through one
  function with the JAX package's validation.
"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import raytracing_tpu as rt  # noqa: E402
from raytracing_tpu.ops.pallas import trace as ptrace  # noqa: E402

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch.ops import cull as tcull  # noqa: E402
from raytracing_tpu_torch.ops import trace as ttrace  # noqa: E402

from test_torch_cull import (  # noqa: E402
    _bench, _jax_votes, _port_votes, _rays_t, _seeded_rays, _sphere_case,
    _ulp_diff,
)
from torch_port_helpers import to_port  # noqa: E402

_ENV = ("RT_CULL", "RT_CULL_SUB", "RT_CULL_HINT")


@functools.lru_cache(maxsize=None)
def _scene(name):
    """(params, JAX scene, port scene) of a bench.py scene at 64 px."""
    params, js = _bench(name)
    return params, js, to_port(js)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)


# ---------------------------------------------------------------------------
# Bound tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name, kind, sub", [
    ("stress:2048", "sphere", 1), ("stress:2048", "box", 2),
    ("stress:2048", "box", 4), ("stress:2048", "box", 8),
    ("stress:8192", "sphere", 1), ("mesh:3", "sphere", 1),
    ("mesh:3", "box", 2), ("mesh:3", "box", 8),
])
def test_bound_tables_match_jax(monkeypatch, name, kind, sub):
    monkeypatch.setenv("RT_CULL_SUB", str(sub))
    params, js, ts = _scene(name)
    origin = rt.derive(params).center
    tables = ttrace.pack_scene(ts, origin=np.asarray(origin), cull=kind,
                               cull_sub=sub)
    assert (tables.cull_kind, tables.cull_sub) == (kind, sub)
    if name.startswith("stress"):
        gh, _, sh, n = ptrace.pack_scene(js)[:4]
        blk = min(gh.shape[0], ptrace._SWEEP_ROWS)
        order, bnd = ptrace._block_bounds(
            gh[:, :3], sh[:, 3], n, blk, origin, kind
        )
        got_order, got_bnd = tables.sph_order, tables.sph_bounds
        got_sub = tables.sph_sub
    else:
        tri, m = ptrace.pack_triangles(js)
        blk = ptrace._tri_blk(tri.shape[0])
        order, bnd = ptrace._tri_block_bounds(
            tri[:, 0:3], tri[:, 3:6], tri[:, 6:9], m, blk, origin, kind
        )
        got_order, got_bnd = tables.tri_order, tables.tri_bounds
        got_sub = tables.tri_sub
    # Sub-boxes cover at least 64 rows: 256-row triangle blocks take 4.
    if kind == "box":
        assert got_sub == ptrace._cull_sub(blk) == min(sub, blk // 64)
    assert got_bnd.shape[1] == tables.bound_width(got_sub)
    np.testing.assert_array_equal(got_order.numpy(), np.asarray(order))
    assert _ulp_diff(got_bnd.numpy().reshape(-1), bnd).max() == 0


@pytest.mark.parametrize("sub", [2, 8])
def test_box_block_bounds_sub_matches_jax(sub):
    # Random rows with a padded tail: the sub-box reduction, widening and
    # the visit order by a block's nearest sub-box.
    rng = np.random.default_rng(6)
    c = rng.normal(size=(1024, 3)).astype(np.float32) * 30
    r = rng.uniform(0.1, 2.0, (1024, 1)).astype(np.float32)
    lo, hi = c - r, c + r
    origin = np.float32([5.0, -3.0, 2.0])
    order, bnd = ptrace._box_block_bounds(
        jnp.asarray(lo), jnp.asarray(hi), 900, 256, jnp.asarray(origin),
        sub=sub,
    )
    got_order, got_bnd = tcull.box_block_bounds(
        torch.from_numpy(lo), torch.from_numpy(hi), 900, 256,
        torch.from_numpy(origin), sub,
    )
    np.testing.assert_array_equal(got_order.numpy(), np.asarray(order))
    assert _ulp_diff(got_bnd.numpy().reshape(-1), bnd).max() == 0
    assert got_bnd.shape == (4, 8 * sub)


# ---------------------------------------------------------------------------
# The bounding-sphere gate's vote against the JAX package's gate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["seeded", "kill_shot", "axis_parallel",
                                  "overflow"])
def test_sphere_bound_gate_vote_matches_jax(name):
    rng = np.random.default_rng(7)
    ts, rays = _sphere_case(name, rng)
    tables = ttrace.pack_scene(ts, cull="sphere")
    assert tables.sph_bounds.shape[1] == 4
    best, mask = ttrace.sphere_stage1(
        ttrace.pack_scene(ts, cull=False), _rays_t(rays)
    )
    carry = best.numpy().copy()
    carry[1::2] = np.int32(ttrace._BIGF_BITS & ~mask)
    act = rng.uniform(size=carry.shape) < 0.9 if name == "seeded" else None
    kw = dict(id_mask=mask, scaled=True, act=act, kind="sphere")
    order, bounds = tables.sph_order.numpy(), tables.sph_bounds.numpy()
    want = _jax_votes(order, bounds, rays, carry, **kw)
    got = _port_votes(order, bounds, rays, carry, **kw)
    np.testing.assert_array_equal(got, want)
    assert got.any()
    if name == "seeded":
        assert not got.all()


def test_sphere_bound_triangle_gate_with_hint_matches_jax():
    rng = np.random.default_rng(8)
    params, _, ts = _scene("mesh:3")
    tables = ttrace.pack_scene(ts, origin=np.asarray(rt.derive(params).center),
                               cull="sphere")
    rays = _seeded_rays(rng, [-1.5, 0.0, -1.5], [1.5, 2.5, 1.5])
    best, mask = ttrace.tri_stage1(
        ttrace.pack_scene(ts, cull=False), _rays_t(rays)
    )
    carry = best.numpy().copy()
    carry[1::2] = np.int32(ttrace._BIGF_BITS & ~mask)
    hint = np.where(rng.uniform(size=carry.shape) < 0.5,
                    rng.uniform(0.5, 20.0, size=carry.shape),
                    ttrace._BIGF).astype(np.float32)
    for h in (hint, None):
        kw = dict(id_mask=mask, scaled=False, hint=h, kind="sphere")
        order, bounds = tables.tri_order.numpy(), tables.tri_bounds.numpy()
        want = _jax_votes(order, bounds, rays, carry, **kw)
        got = _port_votes(order, bounds, rays, carry, **kw)
        np.testing.assert_array_equal(got, want)
        assert got.any() and not got.all()


# ---------------------------------------------------------------------------
# Bit-transparency of every kind, sub-box count and hint setting
# ---------------------------------------------------------------------------


_SETTINGS = {
    "stress:2048": [("sphere", 1, True), ("box", 2, True), ("box", 8, True)],
    "mesh:3": [("sphere", 1, True), ("box", 2, True), ("box", 4, True),
               ("box", 1, False), ("sphere", 1, False)],
}
_N = 1024  # one tile of slots and of rays
_DEPTH = 3


@pytest.mark.parametrize("rule", ["flat", "2l"])
@pytest.mark.parametrize("kind, sub", [("sphere", 1), ("box", 4)])
def test_stage1_keys_on_hostile_rays(monkeypatch, kind, sub, rule):
    # The JAX package's hostile cull cases under both sphere rules.
    if rule == "2l":
        monkeypatch.setenv("RT_TWO_LEVEL_MIN", "513")
    for name in ("kill_shot", "axis_parallel", "overflow"):
        ts, rays = _sphere_case(name, np.random.default_rng(7))
        on = ttrace.pack_scene(ts, cull=kind, cull_sub=sub)
        off = ttrace.pack_scene(ts, cull=False)
        assert on.sphere_rule == rule
        r = _rays_t(rays)
        tally = ttrace.SweepTally()
        k_on, _ = ttrace.sphere_stage1(on, r, tally)
        k_off, _ = ttrace.sphere_stage1(off, r)
        assert torch.equal(k_on, k_off), name
        assert tally.sphere_passes > 0


def _entries(tables, params, hint=None, tally=None):
    """A one-tile regen wave and a one-tile trace of camera rays."""
    cam = rtt.derive(rtt.CameraParameters(**dataclasses.asdict(params)))
    wave = ttrace.render_pixels_fused_reference(
        tables, cam.as_vector(), slot_base=0, map_param=2, seed=3,
        sample_start=0, spp=1, max_depth=_DEPTH, t_end=1,
        done=torch.zeros(_N, dtype=torch.int32), num_slots=_N, tally=tally,
        cull_hint=hint,
    )
    k = torch.arange(_N)
    px = (k % cam.image_width).float() + 0.5
    py = (k // cam.image_width % cam.image_height).float() + 0.5
    d = (cam.pixel00[None] + px[:, None] * cam.pixel_delta_u[None]
         + py[:, None] * cam.pixel_delta_v[None] - cam.center[None])
    o = cam.center[None].expand(_N, 3).contiguous()
    rays = ttrace.trace_rays_fused(tables, o, d.contiguous(), 3, 0, _DEPTH,
                                   cull_hint=hint)
    return wave[:2], rays


@functools.lru_cache(maxsize=None)
def _cull_off(name):
    params, _, ts = _scene(name)
    origin = np.asarray(rt.derive(params).center)
    return _entries(ttrace.pack_scene(ts, origin=origin, cull=False), params)


@pytest.mark.parametrize("name, setting", [
    (n, s) for n, settings in _SETTINGS.items() for s in settings
], ids=lambda v: v if isinstance(v, str) else
    f"{v[0]}{v[1]}{'' if v[2] else '-nohint'}")
def test_both_entries_bit_equal_to_cull_off(name, setting):
    kind, sub, hint = setting
    params, _, ts = _scene(name)
    origin = np.asarray(rt.derive(params).center)
    on = ttrace.pack_scene(ts, origin=origin, cull=kind, cull_sub=sub)
    tally = ttrace.SweepTally()
    (r_on, s_on), (t_on, ts_on) = _entries(on, params, hint, tally)
    (r_off, s_off), (t_off, ts_off) = _cull_off(name)
    assert torch.equal(r_on, r_off) and int(s_on) == int(s_off)
    assert torch.equal(t_on, t_off) and int(ts_on) == int(ts_off)
    kind_t = "tri" if name.startswith("mesh") else "sphere"
    votes = getattr(tally, f"{kind_t}_votes")
    assert 0 < getattr(tally, f"{kind_t}_passes") < votes


def test_hint_off_passes_more_triangle_blocks():
    # tests/test_torch_cull.py's occluder: a metal sphere in front of a
    # 1,280-triangle mesh. With the hint the occluded rays reject every
    # mesh block; without it they pass some; the bounce is the same bits.
    from test_torch_cull import _uniforms
    from raytracing_tpu.scene import mesh as jmesh
    from raytracing_tpu.scene.types import MaterialKind, SceneBuilder

    verts, faces = jmesh.make_icosphere(3)
    b = SceneBuilder()
    b.add_mesh(verts * 0.9 + np.float32([0.0, 0.0, -4.0]), faces,
               albedo=(0.8, 0.8, 0.9), kind=MaterialKind.METALLIC, fuzz=0.0)
    b.add_metallic_sphere((0.0, 0.0, -2.0), 0.55, (0.9, 0.9, 0.9), 0.0)
    for kind in ("box", "sphere"):
        tables = ttrace.pack_scene(to_port(b.build()), cull=kind)
        rng = np.random.default_rng(31)
        d = np.tile(np.float32([0.0, 0.0, -1.0]), (1024, 1))
        d[:, :2] += rng.normal(size=(1024, 2)).astype(np.float32) * 0.02
        r = _rays_t(np.concatenate([np.zeros_like(d).T, d.T]))
        uni = _uniforms(1024, 2)
        t_on, t_off = ttrace.SweepTally(), ttrace.SweepTally()
        a = ttrace._bounce(tables, r, uni, t_on, cull_hint=True)
        c = ttrace._bounce(tables, r, uni, t_off, cull_hint=False)
        for k in a:
            va = a[k] if isinstance(a[k], tuple) else (a[k],)
            vc = c[k] if isinstance(c[k], tuple) else (c[k],)
            assert all(torch.equal(x, y) for x, y in zip(va, vc)), k
        assert a["hitm"].all() and t_on.tri_votes == t_off.tri_votes > 0
        assert t_on.tri_passes == 0 < t_off.tri_passes, kind


# ---------------------------------------------------------------------------
# The environment
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("env, want", [
    ({}, ("box", 1, True)),
    ({"RT_CULL": "1"}, ("box", 1, True)),
    ({"RT_CULL": "sphere", "RT_CULL_HINT": "0"}, ("sphere", 1, False)),
    ({"RT_CULL": "box", "RT_CULL_SUB": "4"}, ("box", 4, True)),
    ({"RT_CULL": "0"}, (None, 1, True)),
])
def test_env_settings_pick_the_jax_packages_gate(monkeypatch, env, want):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tcull.env_settings() == want
    assert ptrace._cull_kind() == want[0]
    assert ptrace._cull_hint() == want[2]
    assert tcull.clamp_sub(want[1], 512) == ptrace._cull_sub(512)
    assert tcull.clamp_sub(want[1], 256) == ptrace._cull_sub(256)
    tables = ttrace.pack_scene(_scene("stress:2048")[2])
    assert tables.cull_kind == want[0]
    assert (tables.sph_bounds is None) == (want[0] is None)
    if want[0] is not None:
        assert tables.sph_bounds.shape[1] == tables.bound_width(want[1])


@pytest.mark.parametrize("env", [{"RT_CULL": "yes"}, {"RT_CULL_SUB": "3"},
                                 {"RT_CULL_SUB": "16"},
                                 {"RT_CULL_HINT": "2"}])
def test_bad_env_values_raise_in_both_packages(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError):
        tcull.env_settings()
    with pytest.raises(ValueError):
        ptrace._cull_kind()
        ptrace._cull_sub(512)
        ptrace._cull_hint()
    with pytest.raises(ValueError):
        ttrace.pack_scene(_scene("stress:2048")[2])


def test_wrappers_reject_bound_tables_of_the_wrong_layout():
    ts = _scene("stress:2048")[2]
    box = ttrace.pack_scene(ts, cull="box", cull_sub=4)
    sph = ttrace.pack_scene(ts, cull="sphere")
    o = torch.zeros((1024, 3))
    d = torch.ones((1024, 3))
    for bad in (
        dataclasses.replace(box, cull_sub=2),       # rows of 32 floats
        dataclasses.replace(sph, cull_kind="box"),  # rows of 4 floats
        dataclasses.replace(box, cull_kind="cone"),
        dataclasses.replace(box, cull_sub=3),
    ):
        with pytest.raises(ValueError):
            ttrace.trace_rays_fused(bad, o, d, 0, 0, 2)
    with pytest.raises(ValueError):
        ttrace.pack_scene(ts, cull="cone")
    with pytest.raises(ValueError):
        ttrace.pack_scene(ts, cull_sub=16)
