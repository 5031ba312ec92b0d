"""Port vs JAX package: the per-block box cull (``ops/cull.py``).

* The bound tables (order and widened boxes) against
  ``_block_bounds(..., "box")`` and ``_tri_block_bounds`` of the JAX
  package, on the tables the Renderer packs.
* The gate's vote against ``_gate_pre`` + ``_cull_gate_box`` run in a
  test-only ``pl.pallas_call`` in TPU-interpret mode, on seeded (1, 128) ray
  groups and on the JAX package's hostile directions.
* Bit-transparency of the plain sweeps: stage-1 keys, bounces and whole
  waves are the same bits with the cull on and off, while the gate rejects
  a nonzero share of (ray, block) pairs.
* The Renderer's tables carry bound tables exactly where the JAX package's
  ``_aux_scene_inputs`` builds them.
"""

import dataclasses
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import raytracing_tpu as rt  # noqa: E402
from raytracing_tpu.ops.pallas import trace as ptrace  # noqa: E402
from raytracing_tpu.scene import mesh as jmesh  # noqa: E402
from raytracing_tpu.scene.types import MaterialKind, SceneBuilder  # noqa: E402

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch.ops import cull as tcull  # noqa: E402
from raytracing_tpu_torch.ops import trace as ttrace  # noqa: E402
from raytracing_tpu_torch.tools import profile_render as pr  # noqa: E402

from torch_port_helpers import COVER, slots_of, to_port  # noqa: E402

_ROOT = pathlib.Path(__file__).resolve().parent.parent
# Largest difference between the two packages' bound tables, in units in
# the last place of f32. Measured: 0 (both run the same f32 operations in
# the same order; the JAX functions run eagerly, so XLA fuses nothing).
ULP_BOUND = 0


def _ulp_diff(a, b) -> np.ndarray:
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ai = np.where(ai < 0, -(ai & 0x7FFFFFFF), ai)
    bi = np.where(bi < 0, -(bi & 0x7FFFFFFF), bi)
    return np.abs(ai - bi)


def _bench(name, width=64):
    """(params, scene) of a bench.py scene name, built by the JAX package."""
    if name.startswith("stress:"):
        return rt.make_world_stress(int(name[7:]), image_width=width)
    if name.startswith("meshes:"):
        return rt.make_world_meshes(int(name[7:]), image_width=width)
    if name.startswith("mesh:"):
        return rt.make_world_mesh(image_width=width, subdivisions=int(name[5:]))
    if name == "textured":
        return rt.make_world_textured(image_width=width)
    params, scene = rt.load_and_build(COVER)
    return params, scene


def _port_tables(js, origin, cull=True):
    return ttrace.pack_scene(to_port(js), origin=np.asarray(origin), cull=cull)


# ---------------------------------------------------------------------------
# (c) Bound tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["stress:2048", "stress:8192", "mesh:3",
                                  "mesh:5"])
def test_bound_tables_match_jax(name):
    params, js = _bench(name)
    origin = rt.derive(params).center
    tables = _port_tables(js, origin)
    if name.startswith("stress"):
        gh, _, sh, n = ptrace.pack_scene(js)[:4]
        blk = min(gh.shape[0], ptrace._SWEEP_ROWS)
        order, bnd = ptrace._block_bounds(
            gh[:, :3], sh[:, 3], n, blk, origin, "box"
        )
        got_order, got_bnd = tables.sph_order, tables.sph_bounds
        assert tables.tri_order is None
    else:
        tri, m = ptrace.pack_triangles(js)
        blk = ptrace._tri_blk(tri.shape[0])
        order, bnd = ptrace._tri_block_bounds(
            tri[:, 0:3], tri[:, 3:6], tri[:, 6:9], m, blk, origin, "box"
        )
        got_order, got_bnd = tables.tri_order, tables.tri_bounds
        assert tables.sph_order is None  # 3 spheres: one block
    assert blk == (ttrace.sphere_block_rows(tables.n_pad)
                   if name.startswith("stress")
                   else ttrace.tri_block_rows(tables.m_pad))
    np.testing.assert_array_equal(got_order.numpy(), np.asarray(order))
    assert _ulp_diff(got_bnd.numpy().reshape(-1), bnd).max() <= ULP_BOUND
    # The scenes have empty tail blocks only where padding fills a block.
    assert (got_bnd[:, 7] > 0.5).any()


def test_order_bounds_matches_jax():
    rng = np.random.default_rng(3)
    ctr = rng.normal(size=(16, 3)).astype(np.float32) * 20
    rad = rng.uniform(0.5, 3.0, 16).astype(np.float32)
    has = rng.uniform(size=16) < 0.8
    origin = np.float32([3.0, 1.0, -2.0])
    order, bnd = ptrace._order_bounds(*map(jnp.asarray, (ctr, rad, has, origin)))
    got_order, got_bnd = tcull.order_bounds(
        *map(torch.from_numpy, (ctr, rad, has, origin))
    )
    np.testing.assert_array_equal(got_order.numpy(), np.asarray(order))
    assert _ulp_diff(got_bnd.numpy(), bnd).max() <= ULP_BOUND


# ---------------------------------------------------------------------------
# (d) The gate's vote against the JAX package's gate, in a pallas_call
# ---------------------------------------------------------------------------


def _jax_votes(order, bounds, rays, carry, *, id_mask, scaled, hint=None,
               act=None, kind="box"):
    """Per (block, 128-ray group) vote of ``_cull_gate`` (``_cull_gate_box``
    for the box kind) in TPU-interpret mode: the block body marks the
    group's carry with -1."""
    nb = order.shape[0]
    g_count = rays.shape[1] // 128
    ray_in = rays.reshape(6, g_count, 128)
    extra = [carry.reshape(g_count, 128)]
    if hint is not None:
        extra.append(hint.reshape(g_count, 128))
    if act is not None:
        extra.append(act.reshape(g_count, 128).astype(np.int32))

    def kernel(ord_ref, bnd_ref, ray_ref, carry_ref, *rest):
        rest = list(rest)
        out_ref = rest.pop()
        hint_ref = rest.pop(0) if hint is not None else None
        act_ref = rest.pop(0) if act is not None else None
        for g in range(g_count):
            rows = tuple(ray_ref[k, g:g + 1, :] for k in range(6))
            ox, oy, oz, dx, dy, dz = rows
            a = dx * dx + dy * dy + dz * dz
            pre = ptrace._gate_pre(
                rows, a, dx * ox + dy * oy + dz * oz,
                ox * ox + oy * oy + oz * oz, ptrace._T_MIN * a, kind,
            )
            lane_act = act_ref[g:g + 1, :] > 0 if act is not None else None
            lane_hint = hint_ref[g:g + 1, :] if hint is not None else None
            for b in range(nb):
                out = ptrace._cull_gate(
                    (ord_ref, bnd_ref, lane_act, kind), b, rows, pre, 1,
                    (carry_ref[g:g + 1, :],), id_mask=id_mask,
                    scaled_key=scaled,
                    body=lambda ob, kw: tuple(jnp.full_like(k, -1) for k in kw),
                    hint=lane_hint,
                )
                out_ref[b, g:g + 1, :] = out[0]

    smem = pl.BlockSpec(memory_space=pltpu.SMEM)
    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
    with pltpu.force_tpu_interpret_mode():
        out = pl.pallas_call(
            kernel,
            out_shape=jax.ShapeDtypeStruct((nb, g_count, 128), jnp.int32),
            in_specs=[smem, smem, vmem, vmem] + [vmem] * (len(extra) - 1),
            out_specs=vmem,
        )(jnp.asarray(order), jnp.asarray(bounds.reshape(-1)),
          jnp.asarray(ray_in), *map(jnp.asarray, extra))
    return (np.asarray(out) == -1).all(axis=2)


def _port_votes(order, bounds, rays, carry, *, id_mask, scaled, hint=None,
                act=None, kind="box"):
    """The any-vote per 128-ray group over the port's per-ray pass mask."""
    r = [torch.from_numpy(np.ascontiguousarray(v)) for v in rays]
    dx, dy, dz = r[3:]
    a = dx * dx + dy * dy + dz * dz
    pre = tcull.gate_pre(r, kind)
    c = torch.from_numpy(carry)
    h = torch.from_numpy(hint) if hint is not None else None
    votes = []
    for v in range(order.shape[0]):
        m = tcull.cull_gate(kind, r, pre, torch.from_numpy(bounds[v]), a, c,
                            id_mask, scaled_key=scaled, hint=h)
        if act is not None:
            m = m & torch.from_numpy(act)
        votes.append(m.view(-1, 128).any(dim=1).numpy())
    return np.stack(votes)


def _shell_scene(center, count, radius, rng, spread=0.4):
    """``count`` metal spheres on a shell around ``center`` (the hostile
    scenes of tests/test_pallas.py); returns (scene, centers)."""
    b = SceneBuilder()
    cs = []
    for _ in range(count):
        u = rng.normal(size=3)
        c = np.asarray(center) + u / np.linalg.norm(u) * spread
        cs.append(c)
        b.add_metallic_sphere(tuple(c), radius, (0.9, 0.9, 0.9), 0.0)
    return b.build(), np.asarray(cs)


def _dynamic_range_rays(rng):
    """tests/test_pallas.py's dynamic-range scene and rays: 1,024 rays at
    the silhouettes of a far compact cluster, then 128 copies of the found
    kill-shot direction (a uniform group that no other lane can rescue)."""
    c0 = np.array([120.0, -340.0, 930.0])
    c0 = c0 / np.linalg.norm(c0) * 1000.0
    scene, centers = _shell_scene(c0, 600, 0.05, rng)
    idx = rng.integers(0, len(centers), size=1024)
    c = centers[idx]
    tang = rng.normal(size=(1024, 3))
    tang -= (tang * c).sum(1, keepdims=True) * c / (c * c).sum(1, keepdims=True)
    tang /= np.linalg.norm(tang, axis=1, keepdims=True)
    aim = c + tang * (0.05 * rng.uniform(0.9, 1.1, size=1024))[:, None]
    d1 = aim / np.linalg.norm(aim, axis=1, keepdims=True)
    kill = np.array(
        [0.11988540463865942, -0.34081958551765895, 0.9324534840313463]
    )
    d = np.concatenate([d1, np.tile(kill, (128, 1))]).astype(np.float32)
    o = np.zeros_like(d)
    return scene, np.concatenate([o.T, d.T])


def _axis_parallel_rays(rng):
    """tests/test_pallas.py's axis-parallel case: d_x exactly 0 from an
    origin just past the widened x-extent of every block."""
    scene, _ = _shell_scene((0.0, 0.0, 1000.0), 600, 0.05, rng)
    tables = ttrace.pack_scene(to_port(scene))
    bnd = tables.sph_bounds.numpy()
    x0 = np.float32(bnd[bnd[:, 7] > 0.5, 3].max() + 2.0e-4)
    d = np.tile(np.float32([0.0, 4.999515113013331e-06, 1.0]), (256, 1))
    o = np.tile(np.float32([x0, 0.0, 0.0]), (256, 1))
    return scene, np.concatenate([o.T, d.T])


def _overflow_rays(rng):
    """tests/test_pallas.py's overflow case: coordinates near 1e9 and d_x
    exactly 0 through a sphere's center, so the x slab products overflow
    to inf and inf - inf = NaN (the gate must pass such lanes)."""
    b = SceneBuilder()
    centers = []
    c_mid = np.array([1.2e9, 3.0e8, 9.0e8])
    for _ in range(600):
        u = rng.normal(size=3)
        c = np.abs(c_mid + u / np.linalg.norm(u) * 4.0e8 * rng.uniform(0.3, 1.0))
        centers.append(c)
        b.add_metallic_sphere(tuple(c), 2.0e6, (0.9, 0.9, 0.9), 0.0)
    c0 = centers[0]
    dyz = np.array([0.0, c0[1], c0[2]])
    dyz = dyz / np.linalg.norm(dyz)
    o0 = np.array([c0[0], c0[1] - 5.0e8 * dyz[1], c0[2] - 5.0e8 * dyz[2]])
    d = np.tile(dyz, (256, 1)).astype(np.float32)
    o = np.tile(o0, (256, 1)).astype(np.float32)
    return b.build(), np.concatenate([o.T, d.T])


def _seeded_rays(rng, lo, hi, n=1024):
    """``n // 128`` coherent groups of 128 rays (one origin, directions in a
    narrow cone, like a warp of primary rays or of one bounce), so that
    votes differ between blocks: half camera-like groups from outside the
    box [lo, hi] aimed at a point in it, half bounce-like groups from a
    point inside it in a random direction."""
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    o, d = [], []
    for g in range(n // 128):
        if g < n // 256:
            og = hi + 5.0
            dg = rng.uniform(lo, hi) - og
        else:
            og = rng.uniform(lo, hi)
            dg = rng.normal(size=3)
        dg = dg / np.linalg.norm(dg)
        o.append(np.tile(og, (128, 1)))
        d.append(dg + rng.normal(size=(128, 3)) * 0.02)
    return np.concatenate(
        [np.concatenate(o).T, np.concatenate(d).T]
    ).astype(np.float32)


def _sphere_case(name, rng):
    if name == "seeded":
        _, scene = _bench("stress:2048")
        rays = _seeded_rays(rng, [-28.0, 0.0, -28.0], [28.0, 1.0, 28.0])
    elif name == "kill_shot":
        scene, rays = _dynamic_range_rays(rng)
    elif name == "axis_parallel":
        scene, rays = _axis_parallel_rays(rng)
    else:
        scene, rays = _overflow_rays(rng)
    return to_port(scene), rays


def _rays_t(rays):
    return tuple(torch.from_numpy(np.ascontiguousarray(v)) for v in rays)


@pytest.mark.parametrize("name", ["seeded", "kill_shot", "axis_parallel",
                                  "overflow"])
def test_sphere_gate_vote_matches_jax(name):
    rng = np.random.default_rng(7)
    ts, rays = _sphere_case(name, rng)
    tables = ttrace.pack_scene(ts)
    order = tables.sph_order.numpy()
    bounds = tables.sph_bounds.numpy()
    # Carries: each lane's final stage-1 key (the tightest bound it can
    # reach), and a miss key on every other lane.
    best, mask = ttrace.sphere_stage1(
        ttrace.pack_scene(ts, cull=False), _rays_t(rays)
    )
    carry = best.numpy().copy()
    carry[1::2] = np.int32(ttrace._BIGF_BITS & ~mask)
    act = rng.uniform(size=carry.shape) < 0.9 if name == "seeded" else None
    kw = dict(id_mask=mask, scaled=True, act=act)
    want = _jax_votes(order, bounds, rays, carry, **kw)
    got = _port_votes(order, bounds, rays, carry, **kw)
    np.testing.assert_array_equal(got, want)
    if name == "seeded":
        assert got.any() and not got.all()
    else:
        assert got.any()


def test_triangle_gate_vote_with_hint_matches_jax():
    rng = np.random.default_rng(8)
    params, js = _bench("mesh:3")
    ts = to_port(js)
    tables = ttrace.pack_scene(ts, origin=np.asarray(rt.derive(params).center))
    rays = _seeded_rays(rng, [-1.5, 0.0, -1.5], [1.5, 2.5, 1.5])
    best, mask = ttrace.tri_stage1(
        ttrace.pack_scene(ts, cull=False), _rays_t(rays)
    )
    carry = best.numpy().copy()
    carry[1::2] = np.int32(ttrace._BIGF_BITS & ~mask)
    # Hints: a sphere winner's t on some lanes, the miss value on others.
    hint = np.where(rng.uniform(size=carry.shape) < 0.5,
                    rng.uniform(0.5, 20.0, size=carry.shape),
                    ttrace._BIGF).astype(np.float32)
    kw = dict(id_mask=mask, scaled=False, hint=hint)
    want = _jax_votes(tables.tri_order.numpy(), tables.tri_bounds.numpy(),
                      rays, carry, **kw)
    got = _port_votes(tables.tri_order.numpy(), tables.tri_bounds.numpy(),
                      rays, carry, **kw)
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()


# ---------------------------------------------------------------------------
# (e) Bit-transparency of the plain sweeps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rule", ["flat", "2l"])
@pytest.mark.parametrize("name", ["kill_shot", "axis_parallel", "overflow"])
def test_cull_keeps_sphere_keys_on_hostile_rays(monkeypatch, name, rule):
    if rule == "2l":
        monkeypatch.setenv("RT_TWO_LEVEL_MIN", "513")
    rng = np.random.default_rng(7)
    ts, rays = _sphere_case(name, rng)
    on, off = ttrace.pack_scene(ts), ttrace.pack_scene(ts, cull=False)
    assert on.sphere_rule == rule and on.sph_bounds is not None
    r = _rays_t(rays)
    tally = ttrace.SweepTally()
    k_on, _ = ttrace.sphere_stage1(on, r, tally)
    k_off, mask = ttrace.sphere_stage1(off, r)
    assert torch.equal(k_on, k_off)
    hit_on, row_on = ttrace._closest_sphere(on, r)
    hit_off, row_off = ttrace._closest_sphere(off, r)
    assert torch.equal(hit_on, hit_off) and torch.equal(row_on, row_off)
    assert hit_on.any()  # the rays do hit: the comparison has teeth
    assert tally.sphere_passes > 0


def _probe_box_cull():
    spec = importlib.util.spec_from_file_location(
        "probe_box_cull", _ROOT / "scripts" / "probe_box_cull.py"
    )
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    return probe


def _uniforms(n, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.random(n).astype(np.float32))
                 for _ in range(3))


def _bounce_equal(on, off, r, uni):
    a = ttrace._bounce(on, r, uni)
    b = ttrace._bounce(off, r, uni)
    for k in a:
        va = a[k] if isinstance(a[k], tuple) else (a[k],)
        vb = b[k] if isinstance(b[k], tuple) else (b[k],)
        for x, y in zip(va, vb):
            assert torch.equal(x, y), k
    return a


def test_cull_keeps_triangle_keys_at_dynamic_range():
    # tests/test_mesh.py's hostile mesh: 600 small triangles on a shell
    # 1000 away, axis-parallel rays from just past the widened x-extent
    # aimed at edge midpoints, plus rays grazing the cluster.
    rng = np.random.default_rng(5)
    scene, tris = _probe_box_cull().build_tri_scene(rng)
    ts = to_port(scene)
    on, off = ttrace.pack_scene(ts), ttrace.pack_scene(ts, cull=False)
    assert on.tri_rule == "2l" and on.tri_bounds is not None
    bnd = on.tri_bounds.numpy()
    x0 = np.float32(bnd[bnd[:, 7] > 0.5, 3].max() + 2.0e-4)
    vmax = tris.max(axis=1)[:, 0]
    order = np.argsort(-vmax)
    dirs = []
    for i in range(1024):
        a3, b3, c3 = tris[order[i % 16]]
        mid = 0.5 * (a3 if i % 3 else b3) + 0.5 * c3
        aim = mid + rng.normal(size=3) * 5.0e-3
        dyz = aim[1:] / np.linalg.norm(aim[1:])
        dirs.append([0.0, dyz[0], dyz[1]])
    d1 = np.asarray(dirs, np.float32)
    o1 = np.tile(np.float32([x0, 0.0, 0.0]), (1024, 1))
    aim2 = np.array([0.0, 0.0, 1000.0]) + rng.normal(size=(1024, 3)) * 0.45
    d2 = (aim2 / np.linalg.norm(aim2, axis=1, keepdims=True)).astype(np.float32)
    o = np.concatenate([o1, np.zeros((1024, 3), np.float32)])
    d = np.concatenate([d1, d2])
    r = _rays_t(np.concatenate([o.T, d.T]))
    tally = ttrace.SweepTally()
    k_on, _ = ttrace.tri_stage1(on, r, tally=tally)
    k_off, _ = ttrace.tri_stage1(off, r)
    assert torch.equal(k_on, k_off)
    out = _bounce_equal(on, off, r, _uniforms(2048, 1))
    assert out["hitm"].any() and tally.tri_passes > 0


def test_cull_hint_keeps_bounces_behind_an_occluder():
    # tests/test_mesh.py's occluder case: a metal sphere in front of a
    # 1,280-triangle mesh; the sphere winner's t (the hint) lets lanes that
    # hit it skip every mesh block, and the bounce stays the same bits.
    verts, faces = jmesh.make_icosphere(3)
    b = SceneBuilder()
    b.add_mesh(verts * 0.9 + np.float32([0.0, 0.0, -4.0]), faces,
               albedo=(0.8, 0.8, 0.9), kind=MaterialKind.METALLIC, fuzz=0.0)
    b.add_metallic_sphere((0.0, 0.0, -2.0), 0.55, (0.9, 0.9, 0.9), 0.0)
    ts = to_port(b.build())
    on, off = ttrace.pack_scene(ts), ttrace.pack_scene(ts, cull=False)
    rng = np.random.default_rng(31)
    d1 = np.tile(np.float32([0.0, 0.0, -1.0]), (1024, 1))
    d1[:, :2] += rng.normal(size=(1024, 2)).astype(np.float32) * 0.02
    ang = 0.55 / 2.0
    theta = ang * rng.uniform(0.85, 1.6, size=1024)
    phi = rng.uniform(0.0, 2 * np.pi, size=1024)
    d2 = np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi),
                   -np.cos(theta)], axis=1).astype(np.float32)
    d = np.concatenate([d1, d2])
    r = _rays_t(np.concatenate([np.zeros_like(d).T, d.T]))
    out = _bounce_equal(on, off, r, _uniforms(2048, 2))
    # The straight rays all hit the occluder; the wide ones part hit.
    assert out["hitm"][:1024].all() and out["hitm"][1024:].any()
    assert not out["hitm"][1024:].all()
    # With the hint, the occluded lanes reject every mesh block, and some
    # of the wide lanes pass some.
    uni = _uniforms(2048, 2)
    for part, want_passes in ((slice(0, 1024), False), (slice(1024, None), True)):
        tally = ttrace.SweepTally()
        ttrace._bounce(on, tuple(v[part] for v in r),
                       tuple(u[part] for u in uni), tally)
        assert tally.tri_votes > 0
        assert (tally.tri_passes > 0) == want_passes


def _wave(tables, params, tally=None):
    jcam = rt.derive(params)
    s, mp = slots_of(jcam, "tiled")
    cam = rtt.derive(rtt.CameraParameters(**dataclasses.asdict(params)))
    return ttrace.render_pixels_fused_reference(
        tables, cam.as_vector(), slot_base=0, map_param=mp, seed=3,
        sample_start=0, spp=1, max_depth=4, t_end=1,
        done=torch.zeros(s, dtype=torch.int32), num_slots=s, tally=tally,
    )


@pytest.mark.parametrize("name", ["stress:2048", "stress:8192", "mesh:3"])
def test_cull_on_off_waves_bit_equal(name):
    params, js = _bench(name)
    origin = rt.derive(params).center
    on, off = _port_tables(js, origin), _port_tables(js, origin, cull=False)
    tally = ttrace.SweepTally()
    r_on, s_on, d_on = _wave(on, params, tally)
    r_off, s_off, d_off = _wave(off, params)
    assert torch.equal(r_on, r_off)
    assert int(s_on) == int(s_off) and torch.equal(d_on, d_off)
    kind = "tri" if name.startswith("mesh") else "sphere"
    votes = getattr(tally, f"{kind}_votes")
    passes = getattr(tally, f"{kind}_passes")
    # The gate rejects a nonzero share of (ray, block) pairs.
    assert 0 < passes < votes


# ---------------------------------------------------------------------------
# (f) Wiring and the profile tool's bound
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["cover", "textured", "mesh:2", "mesh:3",
                                  "meshes:4", "stress:2048", "stress:8192"])
def test_renderer_tables_carry_bounds_where_jax_builds_them(name):
    params, js = _bench(name)
    jcam = rt.derive(params)
    gh, _, sh, n = ptrace.pack_scene(js)[:4]
    _, _, kflags = ptrace._aux_scene_inputs(
        js, gh, sh, n, gh.shape[0], jcam.center
    )
    tparams = rtt.CameraParameters(**dataclasses.asdict(params))
    tables = rtt.Renderer(to_port(js), tparams, device="cpu")._tables
    assert (tables.sph_bounds is not None) == bool(kflags["sph_cull"])
    assert (tables.tri_bounds is not None) == bool(kflags["tri_cull"])
    assert (tables.sph_order is not None) == bool(kflags["sph_cull"])
    if name in ("cover", "mesh:2"):
        assert tables.sph_bounds is None and tables.tri_bounds is None
    want_rule = "2l" if gh.shape[0] >= 8192 else "flat"
    assert tables.sphere_rule == want_rule
    assert ("_sph2l" in ttrace.kernel_variant(tables)) == (want_rule == "2l")


def test_wrapper_rejects_bad_bound_tables():
    params, js = _bench("stress:2048")
    tables = _port_tables(js, rt.derive(params).center)
    s, mp = slots_of(rt.derive(params), "tiled")
    meta = dict(slot_base=0, map_param=mp, seed=0, sample_start=0, spp=1,
                max_depth=2, t_end=1, num_slots=s,
                done=torch.zeros(s, dtype=torch.int32))
    cam = torch.zeros(20, dtype=torch.float32)
    for bad in (
        dict(sph_order=None),
        dict(sph_bounds=tables.sph_bounds[:, :7].contiguous()),
        dict(sph_order=tables.sph_order.long()),
        dict(sph_bounds=tables.sph_bounds[:2].contiguous()),
        dict(tri_order=tables.sph_order, tri_bounds=tables.sph_bounds),
        # Contiguous but 4 bytes off the 16-byte rows the kernel loads.
        dict(sph_bounds=torch.cat([torch.zeros(1), tables.sph_bounds.view(-1)])
             [1:].view(-1, 8)),
    ):
        with pytest.raises((TypeError, ValueError)):
            ttrace.render_pixels_fused(dataclasses.replace(tables, **bad),
                                       cam, **meta)


def test_profile_bound_counts_gate_passes():
    # With bound tables the bound's sweep pairs are the plain version's
    # per-ray gate passes on the same wave; without a tally such tables get
    # no bound; an unculled table counts every real row (the two-level
    # rule's stage 2 is folded into stage 1: no window of its own).
    params, js = _bench("stress:8192")
    origin = rt.derive(params).center
    on, off = _port_tables(js, origin), _port_tables(js, origin, cull=False)
    tally = ttrace.SweepTally()
    _, seg, _ = _wave(on, params, tally)
    seg = int(seg)
    s = slots_of(rt.derive(params), "tiled")[0]
    b = pr.bound(on, seg, s, tally)
    assert b["fp32_ops"] == seg * pr.SEGMENT_OPS + (
        tally.sphere_pairs * pr.SPHERE_PAIR_OPS
    )
    assert pr.bound(on, seg, s)["bound_ms"] is None
    full = pr.bound(off, seg, s)
    rows = on.n_actual
    assert full["fp32_ops"] == seg * (
        pr.SEGMENT_OPS + rows * pr.SPHERE_PAIR_OPS
    )
    # The gate's passes sweep far fewer pairs: a lower floor.
    assert 0 < tally.sphere_pairs < seg * rows
    assert b["bound_ms"] < full["bound_ms"]
    # The unculled plain version's tally gives the unculled count.
    t_off = ttrace.SweepTally()
    _wave(off, params, t_off)
    assert t_off.sphere_pairs == seg * rows
