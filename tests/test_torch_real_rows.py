"""The staged sphere sweep stops at the real rows: proof on the CPU.

The kernel's staged body (``csrc/regen.cu``, ``staged_body``) sweeps the
sphere table's real rows rounded up to a trip of four (``n_actual``), and
per cull block the block's real rows, in place of all ``n_pad`` rows, for
every ray inside the cut's bound (``cut_ok``): ``a = |d|^2 >= 2^-126``,
``o.o <= 1e26`` and the pad rows' centre within 1e13 on every axis. Other
rays sweep every row. ``ops/trace.py::staged_sweep_rows`` is that rule.

A pad row repeats the last sphere's centre with ``cm2 = 1e30`` and radius
0. Its key is the miss unless its discriminant ``h*h - a*cq`` reaches 0.
Here the plain keys (``ops/trace.py::_sphere_key``, the kernel's
arithmetic with no multiply-add) find where that can happen:

* origins from 2e18 on (rays aimed at the pad centre; none below 1e18),
  where ``o.o`` rounds away more than the 1e30 of ``cq``;
* a pad centre past 1e15 (``|c|^2 > 1e30``: the pad rows are then a
  sphere of radius ``sqrt(|c|^2 - 1e30)``, and win rays aimed at it; the
  first step that wins is 2e15);
* ``a`` that rounds to 0 (``|d|`` below about 2^-75 on every axis), where
  the discriminant is ``h*h``: in a table with real rows the pad key equals
  the last real row's and loses on its row id; in a table of pad rows only
  it wins.

The bound sits five orders of magnitude inside the first two and excludes
the third, and every key inside it is the miss on the seeded sets below.
So rays inside it take the full sweep's winner from the real rows, and the
rays past it keep their bits by sweeping every row. The port's plain
versions (which sweep every row, as the JAX package does) are held against
the JAX package on such rays, with XLA-CPU's FMA off as in
``tests/test_torch_rays.py``: radiance within atol 2e-4 / rtol 1e-3,
segments equal. The card holds the kernel bit for bit against them
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch.ops import trace as ttrace  # noqa: E402
from raytracing_tpu_torch.tools import sweep_edges  # noqa: E402

from torch_port_helpers import (  # noqa: E402
    COVER, close_share, golden_scene_jax, phantom_params,
    phantom_scene_jax, render_port, sphereless_scene_jax, to_port,
    trace_jax_without_fma, trace_port, wave_jax_without_fma,
)

_MISS = ttrace._BIGF
_INT_MAX = np.iinfo(np.int32).max


def _seeded_spheres(n: int, seed: int = 0):
    """``n`` spheres of every material in a 40-unit box, seeded."""
    rng = np.random.default_rng(seed)
    b = rtt.SceneBuilder()
    for _ in range(n):
        c = tuple(float(v) for v in rng.uniform(-20.0, 20.0, 3))
        r = float(rng.uniform(0.2, 2.0))
        u = rng.uniform()
        if u < 0.5:
            b.add_lambertian_sphere(c, r, tuple(rng.uniform(0, 1, 3)))
        elif u < 0.8:
            b.add_metallic_sphere(c, r, tuple(rng.uniform(0.5, 1, 3)), 0.1)
        else:
            b.add_dielectric_sphere(c, r, 1.5)
    return b.build()


def _scene(name: str):
    if name.startswith("spheres:"):
        return _seeded_spheres(int(name.split(":")[1]))
    if name == "cover":
        return rtt.load_and_build(COVER)[1]
    if name == "textured":
        return rtt.make_world_textured(image_width=64)[1]
    if name == "golden":
        return to_port(golden_scene_jax())
    if name == "mesh:3":
        return rtt.make_world_mesh(image_width=64, subdivisions=3)[1]
    raise ValueError(name)


TABLES = ["spheres:1", "spheres:3", "spheres:5", "spheres:127",
          "spheres:128", "cover", "spheres:1000", "textured", "golden",
          "mesh:3"]


def _rays(seed: int = 0):
    """The sweep-edge rays, seeded rays about the scenes, and rays out to
    the bound's edges (origins up to 1e13 per axis, a from 2^-126): numpy
    float32 origins and directions [n, 3]."""
    eo, ed, _ = sweep_edges.edge_rays(seed)
    rng = np.random.default_rng(seed + 1)
    n = 1024
    so = rng.uniform(-30.0, 30.0, (n, 3))
    sd = rng.normal(size=(n, 3))
    # Origins of magnitude 1 to 1e13 on each axis and directions of length
    # 2^-62 (a = 2^-124) to 1e15, log-uniform.
    m = 512
    bo = rng.normal(size=(m, 3))
    bo /= np.abs(bo).max(1, keepdims=True)
    bo *= 10.0 ** rng.uniform(0.0, 13.0, (m, 1))
    bd = rng.normal(size=(m, 3))
    bd /= np.linalg.norm(bd, axis=1, keepdims=True)
    bd *= 2.0 ** rng.uniform(-62.0, 50.0, (m, 1))
    o = np.concatenate([eo, so, bo]).astype(np.float32)
    d = np.concatenate([ed, sd, bd]).astype(np.float32)
    return o, d


def _cols(o, d):
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    return o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2]


def _packed_keys(tables, o, d):
    """The flat rule's packed keys of every (ray, row) pair, int32
    [rays, n_pad], and the miss key with row id 0 (the sweep's start)."""
    n_pad = tables.n_pad
    mask = (1 << ttrace._pack_bits(n_pad)) - 1
    gh, gc = tables.geom_h, tables.geom_c
    c = (gh[:, 0], gh[:, 1], gh[:, 2], gc[:, 0], gc[:, 1], gc[:, 2],
         gc[:, 3])
    terms = ttrace._sphere_ray_terms(_cols(o, d))
    key = ttrace._sphere_key(c, [t[:, None] for t in terms])
    ids = torch.arange(n_pad, dtype=torch.int32)
    return (key.view(torch.int32) & ~mask) | ids, ttrace._BIGF_BITS & ~mask


def _sweep(keys, start, rows):
    """The packed-key min from ``start`` over each ray's first ``rows``."""
    ids = torch.arange(keys.shape[1])
    inside = ids[None, :] < torch.as_tensor(rows).reshape(-1, 1)
    swept = torch.where(inside, keys, _INT_MAX).amin(dim=1)
    return torch.clamp(swept, max=start)


def _pad_keys(center, o, d):
    """The plain keys of a pad row at ``center`` (cm2 = 1e30) [rays]."""
    cx, cy, cz = (torch.tensor(v, dtype=torch.float32) for v in center)
    c = (cx, cy, cz, -2.0 * cx, -2.0 * cy, -2.0 * cz,
         torch.tensor(1.0e30, dtype=torch.float32))
    return ttrace._sphere_key(c, ttrace._sphere_ray_terms(_cols(o, d)))


@pytest.mark.parametrize("name", TABLES)
def test_real_rows_give_the_full_sweeps_winners(name):
    # Every ray: the sweep over its staged_sweep_rows rows (the real rows
    # rounded up to four inside the bound) gives the full sweep's packed
    # key, hence its winner; inside the bound the real rows alone do.
    tables = ttrace.pack_scene(_scene(name), cull=False)
    assert tables.n_pad <= 1024 and tables.sphere_rule == "flat"
    o, d = _rays()
    keys, start = _packed_keys(tables, o, d)
    full = _sweep(keys, start, tables.n_pad)
    rows = ttrace.staged_sweep_rows(tables, _cols(o, d))
    real = (tables.n_actual + 3) & ~3
    assert torch.equal(_sweep(keys, start, rows), full)
    inside = rows == real
    # Only the edge set's tiny, huge and overflowing rays lie outside.
    assert int((~inside).sum()) <= 80
    assert torch.equal(_sweep(keys, start, real)[inside], full[inside])
    # Per cull block of 512 rows (the 1,024-row table), in either visit
    # order: each block's real rows (none past the real ones) give the
    # same minimum.
    if tables.n_pad == 1024:
        got = torch.full_like(full, start)
        for b0 in (512, 0):
            n = torch.clamp(rows - b0, 0, 512)
            got = torch.minimum(got, _sweep(keys[:, b0:b0 + 512], start, n))
        assert torch.equal(got, full)


def test_pad_rows_miss_inside_the_bound():
    # Seeded pad centres within 1e13 per axis, origins with o.o <= 1e26 and
    # directions with a from 2^-126: every pad key is the miss.
    rng = np.random.default_rng(3)
    n = 4096
    for scale in (1.0, 1.0e6, 1.0e13):
        center = tuple(float(v) for v in rng.uniform(-scale, scale, 3))
        o = rng.normal(size=(n, 3))
        o *= 10.0 ** rng.uniform(-3.0, 13.0, (n, 1)) / np.linalg.norm(
            o, axis=1, keepdims=True)
        o = o.astype(np.float32)
        d = sweep_edges.aimed(center, o, rng, 1e-4)
        d = (d * 2.0 ** rng.uniform(-62.0, 60.0, (n, 1))).astype(np.float32)
        cols = _cols(o, d)
        ok = ((cols[3] * cols[3] + cols[4] * cols[4] + cols[5] * cols[5]
               >= ttrace.CUT_MIN_A)
              & (cols[0] * cols[0] + cols[1] * cols[1] + cols[2] * cols[2]
                 <= ttrace.CUT_MAX_ODO))
        assert int(ok.sum()) >= n * 9 // 10
        assert (_pad_keys(center, o, d)[ok] == _MISS).all()


def _first_win(values, keys_at):
    """The first of ``values`` at which some pad key falls below the miss."""
    for v in values:
        if bool((keys_at(v) < _MISS).any()):
            return v
    return None


def test_where_a_pad_row_wins():
    rng = np.random.default_rng(5)
    steps = [m * 10.0 ** e for e in range(12, 20) for m in (1, 2, 5)]
    center = (0.5, -1.5, 2.0)

    def far_origins(r):
        u = rng.normal(size=(4096, 3))
        o = (u / np.linalg.norm(u, axis=1, keepdims=True) * r)
        o = o.astype(np.float32)
        return _pad_keys(center, o, sweep_edges.aimed(center, o, rng, 1e-7))

    origin_at = _first_win(steps, far_origins)
    assert origin_at == 2.0e18
    assert origin_at ** 2 > 1e10 * ttrace.CUT_MAX_ODO

    def far_centre(m):
        c = tuple(m * v for v in (0.6, 0.48, 0.64))
        o = rng.uniform(-10.0, 10.0, (4096, 3)).astype(np.float32)
        return _pad_keys(c, o, sweep_edges.aimed(c, o, rng, 0.3))

    # |c| = 1e15 puts |c|^2 at the 1e30 of cm2: the first win is the next
    # step.
    centre_at = _first_win(steps, far_centre)
    assert centre_at == 2.0e15
    assert centre_at > 1e2 * ttrace.CUT_MAX_PAD_C * 3 ** 0.5

    # a = 0: directions of 1e-25 per axis; the pad key is 2h, below the miss.
    d = np.full((8, 3), 1.0e-25, np.float32)
    o = np.zeros((8, 3), np.float32)
    cols = _cols(o, d)
    assert (cols[3] * cols[3] + cols[4] * cols[4] + cols[5] * cols[5]
            == 0).all()
    assert (_pad_keys((1.0e9,) * 3, o, d) < _MISS).all()


def test_cut_keeps_bits_past_the_bound():
    # Where a pad row wins, the real rows alone would give another winner;
    # staged_sweep_rows sends those rays through every row.
    rng = np.random.default_rng(7)
    cases = []
    # The phantom scene: its pad centre lies past 1e13.
    phantom = ttrace.pack_scene(to_port(phantom_scene_jax()), cull=False)
    o = rng.uniform(-1.0, 1.0, (2048, 3)).astype(np.float32)
    d = sweep_edges.aimed(sweep_edges.PHANTOM_CENTER, o, rng, 0.3)
    cases.append((phantom, o, d))
    # A table of pad rows only, rays with a = 0 toward its centre.
    empty = ttrace.pack_scene(to_port(sphereless_scene_jax()), cull=False)
    assert empty.n_actual == 0
    d = (np.abs(rng.normal(size=(1024, 3))) * 1.0e-25).astype(np.float32)
    cases.append((empty, np.zeros((1024, 3), np.float32), d))
    for tables, o, d in cases:
        keys, start = _packed_keys(tables, o, d)
        full = _sweep(keys, start, tables.n_pad)
        naive = _sweep(keys, start, (tables.n_actual + 3) & ~3)
        assert int((naive != full).sum()) >= 100
        rows = ttrace.staged_sweep_rows(tables, _cols(o, d))
        assert (rows == tables.n_pad).all()
        assert torch.equal(_sweep(keys, start, rows), full)


def _agree(rad_t, rad_j) -> bool:
    """Every ray within atol 2e-4 / rtol 1e-3, NaN where the other is NaN
    (a ray of a = 0 that hits divides by a)."""
    return bool((np.isnan(rad_t) == np.isnan(rad_j)).all()
                and np.isclose(rad_t, rad_j, atol=2e-4, rtol=1e-3,
                               equal_nan=True).all())


def test_trace_past_the_bound_matches_jax_without_fma(tmp_path):
    o, d = sweep_edges.past_the_bound_rays()
    tables = ttrace.pack_scene(to_port(phantom_scene_jax()), cull=False)
    rows = ttrace.staged_sweep_rows(tables, _cols(o, d))
    assert (rows == tables.n_pad).all()
    rad_j, seg_j = trace_jax_without_fma(
        tmp_path, "h.phantom_scene_jax()", o, d, depth=3, seed=5,
    )
    rad_t, seg_t = trace_port(phantom_scene_jax(), o, d, depth=3, seed=5)
    assert seg_t == seg_j
    assert _agree(rad_t, rad_j)
    assert np.isfinite(rad_t[:256]).all()


def test_sphereless_a_zero_rays_match_jax_without_fma(tmp_path):
    rng = np.random.default_rng(11)
    d = (rng.normal(size=(1024, 3)) * 1.0e-25).astype(np.float32)
    d[512:] = rng.normal(size=(512, 3)).astype(np.float32)
    o = np.zeros_like(d)
    rad_j, seg_j = trace_jax_without_fma(
        tmp_path, "h.sphereless_scene_jax()", o, d, depth=3, seed=5,
    )
    rad_t, seg_t = trace_port(sphereless_scene_jax(), o, d, depth=3, seed=5)
    assert seg_t == seg_j
    assert _agree(rad_t, rad_j)


def test_regen_past_the_bound_matches_jax_without_fma(tmp_path):
    params = phantom_params(max_depth=3)
    rad_j, seg_j = wave_jax_without_fma(
        tmp_path, "(h.phantom_params(max_depth=3), h.phantom_scene_jax())",
        width=64, spp=1, depth=3, seed=0,
    )
    rad_t, seg_t, done_t = render_port(phantom_scene_jax(), params, spp=1,
                                       depth=3, seed=0)
    assert seg_t == seg_j
    assert close_share(rad_t, rad_j) == 1.0
    assert (done_t == 1).all()
