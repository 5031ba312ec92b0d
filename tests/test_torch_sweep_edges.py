"""Port vs JAX package: caller rays at the sphere key's edge cases.

The sweep's miss select (``csrc/regen_core.cuh``, ``sphere_key``) takes
the root of the discriminant only where it is >= 0 and keeps every other
pair's key at the miss key, where the root of the raw discriminant was
NaN. These rays (``raytracing_tpu_torch/tools/sweep_edges.py``) put the
discriminant at +0, at positive and negative denormals, at -inf and NaN
(origins at 1e20) and through the pad rows (cm2 = 1e30), on a scene of
three spheres with small-integer coordinates. The kernel holds them bit
for bit against the plain version on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``); here the plain version (the CPU path of
``trace_rays_fused``) is held against the JAX package's
``trace_rays_fused`` in TPU-interpret mode, in a process whose XLA-CPU
target has no FMA (a contracted ``h*h - a*cq`` would not be +0 at a
tangent). Tolerance: radiance within atol 2e-4 / rtol 1e-3, segments
equal, as in ``tests/test_torch_rays.py``.

Denormal discriminants are a class of difference of their own: XLA-CPU
flushes denormal results to zero (as the TPU's float32 does), the port and
the card keep them. At depth 1 (a miss leaves the sky's radiance, a hit
none) a positive denormal is a hit in both; a negative one is -0.0 in the
JAX package, whose root is -0.0 (a hit), and NaN in the port (a miss).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raytracing_tpu_torch.ops import trace as ttrace  # noqa: E402
from raytracing_tpu_torch.tools import sweep_edges  # noqa: E402

from torch_port_helpers import (  # noqa: E402
    close_share, sweep_edge_scene_jax, to_port, trace_jax,
    trace_jax_without_fma, trace_port,
)

_TINY = np.finfo(np.float32).tiny
_SEED = 11


def _batch(keep, seed=_SEED):
    """The edge rays of the kinds ``keep`` selects (by kind and the sign of
    the grazed sphere's discriminant), padded to 1,024 with seeded rays;
    with the discriminants of every kept ray."""
    o, d, kinds = sweep_edges.edge_rays(seed, n=2 * sweep_edges.RAYS)
    delta = sweep_edges.deltas(o, d)
    rows = [i for kind, a, b in kinds if kind != "seeded"
            for i in range(a, b) if keep(kind, delta[i])]
    n = sweep_edges.RAYS - len(rows)
    fill = [i for kind, a, b in kinds if kind == "seeded"
            for i in range(a, b)][:n]
    idx = np.array(rows + fill)
    return o[idx], d[idx], delta[idx], len(rows)


def _denormal(delta):
    return bool(((np.abs(delta) < _TINY) & (delta != 0)).any())


def test_edge_rays_reach_every_case():
    # The batch puts the discriminant where the two root forms could part.
    o, d, kinds = sweep_edges.edge_rays(_SEED)
    assert len(o) == sweep_edges.RAYS and o.dtype == np.float32
    delta = sweep_edges.deltas(o, d)
    by = {k: np.concatenate([delta[a:b] for k2, a, b in kinds if k2 == k])
          for k, _, _ in kinds}
    assert (by["tangent"] == 0).sum() == len(by["tangent"])
    den = by["denormal"][np.abs(by["denormal"]) < _TINY]
    assert (den > 0).sum() >= 12 and (den < 0).sum() >= 12
    assert np.isnan(by["overflow"]).any()
    assert np.isneginf(by["overflow"]).any()
    # -0.0 cannot arise: h*h is never -0.0.
    assert not ((delta == 0) & np.signbit(delta)).any()


def test_edge_scene_packs_pad_rows_at_the_last_centre():
    # The pad rows the "pad" rays run through: the Morton-last sphere's
    # centre with cm2 = 1e30, in a staged table of 128 rows.
    tables = ttrace.pack_scene(to_port(sweep_edge_scene_jax()), cull=False)
    assert tables.n_pad == 128 and tables.sphere_rule == "flat"
    gh, gc = tables.geom_h.numpy(), tables.geom_c.numpy()
    n = len(sweep_edges.SPHERES)
    assert (gc[n:, 3] == np.float32(1e30)).all()
    assert (gh[n:, :3] == gh[n - 1, :3]).all()


def test_edge_rays_match_jax_without_fma(tmp_path):
    # Every kind but the denormal discriminants, depth 3: equal segments,
    # every ray within tolerance.
    o, d, _, _ = _batch(lambda kind, delta: kind != "denormal")
    rad_j, seg_j = trace_jax_without_fma(
        tmp_path, "h.sweep_edge_scene_jax()", o, d, depth=3, seed=5,
    )
    rad_t, seg_t = trace_port(sweep_edge_scene_jax(), o, d, depth=3, seed=5)
    assert seg_t == seg_j
    assert np.isfinite(rad_t).all()
    assert close_share(rad_t, rad_j) == 1.0


def test_denormal_discriminants_against_jax_without_fma(tmp_path):
    # Depth 1: radiance is the sky's on a miss and zero on a hit. Positive
    # denormals hit in both packages; negative ones hit in the JAX package
    # (flushed to -0.0) and miss in the port (NaN root), as on the card.
    o, d, delta, n = _batch(lambda kind, dl: kind == "denormal"
                            and _denormal(dl))
    rad_j, seg_j = trace_jax_without_fma(
        tmp_path, "h.sweep_edge_scene_jax()", o, d, depth=1, seed=5,
    )
    rad_t, seg_t = trace_port(sweep_edge_scene_jax(), o, d, depth=1, seed=5)
    assert seg_t == seg_j == len(o)
    grazed = np.where(np.abs(delta[:n]) < _TINY, delta[:n], np.nan)
    pos = np.nanmax(grazed, axis=1) > 0
    neg = ~pos
    assert pos.sum() >= 12 and neg.sum() >= 12
    hit_t = (rad_t[:n] == 0).all(axis=1)
    hit_j = (rad_j[:n] == 0).all(axis=1)
    assert hit_t[pos].all() and hit_j[pos].all()
    assert not hit_t[neg].any()
    assert hit_j[neg].all()
    # The seeded rays beyond them agree within tolerance.
    assert close_share(rad_t[n:], rad_j[n:]) == 1.0


@pytest.mark.parametrize("depth", [1, 2])
def test_overflow_and_pad_rays_match_jax(depth):
    # In process, with XLA-CPU's default multiply-adds (which cannot turn
    # an infinite or NaN discriminant finite): every overflow ray misses
    # in both packages, and every ray agrees within tolerance.
    o, d, _, n = _batch(lambda kind, dl: kind in ("overflow", "pad"))
    jscene = sweep_edge_scene_jax()
    rad_j, seg_j = trace_jax(jscene, o, d, depth=depth, seed=5)
    rad_t, seg_t = trace_port(jscene, o, d, depth=depth, seed=5)
    assert seg_t == seg_j
    delta = sweep_edges.deltas(o[:n], d[:n])
    over = (np.isnan(delta) | np.isinf(delta)).any(axis=1)
    assert over.sum() == 9
    assert (rad_t[:n][over] > 0).all(axis=1).all()
    assert np.isfinite(rad_t).all()
    assert close_share(rad_t, rad_j) == 1.0


@pytest.mark.parametrize("rule", ["flat", "2l"])
def test_padded_table_sends_hits_outside_the_fast_range(rule, monkeypatch):
    # Past 1,024 rows the chunked bodies sweep the table (flat rule, or the
    # two-level rule's stage 1 and stage 2), each sweeping again with sqrtf
    # where a root fell outside fast_root's range. The card holds them bit
    # for bit against the plain version on these rays
    # (tests/test_torch_cuda.py, chip_smoke.py); here the plain version
    # shows that the rays reach that range there. The tiny camera's every
    # hit has a discriminant in [0, 2^-101): at depth 1 a hit leaves zero
    # radiance, and the hits are exactly the rays with a discriminant >= 0.
    from raytracing_tpu_torch import SceneBuilder, derive
    from raytracing_tpu_torch.ops import sweep_root

    if rule == "2l":
        monkeypatch.setenv("RT_TWO_LEVEL_MIN", "1")
    scene = sweep_edges.padded_spheres(SceneBuilder()).build()
    tables = ttrace.pack_scene(scene)
    assert tables.n_pad == sweep_edges.PADDED_ROWS > 1024
    assert tables.sphere_rule == rule and tables.sph_bounds is not None
    assert ttrace.kernel_variant(tables) == {"flat": "regen",
                                             "2l": "regen_sph2l"}[rule]
    cam = derive(sweep_edges.tiny_camera())
    w, h = cam.image_width, cam.image_height
    k = torch.arange(3 * 1024) % (w * h)
    px, py = (k % w).float(), (k // w).float()
    d = (cam.pixel00[None] + px[:, None] * cam.pixel_delta_u[None]
         + py[:, None] * cam.pixel_delta_v[None] - cam.center[None])
    o = cam.center[None].expand(len(k), 3).contiguous()
    delta = sweep_edges.deltas(o.numpy(), d.numpy())
    hit = (delta >= 0).any(axis=1)
    bits = torch.from_numpy(delta[delta >= 0]).view(torch.int32).long()
    assert hit.sum() >= 300
    assert sweep_root.outside_reference(bits).all()
    rad, seg = ttrace.trace_rays_fused(tables, o, d.contiguous(), 5, 0, 1)
    assert int(seg) == len(k)
    assert ((rad == 0).all(dim=1).numpy() == hit).all()
    # The edge rays meet their spheres in the padded table as in the
    # three-sphere one: the same depth-1 radiance.
    eo, ed, _ = sweep_edges.edge_rays(_SEED)
    eo, ed = torch.from_numpy(eo), torch.from_numpy(ed)
    small = ttrace.pack_scene(to_port(sweep_edge_scene_jax()))
    want, _ = ttrace.trace_rays_fused(small, eo, ed, 5, 0, 1)
    got, _ = ttrace.trace_rays_fused(tables, eo, ed, 5, 0, 1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bits,outside", [
    (0x00000000, True), (0x00000001, True), (0x0CFFFFFF, True),
    (0x0D000000, False), (0x3F800000, False), (0x7F7FFFFF, False),
    (0x7F800000, True), (0x7FC00000, True), (0x80000000, True),
    (0xBF800000, True),
])
def test_sweep_root_fast_range(bits, outside):
    # sqrtf's fast range, where the sweep's fast_root is sqrtf: positive
    # floats from 2^-101 to the largest; zero, denormals, infinity, NaN
    # and negatives lie outside (the sweep sweeps those rows again). The
    # roots themselves are held against torch.sqrt on the card
    # (tests/test_torch_cuda.py): on the CPU the plain version is
    # torch.sqrt.
    from raytracing_tpu_torch.ops import sweep_root

    _, out = sweep_root.sweep_root(bits, 1, "cpu")
    assert bool(out[0]) == outside
    assert bool(sweep_root.outside_reference(
        torch.tensor([bits], dtype=torch.int64))[0]) == outside


def test_sweep_root_plain_version_and_arguments():
    from raytracing_tpu_torch.ops import sweep_root

    _, out = sweep_root.sweep_root(0x3F000000, 4096, "cpu")
    assert out.shape == (4096,) and not out.any()
    # The range's two edges: one float below the first and above the last
    # lie outside, the edges inside.
    _, out = sweep_root.sweep_root(sweep_root.FAST_FIRST - 1, 2, "cpu")
    assert out.tolist() == [True, False]
    _, out = sweep_root.sweep_root(sweep_root.FAST_LAST, 2, "cpu")
    assert out.tolist() == [False, True]
    for bad in ((0, 0), (-1, 4), (1 << 32, 4)):
        with pytest.raises(ValueError):
            sweep_root.sweep_root(*bad, "cpu")
    with pytest.raises(ValueError):
        sweep_root.sweep_root(0, 4, "meta")
    with pytest.raises(TypeError):
        sweep_root.sweep_root(0, 4)  # the device has no default
    r = sweep_root.check_fast_range("cpu", sweep_root.FAST_FIRST - 64,
                                    sweep_root.FAST_FIRST + 64, chunk=32)
    assert r == dict(r, values=129, root_mismatches=0, range_mismatches=0)
