"""The megakernel's triangle sweep, as redesigned for Hopper
(``csrc/regen.cu``: ``key_rcp``, ``tri_sweep``, ``tri_winner``), held on
the CPU against the plain version and the JAX package:

* the key's reciprocal (``rcp.approx`` and one Newton step by explicit
  multiply-adds), modelled exactly in numpy, is the IEEE ``1 / b`` on every
  bfloat16 value the key can receive below 2^126, for every approximation
  within 1 ulp; the values from 2^126 on are the ones it sends to the
  IEEE re-sweep;
* stage 2 folded into stage 1 (the winning window's row-id key min kept
  beside the packed window key) equals ``_tri_winner``'s two stages,
  also on adversarial keys and when the hint culled the only hit. The
  kernel does not fold (it measured slower: a warp re-sweeps window 0
  whenever one of its lanes missed the mesh with window 0 gated out, and
  the extra min costs every stage-1 row; PERF.md); the model keeps the
  proof for the culled sweep's next redesign;
* padding rows never give a valid key, and the sweep may stop at the real
  rows;
* the plain version still matches the JAX package on a mesh whose real
  rows end inside a window;
* the SASS loop finder and the per-warp divergence count of the tools.

The kernel itself is held against the plain version on a card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import raytracing_tpu as rt  # noqa: E402

from raytracing_tpu_torch.ops import sweep_root as tsr  # noqa: E402
from raytracing_tpu_torch.ops import trace as ttrace  # noqa: E402
from raytracing_tpu_torch.tools import probe_sweep, profile_render  # noqa: E402

from torch_port_helpers import (  # noqa: E402
    close_share, to_port, trace_jax, trace_port,
)

WIN = ttrace.WIN
BIG = int(np.array(np.float32(3.0e38)).view(np.int32))


def _inside_values():
    bits = np.arange(tsr.RCP_FIRST, tsr.RCP_FAST_END, dtype=np.int32)
    return (bits << 16).view(np.float32)


@pytest.mark.parametrize("ulps", [-1, 0, 1])
def test_key_rcp_newton_step_is_ieee_on_every_input(ulps):
    # rcp.approx is within 1 ulp of 1/b: whichever float it returns there,
    # one Newton step gives the correctly rounded reciprocal, which is
    # what np.float32(1) / b and the plain version's bf16_reciprocal give.
    b = _inside_values()
    ieee = np.float32(1) / b
    y = (ieee.view(np.int32) + ulps).view(np.float32)
    got = tsr.newton_model(b, y)
    np.testing.assert_array_equal(got.view(np.int32), ieee.view(np.int32))
    plain = ttrace.bf16_reciprocal(torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(plain.view(np.int32), ieee.view(np.int32))


def test_key_rcp_range_and_plain_version():
    # Every bfloat16 pattern from bf16(1e-30) to +inf: the plain version is
    # the IEEE reciprocal, and the outside set is exactly b >= 2^126.
    assert np.float32(1e-30).view(np.int32) >> 16 == tsr.RCP_FIRST
    assert np.float32(np.inf).view(np.int32) >> 16 == tsr.RCP_LAST
    assert (np.float32(2.0 ** 126).view(np.int32) >> 16) == tsr.RCP_FAST_END
    n = tsr.RCP_LAST + 1 - tsr.RCP_FIRST
    rcp, outside = tsr.key_rcp(tsr.RCP_FIRST, n, "cpu")
    b = tsr.bf16_values(tsr.RCP_FIRST, n, "cpu")
    assert torch.equal(rcp.view(torch.int32), (1.0 / b).view(torch.int32))
    assert torch.equal(outside, b >= 2.0 ** 126)
    assert int(outside.sum()) == tsr.RCP_LAST + 1 - tsr.RCP_FAST_END
    # Below 2^126 the reciprocal is a normal float above the least one;
    # from 2^126 on it is that one (1 / 2^126), a subnormal or 0.
    tiny = torch.finfo(torch.float32).tiny
    assert bool((rcp[~outside] > tiny).all())
    assert bool((rcp[outside] <= tiny).all())
    r = tsr.check_key_rcp("cpu")
    assert (r["values"], r["rcp_mismatches"], r["range_mismatches"]) == \
        (n, 0, 0)
    for first, count in ((-1, 4), (0xFFFF, 2), (0, 0)):
        with pytest.raises(ValueError):
            tsr.key_rcp(first, count, "cpu")
    with pytest.raises(TypeError):
        tsr.key_rcp(0, 4)


# ---------------------------------------------------------------------------
# Stage 2 folded into stage 1
# ---------------------------------------------------------------------------


def _two_stages(keys, swept, mask):
    """_tri_winner's two-level rule on key bits [R, m_pad]: stage 1 over
    the swept windows, stage 2 over every row of the winning window."""
    r, m_pad = keys.shape
    n_win = m_pad // WIN
    wmin = keys.reshape(r, n_win, WIN).min(axis=2)
    packed = (wmin & ~mask) | np.arange(n_win)
    packed = np.where(swept, packed, np.iinfo(np.int32).max)
    kwin = np.minimum(BIG & ~mask, packed.min(axis=1))
    win = kwin & mask
    rows = keys[np.arange(r)[:, None], win[:, None] * WIN + np.arange(WIN)]
    k2 = np.minimum(BIG & ~(WIN - 1),
                    ((rows & ~(WIN - 1)) | np.arange(WIN)).min(axis=1))
    return kwin, k2


def _folded(keys, swept, mask, order, m_actual):
    """The fold: windows in visit order, each swept
    window's real rows giving its bare min and its row-id min, kept when
    its packed key is at or below kwin; window 0 again when no swept
    window set kwin."""
    m_real = (m_actual + 3) & ~3
    kwins, k2s = [], []
    for ray in range(keys.shape[0]):
        kwin, k2 = BIG & ~mask, -1
        for w in order:
            n = min(WIN, m_real - w * WIN)
            if not swept[ray, w] or n <= 0:
                continue
            rows = keys[ray, w * WIN:w * WIN + n]
            wmin = min(BIG, int(rows.min()))
            w2 = min(BIG & ~(WIN - 1),
                     int(((rows & ~(WIN - 1)) | np.arange(n)).min()))
            pk = (wmin & ~mask) | w
            if pk <= kwin:
                kwin, k2 = pk, w2
        if k2 < 0:
            n = min(WIN, m_real)
            rows = keys[ray, :n]
            k2 = min(BIG & ~(WIN - 1),
                     int(((rows & ~(WIN - 1)) | np.arange(n)).min()))
        kwins.append(kwin)
        k2s.append(k2)
    return np.array(kwins), np.array(k2s)


def _key_case(case: str, rng, r: int, m_pad: int, m_actual: int):
    """Key bits [r, m_pad] (padding rows the miss) and the swept windows."""
    n_win = m_pad // WIN
    hit = rng.random((r, m_pad)) < 0.05
    t = rng.uniform(0.5, 20.0, (r, m_pad)).astype(np.float32)
    keys = np.where(hit, t.view(np.int32), BIG)
    swept = np.ones((r, n_win), bool)
    if case == "truncated_within":
        # Keys whose bits differ in the low 7 bits only, in one window:
        # stage 2's row ids decide among them.
        base = np.float32(3.0).view(np.int32) & ~(WIN - 1)
        keys[:, 5:9] = base | rng.integers(0, WIN, (r, 4))
    elif case == "truncated_across":
        # The same truncated key in every window: the window ids decide.
        base = np.float32(3.0).view(np.int32)
        for w in range(n_win):
            keys[:, w * WIN + 17] = base + rng.integers(0, 8, r)
    elif case == "no_hit":
        keys[:] = BIG
    elif case == "culled_window0_hit":
        # The only hit lies in window 0, which the gate (the hint) culled.
        keys[:] = BIG
        keys[:, 3] = np.float32(7.0).view(np.int32)
        swept[:, 0] = False
    elif case == "culled_random":
        swept = rng.random((r, n_win)) < 0.5
    keys[:, m_actual:] = BIG
    return keys.astype(np.int32), swept


CASES = ["random", "truncated_within", "truncated_across", "no_hit",
         "culled_window0_hit", "culled_random"]


@pytest.mark.parametrize("m_pad, m_actual", [(512, 320), (2048, 1280),
                                             (256, 129)])
@pytest.mark.parametrize("case", CASES)
def test_folded_stage2_equals_two_stages(case, m_pad, m_actual):
    rng = np.random.default_rng(CASES.index(case) * 7 + m_actual)
    mask = (1 << max((m_pad // WIN - 1).bit_length(), 1)) - 1
    keys, swept = _key_case(case, rng, 96, m_pad, m_actual)
    blocks = list(range(m_pad // WIN))
    for order in (blocks, blocks[::-1], list(rng.permutation(blocks))):
        want = _two_stages(keys, swept, mask)
        got = _folded(keys, swept, mask, order, m_actual)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    if case == "culled_window0_hit":
        # Window 0 was swept again and its hit found, as stage 2 finds it.
        assert (want[1] >> 7 == np.float32(7.0).view(np.int32) >> 7).all()


def _mesh_rays(tables, scene, n=256, seed=3):
    """Rays at the mesh from a ring of origins, and axis-aligned ones."""
    rng = np.random.default_rng(seed)
    v0 = scene.tri_v0.numpy()
    tgt = v0[rng.integers(0, v0.shape[0], n)]
    org = rng.normal(0.0, 1.0, (n, 3)).astype(np.float32) * 4.0
    d = (tgt - org).astype(np.float32)
    d[: n // 8] = np.eye(3, dtype=np.float32)[np.arange(n // 8) % 3]
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in
                 (*org.T, *d.T))


@pytest.mark.parametrize("cull", [False, True], ids=["nocull", "cull"])
@pytest.mark.parametrize("hint", [None, "sphere"], ids=["nohint", "hint"])
def test_folded_stage2_on_plain_keys(monkeypatch, cull, hint):
    # A 320-triangle icosphere (512 rows; the last real window half real)
    # under the two-level rule: the fold, run on the plain version's keys
    # and its per-ray gate passes, gives _tri_winner's window and row.
    monkeypatch.setenv("RT_TWO_LEVEL_MIN", "1")
    _, js = rt.make_world_mesh(image_width=32, subdivisions=2)
    scene = to_port(js)
    tables = ttrace.pack_scene(scene, origin=(0.0, 0.0, 4.0), cull=cull)
    assert (tables.tri_rule, tables.m_pad, tables.m_actual) == ("2l", 512, 320)
    assert (tables.tri_bounds is not None) == cull
    rays = _mesh_rays(tables, scene)
    r = rays[0].shape[0]
    hint_t = (None if hint is None
              else torch.full((r,), 6.0).where(torch.arange(r) % 2 == 0,
                                                torch.tensor(3.0e38)))
    keys = ttrace._tri_keys([tables.tri[:, j] for j in range(9)],
                            *[t[:, None] for t in rays]).view(torch.int32)
    mask = (1 << 2) - 1
    blk = ttrace.tri_block_rows(tables.m_pad)
    nwb = blk // WIN
    # The plain stage 1's gate passes, block by block, as tri_stage1 runs.
    swept = np.zeros((r, tables.m_pad // WIN), bool)
    best = torch.full((r,), BIG & ~mask, dtype=torch.int32)
    a = rays[3] ** 2 + rays[4] ** 2 + rays[5] ** 2
    order = []
    for b, idx in ttrace._block_loop(
            tables.m_pad // blk, tables.tri_order, tables.tri_bounds,
            tables.cull_kind, rays, a, best, mask, scaled_key=False,
            hint=hint_t):
        sel = torch.arange(r) if idx is None else idx
        wins = list(range(b * nwb, (b + 1) * nwb))
        order += wins
        swept[sel.numpy()[:, None], np.array(wins)[None]] = True
        kw = keys[sel][:, b * blk:(b + 1) * blk].view(-1, nwb, WIN).amin(2)
        ki = (kw & ~mask) | torch.tensor(wins, dtype=torch.int32)
        best[sel] = torch.minimum(best[sel], ki.min(dim=1).values)
    order += [w for w in range(tables.m_pad // WIN) if w not in order]
    kwin, k2 = _folded(keys.numpy(), swept, mask, order, tables.m_actual)
    want_best, _ = ttrace.tri_stage1(tables, rays, hint_t)
    np.testing.assert_array_equal(kwin, want_best.numpy())
    words, hitk = ttrace._tri_winner(tables, rays, hint_t)
    row = (kwin & mask) * WIN + (k2 & (WIN - 1))
    assert torch.equal(words, tables.tri.view(torch.int32)[row, :11])
    assert np.array_equal(hitk.numpy(), k2 < (BIG & ~(WIN - 1)))
    assert hitk.any() and not hitk.all()


@pytest.mark.parametrize("rays", ["axis", "on_mesh", "random", "pad_origin"])
def test_padding_rows_never_give_a_valid_key(rays):
    _, js = rt.make_world_mesh(image_width=32, subdivisions=2)
    scene = to_port(js)
    tri, m = ttrace.pack_triangles(scene)
    pad = tri[m:]
    assert pad.shape[0] == 192 and bool((pad[:, 3:9] == 0).all())
    rng = np.random.default_rng(11)
    v0 = scene.tri_v0.numpy()
    if rays == "axis":
        d = np.repeat(np.concatenate([np.eye(3), -np.eye(3)]), 40, 0)
        o = rng.normal(0, 2, d.shape)
    elif rays == "on_mesh":
        o = (v0 + 0.25 * scene.tri_e1.numpy() + 0.25 * scene.tri_e2.numpy())
        o = np.concatenate([o, v0])
        d = rng.normal(0, 1, o.shape)
    elif rays == "random":
        o = rng.normal(0, 5, (512, 3))
        d = rng.normal(0, 1, (512, 3))
    else:  # from the padding rows' own v0, and next to it
        o = np.full((64, 3), 1.0e9) + rng.normal(0, 1, (64, 3))
        o[0] = 1.0e9
        d = rng.normal(0, 1, (64, 3))
    o, d = o.astype(np.float32), d.astype(np.float32)
    ray = [torch.from_numpy(np.ascontiguousarray(c))[:, None]
           for c in (*o.T, *d.T)]
    keys = ttrace._tri_keys([pad[:, j] for j in range(9)], *ray)
    assert bool((keys == 3.0e38).all())
    # The real rows are hit somewhere, so the rays are not all misses.
    if rays in ("on_mesh", "random"):
        real = ttrace._tri_keys([tri[:m, j] for j in range(9)], *ray)
        assert bool((real < 3.0e38).any())


@pytest.mark.parametrize("rule", ["flat", "2l"])
def test_plain_version_matches_jax_with_a_partial_window(monkeypatch, rule):
    # 320 triangles: 512 rows, the real ones ending half way through the
    # third 128-row window (flat rule by default; the two-level rule from
    # RT_TWO_LEVEL_MIN=1 in both packages).
    if rule == "2l":
        monkeypatch.setenv("RT_TWO_LEVEL_MIN", "1")
    params, js = rt.make_world_mesh(image_width=32, subdivisions=2)
    tables = ttrace.pack_scene(to_port(js))
    assert (tables.m_pad, tables.m_actual, tables.tri_rule) == (512, 320, rule)
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
    rad_t, seg_t = trace_port(js, o, d, depth=3, seed=3)
    assert seg_t == seg_j
    assert close_share(rad_t, rad_j) == 1.0


# ---------------------------------------------------------------------------
# The tools
# ---------------------------------------------------------------------------


def _listing(body: list[str]) -> list[tuple[int, str]]:
    return [(16 * k, t) for k, t in enumerate(body)]


def test_tri_loop_finder():
    row = ["LDG.E.128 R4, [R2.64]", "FMUL R1, R2, R3", "F2F.BF16.F32 R5, R6",
           "MUFU.RCP R7, R5", "FFMA R8, -R5, R7, 1", "VIMNMX R9, R9, R8, PT"]
    four = ["NOP"] + row * 4 + ["ISETP.GE.AND P0, PT, R1, R2, PT",
                                "BRA `(.L_x_0)"]
    insns = _listing(four)
    insns[-1] = (insns[-1][0], "BRA 0x0")
    slow = _listing(["LDG.E R1, [R2.64]", "MUFU.RCP R7, R5", "BSSY B0, 0x500",
                     "CALL.REL.NOINC 0x900", "BSYNC B0", "BRA 0x0"])
    slow = [(a + 0x400, t.replace("BRA 0x0", "BRA 0x400")) for a, t in slow]
    radix = _listing(["SHFL.IDX R1, R2, R3, R4", "LDG.E R1, [R2.64]",
                      "MUFU.RCP R7, R5", "BRA 0x0"])
    radix = [(a + 0x800, t.replace("BRA 0x0", "BRA 0x800")) for a, t in radix]
    loops = probe_sweep.tri_loops(insns + slow + radix)
    assert [lp["rows_per_trip"] for lp in loops] == [4, 1]
    main, redo = loops
    assert main["instructions_per_row"] == (len(four) - 1) / 4
    assert main["opcodes_per_row"]["LDG.128"] == 1
    assert main["memory"] == "global" and not main["branches_out"]
    assert redo["branches_out"]
    line = probe_sweep.describe_tri_sass("k", {"loops": loops})
    assert "2 triangle loop(s)" in line and "branches out" in line


def test_divergence_count_by_warp():
    # The plain version's gate tally grouped by warp: a warp of one lane
    # is the lane itself; with 32 lanes the union covers every pass, and
    # the lane tallies do not move.
    one = profile_render.divergence("mesh:3", 32, 1, 3, device="cpu", warp=1)
    assert one["warp_passes"] == one["warp_lanes"] == one["lane_passes"] > 0
    w32 = profile_render.divergence("mesh:3", 32, 1, 3, device="cpu")
    assert (w32["votes"], w32["lane_passes"], w32["segments"]) == \
        (one["votes"], one["lane_passes"], one["segments"])
    assert w32["warp_passes"] <= w32["lane_passes"] <= w32["warp_lanes"]
    assert w32["warp_lanes"] <= 32 * w32["warp_passes"]
    assert 0.0 < w32["useful_share"] <= 1.0
    with pytest.raises(ValueError, match="no culled triangle"):
        profile_render.divergence("cover", 32, 1, 2, device="cpu")
