"""A bit-level model of the flat sphere sweep's lean row
(``csrc/regen_core.cuh``, ``sweep_keys``) against the row_key form it
replaced, in float32 with no contraction (numpy float32: each operation
rounds once, as the kernel built with ``-fmad=false`` does).

The row_key form takes the root of the discriminant delta where delta >= 0
and of 1.0 elsewhere, makes the key kBigF on a miss, packs every row's key
with its id and flags a sweep for the ``sqrtf`` re-sweep where the root's
argument lies outside ``fast_root``'s range. The lean row takes the root of
the raw delta, takes the minimum only where the near root lies past
T_MIN * a, and flags a sweep where the least delta's bits, read unsigned,
lie below 2^-101's: a delta in [+0, 2^-101). Either sweep, when flagged,
sweeps its rows again from the starting key with the row_key form and
``sqrtf``.

``fast_root`` is modelled as the card gives it: ``sqrtf``'s bits over its
fast range [2^-101, FLT_MAX]; NaN on every float whose bits lie at or past
+inf's (+inf, the NaNs, every negative float: ``ops/sweep_root.py::
check_unflagged_nan`` holds the kernel to that on the card); and an
arbitrary value on the rest, [+0, 2^-101), taken from ``_OUTSIDE``, since
nothing there may depend on it. Every case asserts the same final
packed-key minimum for the lean row, the row_key form on ``fast_root`` and
the row_key form on ``sqrtf`` alone. The one delta where the two forms'
keys part without a flag, -0.0 (a hit for row_key, NaN for the lean row),
cannot arise: ``test_discriminant_is_never_minus_zero``. No card or JAX
needed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raytracing_tpu_torch import SceneBuilder  # noqa: E402
from raytracing_tpu_torch.ops import sweep_root  # noqa: E402
from raytracing_tpu_torch.ops import trace as ttrace  # noqa: E402
from raytracing_tpu_torch.tools import sweep_edges  # noqa: E402

F = np.float32
BIGF = F(3.0e38)
T_MIN = F(1.0e-4)
FAST_MIN = F(2.0 ** -101)
MASK = (1 << 9) - 1  # a 512-row table's id bits
NOHIT = int(BIGF.view(np.int32)) & ~MASK
# fast_root's value outside its range where the lean row flags the sweep.
_OUTSIDE = (np.nan, 0.0, 1.0e-30, 1.0, -1.0, 3.2e38, np.inf, -np.inf)


def _ulp(x, toward):
    return np.nextafter(F(x), F(toward))


def _bits(x):
    return np.asarray(x, F).view(np.int32)


def _ubits(x):
    return _bits(x).view(np.uint32).astype(np.int64)


def _fast_range(x):
    u = _bits(x).view(np.uint32).astype(np.int64)
    return (u - sweep_root.FAST_FIRST) % (1 << 32) <= (
        sweep_root.FAST_LAST - sweep_root.FAST_FIRST)


def fast_root(x, outside):
    """The card's ``fast_root`` of float32 ``x``; ``outside`` where it is
    not determined."""
    x = np.asarray(x, F)
    with np.errstate(invalid="ignore"):
        root = np.sqrt(x)
    nan = _ubits(x) >= sweep_root.NAN_FIRST
    return np.where(_fast_range(x), root,
                    np.where(nan, F(np.nan), F(outside))).astype(F)


def _sqrt(x):
    with np.errstate(invalid="ignore"):
        return np.sqrt(np.asarray(x, F))


def _packed(key, ids):
    return (_bits(key) & ~MASK) | ids


def row_key_form(h, delta, ta, root):
    """row_key's keys (sphere_key) with the root ``root``."""
    real = delta >= 0
    sq = root(np.where(real, delta, F(1.0)).astype(F))
    with np.errstate(invalid="ignore"):
        n1, n2 = h - sq, h + sq
        nroot = np.where(n1 > ta, n1, n2)
        return np.where(real & (nroot > ta), nroot, BIGF).astype(F)


def sweep_sqrt(h, delta, ta, ids, kin):
    """The row_key form on sqrtf: the re-sweep, and the reference."""
    return min(kin, int(_packed(row_key_form(h, delta, ta, _sqrt), ids).min()))


def sweep_row_key(h, delta, ta, ids, kin, outside):
    """The row_key form on fast_root with its range test of the argument."""
    arg = np.where(delta >= 0, delta, F(1.0)).astype(F)
    if (~_fast_range(arg)).any():
        return sweep_sqrt(h, delta, ta, ids, kin)
    keys = row_key_form(h, delta, ta, lambda x: fast_root(x, outside))
    return min(kin, int(_packed(keys, ids).min()))


def lean_flags(delta):
    return _ubits(delta) < sweep_root.FAST_FIRST


def sweep_lean(h, delta, ta, ids, kin, outside):
    """The lean row: root of the raw delta, a minimum for hits alone, the
    flag on the least delta's bits."""
    if lean_flags(delta).any():
        return sweep_sqrt(h, delta, ta, ids, kin)
    sq = fast_root(delta, outside)
    with np.errstate(invalid="ignore"):
        n1, n2 = h - sq, h + sq
        nroot = np.where(n1 > ta, n1, n2).astype(F)
        hit = nroot > ta
    kmin = kin
    for key in _packed(nroot, ids)[hit]:
        kmin = min(kmin, int(key))
    return kmin


# Filler rows: hits (delta 1, h 10 + i: key 9 + i) and misses (delta -1).
_FILL_H = F(10.0) + np.arange(6, dtype=F)
_FILL_D = np.array([1.0, -1.0, 1.0, -1.0, 1.0, -1.0], F)

# The edge row of each case (h, delta); h = 2 makes its key the winner
# wherever it is a hit.
_CASES = {
    "miss": (2.0, -1.0),
    "plus_zero": (2.0, 0.0),
    "denormal": (2.0, 1.0e-40),
    "denormal_neg": (2.0, -1.0e-40),
    "below_fast_min": (2.0, _ulp(FAST_MIN, 0.0)),
    "fast_min": (2.0, FAST_MIN),
    "above_fast_min": (2.0, _ulp(FAST_MIN, 1.0)),
    "tiny_neg": (2.0, -_ulp(FAST_MIN, 0.0)),
    "neg_fast_min": (2.0, -FAST_MIN),
    "plus_inf": (2.0, np.inf),
    "minus_inf": (2.0, -np.inf),
    "nan": (2.0, np.nan),
    "h_nan": (np.nan, 1.0),
    "root_past_bigf": (3.2e38, 1.0),
    "grazing_behind": (-2.0, 0.0),
}


def _block(case):
    h0, d0 = _CASES[case]
    h = np.concatenate([[F(h0)], _FILL_H, [F(9.5)]]).astype(F)
    delta = np.concatenate([[F(d0)], _FILL_D, [F(1.0)]]).astype(F)
    return h, delta


# kin: nohit; an earlier block's key below every key here; one between the
# edge row's key and the fillers'.
_KIN = {"nohit": NOHIT, "earlier_low": (int(_bits(F(0.5))) & ~MASK) | 7,
        "earlier_mid": (int(_bits(F(5.0))) & ~MASK) | 300}


@pytest.mark.parametrize("kin", sorted(_KIN))
@pytest.mark.parametrize("case", sorted(_CASES))
def test_lean_row_gives_row_key_bits(case, kin):
    h, delta = _block(case)
    ta = T_MIN * F(1.0)
    ids = np.arange(len(h), dtype=np.int32) + 64
    want = sweep_sqrt(h, delta, ta, ids, _KIN[kin])
    for outside in _OUTSIDE:
        assert sweep_row_key(h, delta, ta, ids, _KIN[kin], outside) == want
        assert sweep_lean(h, delta, ta, ids, _KIN[kin], outside) == want


@pytest.mark.parametrize("case", sorted(_CASES))
def test_lean_flag_catches_every_row_it_must(case):
    # Where fast_root is not sqrtf and the true key could go below nohit,
    # the lean flag is set; a row that only the row_key form's test flagged
    # (+inf) has the key +inf, never below nohit; tiny negative deltas,
    # which neither flags, have no key.
    h, delta = _block(case)
    ta = T_MIN * F(1.0)
    ids = np.arange(len(h), dtype=np.int32)
    true_keys = _packed(row_key_form(h, delta, ta, _sqrt), ids)
    below = true_keys < NOHIT
    new = lean_flags(delta)
    arg = np.where(delta >= 0, delta, F(1.0)).astype(F)
    old = ~_fast_range(arg)
    for outside in _OUTSIDE:
        fr = fast_root(delta, outside)
        differs = _bits(fr) != _bits(_sqrt(delta))
        differs &= ~(np.isnan(fr) & np.isnan(_sqrt(delta)))
        assert not (differs & below & ~new).any()
    only_old = old & ~new
    assert (true_keys[only_old] >= NOHIT).all()
    if case == "plus_inf":
        assert only_old[0] and row_key_form(h, delta, ta, _sqrt)[0] == np.inf
    if case in ("tiny_neg", "nan", "denormal_neg", "neg_fast_min"):
        # Unflagged by either test, and no key in either form.
        assert not new[0] and not old[0] and true_keys[0] >= NOHIT


def test_ties_in_truncated_keys_keep_the_lower_id():
    # Keys equal under ~mask (the same root, or roots that differ in the
    # masked bits only) tie; the lower id wins in both forms.
    h = np.array([3.0, 3.0, _ulp(3.0, 4.0), 4.0], F)
    delta = np.array([1.0, 1.0, 1.0, FAST_MIN], F)
    ta = T_MIN * F(1.0)
    for ids in (np.array([9, 5, 2, 1], np.int32),
                np.array([1, 2, 3, 4], np.int32)):
        want = sweep_sqrt(h, delta, ta, ids, NOHIT)
        got = sweep_lean(h, delta, ta, ids, NOHIT, 0.0)
        assert got == want == (int(_bits(F(2.0))) & ~MASK) | int(ids[:3].min())


def _terms(o, d, c, cm2):
    """(h, delta, T_MIN * a) in the kernel's association order, float32."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    cx, cy, cz = c[None, :, 0], c[None, :, 1], c[None, :, 2]
    with np.errstate(over="ignore", invalid="ignore"):
        a = dx * dx + dy * dy + dz * dz
        ddo = dx * ox + dy * oy + dz * oz
        odo = ox * ox + oy * oy + oz * oz
        h = cx * dx + cy * dy + cz * dz - ddo
        cq = (cm2[None] + F(-2.0) * cx * ox + F(-2.0) * cy * oy
              + F(-2.0) * cz * oz + odo)
        return h, h * h - a * cq, T_MIN * a


@pytest.mark.parametrize("kin", sorted(_KIN))
def test_edge_rays_through_spheres_and_pad_rows(kin):
    # tools/sweep_edges.py's rays (+0, denormal and tiny normal
    # discriminants of both signs, -inf, NaN, the pad rays) against its
    # three spheres and five pad rows (the last centre, cm2 = 1e30).
    o, d, _ = sweep_edges.edge_rays(11)
    c = np.array([s[0] for s in sweep_edges.SPHERES], F)
    r = np.array([s[1] for s in sweep_edges.SPHERES], F)
    cm2 = (c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] + c[:, 2] * c[:, 2]
           - r * r).astype(F)
    c = np.concatenate([c, np.repeat(c[-1:], 5, 0)])
    cm2 = np.concatenate([cm2, np.full(5, 1e30, F)]).astype(F)
    h, delta, ta = _terms(o, d, c, cm2)
    ids = np.arange(len(c), dtype=np.int32)
    flagged = lean_flags(delta).any(axis=1)
    tiny_neg = ((delta < 0) & (delta > -FAST_MIN)).any(axis=1)
    assert flagged.sum() >= 60 and (~flagged).sum() >= 800
    assert (tiny_neg & ~flagged).sum() >= 36
    assert (np.isnan(delta).any(axis=1) & ~flagged).any()
    for i in range(len(o)):
        want = sweep_sqrt(h[i], delta[i], ta[i], ids, _KIN[kin])
        for outside in (np.nan, 1.0, -1.0):
            got = sweep_lean(h[i], delta[i], ta[i], ids, _KIN[kin], outside)
            assert got == want, (i, outside)


def test_tally_counts_the_lean_flags_segments():
    # The plain version's SweepTally over the edge rays at depth 1 (one
    # segment a ray) counts the rays whose real rows hold a delta that
    # each flag catches: those in [+0, 2^-101) both, +inf the earlier one.
    o, d, _ = sweep_edges.edge_rays(11)
    delta = sweep_edges.deltas(o, d)
    new = lean_flags(delta).any(axis=1)
    with np.errstate(invalid="ignore"):
        old = ((delta >= 0) & ((delta < FAST_MIN) | np.isinf(delta))).any(1)
    scene = sweep_edges.add_spheres(SceneBuilder()).build()
    tables = ttrace.pack_scene(scene, cull=False)
    tally = ttrace.SweepTally()
    _, seg = ttrace.trace_rays_fused_reference(
        tables, torch.from_numpy(o), torch.from_numpy(d), seed=5,
        tile_offset=0, max_depth=1, tile_rays=1024, tally=tally)
    assert int(seg) == len(o)
    assert tally.sphere_fallbacks == int(new.sum())
    assert tally.sphere_fallbacks_old == int(old.sum())
    assert 60 <= tally.sphere_fallbacks <= tally.sphere_fallbacks_old


@pytest.mark.parametrize("value,flagged", [
    (0.0, True), (-0.0, False), (1.0e-40, True), (-1.0e-40, False),
    (float(_ulp(FAST_MIN, 0.0)), True), (float(FAST_MIN), False),
    (-float(FAST_MIN), False), (-float(_ulp(FAST_MIN, 0.0)), False),
    (np.inf, False), (-np.inf, False), (np.nan, False), (-np.nan, False),
    (1.0, False),
])
def test_lean_outside_reference(value, flagged):
    x = torch.tensor([value], dtype=torch.float32)
    assert bool(sweep_root.lean_outside_reference(x)[0]) == flagged
    assert bool(lean_flags(np.array([value], F))[0]) == flagged


_SPECIAL = np.array([0.0, -0.0, 1.0e-45, -1.0e-45, 1.0e-38, -1.0e-38,
                     2.0 ** -101, 1.0, -1.0, 3.0e38, -3.0e38, np.inf,
                     -np.inf, np.nan], F)


def test_discriminant_is_never_minus_zero():
    # delta = h*h - a*cq, each product and the difference rounded once
    # (-fmad=false): h*h is never -0.0, and in round-to-nearest a
    # difference is -0.0 only when its first operand is -0.0, so the one
    # delta where the lean row (NaN) and row_key (a hit at h) part without
    # a flag cannot arise, whatever h, a and cq are.
    h = _SPECIAL[:, None, None]
    a = np.abs(_SPECIAL)[None, :, None]  # a = |d|^2 is never negative
    cq = _SPECIAL[None, None, :]
    with np.errstate(over="ignore", invalid="ignore", under="ignore"):
        delta = h * h - a * cq
    assert delta.dtype == F
    assert not ((delta == 0) & np.signbit(delta)).any()
    assert ((delta == 0) & ~np.signbit(delta)).any()
    # Were it to arise, it would part: row_key's key is h.
    h1, d1 = np.array([F(2.0)]), np.array([F(-0.0)])
    ta = T_MIN * F(1.0)
    ids = np.zeros(1, np.int32)
    assert sweep_sqrt(h1, d1, ta, ids, NOHIT) < NOHIT
    assert sweep_lean(h1, d1, ta, ids, NOHIT, 0.0) == NOHIT


# ---------------------------------------------------------------------------
# The two-level windows: sweep_window_keys (a dense chunk, per lane) and the
# cooperative loop of sphere_chunk_warp (lane L holds rows L + 32 q of a
# window and the warp reduces), csrc/regen.cu. A window gives its bare key
# min (k1) and its keys packed with their 7-bit row ids, min'd (k2). The
# row_key form took both from INT_MAX over every row, misses at kBigF; the
# lean row starts k1 at kBigF's bits and k2 at row 0 with the miss key and
# takes hits alone. keep_window then folds each window into a lane's Keys.
# ---------------------------------------------------------------------------

WIN = 128
RMASK = WIN - 1
LANES = 32
BIGF_BITS = int(_bits(BIGF))
MISS2 = BIGF_BITS & ~RMASK  # k2's start: row 0 with the miss key
INT_MAX = 2 ** 31 - 1
WIN_MASK = (1 << 6) - 1  # the window-id bits of an 8,192-row table
WIN_NOHIT = BIGF_BITS & ~WIN_MASK
FLAT_MASK = (1 << 11) - 1  # the row-id bits of a 2,048-row chunked table
FLAT_NOHIT = BIGF_BITS & ~FLAT_MASK

# The edge rows of the flat row, and keys at kBigF and just below it (a hit
# whose 7-bit truncation is the miss key's).
_WINDOW_CASES = dict(
    _CASES, root_at_bigf=(float(BIGF), 1.0),
    root_truncated_to_miss=(float(np.int32(MISS2 | 0x20).view(F)), 1.0))

# Where the edge row sits among 127 misses (delta -1), and what else hits:
# "hits" three rows (keys 10, 11, 12) beside it, "tie" two rows whose keys
# tie under ~RMASK (2.0 and the next float) at rows 41 and 9.
_LAYOUTS = {"alone_at_0": (0, ()), "alone_at_77": (77, ()),
            "hits": (77, ((3, 12.0, 1.0), (64, 11.0, 1.0), (100, 13.0, 1.0))),
            "tie": (0, ((41, 3.0, 1.0), (9, float(_ulp(3.0, 4.0)), 1.0)))}


def _window(case, layout):
    pos, extra = _LAYOUTS[layout]
    h = np.full(WIN, F(2.0))
    delta = np.full(WIN, F(-1.0))
    for row, hv, dv in extra:
        h[row], delta[row] = F(hv), F(dv)
    h[pos], delta[pos] = (F(v) for v in _WINDOW_CASES[case])
    return h, delta


def _window_rows(keys, ids, k1, k2):
    """Minima of ``keys`` (bits) into (k1, k2), k2 packed with ``ids``."""
    keys = np.asarray(keys, np.int64)
    ids = np.asarray(ids, np.int64)
    if keys.size:
        k1 = min(k1, int(keys.min()))
        k2 = min(k2, int(((keys & ~RMASK) | ids).min()))
    return k1, k2


def window_row_key(h, delta, ta, outside):
    """The row_key form as the windows took it: (k1, k2) from INT_MAX over
    every row on fast_root; the window swept again with sqrtf where a root's
    argument lay outside fast_root's range."""
    arg = np.where(delta >= 0, delta, F(1.0)).astype(F)
    flagged = (~_fast_range(arg)).any()
    root = _sqrt if flagged else (lambda x: fast_root(x, outside))
    keys = _bits(row_key_form(h, delta, ta, root))
    return _window_rows(keys, np.arange(WIN), INT_MAX, INT_MAX)


def window_reference(h, delta, ta):
    """The row_key form on sqrtf from INT_MAX: what the windows are held to."""
    keys = _bits(row_key_form(h, delta, ta, _sqrt))
    return _window_rows(keys, np.arange(WIN), INT_MAX, INT_MAX)


def lean_lanes(h, delta, ta, outside, lanes):
    """The lean row's per-lane minima, lane L over rows L + lanes * q
    (``lanes`` 1: one lane over the window, sweep_window_keys): (k1, k2,
    flag) arrays, k1 from kBigF's bits and k2 from row 0 with the miss key,
    hits alone; the flag where the lane's least delta bits lie below
    2^-101's. The cooperative loop packs a key with 32 q alone and ORs the
    lane into k2 once, after its rows."""
    sq = fast_root(delta, outside)
    with np.errstate(invalid="ignore"):
        n1, n2 = h - sq, h + sq
        nroot = np.where(n1 > ta, n1, n2).astype(F)
        hit = nroot > ta
    bits = _bits(nroot)
    flags = lean_flags(delta)
    out = np.zeros((3, lanes), np.int64)
    for lane in range(lanes):
        rows = np.arange(lane, WIN, lanes)
        rows_hit = rows[hit[rows]]
        k1, k2 = _window_rows(bits[rows_hit], rows_hit - lane, BIGF_BITS,
                              MISS2)
        out[0, lane], out[1, lane] = k1, k2 | lane
        out[2, lane] = flags[rows].any()
    return out


def window_lean(h, delta, ta, outside, lanes):
    """The lean window: the lanes' minima reduced (the cooperative loop's
    two REDUX), swept again with row_key's form and sqrtf from the same
    starts where some lane flagged it."""
    k1, k2, flag = lean_lanes(h, delta, ta, outside, lanes)
    if flag.any():
        keys = _bits(row_key_form(h, delta, ta, _sqrt))
        return _window_rows(keys, np.arange(WIN), BIGF_BITS, MISS2)
    return int(k1.min()), int(k2.min())


def keep_window(k, red, red2, win, win_mask=WIN_MASK):
    """csrc/regen.cu's keep_window."""
    cand = (red & ~win_mask) | win
    return min(k[0], cand), (red2 if cand <= k[0] else k[1])


def hitm(k):
    """The chunked body's hit test on the folded stage 2."""
    return k[1] < MISS2


@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
@pytest.mark.parametrize("case", sorted(_WINDOW_CASES))
def test_lean_window_gives_row_key_minima_capped_at_the_starts(case, layout):
    # Per lane (the cooperative loop, before its reductions) and per window
    # (both paths, after the flag): each lean minimum is row_key's from
    # INT_MAX capped at its start (a lane's k2 at the miss key with its own
    # id), whatever fast_root gives outside its range; the row_key form on
    # fast_root gives the reference's bits.
    h, delta = _window(case, layout)
    ta = T_MIN * F(1.0)
    ref = window_reference(h, delta, ta)
    want = (min(ref[0], BIGF_BITS), min(ref[1], MISS2))
    ref_keys = _bits(row_key_form(h, delta, ta, _sqrt))
    for outside in _OUTSIDE:
        assert window_row_key(h, delta, ta, outside) == ref
        for lanes in (1, LANES):
            assert window_lean(h, delta, ta, outside, lanes) == want
        k1, k2, flag = lean_lanes(h, delta, ta, outside, LANES)
        for lane in np.flatnonzero(flag == 0):
            rows = np.arange(lane, WIN, LANES)
            r1, r2 = _window_rows(ref_keys[rows], rows, INT_MAX, INT_MAX)
            assert (k1[lane], k2[lane]) == (min(r1, BIGF_BITS),
                                            min(r2, MISS2 | lane)), lane
        assert bool(flag.any()) == bool(lean_flags(delta).any())


def _miss_window():
    return np.full(WIN, F(2.0)), np.full(WIN, F(-1.0))


def _hit_window():
    h, delta = _miss_window()
    h[50], delta[50] = F(1.5), F(1.0)  # key 0.5: below every edge key
    return h, delta


# A segment's windows in visiting order: (window id, window), "edge" the
# case's window. Window 0 is where k2 follows a window while nothing is hit.
_ORDERS = {
    "edge_is_window_0": (("edge", 0),),
    "window_0_after_a_miss": (("miss", 5), ("edge", 0)),
    "window_0_after_a_hit": (("hit", 5), ("edge", 0)),
    "edge_then_window_0_missed": (("edge", 5), ("miss", 0)),
    "edge_past_a_hit": (("hit", 0), ("edge", 63)),
}


def _keys_through(order, windows, form):
    k = (WIN_NOHIT, MISS2)  # Keys{nohit, kBigF & ~(kWin - 1)}
    for name, win in order:
        red, red2 = form(*windows[name])
        k = keep_window(k, red, red2, win)
    return k


@pytest.mark.parametrize("order", sorted(_ORDERS))
@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
@pytest.mark.parametrize("case", sorted(_WINDOW_CASES))
def test_lean_window_keeps_what_the_callers_read(case, layout, order):
    # Through keep_window from Keys{nohit, kBigF & ~127}: the same k1 (the
    # gate's bound and the winning window), the same hit test on k2, and
    # where it holds the same k2 (the winning row). Elsewhere the segment
    # takes the sky and the row fetched from k2 is not read; the lean k2 is
    # row_key's capped at the miss key.
    ta = T_MIN * F(1.0)
    windows = {"edge": _window(case, layout), "miss": _miss_window(),
               "hit": _hit_window()}
    ref = _keys_through(_ORDERS[order], windows,
                        lambda h, d: window_reference(h, d, ta))
    for outside in (np.nan, 1.0, -1.0):
        old = _keys_through(_ORDERS[order], windows,
                            lambda h, d: window_row_key(h, d, ta, outside))
        assert old == ref
        for lanes in (1, LANES):
            new = _keys_through(
                _ORDERS[order], windows,
                lambda h, d: window_lean(h, d, ta, outside, lanes))
            assert new[0] == ref[0]
            assert hitm(new) == hitm(ref)
            assert new[1] == min(ref[1], MISS2)
            if hitm(ref):
                assert new == ref


def test_hit_past_bigf_in_window_0_parts_in_an_unread_row_id():
    # The edge where the forms' keys part: window 0, nothing hit before, a
    # hit at or past kBigF at row 0 and misses elsewhere. row_key's k2 is
    # the miss key with row 1 (the first miss), the lean row's row 0 with
    # it; neither is a hit, so the segment takes the sky. Window 0 with no
    # hit at all keeps Keys{nohit, kBigF & ~127} in both.
    ta = T_MIN * F(1.0)
    h, delta = _window("root_past_bigf", "alone_at_0")
    old = keep_window((WIN_NOHIT, MISS2), *window_reference(h, delta, ta), 0)
    new = keep_window((WIN_NOHIT, MISS2),
                      *window_lean(h, delta, ta, np.nan, LANES), 0)
    assert old == (WIN_NOHIT, MISS2 | 1) and new == (WIN_NOHIT, MISS2)
    assert not hitm(old) and not hitm(new)
    h, delta = _miss_window()
    for form in (lambda: window_reference(h, delta, ta),
                 lambda: window_lean(h, delta, ta, np.nan, 1)):
        assert form() == (BIGF_BITS, MISS2)
        assert keep_window((WIN_NOHIT, MISS2), *form(), 0) == (WIN_NOHIT,
                                                               MISS2)


_FLAT_KIN = {"nohit": FLAT_NOHIT,
             "earlier_low": (int(_bits(F(0.5))) & ~FLAT_MASK) | 7,
             "earlier_mid": (int(_bits(F(5.0))) & ~FLAT_MASK) | 300}


@pytest.mark.parametrize("kin", sorted(_FLAT_KIN))
@pytest.mark.parametrize("case", sorted(_WINDOW_CASES))
def test_lean_cooperative_flat_rule_keeps_the_same_key(case, kin):
    # The chunked flat rule's cooperative loop: a lane's keys packed with
    # 32 q from nohit, hits alone, its id bits (640 + lane) ORed in after
    # its rows, reduced, swept again from nohit where flagged; the ray's
    # lane keeps the min with its key (at or below nohit), as row_key's form
    # from INT_MAX gives.
    h, delta = _window(case, "hits")
    ta = T_MIN * F(1.0)
    ids = np.arange(WIN, dtype=np.int32) + 640
    want = min(_FLAT_KIN[kin], int(
        ((_bits(row_key_form(h, delta, ta, _sqrt)) & ~FLAT_MASK) | ids).min()))
    sq = fast_root(delta, 0.0)
    with np.errstate(invalid="ignore"):
        n1, n2 = h - sq, h + sq
        nroot = np.where(n1 > ta, n1, n2).astype(F)
    red = INT_MAX
    for lane in range(LANES):
        rows = np.arange(lane, WIN, LANES)
        k4 = FLAT_NOHIT
        for i in rows[nroot[rows] > ta]:
            k4 = min(k4, (int(_bits(nroot[i])) & ~FLAT_MASK) | (i - lane))
        red = min(red, k4 | int(ids[lane]))
    if lean_flags(delta).any():
        red = min(FLAT_NOHIT, int(
            ((_bits(row_key_form(h, delta, ta, _sqrt)) & ~FLAT_MASK)
             | ids).min()))
    assert min(_FLAT_KIN[kin], red) == want


@pytest.mark.parametrize("lanes", [1, LANES])
def test_edge_rays_through_a_two_level_window(lanes):
    # tools/sweep_edges.py's rays against its three spheres in a window of
    # 128 rows, the rest pad rows (the last centre, cm2 = 1e30): the lean
    # window's minima are the reference's capped at their starts, and
    # window 0 kept from Keys{nohit, kBigF & ~127} agrees where it is read.
    o, d, _ = sweep_edges.edge_rays(11)
    c = np.array([s[0] for s in sweep_edges.SPHERES], F)
    r = np.array([s[1] for s in sweep_edges.SPHERES], F)
    cm2 = (c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] + c[:, 2] * c[:, 2]
           - r * r).astype(F)
    pad = WIN - len(c)
    c = np.concatenate([c, np.repeat(c[-1:], pad, 0)])
    cm2 = np.concatenate([cm2, np.full(pad, 1e30, F)]).astype(F)
    h, delta, ta = _terms(o, d, c, cm2)
    flagged = lean_flags(delta).any(axis=1)
    assert flagged.sum() >= 60 and (~flagged).sum() >= 800
    for i in range(len(o)):
        ref = window_reference(h[i], delta[i], ta[i, 0])
        got = window_lean(h[i], delta[i], ta[i, 0], np.nan, lanes)
        assert got == (min(ref[0], BIGF_BITS), min(ref[1], MISS2)), i
        old = keep_window((WIN_NOHIT, MISS2), *ref, 0)
        new = keep_window((WIN_NOHIT, MISS2), *got, 0)
        assert new[0] == old[0] and hitm(new) == hitm(old)
        if hitm(old):
            assert new == old
