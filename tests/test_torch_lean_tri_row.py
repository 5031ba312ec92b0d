"""A bit-level model of the lean triangle row (``csrc/regen.cu``,
``lean_tri``) and its predicated minima against the form it replaced
(``tri_key`` with ``key_rcp``'s reciprocal), in float32 with no
contraction (numpy float32: each operation rounds once, as the kernel
built with ``-fmad=false`` does).

The old form multiplies det, u, v and t by the orientation sign (-1 where
det < 0, else 1), clamps |det| at 1e-30 before its bfloat16 rounding, and
makes the key kBigF unless the row is a hit with t below kBigF; its
callers took every row's key into their minima, the cooperative loop's
stage-2 key from INT_MAX. The lean row takes |det|, gives u, v and t det's
sign bit by an XOR, does not clamp, drops the t < kBigF test, and its
callers take a row's key only where it is a hit, the stage-2 key from row
0 with the miss key (kBigF & ~127). Both set the same re-sweep flag (the
bfloat16 |det| at or past 2^126, where ``key_rcp`` is not the IEEE
reciprocal), and a flagged window or sweep is swept again with the IEEE
form from the same starts.

``key_rcp`` is modelled as the card gives it: the IEEE ``1 / b`` on every
bfloat16 b in [bf16(1e-30), 2^126) (``tests/test_torch_tri_sweep.py``
proves it, ``chip_smoke.py`` checks the card), and an arbitrary value
elsewhere, taken from ``_OUTSIDE``, since nothing there may depend on it.
Every case asserts that the cooperative loop's two reductions, the keys a
lane keeps through ``keep_window`` and the flat rule's packed minimum are
the old form's, bit for bit, and the IEEE form's. No card or JAX needed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raytracing_tpu_torch.ops import trace as ttrace  # noqa: E402
from raytracing_tpu_torch.scene.mesh import make_icosphere  # noqa: E402
from raytracing_tpu_torch.tools import sweep_edges  # noqa: E402

F = np.float32
BIGF = F(3.0e38)
BIGF_BITS = int(np.array(BIGF).view(np.int32))
T_MIN = F(1.0e-4)
RCP_LO = F(np.array(0x0DA2 << 16, np.int32).view(np.float32))  # bf16(1e-30)
RCP_HI = F(2.0 ** 126)
WIN = 128
RMASK = WIN - 1
LANES = 32
LANE_ROWS = WIN // LANES
MISS2 = BIGF_BITS & ~RMASK  # row 0 with the miss key
INT_MAX = 2 ** 31 - 1
WIN_MASK = (1 << 4) - 1  # the window-id bits of a 2,048-row table
WIN_NOHIT = BIGF_BITS & ~WIN_MASK
FLAT_MASK = (1 << 9) - 1  # the row-id bits of a 512-row flat table
FLAT_NOHIT = BIGF_BITS & ~FLAT_MASK
# key_rcp's value where it is not the IEEE reciprocal.
_OUTSIDE = (np.nan, 0.0, 1.0e-30, 1.0, -1.0, 3.2e38, np.inf, -np.inf)


def _ulp(x, toward):
    return np.nextafter(F(x), F(toward))


def _bits(x):
    return np.asarray(x, F).view(np.int32).astype(np.int64)


def _from_bits(b):
    return np.asarray(b, np.int64).astype(np.uint32).view(F)


def bf16(x):
    """Round to bfloat16, nearest even (``__float2bfloat16_rn``)."""
    t = torch.from_numpy(np.ascontiguousarray(x, F))
    return t.to(torch.bfloat16).to(torch.float32).numpy()


def rcp_fast(b, outside):
    """key_rcp: the IEEE reciprocal over its range, ``outside`` elsewhere."""
    inside = (b >= RCP_LO) & (b < RCP_HI)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(inside, F(1.0) / b, F(outside)).astype(F)


def _ieee_rcp(b, outside):
    with np.errstate(divide="ignore", invalid="ignore"):
        return (F(1.0) / b).astype(F)


def _clamp_min(x, lo):
    return np.where(x < lo, F(lo), x).astype(F)  # NaN passes through


def old_key(dots, outside, rcp=rcp_fast):
    """tri_key's form on the four dot products (det, u, v, t): the key
    (kBigF on a miss) and the re-sweep flag."""
    det, u, v, t = (np.asarray(x, F) for x in dots)
    with np.errstate(over="ignore", invalid="ignore"):
        g = np.where(det < 0, F(-1.0), F(1.0)).astype(F)
        dabs, us, vs, ts = det * g, u * g, v * g, t * g
        b = bf16(_clamp_min(dabs, F(1e-30)))
        tapx = ts * rcp(b, outside)
        valid = ((dabs > F(1e-12)) & (us >= 0) & (vs >= 0)
                 & (us + vs <= dabs) & (tapx > T_MIN) & (tapx < BIGF))
        return np.where(valid, tapx, BIGF).astype(F), b >= RCP_HI


def ieee_key(dots):
    """The re-sweeps' tri_key: the old form with the IEEE divide."""
    return old_key(dots, 0.0, _ieee_rcp)[0]


def lean_key(dots, outside):
    """lean_tri: the key t, whether the row is a hit, the re-sweep flag."""
    det, u, v, t = (np.asarray(x, F) for x in dots)
    sign = _bits(det) & 0x80000000
    with np.errstate(over="ignore", invalid="ignore"):
        dabs = np.abs(det)
        us, vs, ts = (_from_bits(_bits(x) ^ sign) for x in (u, v, t))
        b = bf16(dabs)
        tt = ts * rcp_fast(b, outside)
        hit = ((dabs > F(1e-12)) & (us >= 0) & (vs >= 0)
               & (us + vs <= dabs) & (tt > T_MIN))
        return tt.astype(F), hit, b >= RCP_HI


def lane_rows(n):
    """Each lane's rows of a window with ``n`` real rows (row(k): rows past
    the real ones repeat the last real row) and their ids lane + 32 k."""
    ids = np.arange(LANES)[:, None] + LANES * np.arange(LANE_ROWS)[None, :]
    return np.minimum(ids, n - 1), ids


def window_old(dots, n, outside):
    """The cooperative loop as it was: every row's key into k4 (from
    kBigF's bits) and k2 (from INT_MAX), the two reductions, and the
    IEEE re-sweep from the same starts where some lane flagged."""
    rows, ids = lane_rows(n)
    key, flag = old_key(dots, outside)
    if flag[rows].any():
        key = ieee_key(dots)
    bits = _bits(key)[rows]
    return (int(np.minimum(BIGF_BITS, bits).min()),
            int(((bits & ~RMASK) | ids).min()))


def window_lean(dots, n, outside):
    """The lean cooperative loop: a lane's hits alone into k4 (from
    kBigF's bits) and k2 (from row 0 with the miss key), the reductions,
    and the unchanged IEEE re-sweep where some lane flagged."""
    rows, ids = lane_rows(n)
    t, hit, flag = lean_key(dots, outside)
    if flag[rows].any():
        bits = _bits(ieee_key(dots))[rows]
        return (int(np.minimum(BIGF_BITS, bits).min()),
                int(((bits & ~RMASK) | ids).min()))
    red, red2 = BIGF_BITS, MISS2
    for lane in range(LANES):
        k4, k2 = BIGF_BITS, MISS2
        for k in range(LANE_ROWS):
            r = rows[lane, k]
            if hit[r]:
                k4 = min(k4, int(_bits(t[r])))
                k2 = min(k2, (int(_bits(t[r])) & ~RMASK) | int(ids[lane, k]))
        red, red2 = min(red, k4), min(red2, k2)
    return red, red2


def window_reference(dots, n):
    """The IEEE form over the window's real rows from INT_MAX."""
    bits = _bits(ieee_key(dots))[:n]
    return int(bits.min()), int(((bits & ~RMASK) | np.arange(n)).min())


def keep_window(k, red, red2, win, win_mask=WIN_MASK):
    """csrc/regen.cu's keep_window."""
    cand = (red & ~win_mask) | win
    return min(k[0], cand), (red2 if cand <= k[0] else k[1])


def flat_old(dots, kin, outside):
    """tri_sweep as it was: every row's packed key from ``kin``."""
    key, flag = old_key(dots, outside)
    if flag.any():
        key = ieee_key(dots)
    ids = np.arange(len(key))
    return min(kin, int(((_bits(key) & ~FLAT_MASK) | ids).min()))


def flat_lean(dots, kin, outside):
    """The lean tri_sweep: hits alone from ``kin``, the IEEE re-sweep from
    ``kin`` where flagged."""
    t, hit, flag = lean_key(dots, outside)
    if flag.any():
        return flat_old(dots, kin, np.nan)
    kmin = kin
    for i in np.flatnonzero(hit):
        kmin = min(kmin, (int(_bits(t[i])) & ~FLAT_MASK) | int(i))
    return kmin


# The edge rows as dot products (det, u, v, t): the key where they are a
# hit lies near 2 (t = 2 det), below every filler's.
_E = F(1e-12)
_CASES = {
    "hit": (1.0, 0.25, 0.25, 2.0),
    "hit_neg_det": (-1.0, -0.25, -0.25, -2.0),
    "det_plus_zero": (0.0, 0.0, 0.0, 0.0),  # a padding row: e1 = e2 = 0
    "det_minus_zero": (-0.0, -0.0, -0.0, -1.0),
    "det_minus_zero_pos": (-0.0, 0.0, 0.0, 1.0),
    "det_nan": (np.nan, 0.25, 0.25, 2.0),
    "det_denormal": (1.0e-40, 0.0, 0.0, 2.0e-40),
    "det_neg_denormal": (-1.0e-40, -0.0, -0.0, -2.0e-40),
    "det_1e-12": (_E, _E * F(0.25), _E * F(0.25), _E * F(2.0)),
    "det_minus_1e-12": (-_E, -_E * F(0.25), -_E * F(0.25), -_E * F(2.0)),
    "det_past_1e-12": (_ulp(_E, 1.0), 0.0, 0.0, _E * F(2.0)),
    "det_tiny_normal": (1.0e-35, 0.0, 0.0, 2.0e-35),
    "b_at_2^126": (RCP_HI, 0.0, 0.0, RCP_HI),
    "b_rounds_to_2^126": (_ulp(RCP_HI, 0.0), 0.0, 0.0, RCP_HI),
    "b_below_2^126": (F(2.0 ** 125) * F(1.9), 0.0, 0.0, F(2.0 ** 125)),
    "b_neg_2^126": (-RCP_HI, -0.0, -0.0, -RCP_HI),
    "b_past_2^126": (3.0e38, 1.0, 1.0, 3.0e38),
    "det_inf": (np.inf, 1.0, 1.0, np.inf),
    "det_neg_inf": (-np.inf, -1.0, -1.0, -np.inf),
    "u_minus_zero": (1.0, -0.0, 0.25, 2.0),
    "v_minus_zero": (1.0, 0.25, -0.0, 2.0),
    "u_plus_zero_neg_det": (-1.0, 0.0, -0.25, -2.0),
    "v_plus_zero_neg_det": (-1.0, -0.25, 0.0, -2.0),
    "u_negative": (1.0, -1.0e-30, 0.25, 2.0),
    "u_plus_v_is_dabs": (1.0, 0.25, 0.75, 2.0),
    "u_plus_v_past_dabs": (1.0, 0.25, _ulp(0.75, 1.0), 2.0),
    "u_plus_v_is_dabs_neg": (-1.0, -0.25, -0.75, -2.0),
    "u_nan": (1.0, np.nan, 0.25, 2.0),
    "t_at_tmin": (1.0, 0.25, 0.25, T_MIN),
    "t_past_tmin": (1.0, 0.25, 0.25, _ulp(T_MIN, 1.0)),
    "t_behind": (1.0, 0.25, 0.25, -2.0),
    "t_below_bigf": (1.0, 0.25, 0.25, _ulp(BIGF, 0.0)),
    "t_at_bigf": (1.0, 0.25, 0.25, BIGF),
    "t_past_bigf": (1.0, 0.25, 0.25, _ulp(BIGF, np.inf)),
    "t_flt_max": (1.0, 0.25, 0.25, np.finfo(F).max),
    "t_inf": (1.0, 0.25, 0.25, np.inf),
    "t_rcp_overflows": (1.5e-12, 0.0, 0.0, 1.0e30),
    "t_nan": (1.0, 0.25, 0.25, np.nan),
}

# Where the edge row sits among misses (padding rows), what else hits:
# "hits" rows with keys 10, 11, 12 beside it; "tie" two rows whose keys
# tie under ~127 (3.0 and the next float).
_HIT = (1.0, 0.25, 0.25)
_LAYOUTS = {
    "alone_at_0": (0, ()),
    "alone_at_77": (77, ()),
    "hits": (77, ((3, 12.0), (64, 11.0), (100, 13.0))),
    "tie": (0, ((41, 3.0), (9, float(_ulp(3.0, 4.0))))),
}


def _window(case, layout):
    pos, extra = _LAYOUTS[layout]
    dots = np.zeros((4, WIN), F)  # padding rows
    for row, t in extra:
        dots[:, row] = (*_HIT, t)
    dots[:, pos] = _CASES[case]
    return dots


def _miss_window():
    return np.zeros((4, WIN), F)


def _hit_window():
    dots = _miss_window()
    dots[:, 50] = (*_HIT, 0.5)  # key 0.5: below every edge key
    return dots


@pytest.mark.parametrize("case", sorted(_CASES))
def test_lean_row_hits_where_the_old_key_is_below_bigf(case):
    # Row by row: the same flag; where the old key is below kBigF the lean
    # row is a hit with its bits; elsewhere a lean hit's key lies at or
    # past kBigF, so it packs at or past every start.
    dots = np.array(_CASES[case], F)[:, None]
    for outside in _OUTSIDE:
        key, flag = old_key(dots, outside)
        t, hit, lflag = lean_key(dots, outside)
        assert lflag[0] == flag[0]
        if flag[0]:
            continue
        assert ieee_key(dots)[0].tobytes() == key[0].tobytes()
        if key[0] < BIGF:
            assert hit[0] and _bits(t[0]) == _bits(key[0])
        elif hit[0]:
            assert t[0] >= BIGF


def test_edge_cases_cover_each_outcome():
    # The cases reach both forms' hits, the misses of each test, a hit at
    # or past kBigF that only the lean row takes, and the flag.
    dots = np.array([_CASES[c] for c in sorted(_CASES)], F).T
    key, flag = old_key(dots, np.nan)
    t, hit, _ = lean_key(dots, np.nan)
    names = np.array(sorted(_CASES))
    assert set(names[(key < BIGF) & ~flag]) >= {
        "hit", "hit_neg_det", "det_past_1e-12", "u_minus_zero",
        "v_minus_zero", "u_plus_zero_neg_det", "u_plus_v_is_dabs",
        "u_plus_v_is_dabs_neg", "t_past_tmin", "t_below_bigf"}
    assert set(names[hit & (t >= BIGF)]) == {
        "t_at_bigf", "t_past_bigf", "t_flt_max", "t_inf", "t_rcp_overflows"}
    assert set(names[flag]) == {"b_at_2^126", "b_rounds_to_2^126",
                                "b_neg_2^126", "b_past_2^126", "det_inf",
                                "det_neg_inf"}
    assert not flag[names == "b_below_2^126"][0]


@pytest.mark.parametrize("n", [1, 78, 128])
@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
@pytest.mark.parametrize("case", sorted(_CASES))
def test_lean_window_gives_the_old_reductions(case, layout, n):
    # The cooperative loop's two reductions are the old form's bit for
    # bit (row 0, lane 0, gives the miss key's k2 in both), and the IEEE
    # form's over the real rows, whatever key_rcp gives outside its range.
    dots = _window(case, layout)
    if _LAYOUTS[layout][0] >= n:
        dots = np.roll(dots, -_LAYOUTS[layout][0], axis=1)
    ref = window_reference(dots, n)
    for outside in _OUTSIDE:
        old = window_old(dots, n, outside)
        assert old == (min(ref[0], BIGF_BITS), min(ref[1], MISS2))
        assert window_lean(dots, n, outside) == old


# A segment's windows in visiting order: (window, id); window 0 is where
# k2 follows a window while nothing is hit.
_ORDERS = {
    "edge_is_window_0": (("edge", 0),),
    "window_0_after_a_miss": (("miss", 5), ("edge", 0)),
    "window_0_after_a_hit": (("hit", 5), ("edge", 0)),
    "edge_then_window_0_missed": (("edge", 5), ("miss", 0)),
    "edge_past_a_hit": (("hit", 0), ("edge", 15)),
}


def _keys_through(order, windows, form):
    k = (WIN_NOHIT, MISS2)  # Keys{nohit & ~tri_mask, kBigF & ~127}
    for name, win in order:
        k = keep_window(k, *form(windows[name]), win)
    return k


@pytest.mark.parametrize("order", sorted(_ORDERS))
@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
@pytest.mark.parametrize("case", sorted(_CASES))
def test_lean_window_keeps_the_same_keys(case, layout, order):
    # Through keep_window from the lane's start: the same Keys as the old
    # form, and as the IEEE form over the real rows.
    windows = {"edge": _window(case, layout), "miss": _miss_window(),
               "hit": _hit_window()}
    ref = _keys_through(_ORDERS[order], windows,
                        lambda d: window_reference(d, WIN))
    for outside in (np.nan, 1.0, -1.0, np.inf):
        old = _keys_through(_ORDERS[order], windows,
                            lambda d: window_old(d, WIN, outside))
        new = _keys_through(_ORDERS[order], windows,
                            lambda d: window_lean(d, WIN, outside))
        assert new == old == ref


def test_every_row_missing_keeps_the_start():
    # A window with no hit (padding rows only, or misses of every kind)
    # gives kBigF's bits and row 0 with the miss key in both forms, and
    # window 0 then keeps the lane's start.
    misses = [c for c in _CASES
              if old_key(np.array(_CASES[c], F)[:, None], np.nan)[0][0] == BIGF
              and not old_key(np.array(_CASES[c], F)[:, None], np.nan)[1][0]]
    assert len(misses) >= 15
    for dots in (_miss_window(),
                 np.resize(np.array([_CASES[c] for c in misses], F),
                           (WIN, 4)).T):
        for form in (window_old, window_lean):
            assert form(dots, WIN, np.nan) == (BIGF_BITS, MISS2)
            assert keep_window((WIN_NOHIT, MISS2), *form(dots, WIN, np.nan),
                               0) == (WIN_NOHIT, MISS2)


_FLAT_KIN = {"nohit": FLAT_NOHIT,
             "earlier_low": (int(_bits(F(0.5))) & ~FLAT_MASK) | 7,
             "earlier_mid": (int(_bits(F(5.0))) & ~FLAT_MASK) | 300}


@pytest.mark.parametrize("kin", sorted(_FLAT_KIN))
@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
@pytest.mark.parametrize("case", sorted(_CASES))
def test_lean_flat_sweep_keeps_the_same_key(case, layout, kin):
    # tri_sweep (the flat rule) from a kmin at or below nohit & ~mask.
    dots = _window(case, layout)
    want = min(_FLAT_KIN[kin], int(
        ((_bits(ieee_key(dots)) & ~FLAT_MASK) | np.arange(WIN)).min()))
    for outside in _OUTSIDE:
        assert flat_old(dots, _FLAT_KIN[kin], outside) == want
        assert flat_lean(dots, _FLAT_KIN[kin], outside) == want


def tri_dots(rows, o, d):
    """(det, u, v, t) of every (ray, row) pair in the kernel's association
    order, float32, no multiply-adds: [4, rays, rows]. ``rows`` holds
    v0, e1, e2 (9 columns)."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
        rows[None, :, j] for j in range(9))
    ox, oy, oz = (o[:, j:j + 1] for j in range(3))
    dx, dy, dz = (d[:, j:j + 1] for j in range(3))
    with np.errstate(over="ignore", invalid="ignore"):
        hx = dy * e2z - dz * e2y
        hy = dz * e2x - dx * e2z
        hz = dx * e2y - dy * e2x
        det = e1x * hx + e1y * hy + e1z * hz
        sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
        u = sx * hx + sy * hy + sz * hz
        qx = sy * e1z - sz * e1y
        qy = sz * e1x - sx * e1z
        qz = sx * e1y - sy * e1x
        v = dx * qx + dy * qy + dz * qz
        t = e2x * qx + e2y * qy + e2z * qz
    return np.stack([det, u, v, t]).astype(F)


def _mesh_rows(scale, shift, n_pad):
    """An icosphere's 80 rows (v0, e1, e2) scaled and shifted, then
    padding rows (e1 = e2 = 0 at the last v0) up to ``n_pad``."""
    verts, faces = make_icosphere(1)
    verts = (np.asarray(verts, F) * F(scale) + np.asarray(shift, F)).astype(F)
    v0, v1, v2 = (verts[faces[:, j]] for j in range(3))
    rows = np.concatenate([v0, v1 - v0, v2 - v0], axis=1).astype(F)
    pad = np.zeros((n_pad - len(rows), 9), F)
    pad[:, :3] = rows[-1, :3]
    return np.concatenate([rows, pad]).astype(F)


def _rays(rows, n, seed):
    """Rays from the origin, of unit length: aimed at vertices, edge
    midpoints and centroids of the real rows (u, v or u + v on their
    bounds), then seeded directions; and the edge rays of
    tools/sweep_edges.py."""
    rng = np.random.default_rng(seed)
    real = rows[np.any(rows[:, 3:] != 0, axis=1)]
    v0, e1, e2 = real[:, :3], real[:, 3:6], real[:, 6:9]
    aims = np.concatenate([v0, v0 + e1, v0 + F(0.5) * e1 + F(0.5) * e2,
                           v0 + (e1 + e2) / F(3.0)]).astype(F)
    d = np.concatenate([aims[rng.permutation(len(aims))[:n // 2]],
                        rng.normal(size=(n // 2, 3))]).astype(np.float64)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(F)
    o = np.zeros_like(d)
    eo, ed, _ = sweep_edges.edge_rays(5, 180)  # the edge kinds alone
    return (np.concatenate([o, np.asarray(eo, F)]),
            np.concatenate([d, np.asarray(ed, F)]))


@pytest.mark.parametrize("scene", ["unit", "near_origin", "scaled"])
def test_mesh_rays_through_lean_windows(scene):
    # Real rows against rays aimed at their vertices, edges and centres,
    # seeded rays and the edge rays: per window of 128 rows (80 real, the
    # rest padding) the reductions and the flat rule's key are the old
    # form's and the IEEE form's; the IEEE form is the plain version's
    # (ops/trace.py::_tri_keys). "scaled" is a 2^64 icosphere 0.5 from the
    # origin: its |det| lies at or past 2^126, so its keys set the
    # re-sweep flag, and the near triangles are hit.
    scale, shift = {"unit": (1.0, (0.0, 0.0, -3.0)),
                    "near_origin": (0.5, (0.1, -0.2, -0.6)),
                    "scaled": (2.0 ** 64, (0.0, 0.0, -2.0 ** 64 - 0.5))}[scene]
    rows = _mesh_rows(scale, shift, WIN)
    o, d = _rays(rows, 192, 7)
    dots = tri_dots(rows, o, d)
    plain = ttrace._tri_keys(
        [torch.from_numpy(rows[None, :, j].copy()) for j in range(9)],
        *[torch.from_numpy(x[:, j:j + 1].copy()) for x in (o, d)
          for j in range(3)]).numpy()
    ieee = np.stack([ieee_key(dots[:, i]) for i in range(len(o))])
    np.testing.assert_array_equal(_bits(plain), _bits(ieee))
    hits = flags = both = 0
    for i in range(len(o)):
        ray = dots[:, i]
        ref = window_reference(ray, 80)
        flagged = bool(old_key(ray, np.nan)[1][:80].any())
        flags += flagged
        hits += ref[1] < MISS2
        both += flagged and ref[1] < MISS2
        for outside in (np.nan, 1.0, -1.0):
            old = window_old(ray, 80, outside)
            assert old == (min(ref[0], BIGF_BITS), min(ref[1], MISS2)), i
            assert window_lean(ray, 80, outside) == old, i
            assert flat_lean(ray, FLAT_NOHIT, outside) == flat_old(
                ray, FLAT_NOHIT, outside), i
    assert hits >= 100
    if scene == "scaled":
        assert flags >= 200 and both >= 5
    else:
        assert flags == 0
