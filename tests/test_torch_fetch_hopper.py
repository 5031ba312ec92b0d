"""Port vs JAX package: the plain models of the Hopper winner fetch.

``ops/fetch.py`` models the card's two fetch designs step by step:

* ``exchange_reference`` is the radix route's warp exchange
  (``csrc/fetch.cuh``): the lanes of a warp that reach the fetch together
  walk the table in chunks of as many rows as they are, lane of rank r
  reading row i0 + r, and take each word from the lane of rank
  ``sel - i0``. It is held against the JAX package's radix fetch
  (``_gather_cols``: ``_fold_half``, ``_fold8``, the select over 512-row
  windows), run in a ``pallas_call`` in TPU-interpret mode as
  ``tests/test_pallas.py`` runs it, on seeded tables of 1 to 8,192 rows
  and the hazard scene's table, under five groups: every lane, one lane a
  warp, alternate lanes, seeded masks, and a ragged last warp.
  ``_gather_cols`` folds at least 8 rows (``_fold8``), so tables of fewer
  rows reach it padded with zero rows to 8; no lane selects a padding row.
* ``plane_table_reference`` is the one-hot mode's bf16 planes (the
  prepass ``fetch_planes`` writes them): held bit for bit against
  ``_plane_table_int`` and ``_plane_table`` (padding included), and
  ``plane_tiles_reference`` is their layout in the prepass's scratch.
* ``onehot_product_reference`` is the product over those planes, held
  against ``_gather_mxu`` in interpret mode.

Tolerance: none. Every word must be the table's, as int32, the hazard
words included (0x80008000 is a subnormal float32 pattern, 0xFFFFFFFF a
NaN).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from raytracing_tpu.ops.pallas import trace as ptrace  # noqa: E402
from raytracing_tpu.scene.types import SceneBuilder  # noqa: E402

from raytracing_tpu_torch.ops import fetch as tfetch  # noqa: E402
from raytracing_tpu_torch.ops import trace as ttrace  # noqa: E402

from torch_port_helpers import to_port  # noqa: E402

ROWS = (1, 2, 4, 32, 64, 512, 8192)
COLS = (1, 3, 4, 6, 16)
T_SUB = 2
LANES = T_SUB * 128  # 8 warps
RAGGED = 200  # lanes of the ragged case: its last warp holds 8
HAZARDS = (np.int32(-2147450880), np.int32(-1))  # 0x80008000, 0xFFFFFFFF
TABLES = (*ROWS, "hazard")


def _hazard_words():
    """tests/test_pallas.py's fetch scene, packed by the port: a gray
    lambertian ground (w1 = 0x80008000), a white dielectric (0xFFFFFFFF)
    and 40 metal spheres; its shade words [64, 6] and real row count."""
    b = SceneBuilder()
    b.add_lambertian_sphere((0.0, -100.0, 0.0), 99.0, (0.5, 0.5, 0.5))
    b.add_dielectric_sphere((1.0, 1.0, 0.0), 1.0, 1.5)
    for i in range(40):
        b.add_metallic_sphere(
            (float(i % 7), 0.2, float(i // 7)), 0.2,
            ((i % 5) / 4.0, (i % 3) / 2.0, (i % 7) / 6.0), 0.1,
        )
    js = b.build()
    shade = ttrace.pack_scene(to_port(js), cull=False).shade
    return shade.view(torch.int32)[:, :6].numpy().copy(), js.num_objects


def _table(name):
    """(int32 words [N, C], selections [LANES] in [0, real rows))."""
    if name == "hazard":
        words, real = _hazard_words()
    else:
        rng = np.random.default_rng(name)
        words = rng.integers(-2**31, 2**31, size=(name, 16)).astype(np.int32)
        real = name
    rng = np.random.default_rng(1000 + words.shape[0])
    sel = rng.integers(0, real, size=LANES).astype(np.int32)
    return words, sel


def _pallas(kernel, inputs, out_shape):
    return pl.pallas_call(
        kernel,
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * len(inputs),
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=out_shape,
        interpret=ptrace._interp(True),
    )(*inputs)


def _jax_gather_cols(words, sel):
    """``_gather_cols`` of every column: int32 [LANES, C]."""
    n, c = words.shape
    if n < 8:
        words = np.concatenate([words, np.zeros((8 - n, c), np.int32)])
    rows = words.shape[0]

    def kernel(t_ref, s_ref, o_ref):
        outs = ptrace._gather_cols(t_ref, range(c), s_ref[...], n_rows=rows,
                                   t_sub=T_SUB)
        for j in range(c):
            o_ref[j] = outs[j]

    out = _pallas(kernel, [jnp.asarray(words.view(np.float32)),
                           jnp.asarray(sel.reshape(T_SUB, 128))],
                  jax.ShapeDtypeStruct((c, T_SUB, 128), jnp.float32))
    return np.moveaxis(np.asarray(out).view(np.int32), 0, -1).reshape(-1, c)


def _jax_gather_mxu(words, sel):
    """``_gather_mxu`` over ``_plane_table_int``'s planes: int32 [LANES,
    C]."""
    n, c = words.shape
    planes = ptrace._plane_table_int([jnp.asarray(words[:, j]) for j in
                                      range(c)], n)

    def kernel(p_ref, s_ref, o_ref):
        outs = ptrace._gather_mxu(p_ref, s_ref[...], n_pad=n, t_sub=T_SUB,
                                  n_cols=c)
        for j in range(c):
            o_ref[j] = outs[j]

    out = _pallas(kernel, [planes, jnp.asarray(sel.reshape(T_SUB, 128))],
                  jax.ShapeDtypeStruct((c, T_SUB, 128), jnp.int32))
    return np.moveaxis(np.asarray(out), 0, -1).reshape(-1, c)


_CACHE = {}


def _jax(name, fn):
    """One JAX fetch of every column of a table, computed once."""
    key = (name, fn.__name__)
    if key not in _CACHE:
        words, sel = _table(name)
        _CACHE[key] = fn(words, sel)
    return _CACHE[key]


def _mask(kind, lanes):
    """The active lanes of a group kind (None: every lane)."""
    lane = torch.arange(lanes)
    if kind == "one":
        return lane % 32 == 5
    if kind == "alternate":
        return lane % 2 == 0
    if kind == "seeded":
        return torch.from_numpy(np.random.default_rng(7).random(lanes) < 0.4)
    return None


@pytest.mark.parametrize("kind", ["all", "one", "alternate", "seeded",
                                  "ragged"])
@pytest.mark.parametrize("name", TABLES)
def test_exchange_matches_jax_gather_cols(name, kind):
    words, sel = _table(name)
    want_all = _jax(name, _jax_gather_cols)
    # The JAX package's radix fetch gives the table's rows.
    np.testing.assert_array_equal(want_all, words[sel])
    lanes = RAGGED if kind == "ragged" else LANES
    active = _mask(kind, lanes)
    act = np.ones(lanes, bool) if active is None else active.numpy()
    for c in (c for c in COLS if c <= words.shape[1]):
        got = tfetch.exchange_reference(
            torch.from_numpy(words[:, :c].copy()),
            torch.from_numpy(sel[:lanes]), active,
        ).numpy()
        want = np.where(act[:, None], want_all[:lanes, :c], 0)
        np.testing.assert_array_equal(got, want)
    if name == "hazard":
        for w in HAZARDS:  # the patterns a float move would corrupt
            assert (got[act] == w).any()


def test_exchange_group_sizes():
    # Every group size from one lane to a full warp on one 8,192-row
    # table: the walk takes ceil(N / m) chunks and keeps every word.
    words, sel = _table(8192)
    w = torch.from_numpy(words[:, :3].copy())
    s = torch.from_numpy(sel[:32])
    for m in range(1, 33):
        active = torch.arange(32) < m
        got = tfetch.exchange_reference(w, s, active)
        assert torch.equal(got[:m], w[s[:m].long()])
        assert not got[m:].any()
    # A lane of the group that selects no row (-1: regen.cu's chunked
    # body and texel, lanes with nothing to fetch) keeps zeros; the others
    # are unchanged. Tables of at most 4 rows are swept.
    none = s.clone()
    none[::3] = -1
    for n in (2, 4, 8192):
        sel_n = torch.where(none >= 0, none % n, -1)
        got = tfetch.exchange_reference(w[:n], sel_n)
        for lane in range(32):
            want = (torch.zeros(3, dtype=torch.int32) if lane % 3 == 0 else
                    w[int(sel_n[lane])])
            assert torch.equal(got[lane], want)


@pytest.mark.parametrize("cols", COLS)
def test_plane_table_matches_jax(cols):
    # The prepass's planes, transposed, are _plane_table_int's bit for bit
    # (rows past 4C zero, as its pad to a multiple of 8), and
    # _plane_table's on the same words as float32.
    for n in ROWS:
        words = _table(n)[0][:, :cols]
        got = tfetch.plane_table_reference(torch.from_numpy(words.copy()))
        assert got.dtype == torch.bfloat16
        assert got.shape == (n, tfetch.plane_shape(n, cols)[1])
        got32 = got.to(torch.float32).t().contiguous().numpy()
        want = np.asarray(ptrace._plane_table_int(
            [jnp.asarray(words[:, j]) for j in range(cols)], n))
        np.testing.assert_array_equal(got32.view(np.int32),
                                      want.view(np.int32))
        probe = np.asarray(ptrace._plane_table(
            jnp.asarray(words.view(np.float32)), cols))
        np.testing.assert_array_equal(got32.view(np.int32),
                                      probe.view(np.int32))


@pytest.mark.parametrize("cols", COLS)
def test_plane_tiles_layout(cols):
    # The scratch the prepass writes: K-major 8 x 8 core matrices, core
    # (k // 8, n // 8) at ((k // 8) * N / 8 + n // 8) * 64 halves, row n % 8
    # at stride 8; zero rows pad the table to K. fetch_planes runs this
    # plain version on CPU tensors.
    for n in (1, 64, 512):
        words = torch.from_numpy(_table(n)[0][:, :cols].copy())
        planes = tfetch.plane_table_reference(words)
        k_pad, width = tfetch.plane_shape(n, cols)
        tiles = tfetch.plane_tiles_reference(planes)
        assert tiles.shape == (k_pad * width,) and tiles.dtype == torch.int16
        bits = planes.view(torch.int16)
        k = torch.arange(k_pad)[:, None]
        col = torch.arange(width)[None, :]
        off = ((k // 8) * (width // 8) + col // 8) * 64 + (col % 8) * 8 + k % 8
        full = torch.zeros((k_pad, width), dtype=torch.int16)
        full[:n] = bits
        assert torch.equal(tiles[off], full)
        assert torch.equal(tfetch.fetch_planes(words), tiles)


@pytest.mark.parametrize("name", TABLES)
def test_onehot_product_matches_jax_gather_mxu(name):
    # The product over the prepass's planes, column subsets included,
    # against the JAX package's one-hot matrix-unit fetch.
    words, sel = _table(name)
    want_all = _jax(name, _jax_gather_mxu)
    np.testing.assert_array_equal(want_all, words[sel])
    for c in (c for c in COLS if c <= words.shape[1]):
        planes = tfetch.plane_table_reference(torch.from_numpy(
            words[:, :c].copy()))
        got = tfetch.onehot_product_reference(
            planes, torch.from_numpy(sel).long(), c).numpy()
        np.testing.assert_array_equal(got, want_all[:, :c])
