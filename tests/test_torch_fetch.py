"""Port vs JAX package: the winner fetch (``ops/fetch.py``).

The JAX package's radix fetch (``_gather_cols``: ``_fold_half``,
``_fold8``, the select over 512-row windows) and its one-hot matrix-unit
fetch (``_gather_mxu``) run in a test-only ``pallas_call`` in TPU-interpret
mode, as ``tests/test_pallas.py`` runs its fetch test kernel, on the same
tables and selections as the port's plain versions in their three modes.
Tolerance: none. Every mode must give the table's words bit for bit as
int32, the hazard words included (the gray albedo word 0x80008000 is a
subnormal float32 pattern, the white dielectric word 0xFFFFFFFF a NaN).
The chain and loop forms of ``scripts/probe_mxu_chain.py`` and
``scripts/probe_mxu_loop.py`` are held the same way, and the route
variables are read as the JAX package reads them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import raytracing_tpu as rt  # noqa: E402
from raytracing_tpu.ops.pallas import trace as ptrace  # noqa: E402
from raytracing_tpu.scene.types import SceneBuilder  # noqa: E402

from raytracing_tpu_torch.ops import fetch as tfetch  # noqa: E402
from raytracing_tpu_torch.ops import trace as ttrace  # noqa: E402

from torch_port_helpers import COVER, to_port  # noqa: E402

T_SUB = 8  # selections: (T_SUB, 128) lanes, as in the JAX test kernel
N_COLS = 6
HAZARDS = (np.int32(-2147450880), np.int32(-1))  # 0x80008000, 0xFFFFFFFF


def _hazard_scene():
    """tests/test_pallas.py's fetch scene: a gray lambertian ground (w1 =
    0x80008000), a white dielectric (0xFFFFFFFF) and 40 metal spheres."""
    b = SceneBuilder()
    b.add_lambertian_sphere((0.0, -100.0, 0.0), 99.0, (0.5, 0.5, 0.5))
    b.add_dielectric_sphere((1.0, 1.0, 0.0), 1.0, 1.5)
    for i in range(40):
        b.add_metallic_sphere(
            (float(i % 7), 0.2, float(i // 7)), 0.2,
            ((i % 5) / 4.0, (i % 3) / 2.0, (i % 7) / 6.0), 0.1,
        )
    return b.build()


def _scene(name):
    if name == "hazard":
        return _hazard_scene()
    if name == "cover":
        return rt.load_and_build(COVER)[1]
    return rt.make_world_stress(2048, image_width=64)[1]  # 2,048 rows


def _selection(name, n, n_pad, seed=0):
    rng = np.random.default_rng(seed)
    sel = rng.integers(0, n_pad, size=(T_SUB, 128)).astype(np.int32)
    if name == "hazard":  # every real row, the hazard rows among them
        sel = sel % np.int32(n)
    return sel


def _jax_fetch(shade, planes, sel, n_pad):
    """The JAX package's two fetches of the same selections, in one
    interpret-mode kernel: (radix, one-hot) as int32 [6, T_SUB, 128]."""

    def kernel(shade_ref, mxu_ref, sel_ref, oa, ob):
        s = sel_ref[...]
        a = ptrace._gather_cols(shade_ref, range(N_COLS), s, n_rows=n_pad,
                                t_sub=T_SUB)
        b = ptrace._gather_mxu(mxu_ref, s, n_pad=n_pad, t_sub=T_SUB,
                               n_cols=N_COLS)
        for c in range(N_COLS):
            oa[c] = a[c]
            ob[c] = pltpu.bitcast(b[c], jnp.float32)

    oa, ob = pl.pallas_call(
        kernel,
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 3,
        out_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_shape=[jax.ShapeDtypeStruct((N_COLS, T_SUB, 128), jnp.float32)] * 2,
        interpret=ptrace._interp(True),
    )(shade, planes, jnp.asarray(sel))
    return (np.asarray(oa).view(np.int32), np.asarray(ob).view(np.int32))


@pytest.fixture(scope="module", params=["hazard", "cover", "stress2048"])
def fetched(request):
    """(name, port table words [N_pad, 6], selections, JAX radix and
    one-hot outputs) of one scene."""
    name = request.param
    js = _scene(name)
    _, _, shade, n = ptrace.pack_scene(js)
    planes = ptrace.pack_scene(js, with_planes=N_COLS)[4]
    n_pad = shade.shape[0]
    sel = _selection(name, n, n_pad)
    radix, onehot = _jax_fetch(shade, planes, sel, n_pad)
    port = ttrace.pack_scene(to_port(js)).shade.view(torch.int32)[:, :N_COLS]
    # The port's table is the JAX package's, bit for bit.
    np.testing.assert_array_equal(port.numpy(),
                                  np.asarray(shade).view(np.int32)[:, :N_COLS])
    return name, port, sel, radix, onehot


@pytest.mark.parametrize("mode", ["index", "radix", "onehot", "radix16"])
def test_plain_fetch_matches_jax_radix_and_onehot(fetched, mode):
    name, table, sel, radix, onehot = fetched
    got = tfetch.fetch_rows_reference(
        table, torch.from_numpy(sel.reshape(-1)), mode
    ).numpy()
    want = np.moveaxis(radix, 0, -1).reshape(-1, N_COLS)
    np.testing.assert_array_equal(got, want)
    # The JAX package's own two fetches agree (its test kernel's claim).
    np.testing.assert_array_equal(radix, onehot)
    if name == "hazard":
        for w in HAZARDS:  # the patterns a float op would corrupt
            assert (got == w).any()


def _chain_jax(shade, planes, sel, n_pad):
    """scripts/probe_mxu_chain.py's kernel: a fetch, a selection derived
    from its words, a fetch again, by both JAX fetches: int32 [2 (radix,
    one-hot), 6, 2 (step), T_SUB, 128]."""

    def kernel(shade_ref, mxu_ref, sel_ref, oa, ob):
        s1 = sel_ref[...]
        c1 = ptrace._gather_mxu(mxu_ref, s1, n_pad=n_pad, t_sub=T_SUB,
                                n_cols=N_COLS)
        h = pltpu.bitcast(c1[0], jnp.int32) ^ pltpu.bitcast(c1[4], jnp.int32)
        s2 = jnp.abs(h) & (n_pad - 1)
        c2 = ptrace._gather_mxu(mxu_ref, s2, n_pad=n_pad, t_sub=T_SUB,
                                n_cols=N_COLS)
        r1 = ptrace._gather_cols(shade_ref, range(N_COLS), s1, n_rows=n_pad,
                                 t_sub=T_SUB)
        r2 = ptrace._gather_cols(shade_ref, range(N_COLS), s2, n_rows=n_pad,
                                 t_sub=T_SUB)
        for c in range(N_COLS):
            oa[c, 0] = r1[c]
            oa[c, 1] = r2[c]
            ob[c, 0] = pltpu.bitcast(c1[c], jnp.float32)
            ob[c, 1] = pltpu.bitcast(c2[c], jnp.float32)

    shape = jax.ShapeDtypeStruct((N_COLS, 2, T_SUB, 128), jnp.float32)
    oa, ob = pl.pallas_call(
        kernel,
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 3,
        out_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_shape=[shape] * 2,
        interpret=ptrace._interp(True),
    )(shade, planes, jnp.asarray(sel))
    return np.stack([np.asarray(oa).view(np.int32),
                     np.asarray(ob).view(np.int32)])


def _loop_jax(shade, planes, sel, n_pad, iters, use_mxu):
    """scripts/probe_mxu_loop.py's kernel: ``iters`` fetches, each
    selection fed back from the words so far; returns the hash h."""

    def kernel(shade_ref, mxu_ref, sel_ref, out_ref):
        def body(k, carry):
            s, acc = carry
            if use_mxu:
                cols = ptrace._gather_mxu(mxu_ref, s, n_pad=n_pad,
                                          t_sub=T_SUB, n_cols=N_COLS)
            else:
                cols = ptrace._gather_cols(shade_ref, range(N_COLS), s,
                                           n_rows=n_pad, t_sub=T_SUB)
            h = acc
            for c in cols:
                h = h ^ pltpu.bitcast(c, jnp.int32)
            return (jnp.abs(h) + k) & (n_pad - 1), h

        s0 = sel_ref[...]
        _, h = jax.lax.fori_loop(0, iters, body, (s0, jnp.zeros_like(s0)))
        out_ref[...] = h

    out = pl.pallas_call(
        kernel,
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 3,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((T_SUB, 128), jnp.int32),
        interpret=ptrace._interp(True),
    )(shade, planes, jnp.asarray(sel))
    return np.asarray(out)


@pytest.fixture(scope="module")
def cover_tables():
    js = rt.load_and_build(COVER)[1]
    _, _, shade, _ = ptrace.pack_scene(js)
    planes = ptrace.pack_scene(js, with_planes=N_COLS)[4]
    port = ttrace.pack_scene(to_port(js)).shade.view(torch.int32)[:, :N_COLS]
    return shade, planes, port


@pytest.fixture(scope="module")
def chain_jax(cover_tables):
    """The chain's selections and the JAX outputs (both fetches agree)."""
    shade, planes, table = cover_tables
    n_pad = table.shape[0]
    sel = np.random.default_rng(3).integers(0, n_pad, size=(T_SUB, 128))
    sel = sel.astype(np.int32)
    want = _chain_jax(shade, planes, sel, n_pad)
    np.testing.assert_array_equal(want[0], want[1])
    return sel, want


@pytest.fixture(scope="module")
def loop_jax(cover_tables):
    """The loop's selections and the JAX hash after 8 fetches (the radix
    and one-hot loops agree)."""
    shade, planes, table = cover_tables
    n_pad = table.shape[0]
    sel = np.random.default_rng(2).integers(0, n_pad, size=(T_SUB, 128))
    sel = sel.astype(np.int32)
    want_radix = _loop_jax(shade, planes, sel, n_pad, 8, use_mxu=False)
    want_mxu = _loop_jax(shade, planes, sel, n_pad, 8, use_mxu=True)
    np.testing.assert_array_equal(want_radix, want_mxu)
    return sel, want_radix


@pytest.mark.parametrize("mode", ["index", "radix", "onehot"])
def test_chain_matches_jax(cover_tables, chain_jax, mode):
    # Fetch, derive a selection from the words, fetch again: the port's
    # plain version against both JAX fetches.
    table = cover_tables[2]
    n_pad = table.shape[0]
    sel, want = chain_jax
    s1 = torch.from_numpy(sel.reshape(-1))
    c1 = tfetch.fetch_rows_reference(table, s1, mode)
    s2 = (c1[:, 0] ^ c1[:, 4]).long().abs() & (n_pad - 1)
    c2 = tfetch.fetch_rows_reference(table, s2, mode)
    for step, c in enumerate((c1, c2)):
        np.testing.assert_array_equal(
            c.numpy(), np.moveaxis(want[0][:, step], 0, -1).reshape(-1, N_COLS)
        )


@pytest.mark.parametrize("mode", ["index", "radix", "onehot"])
def test_loop_matches_jax(cover_tables, loop_jax, mode):
    # 8 fetches in a data-dependent loop: the port's hash and selections
    # against the JAX radix and one-hot loops, and fetch_loop_reference's
    # (and fetch_rows' on the CPU) last words against the loop's.
    table = cover_tables[2]
    n_pad, iters = table.shape[0], 8
    sel, want_radix = loop_jax
    s = torch.from_numpy(sel.reshape(-1)).long()
    h = torch.zeros(s.shape, dtype=torch.int32)
    for k in range(iters):
        w = tfetch.fetch_rows_reference(table, s, mode)
        for c in range(N_COLS):
            h = h ^ w[:, c]
        s = tfetch.next_selection(h, k, n_pad)
    np.testing.assert_array_equal(h.numpy(), want_radix.reshape(-1))
    sel_t = torch.from_numpy(sel.reshape(-1))
    last = tfetch.fetch_loop_reference(table, sel_t, mode, iters)
    np.testing.assert_array_equal(last.numpy(), w.t().numpy())
    got = tfetch.fetch_rows(table.contiguous(), sel_t, mode, iters)
    assert got.shape == (N_COLS, sel.size) and torch.equal(got, last)


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 128, 1024, 4096])
def test_tournament_every_table_size(n):
    # The literal tournament at every power-of-two size the route meets:
    # two-level windows (2 ... 512 of them), tables past one 512-row
    # window, and tables narrower than _fold8's 8 rows.
    rng = np.random.default_rng(n)
    table = torch.from_numpy(
        rng.integers(-2**31, 2**31, size=(n, 3), dtype=np.int64)
        .astype(np.int32)
    )
    sel = torch.from_numpy(rng.integers(0, n, size=300))
    for mode in ("radix", "onehot"):
        got = tfetch.fetch_rows_reference(table, sel, mode)
        assert torch.equal(got, table[sel])


def test_window_collapse_and_fold():
    # The two-level stage 2: each lane's 128-row window, and the winner
    # folded out of it, equal the indexed loads.
    rng = np.random.default_rng(5)
    words = torch.from_numpy(
        rng.integers(-2**31, 2**31, size=(1024, 11), dtype=np.int64)
        .astype(np.int32)
    )
    win = torch.from_numpy(rng.integers(0, 8, size=64))
    rows = torch.from_numpy(rng.integers(0, 128, size=64))
    for mode in ("index", "radix", "onehot"):
        col = tfetch.collapse_windows_reference(words, win, 128, mode)
        assert torch.equal(col, words.view(8, 128, 11)[win])
        got = tfetch.fold_rows_reference(col, rows, mode)
        assert torch.equal(got, words[win * 128 + rows])


_ENV = [
    (None, None), ("mxu", None), ("radix", None), ("RADIX", None),
    ("", None), ("index", None), (None, "1"), (None, "0"), (None, "false"),
    (None, ""), ("radix", "0"), ("radix", "1"), ("mxu", "0"),
]


@pytest.mark.parametrize("gather, two_level_mxu", _ENV)
def test_env_settings_read_as_the_jax_package_reads_them(
        monkeypatch, gather, two_level_mxu):
    # Values the JAX package does not know are its defaults, not errors:
    # the same environment picks the same route in both packages.
    for var, val in (("RT_GATHER", gather), ("RT_TWO_LEVEL_MXU", two_level_mxu)):
        if val is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, val)
    rows, windows = tfetch.env_settings()
    assert rows == (not ptrace._mxu_enabled())
    # At a two-level size (8,192 sphere rows, 1,024 triangle rows).
    assert windows == (not ptrace._two_level_mxu(8192))
    assert windows == (not ptrace._two_level_mxu(1024, tri=True))
    assert tfetch.route_flags(None) == (rows, windows)
    assert ttrace.gather_route() == (
        "radix" if rows else "windows" if windows else "index")


def test_gather_argument_overrides_the_environment(monkeypatch):
    monkeypatch.setenv("RT_GATHER", "radix")
    assert tfetch.route_flags("index") == (False, False)
    assert tfetch.route_flags("windows") == (False, True)
    monkeypatch.setenv("RT_GATHER", "mxu")
    assert tfetch.route_flags("radix") == (True, True)
    with pytest.raises(ValueError, match="gather must be"):
        tfetch.route_flags("mxu")


def test_fetch_rows_validates_its_inputs():
    table = torch.zeros((128, 6), dtype=torch.int32)
    sel = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        tfetch.fetch_rows(table[:96], sel)
    with pytest.raises(ValueError, match="columns"):
        tfetch.fetch_rows(torch.zeros((128, 17), dtype=torch.int32), sel)
    with pytest.raises(TypeError):
        tfetch.fetch_rows(table.float(), sel)
    with pytest.raises(TypeError):
        tfetch.fetch_rows(table, sel.long())
    with pytest.raises(ValueError, match="unknown fetch mode"):
        tfetch.fetch_rows(table, sel, "mxu")
    with pytest.raises(ValueError, match="iters"):
        tfetch.fetch_rows(table, sel, "radix", 0)
