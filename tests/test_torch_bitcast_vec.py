"""The dtype bitcast as redesigned for Hopper (``csrc/dtype.cu``: a thread
takes 8 words of a row by two 16-byte loads and writes its 8 low and 8
high halves by one 16-byte store each), held on the CPU:

* a numpy model of that body's index map (``ops/dtype.py::group_map``:
  which words a thread loads and where its two stores land), applied to
  seeded words at 1, 8, 33 and 4,096 rows, equals the plain version
  (``bitcast_reference``) and the JAX package's ``bitcast_probe`` kernel
  (``scripts/probe_dtype.py``) in interpret mode, bit for bit;
* the wrapper's launch path: 4-byte aligned views raise before any
  launch, 8-byte aligned ones reach the launcher, and ``halves=False``
  allocates no halves buffer (the launch itself runs on a card only:
  ``tests/test_torch_cuda.py``).
"""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raytracing_tpu_torch.ops import _build  # noqa: E402
from raytracing_tpu_torch.ops import dtype as tdt  # noqa: E402

from torch_port_helpers import probe_script  # noqa: E402

COLS = tdt.COLS


def _words(rows: int, seed: int) -> np.ndarray:
    """Seeded 32-bit words [rows, 128], every bit pattern possible."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=(rows, COLS),
                        dtype=np.uint64).astype(np.uint32)


def _model(words: np.ndarray) -> np.ndarray:
    """The 16-byte body run thread by thread through ``group_map``: each
    thread's 8 words, its low halves stored from ``lo`` and its high
    halves from ``hi`` (int16 offsets)."""
    flat = words.reshape(-1)
    out = np.full(2 * flat.size, -1, np.int32)
    first, lo, hi = tdt.group_map(flat.size)
    k = np.arange(tdt.GROUP)
    group = flat[first[:, None] + k[None]]  # [threads, 8]
    out[lo[:, None] + k[None]] = (group & 0xFFFF).astype(np.int32)
    out[hi[:, None] + k[None]] = (group >> 16).astype(np.int32)
    assert (out >= 0).all()  # every output element written once
    return out.astype(np.uint16).view(np.int16).reshape(
        *words.shape[:-2], 2 * words.shape[-2], COLS)


class _Shape:
    """Stands in for the JAX probe's ``pl`` module: its ``pallas_call`` runs
    the probe's own kernel on ``x`` (any rows) instead of its fixed tile."""

    def __init__(self, pl, jnp, jax, x):
        self._pl, self._jnp, self._jax, self._x = pl, jnp, jax, x
        self.out = None

    def __getattr__(self, name):
        return getattr(self._pl, name)

    def pallas_call(self, kernel, **kw):
        rows = self._x.shape[0]
        kw["out_shape"] = self._jax.ShapeDtypeStruct((2 * rows, COLS),
                                                     self._jnp.int16)
        fn = self._pl.pallas_call(kernel, **kw)

        def call(*_):
            xf = self._jax.lax.bitcast_convert_type(
                self._jnp.asarray(self._x), self._jnp.float32)
            self.out = np.asarray(fn(xf))
            return self.out

        return call


def _jax_bitcast(words: np.ndarray) -> np.ndarray:
    import jax
    import jax.numpy as jnp

    mod = probe_script("probe_dtype")
    shim = _Shape(mod.pl, jnp, jax, words)
    saved, mod.pl = mod.pl, shim
    try:
        mod.bitcast_probe(True)
    finally:
        mod.pl = saved
    return shim.out


@pytest.mark.parametrize("rows", [1, 8, 33, 4096])
def test_group_map_model_equals_plain_and_jax(rows):
    words = _words(rows, seed=rows)
    want = tdt.bitcast_reference(
        torch.from_numpy(words.view(np.float32).copy())).numpy()
    got = _model(words)
    assert got.shape == want.shape == (2 * rows, COLS)
    assert np.array_equal(got, want)
    assert np.array_equal(got, _jax_bitcast(words))
    # Two tiles of the leading dimension: the map runs over rows, so a
    # tile boundary is a row boundary.
    two = np.stack([words, words[::-1]])
    want2 = tdt.bitcast_reference(torch.from_numpy(
        two.view(np.float32).copy())).numpy()
    assert np.array_equal(_model(two), want2)


def test_group_map_stores_are_16_byte_aligned_and_disjoint():
    words = 8 * COLS
    first, lo, hi = tdt.group_map(words)
    assert first.size == words // tdt.GROUP
    # Loads: two 16-byte words from a 32-byte aligned start, in order.
    assert (first * 4 % 32 == 0).all() and (np.diff(first) == 8).all()
    # Stores: 16-byte aligned (int16 offsets times 2 bytes), each of the
    # 2 * words halves written by exactly one store.
    assert (lo * 2 % 16 == 0).all() and (hi * 2 % 16 == 0).all()
    covered = np.concatenate([lo[:, None] + np.arange(8),
                              hi[:, None] + np.arange(8)]).ravel()
    assert np.array_equal(np.sort(covered), np.arange(2 * words))


class _Launches:
    """Stands in for ``_build`` in the wrapper's launch path: records each
    launch's arguments and counts it by its key (the card runs the kernel,
    not this sandbox)."""

    def __init__(self):
        self.calls = []
        self.launch_counts = collections.Counter()

    def launch(self, name, entry, device, *args, count):
        assert (name, entry) == ("dtype", "rt_dtype_bitcast_launch")
        self.calls.append((entry, device, args))
        self.launch_counts[count] += 1


def _aligned_view(offset_words: int, rows: int = 8) -> torch.Tensor:
    buf = torch.empty(rows * COLS + 4, dtype=torch.float32)
    view = buf[offset_words:offset_words + rows * COLS].view(rows, COLS)
    assert view.data_ptr() % 16 == offset_words * 4 % 16
    return view


def test_wrapper_checks_and_halves_buffer(monkeypatch):
    fake = _Launches()
    monkeypatch.setattr(tdt, "_build", fake)
    # 4-byte aligned views raise before any launch.
    for off in (1, 3):
        with pytest.raises(ValueError, match="8-byte aligned"):
            tdt._launch_bitcast(_aligned_view(off), halves=False)
    assert fake.calls == []
    # 8- and 16-byte aligned views reach the launcher (which picks the
    # pairs body or the 16-byte body from the pointers).
    allocs = []
    real_new_empty = torch.Tensor.new_empty

    def counted(self, *a, **kw):
        allocs.append(kw.get("dtype"))
        return real_new_empty(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "new_empty", counted)
    monkeypatch.setattr(torch, "zeros", None)  # no memset on the path
    for off, halves in ((2, False), (0, False), (0, True)):
        x = _aligned_view(off)
        allocs.clear()
        res = tdt._launch_bitcast(x, halves=halves)
        _, device, args = fake.calls[-1]
        assert args[0] == x.data_ptr() and args[3] == x.numel()
        if halves:
            out, hv = res
            assert allocs == [torch.int16, torch.int32]
            assert hv.shape == (2,) and args[2] == hv.data_ptr()
        else:
            out = res
            # One allocation, the output: no halves buffer is made.
            assert allocs == [torch.int16] and args[2] is None
        assert out.shape == (16, COLS) and out.dtype == torch.int16
        assert args[1] == out.data_ptr()
    assert fake.launch_counts == {"dtype_bitcast": 3}
    with pytest.raises(ValueError, match="contiguous"):
        tdt._launch_bitcast(torch.empty(8, 2 * COLS)[:, ::2], halves=False)
    assert _build is not fake
