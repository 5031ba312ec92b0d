"""Port vs JAX package: the dtype probe.

The JAX package's probe (``scripts/probe_dtype.py``) runs as it stands:
``bitcast_probe`` in interpret mode with its ``pallas_call`` wrapped to keep
the output, and ``rate_probe``'s kernel built in interpret mode and called
outside ``jit`` (the probe times it under ``jit`` and never returns it;
``torch_port_helpers.rate_probe_kernel``).

Tolerances, as measured:

* ``bitcast``, f32 and int16: bit for bit. On ``rate_probe``'s own ``a``
  and ``b`` in this process, where XLA-CPU contracts ``s * b + s`` into an
  FMA (the port's f32_fma rounds once, like the card's ``__fmaf_rn``) and
  also the streams' ``a + (b + b) * i`` (which these inputs round alike
  either way). On seeded tiles, f32_select in a process whose XLA-CPU has
  no FMA (``jax_arrays_without_fma``: the port's set-up rounds the
  multiply and the add apart, as ``-fmad=false`` builds the card's).
* bf16: XLA-CPU rounds every bf16 operation to bf16 (the multiply and the
  add of an FMA apart), while the port rounds each FMA once, like
  ``__hfma2``. On ``rate_probe``'s inputs: equal at 4 steps; at 16 steps
  every one of the 2,048 elements is exactly 1 bf16 ulp apart. On seeded
  tiles the JAX kernel equals torch's own per-operation bf16 arithmetic
  bit for bit, so the difference is where the rounding falls; bf16_select
  (whose add is exact or rounds once either way) is bit-equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from raytracing_tpu_torch.ops import dtype as tdt  # noqa: E402
from raytracing_tpu_torch.tools import probe_dtype as pdt  # noqa: E402

from torch_port_helpers import (  # noqa: E402
    bits, jax_arrays_without_fma, probe_script, rate_probe_kernel)

_JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16, "i16": jnp.int16}


def _jax_dtype(mode):
    return _JNP[mode.split("_")[0]]


def _to_jax(t):
    """A CPU tensor as a JAX array of its dtype (bf16 through its bits)."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _bf16_ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in bf16 ulps between two arrays of bf16 bits."""
    def order(v):
        v = v.astype(np.int32)
        return np.where(v < 0, -32768 - v, v)
    return np.abs(order(a) - order(b))


@pytest.fixture(scope="module")
def jax_mod():
    return probe_script("probe_dtype")


class _Keep:
    def __init__(self, pl):
        self._pl = pl
        self.seen = {}

    def __getattr__(self, name):
        return getattr(self._pl, name)

    def pallas_call(self, kernel, **kw):
        fn = self._pl.pallas_call(kernel, **kw)

        def call(*args):
            out = fn(*args)
            self.seen["in"] = np.asarray(args[0])
            self.seen["out"] = np.asarray(out)
            return out

        return call


@pytest.fixture(scope="module")
def jax_bitcast(jax_mod):
    keep = _Keep(jax_mod.pl)
    saved, jax_mod.pl = jax_mod.pl, keep
    try:
        jax_mod.bitcast_probe(True)
    finally:
        jax_mod.pl = saved
    return keep.seen


@pytest.fixture(scope="module")
def jax_rates(jax_mod):
    """Each rate mode's JAX kernel on ``rate_probe``'s own inputs at 4 and
    16 steps, in this process."""
    out = {}
    for mode in tdt.RATE_MODES:
        a, b = tdt.inputs(tdt.mode_dtype(mode))
        for iters in (4, 16):
            f = rate_probe_kernel(jax_mod, _jax_dtype(mode),
                                  mode.split("_")[1], iters)
            out[mode, iters] = bits(f(_to_jax(a), _to_jax(b)))
    return out


@pytest.fixture(scope="module")
def jax_rates_seeded(tmp_path_factory):
    """The select modes and bf16_fma on seeded tiles at 4 and 16 steps, in a
    process whose XLA-CPU has no FMA."""
    code = """
import jax.numpy as jnp
import torch
from raytracing_tpu_torch.ops import dtype as tdt
m = h.probe_script("probe_dtype")
J = {"f32": jnp.float32, "bf16": jnp.bfloat16, "i16": jnp.int16}
def to_jax(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
    return jnp.asarray(t.numpy())
out = {}
for mode in ("f32_select", "bf16_fma", "bf16_select", "i16_select"):
    dt = tdt.mode_dtype(mode)
    a, b = tdt.seeded_inputs(dt, (tdt.default_rows(dt), 128), seed=1)
    for iters in (4, 16):
        f = h.rate_probe_kernel(m, J[mode.split("_")[0]], mode.split("_")[1],
                                iters)
        r = np.asarray(f(to_jax(a), to_jax(b)))
        out[f"{mode}_{iters}"] = r.view(np.int16 if r.itemsize == 2 else np.int32)
"""
    return jax_arrays_without_fma(tmp_path_factory.mktemp("dtype"), code)


def test_bitcast_input_is_the_jax_probes(jax_bitcast):
    x = tdt.bitcast_input()
    assert np.array_equal(bits(x), bits(jax_bitcast["in"]))


def test_plain_bitcast_matches_jax_probe_bit_for_bit(jax_bitcast):
    x = tdt.bitcast_input()
    out, halves = tdt.bitcast(x, halves=True)
    assert out.shape == (16, 128) == jax_bitcast["out"].shape
    assert np.array_equal(out.numpy(), jax_bitcast["out"])
    assert pdt.name_layout(out, x) == "interleave(lo,hi)"
    assert pdt.name_view_layout(x.view(torch.int16), x) == \
        "column-interleave(lo,hi)"
    # The first element of a 16-bit pair is the word's low half.
    assert halves.tolist() == [7, 7]


def test_plain_bitcast_of_many_tiles_is_tile_by_tile():
    rng = np.random.default_rng(2)
    words = rng.integers(-(1 << 31), 1 << 31, size=(3, 5, 8, 128),
                         dtype=np.int64).astype(np.int32)
    x = torch.from_numpy(words).view(torch.float32)
    out = tdt.bitcast(x)
    assert out.shape == (3, 5, 16, 128)
    for u in range(3):
        for v in range(5):
            assert torch.equal(out[u, v], tdt.bitcast(x[u, v].contiguous()))


def test_inputs_are_rate_probes():
    for dt, fill in ((torch.float32, (0.999, 0.6)),
                     (torch.bfloat16, (0.999, 0.6)), (torch.int16, (1, 1))):
        a, b = tdt.inputs(dt)
        assert a.shape == b.shape == (tdt.default_rows(dt), 128)
        assert torch.equal(a, torch.full_like(a, fill[0]))
        assert torch.equal(b, torch.full_like(b, fill[1]))


@pytest.mark.parametrize("iters", [4, 16])
@pytest.mark.parametrize("mode", ["f32_fma", "f32_select", "i16_select",
                                  "bf16_select"])
def test_plain_rate_matches_jax_probe_bit_for_bit(jax_rates, mode, iters):
    a, b = tdt.inputs(tdt.mode_dtype(mode))
    got = tdt.rate(a, b, mode, iters)
    assert np.array_equal(bits(got), jax_rates[mode, iters])


def test_plain_bf16_fma_within_one_ulp_of_jax_probe(jax_rates):
    a, b = tdt.inputs(torch.bfloat16)
    for iters, differ in ((4, 0), (16, 2048)):
        got = bits(tdt.rate(a, b, "bf16_fma", iters))
        ulps = _bf16_ulps(got, jax_rates["bf16_fma", iters])
        assert int((ulps != 0).sum()) == differ
        assert int(ulps.max()) == (1 if differ else 0)


@pytest.mark.parametrize("iters", [4, 16])
@pytest.mark.parametrize("mode", ["f32_select", "bf16_select", "i16_select"])
def test_plain_select_matches_jax_on_seeded_tiles(jax_rates_seeded, mode,
                                                  iters):
    dt = tdt.mode_dtype(mode)
    a, b = tdt.seeded_inputs(dt, (tdt.default_rows(dt), 128), seed=1)
    assert bool((b > (0 if dt == torch.int16 else 0.5)).any())
    assert bool((b <= (0 if dt == torch.int16 else 0.5)).any())
    got = tdt.rate(a, b, mode, iters)
    assert np.array_equal(bits(got), jax_rates_seeded[f"{mode}_{iters}"])


@pytest.mark.parametrize("iters", [4, 16])
def test_jax_bf16_fma_rounds_each_operation(jax_rates_seeded, iters):
    # The JAX kernel on XLA-CPU is torch's per-operation bf16 arithmetic,
    # bit for bit; the port's single rounding differs from both.
    a, b = tdt.seeded_inputs(torch.bfloat16, (16, 128), seed=1)
    i = torch.arange(tdt.STREAMS).view(-1, 1, 1).to(torch.bfloat16)
    s = a + (b + b) * i
    for _ in range(iters):
        s = s * b + s
    acc = s[0]
    for k in range(1, tdt.STREAMS):
        acc = acc + s[k]
    jax_bits = jax_rates_seeded[f"bf16_fma_{iters}"]
    assert np.array_equal(bits(acc), jax_bits)
    port = bits(tdt.rate(a, b, "bf16_fma", iters))
    assert (port != jax_bits).any()


def test_bf16_round_is_one_rounding():
    # 1 + 2^-8 + 2^-30 lies just above a bf16 tie: rounded once it goes up
    # to 1 + 2^-7; through f32 it first lands on the tie, then goes to even.
    x = torch.tensor([1.0 + 2.0 ** -8 + 2.0 ** -30, -(1.0 + 2.0 ** -8),
                      3.0e38, 1.0e39, 0.1], dtype=torch.float64)
    got = tdt._bf16_round(x)
    assert float(x[:1].float().to(torch.bfloat16)) == 1.0
    assert got.float().tolist()[:2] == [1.0078125, -1.0]
    assert torch.isinf(got[3]) and not torch.isinf(got[2])
    assert torch.equal(got[4:], x[4:].float().to(torch.bfloat16))


def test_rate_modes_step_count_and_streams():
    # At 0 steps every mode is the streams' sum (xor): the set-up alone.
    a, b = tdt.seeded_inputs(torch.float32, (2, 8, 128), seed=4)
    want = sum(a + (b + b) * float(i) for i in range(8))
    got = tdt.rate(a, b, "f32_select", 0)
    acc = a + (b + b) * 0.0
    for i in range(1, 8):
        acc = acc + (a + (b + b) * float(i))
    assert torch.equal(got, acc) and torch.allclose(got, want)
    assert tdt.element_steps(a.numel(), 16) == a.numel() * 8 * 16


def test_wrapper_checks():
    a, b = tdt.inputs(torch.float32)
    with pytest.raises(ValueError, match="mode"):
        tdt.rate(a, b, "f64_fma", 4)
    with pytest.raises(TypeError):
        tdt.rate(a, b, "bf16_fma", 4)
    with pytest.raises(ValueError, match="shape"):
        tdt.rate(a, b[:4], "f32_fma", 4)
    with pytest.raises(ValueError, match="iters"):
        tdt.rate(a, b, "f32_fma", -1)
    with pytest.raises(TypeError):
        tdt.bitcast(a.double())
    with pytest.raises(ValueError):
        tdt.bitcast(torch.zeros(8, 64))


def test_rate_bounds_and_sass_count():
    # The least time per stream step: issue-bound for the selects, the
    # 16-bit FMA at twice the f32 rate.
    assert [pdt.steps_per_cycle_bound(m) for m in tdt.RATE_MODES] == \
        [128.0, 64.0, 256.0, 128.0, 128.0]
    b = pdt.rate_bound_ms("f32_fma", 132 * 128 * 1_980_000, 0)
    assert b["bound_by"] == "operations" and abs(b["bound_ms"] - 1.0) < 1e-9
    sass = """
        Function : _ZN12_GLOBAL__N_111rate_kernelILi1EEEvPKjS2_Pjii
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0100*/                   FSEL R5, R2, R3, P0 ;
        /*0110*/                   FADD R2, R5, R2 ;
        /*0120*/                   NOP ;
        /*0130*/               @P1 BRA 0x100 ;
        /*0140*/                   FADD R4, R4, R2 ;
        /*0150*/              @!P2 BRA 0x140 ;
        /*0160*/                   EXIT ;
"""
    body = pdt.loop_bodies(sass)["_ZN12_GLOBAL__N_111rate_kernelILi1EEEvPKjS2_Pjii"]
    assert [t.split()[0] for t in body] == ["FSEL", "FADD", "NOP", "BRA"]
