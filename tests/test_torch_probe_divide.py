"""Port vs JAX package: the divide probe.

The JAX package's probe (``scripts/probe_divide.py``) runs as it stands,
``main`` with ``--interpret``, its ``pallas_call`` wrapped to keep the
kernel's inputs and outputs. The port's plain version
(``ops/divide.py``: ``torch.reciprocal`` and ``torch.div``) is bit-equal to
it: both are correctly rounded (the JAX probe prints max 0.500 / 0.499 ulp
on XLA-CPU).
"""

import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from raytracing_tpu_torch.ops import divide as tdiv  # noqa: E402

from torch_port_helpers import probe_script  # noqa: E402


class _Keep:
    """A stand-in for the probe's ``pl`` whose ``pallas_call`` keeps the
    kernel's inputs and outputs."""

    def __init__(self, pl):
        self._pl = pl
        self.seen = {}

    def __getattr__(self, name):
        return getattr(self._pl, name)

    def pallas_call(self, kernel, **kw):
        fn = self._pl.pallas_call(kernel, **kw)

        def call(*args):
            out = fn(*args)
            self.seen["in"] = [np.asarray(a) for a in args]
            self.seen["out"] = [np.asarray(o) for o in out]
            return out

        return call


@pytest.fixture(scope="module")
def jax_probe():
    m = probe_script("probe_divide")
    keep = _Keep(m.pl)
    saved, argv = m.pl, sys.argv
    m.pl, sys.argv = keep, ["probe_divide.py", "--interpret"]
    try:
        assert m.main() == 0
    finally:
        m.pl, sys.argv = saved, argv
    return keep.seen


def test_inputs_are_the_jax_probes(jax_probe):
    x, num = tdiv.inputs()
    assert np.array_equal(x.numpy(), jax_probe["in"][0])
    assert np.array_equal(num.numpy(), jax_probe["in"][1])


@pytest.mark.parametrize("mode", tdiv.MODES)
def test_plain_matches_jax_probe_bit_for_bit(jax_probe, mode):
    # On the CPU every mode runs the plain version: the correctly rounded
    # quotient each mode computes.
    x, num = tdiv.inputs()
    recip, quot = tdiv.divide(x, num, mode)
    assert np.array_equal(recip.numpy(), jax_probe["out"][0])
    assert np.array_equal(quot.numpy(), jax_probe["out"][1])


def test_ulp_error_is_the_probes():
    x, num = tdiv.inputs()
    recip, quot = tdiv.divide_reference(x, num)
    x64 = x.numpy().astype(np.float64)
    er = tdiv.ulp_error(recip.numpy(), 1.0 / x64)
    eq = tdiv.ulp_error(quot.numpy(), num.numpy().astype(np.float64) / x64)
    # The JAX probe's interpret-mode figures (max 0.500 / 0.499 ulp, mean
    # 0.2257 / 0.2154): the correctly rounded quotient.
    assert er.max() <= 0.5 and eq.max() <= 0.5
    assert abs(er.mean() - 0.2257) < 5e-5 and abs(eq.mean() - 0.2154) < 5e-5


def test_edge_set_is_correctly_rounded():
    x, num = tdiv.edge_inputs()
    assert x.shape == (20,)
    recip, quot = tdiv.divide(x, num)
    x64 = x.numpy().astype(np.float64)
    assert tdiv.ulp_error(recip.numpy(), 1.0 / x64).max() <= 0.5
    assert tdiv.ulp_error(quot.numpy(),
                          num.numpy().astype(np.float64) / x64).max() <= 0.5
    # safe_inv's clamp inverts to 1e30; past 2^126 the quotient is
    # subnormal (where __fdividef returns 0).
    assert recip[0].item() == pytest.approx(1e30, rel=1e-7)
    assert bool(((recip.abs() < 2.0 ** -126) == (x.abs() > 2.0 ** 126)).all())


def test_wrapper_checks():
    x, num = tdiv.inputs()
    with pytest.raises(ValueError, match="mode"):
        tdiv.divide(x, num, "exact")
    with pytest.raises(TypeError):
        tdiv.divide(x.double(), num)
    with pytest.raises(ValueError, match="shape"):
        tdiv.divide(x, num[:4])


_RAGGED = [1, 3, 4, 5, 255, 1023, 1024, 1025, 16_777_217]


@pytest.mark.parametrize("n", _RAGGED)
def test_plain_version_is_numpys_correctly_rounded_quotient(n):
    # The ragged sizes of the kernel's scalar tail: every mode's function
    # (the plain version on the CPU) equals numpy's f32 division, which is
    # correctly rounded, bit for bit.
    rng = np.random.default_rng(n)
    x = rng.uniform(0.5, 1.5, n).astype(np.float32)
    x *= rng.choice([-1.0, 1.0], n).astype(np.float32)
    num = rng.uniform(-4.0, 4.0, n).astype(np.float32)
    for mode in tdiv.MODES:
        recip, quot = tdiv.divide(torch.from_numpy(x), torch.from_numpy(num),
                                  mode)
        assert np.array_equal(recip.numpy().view(np.int32),
                              (np.float32(1.0) / x).view(np.int32))
        assert np.array_equal(quot.numpy().view(np.int32),
                              (num / x).view(np.int32))
