"""Port vs JAX package: the worklist probe.

The port's plain version (``ops/worklist.py``) against the JAX package's
probe kernel (``scripts/probe_worklist.py``'s ``build``, TPU-interpret
mode) with its ``REPS`` set to 2 on the imported module, on its own inputs
at pass fractions 4/8 and 8/8. The JAX side runs in a process without
XLA-CPU's FMA: there every mode is bit-equal to the port's, the wrapping
sum included (in process, where XLA-CPU contracts multiply-adds in the
sweep quadratic, 93.7-99.0% of the sums agree). The modes' own
equalities, measured on both sides: ``conds`` equals ``worklist`` at every
fraction; ``static`` equals them at 8/8 only (it sweeps every group of a
voted block, and the probe's vote table is not conservative).
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from raytracing_tpu_torch.ops import worklist as twl  # noqa: E402

from torch_port_helpers import jax_arrays_without_fma, probe_script  # noqa: E402

REPS = 2
FRACTIONS = (4, 8)


@pytest.fixture(scope="module")
def jax_no_fma(tmp_path_factory):
    """(mode, pass_groups) -> the JAX probe's output without XLA-CPU's
    FMA."""
    code = (
        "m = h.probe_script('probe_worklist'); m.REPS = %d\n"
        "out = {f'{mode}_{pg}': np.asarray(m.build(mode, interpret=True)("
        "*m._inputs(pass_groups=pg))) for mode in %r for pg in %r}"
        % (REPS, twl.MODES, FRACTIONS)
    )
    arrays = jax_arrays_without_fma(tmp_path_factory.mktemp("wl"), code)
    return {(k.split("_")[0], int(k.split("_")[1])): v
            for k, v in arrays.items()}


@pytest.fixture(scope="module")
def port():
    """(mode, pass_groups) -> the port's plain version on the same inputs."""
    out = {}
    for pg in FRACTIONS:
        tab, rays, votes = twl.inputs(pg)
        for mode in twl.MODES:
            out[mode, pg] = twl.worklist_probe(tab, rays[None], votes, REPS,
                                               mode)[0].numpy()
    return out


@pytest.mark.parametrize("pass_groups", FRACTIONS)
@pytest.mark.parametrize("mode", twl.MODES)
def test_plain_matches_jax_probe_bit_for_bit(jax_no_fma, port, mode,
                                             pass_groups):
    got = port[mode, pass_groups]
    want = jax_no_fma[mode, pass_groups]
    assert got.dtype == want.dtype == np.int32
    assert got.shape == want.shape == (8, 128)
    assert np.array_equal(got, want)
    # The sum of two passes wraps for rays with no hit (2 x _NOHIT).
    assert (got < 0).any()


def test_mode_equalities(jax_no_fma, port):
    for side in (jax_no_fma, port):
        for pg in FRACTIONS:
            assert np.array_equal(side["conds", pg], side["worklist", pg])
        assert np.array_equal(side["static", 8], side["conds", 8])
        assert not np.array_equal(side["static", 4], side["conds", 4])


@pytest.mark.parametrize("pass_groups", [1, 2, 4, 8])
def test_inputs_are_the_jax_probes(pass_groups):
    m = probe_script("probe_worklist")
    want = m._inputs(pass_groups=pass_groups)
    got = twl.inputs(pass_groups)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert twl._NOHIT == m._NOHIT
    assert twl.swept_pairs(got[2], "conds") == 8 * pass_groups


def test_payloads_and_units():
    tab, rays, votes = twl.inputs(2)
    pay = twl.payloads(rays, 2)
    assert pay.shape == (2, 48, 128) and torch.equal(pay[0], rays)
    out = twl.worklist_probe(tab, pay, votes, 1, "conds")
    # Each unit is its own payload.
    assert torch.equal(out[1], twl.worklist_probe(tab, pay[1:2], votes, 1,
                                                  "conds")[0])
    assert not torch.equal(out[0], out[1])
    # Zero passes sum to zero.
    assert not twl.worklist_probe(tab, pay, votes, 0, "static").any()


def test_wrapper_checks():
    tab, rays, votes = twl.inputs(4)
    with pytest.raises(ValueError, match="mode"):
        twl.worklist_probe(tab, rays[None], votes, 1, "warp")
    with pytest.raises(ValueError, match="rays"):
        twl.worklist_probe(tab, rays, votes, 1, "conds")
    with pytest.raises(ValueError, match="votes"):
        twl.worklist_probe(tab, rays[None], votes.float(), 1, "conds")
    with pytest.raises(ValueError, match="reps"):
        twl.worklist_probe(tab, rays[None], votes, -1, "conds")
