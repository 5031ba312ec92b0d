"""Port vs JAX package: the toolchain watcher's feature probes, and the
port's watcher itself.

The JAX package's four feature probes (``scripts/toolchain_watch.py``) run
as they stand with ``pallas_call`` in TPU-interpret mode and their output
kept; each reports ``works`` there, and the port's plain version of its
kernel (``ops/features.py``) is bit-equal to that output on the same
inputs. (The JAX hoisted-mask probe's own check is vacuous; the values are
compared here.) Then the port's watcher (``tools/toolchain_watch.py``):
its ledger (append, compare, exit 0 / 2) with an injected fingerprint, its
statuses, and ``--probe`` in a child process with ``--device cpu``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.experimental.pallas as jpl  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from raytracing_tpu_torch.ops import features as tfeat  # noqa: E402
from raytracing_tpu_torch.tools import toolchain_watch as tw  # noqa: E402

from torch_port_helpers import bits, probe_script  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PROBES = {"bf16_cmp": "_probe_bf16_vector_cmp",
              "i16_relayout": "_probe_i16_mask_relayout",
              "i16_hoisted": "_probe_i16_hoisted_mask",
              "dyn_gather": "_probe_dynamic_gather"}


@pytest.fixture(scope="module")
def jax_features():
    """Each JAX feature probe's status, inputs and kernel output in
    TPU-interpret mode."""
    mod = probe_script("toolchain_watch")
    real = jpl.pallas_call
    out = {}

    def keeping(kernel, **kw):
        fn = real(kernel, interpret=pltpu.InterpretParams(), **kw)

        def call(*args):
            res = fn(*args)
            seen["in"] = [np.asarray(a) for a in args]
            seen["out"] = np.asarray(res)
            seen["kernel"] = fn
            return res

        return call

    jpl.pallas_call = keeping
    try:
        for mode, name in JAX_PROBES.items():
            seen = {}
            seen["status"] = getattr(mod, name)()
            out[mode] = seen
    finally:
        jpl.pallas_call = real
    return out


@pytest.mark.parametrize("mode", list(JAX_PROBES))
def test_jax_probe_works_in_interpret_mode(jax_features, mode):
    assert jax_features[mode]["status"] == "works"


@pytest.mark.parametrize("mode", list(JAX_PROBES))
def test_inputs_are_the_jax_probes(jax_features, mode):
    for port, jax_in in zip(tfeat.inputs(mode), jax_features[mode]["in"]):
        assert port.shape == jax_in.shape
        assert np.array_equal(bits(port), bits(jax_in))


@pytest.mark.parametrize("mode", list(JAX_PROBES))
def test_plain_matches_jax_probe_bit_for_bit(jax_features, mode):
    got = tfeat.features(mode, *tfeat.inputs(mode))
    assert np.array_equal(bits(got), bits(jax_features[mode]["out"]))


def _to_jax(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("mode", list(JAX_PROBES))
def test_plain_matches_jax_kernel_on_seeded_tiles(jax_features, mode):
    # Each JAX probe's kernel (its pallas_call, one tile) on seeded tiles:
    # bf16 values at and around 0.5, random words with random masks, a
    # random table and indices.
    args = tfeat.seeded_inputs(mode, 2, seed=6)
    got = tfeat.features(mode, *args)
    for u in range(2):
        want = jax_features[mode]["kernel"](*[_to_jax(a[u]) for a in args])
        assert np.array_equal(bits(got[u]), bits(want))


def test_watcher_expectation_is_the_jax_probes():
    # The watcher's numpy expectation of each probe (what a "works" needs
    # besides kernel == plain) equals the plain version on the probe's
    # inputs; the probes run in-process on the CPU's plain versions.
    for name in ("bf16_vector_cmp", "i16_mask_relayout", "i16_hoisted_mask",
                 "dynamic_gather"):
        assert tw.PROBES[name](torch.device("cpu")) == ("works", "")


def test_dyn_gather_out_of_range_gives_nan():
    tab, idx = tfeat.seeded_inputs("dyn_gather", 1, seed=2)
    idx[0, 0, :2] = torch.tensor([-1, 64], dtype=torch.int32)
    got = tfeat.features("dyn_gather", tab, idx)
    assert bool(got[0, 0, :2].isnan().all())
    assert not bool(got[0, 0, 2:].isnan().any())


def test_bytes_bound_counts_what_the_data_needs():
    # Output and index bytes, plus the 32-byte table sectors that the
    # indices touch (counted here with a set), or the half of x that each
    # column's mask picks.
    out_idx = 8 * 128 * 8
    tab, idx = tfeat.seeded_inputs("dyn_gather", 3, seed=6)
    idx[1, 0, :4] = torch.tensor([-1, 64, 1 << 30, -(1 << 30)],
                                 dtype=torch.int32)
    touched = {(u, int(idx[u, r, c]), c // 8) for u in range(3)
               for r in range(8) for c in range(128)
               if 0 <= int(idx[u, r, c]) < 64}
    assert tfeat.nbytes("dyn_gather", tab, idx) == \
        32 * len(touched) + 3 * out_idx
    assert 0.55 < len(touched) / (3 * 64 * 16) < 0.7
    zeros = torch.zeros_like(idx)
    assert tfeat.nbytes("dyn_gather", tab, zeros) == 3 * (16 * 32 + out_idx)
    # The JAX probe's idx is (37 c) mod 64 in every row: one sector a
    # column.
    assert tfeat.nbytes("dyn_gather", *tfeat.inputs("dyn_gather")) == \
        128 * 32 + out_idx
    s_out = 128 * 4 + 4 * 128 * 4
    for mode in ("i16_relayout", "i16_hoisted"):
        x, s = tfeat.inputs(mode)              # masks alternate by column
        assert tfeat.nbytes(mode, x, s) == 8 * 128 * 4 + s_out
        ones = torch.full_like(s, 2)           # every mask true
        assert tfeat.nbytes(mode, x, ones) == 4 * 128 * 4 + s_out
    assert tfeat.nbytes("bf16_cmp", *tfeat.seeded_inputs("bf16_cmp", 2)) == \
        2 * 8 * 128 * (2 + 4)


def test_wrapper_checks():
    x, s = tfeat.inputs("i16_relayout")
    with pytest.raises(ValueError, match="mode"):
        tfeat.features("i32_relayout", x, s)
    with pytest.raises(ValueError):
        tfeat.features("i16_relayout", x, s.float())
    with pytest.raises(ValueError):
        tfeat.features("i16_relayout", x[:4], s)
    with pytest.raises(ValueError):
        tfeat.features("i16_relayout", x)


_CHECK_CASES = {
    "bad mode": ("i32_relayout", lambda x, s: (x, s), "mode"),
    "dtype": ("i16_relayout", lambda x, s: (x, s.float()), "want"),
    "tail shape": ("i16_relayout", lambda x, s: (x[:4], s), "want"),
    "arity": ("i16_relayout", lambda x, s: (x,), "takes 2"),
    "leading shapes": ("i16_relayout", lambda x, s: (
        x.expand(2, *x.shape), s.expand(3, *s.shape)), "one leading shape"),
    "devices": ("i16_relayout", lambda x, s: (x, s.to("meta")), "tensors on"),
}


@pytest.mark.parametrize("case", list(_CHECK_CASES))
def test_wrapper_checks_raise_before_any_launch(case):
    # Each check raises ValueError with its message, the plain version's
    # too (both call one check, built once at import).
    mode, make, match = _CHECK_CASES[case]
    args = make(*tfeat.inputs("i16_relayout"))
    for fn in (tfeat.features, tfeat.features_reference):
        with pytest.raises(ValueError, match=match):
            fn(mode, *args)


@pytest.mark.parametrize("off", range(8))
def test_bf16_cmp_output_is_placed_for_the_kernels_vectors(off):
    # The kernel stores 16-byte vectors from the first 16-byte boundary of
    # x (after a head of `head` values): the wrapper's output must be
    # 16-byte aligned at that value too. On the CPU the wrapper computes
    # the plain version of the view, which is the tile's.
    (x,) = tfeat.seeded_inputs("bf16_cmp", 3, seed=off)
    buf = torch.empty(x.numel() + 8, dtype=torch.bfloat16)
    view = buf[off:off + x.numel()].view(x.shape)
    view.copy_(x)
    out = tfeat._output("bf16_cmp", (view,))
    head = (16 - view.data_ptr() % 16) % 16 // 2
    assert out.shape == x.shape and out.is_contiguous()
    assert out.dtype == torch.float32
    assert (out.data_ptr() + 4 * head) % 16 == 0
    assert torch.equal(tfeat.features("bf16_cmp", view),
                       tfeat.features_reference("bf16_cmp", x))


@pytest.mark.parametrize("off", [1, 2, 3])
def test_dyn_gather_table_off_16_bytes_is_refused(off):
    tab, idx = tfeat.seeded_inputs("dyn_gather", 2)
    buf = torch.empty(tab.numel() + 3)
    view = buf[off:off + tab.numel()].view(tab.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfeat._output("dyn_gather", (view, idx))
    out = tfeat._output("dyn_gather", (tab, idx))
    assert out.shape == (2, 8, 128) and out.dtype == torch.float32


@pytest.mark.parametrize("mode", tfeat.MODES)
def test_output_shapes(mode):
    args = tfeat.seeded_inputs(mode, 3)
    out = tfeat._output(mode, args)
    want = tfeat.features_reference(mode, *args)
    assert out.shape == want.shape and out.dtype == want.dtype
    assert out.is_contiguous()


def test_units_come_from_numel():
    for mode in tfeat.MODES:
        args = tfeat.seeded_inputs(mode, 6)
        args = [a.reshape(2, 3, *a.shape[1:]) for a in args]
        assert tfeat.features(mode, *args).shape[:2] == (2, 3)
    assert tfeat.nbytes("bf16_cmp", *[a.reshape(2, 3, 8, 128) for a in
                                      tfeat.seeded_inputs("bf16_cmp", 6)]) \
        == 6 * 8 * 128 * (2 + 4)


# ---------------------------------------------------------------- watcher
FP = {"torch": "t", "torch_cuda": "c", "nvcc": "n", "device": "cpu"}


def test_ledger_append_compare_and_exit_codes(tmp_path, monkeypatch, capsys):
    ledger = tmp_path / "ledger.json"
    fp = dict(FP)
    monkeypatch.setattr(tw, "fingerprint", lambda device: dict(fp))
    monkeypatch.setattr(tw, "run_probes", lambda names, device:
                        {n: {"status": "works", "detail": "", "launches": {}}
                         for n in names})
    base = ["--device", "cpu", "--ledger", str(ledger)]
    # No ledger: changed.
    assert tw.main(["--check"] + base) == 2
    assert not ledger.exists()
    assert tw.main(["--probe", "dynamic_gather"] + base) == 0
    entries = json.loads(ledger.read_text())
    assert len(entries) == 1 and entries[0]["fingerprint"] == FP
    assert entries[0]["probes"] == {"dynamic_gather": {
        "status": "works", "detail": "", "launches": {}}}
    # Unchanged, the default mode is --check.
    assert tw.main(base) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(out) == {"fingerprint": FP, "changed": False}
    fp["nvcc"] = "release 99"
    assert tw.main(["--check"] + base) == 2
    assert tw.main(["--probes"] + base) == 0
    entries = json.loads(ledger.read_text())
    assert len(entries) == 2 and set(entries[1]["probes"]) == set(tw.PROBES)
    assert tw.main(["--check"] + base) == 0


def test_statuses(monkeypatch):
    def broken(dev):
        raise RuntimeError("nvcc failed building features (exit 1):\nmore")

    monkeypatch.setitem(tw.PROBES, "dynamic_gather", broken)
    r = tw.run_probe("dynamic_gather", "cpu")
    assert r["status"] == "blocked"
    assert r["detail"] == "RuntimeError: nvcc failed building features (exit 1):"
    assert tw._verdict({"a": True, "b": False}) == ("wrong", "differs: b")
    assert tw.run_probe_subprocess("dtype", "cpu", timeout=0.01)["status"] == \
        "timeout"


def test_needs_a_card_without_device_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert tw.main(["--check"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err


def test_probe_in_a_child_process(tmp_path):
    ledger = tmp_path / "ledger.json"
    proc = subprocess.run(
        [sys.executable, "-m", "raytracing_tpu_torch.tools.toolchain_watch",
         "--probe", "i16_hoisted_mask", "--device", "cpu",
         "--ledger", str(ledger)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    entry = json.loads(ledger.read_text())[-1]
    assert entry["fingerprint"]["device"] == "cpu"
    assert entry["probes"] == {"i16_hoisted_mask": {
        "status": "works", "detail": "", "launches": {}}}
