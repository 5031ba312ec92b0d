"""The port's one kernel launcher, ``ops/_build.py::launch``, and its launch
registry, on the CPU: a stand-in library and stand-in stream lookups take
the card's place, so each case checks what the launcher does around the C
call (the stream it passes, the device switch, the error check and the
count), not the kernel."""

import contextlib

import pytest

torch = pytest.importorskip("torch")

from raytracing_tpu_torch.ops import _build  # noqa: E402

CURRENT = 1  # the stand-in current device


class _Lib:
    """Stands in for a kernel library: one C launcher that records its
    arguments and returns ``code``, and the error-string entry."""

    def __init__(self, code: int):
        self.code = code
        self.calls = []

    def rt_probe_launch(self, *args):
        self.calls.append(args)
        return self.code

    @staticmethod
    def rt_error_string(err):
        return b"invalid device function"


@pytest.fixture
def card(monkeypatch):
    """Stand-ins for the library loader, the current device, its raw
    stream (1000 + the device index) and the device switch; yields a
    function that installs a library returning a given code, and the
    devices switched to."""
    switched = []

    @contextlib.contextmanager
    def device(index):
        switched.append(index)
        yield

    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: CURRENT,
                        raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1000 + index, raising=False)
    monkeypatch.setattr(torch.cuda, "device", device)
    loaded = []

    def install(code: int) -> _Lib:
        lib = _Lib(code)

        def load(name):
            loaded.append(name)
            return lib

        monkeypatch.setattr(_build, "load", load)
        return lib

    _build.reset_launch_counts()
    yield install, switched, loaded
    _build.reset_launch_counts()


@pytest.mark.parametrize("index, stream, switch", [
    (CURRENT, 1000 + CURRENT, []),
    (None, 1000 + CURRENT, []),
    (3, 1003, [3]),
])
def test_zero_code_counts_one_under_its_key(card, index, stream, switch):
    install, switched, loaded = card
    lib = install(0)
    device = torch.device("cuda", index) if index is not None else \
        torch.device("cuda")
    assert _build.launch("probe", "rt_probe_launch", device, 7, None, 2.5,
                         count="probe_mode") is None
    assert loaded == ["probe"]
    assert lib.calls == [(7, None, 2.5, stream)]
    assert switched == switch
    assert _build.launch_counts == {"probe_mode": 1}
    _build.launch("probe", "rt_probe_launch", device, 8, count="probe_mode")
    _build.launch("probe", "rt_probe_launch", device, 9, count="probe_other")
    assert _build.launch_counts == {"probe_mode": 2, "probe_other": 1}


@pytest.mark.parametrize("code", [1, 98])
def test_nonzero_code_raises_with_the_library_message_and_counts_nothing(
        card, code):
    install, _, _ = card
    lib = install(code)
    with pytest.raises(RuntimeError) as err:
        _build.launch("probe", "rt_probe_launch", torch.device("cuda", 1),
                      4, count="probe_mode")
    msg = str(err.value)
    for part in ("probe_mode", "rt_probe_launch", f"{code} (",
                 "invalid device function"):
        assert part in msg
    assert len(lib.calls) == 1
    assert sum(_build.launch_counts.values()) == 0


def test_reset_clears_the_registry(card):
    install, _, _ = card
    install(0)
    for key in ("regen", "trace_radix", "fetch_planes", "sweep_root"):
        _build.launch("probe", "rt_probe_launch", torch.device("cuda", 1),
                      count=key)
    assert len(_build.launch_counts) == 4
    _build.reset_launch_counts()
    assert not _build.launch_counts
    assert _build.launch_counts["regen"] == 0


@pytest.mark.parametrize("key", ["regen", "regen_sph2l_radixwin",
                                 "fetch_onehot", "key_rcp", "no_such_kernel"])
def test_a_key_never_launched_reads_zero(card, key):
    install, _, _ = card
    install(0)
    _build.launch("probe", "rt_probe_launch", torch.device("cuda", 1),
                  count="dtype_bitcast")
    assert _build.launch_counts[key] == 0
    assert _build.launch_counts["dtype_bitcast"] == 1


def test_check_passes_zero_and_names_what_failed():
    _build.check(_Lib(0), 0, "occupancy query")
    with pytest.raises(RuntimeError,
                       match=r"occupancy query failed: 5 \(invalid device"):
        _build.check(_Lib(0), 5, "occupancy query")
