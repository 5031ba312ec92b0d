"""The port's spans (``utils/spans.py``) on the CPU: where each lies under
``torch.profiler`` (a render's waves, launches and readback; a caller
batch's launch; a session frame's launch and wait), the presenter's
counter, the shared no-op when no profiler records on the thread, and
the same bits with the profiler on and off."""

import io
import threading

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch.ops import trace as ttrace  # noqa: E402
from raytracing_tpu_torch.runtime.interactive import (  # noqa: E402
    InteractiveSession,
)
from raytracing_tpu_torch.utils import spans  # noqa: E402

_PARAMS = dict(
    aspect_ratio=2.0, image_width=32, samples_per_pixel=2, max_depth=3,
    vertical_fov=45.0, defocus_angle=0.0, focus_distance=2.0,
    lookfrom=(0.0, 0.5, 1.5), lookat=(0.0, 0.0, -1.0),
)
# Rays a batch that split a render of the 32x16 image at 2 spp into waves:
# the kernel's one 1,024-slot tile at one sample a wave (two waves); the
# wavefront's 512 pixels in blocks of 256 at one sample (four waves).
_RAYS_PER_BATCH = {"pallas": 16, "xla": 256}


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scene():
    b = rtt.SceneBuilder()
    b.add_metallic_sphere((0.0, -100.5, -1.0), 100.0, (0.5, 0.5, 0.5), 0.0)
    b.add_lambertian_sphere((0.0, 0.0, -1.0), 0.5, (0.7, 0.3, 0.3))
    return b.build()


def _renderer(backend="pallas"):
    return rtt.Renderer(_scene(), rtt.CameraParameters(**_PARAMS), seed=3,
                        device="cpu", backend=backend,
                        max_rays_per_batch=_RAYS_PER_BATCH[backend])


def _session():
    return InteractiveSession(_scene(), rtt.CameraParameters(**_PARAMS),
                              seed=0, device="cpu", pipeline=1,
                              stream=io.StringIO())


def _rays():
    g = torch.Generator().manual_seed(5)
    o = torch.zeros((1024, 3)) + torch.tensor([0.0, 0.5, 1.5])
    d = torch.randn((1024, 3), generator=g) - torch.tensor([0.0, 0.0, 1.0])
    return o.contiguous(), d.contiguous()


def _traced(fn):
    """``fn()``'s result and its ``rt.*`` spans, (name, start, end, thread)
    in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ev = [(e.name, e.time_range.start, e.time_range.end, e.thread)
          for e in prof.events() if e.name.startswith("rt.")]
    return out, sorted(ev, key=lambda e: e[1])


def _inside(spans_, name, parent):
    """The spans called ``name`` inside ``parent``'s interval, on its
    thread."""
    _, a, b, th = parent
    return [e for e in spans_ if e[0] == name and e[3] == th
            and a <= e[1] and e[2] <= b]


def _named(spans_, name):
    return [e for e in spans_ if e[0] == name]


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_render_spans_nest(backend):
    r = _renderer(backend)
    _, ev = _traced(lambda: r.render(spp=2))
    [root] = _named(ev, "rt.render")
    waves = _inside(ev, "rt.render.wave", root)
    assert waves == _named(ev, "rt.render.wave")
    if backend == "pallas":
        assert len(waves) == len(r._waves(2, _PARAMS["max_depth"])[0]) == 2
        for w in waves:
            [launch] = _inside(ev, "rt.launch.regen", w)
            assert len(_inside(ev, "rt.launch.checks", launch)) == 1
        assert len(_named(ev, "rt.launch.regen")) == len(waves)
    else:
        assert len(waves) == 4 and not _named(ev, "rt.launch.regen")
    [readback] = _inside(ev, "rt.render.readback", root)
    parts = [_inside(ev, n, readback) for n in
             ("rt.readback.copy", "rt.readback.untile",
              "rt.readback.segments")]
    # The wavefront's image is in pixel order already: no untile.
    assert [len(p) for p in parts] == [1, int(backend == "pallas"), 1]
    parts = [p for p in parts if p]
    # In order, after the last wave.
    starts = [p[0][1] for p in parts]
    assert waves[-1][2] <= starts[0] and starts == sorted(starts)


def test_trace_rays_spans_nest():
    tables = ttrace.pack_scene(_scene())
    o, d = _rays()
    _, ev = _traced(lambda: ttrace.trace_rays_fused(tables, o, d, 1, 0, 3))
    [launch] = _named(ev, "rt.launch.trace")
    assert len(_inside(ev, "rt.launch.checks", launch)) == 1
    assert {e[0] for e in ev} == {"rt.launch.trace", "rt.launch.checks"}


def test_session_frame_spans_and_presenter_counter():
    s = _session()
    s.step("d")
    _, ev = _traced(lambda: [s.step("d") for _ in range(2)])
    waits = _named(ev, "rt.frame.wait")
    launches = _named(ev, "rt.launch.regen")
    assert len(waits) == len(launches) == 2
    # Each step launches its frame, then waits on the pending presents.
    for launch, wait in zip(launches, waits):
        assert launch[2] <= wait[1]
        assert len(_inside(ev, "rt.launch.checks", launch)) == 1
    assert {e[0] for e in ev} == {"rt.frame.wait", "rt.launch.regen",
                                  "rt.launch.checks"}
    # Presented on the pipeline's worker, where no span is recorded: the
    # presenter counts one entry a presented frame instead.
    assert {e[3] for e in ev} == {waits[0][3]}
    assert len(s.presents) >= s.frames_rendered - s.pipeline
    s.flush()
    assert [p[0] for p in s.presents] == [0, 1, 2] and s.frames_rendered == 3
    assert all(w >= 0.0 and d > 0.0 for _, w, d in s.presents)
    with pytest.raises(AttributeError):
        s.presents = ()


@pytest.mark.parametrize("where", ["no profiler", "profiler on another thread"])
def test_span_off_is_the_shared_noop(where):
    got = []

    def look():
        got.append(spans.span("rt.render"))

    if where == "no profiler":
        look()
    else:
        with profile(activities=[ProfilerActivity.CPU]):
            assert spans.span("rt.render") is not spans.OFF
            t = threading.Thread(target=look)
            t.start()
            t.join(timeout=30)
        assert not t.is_alive()
    assert got == [spans.OFF]
    with got[0] as inner:
        assert inner is None


def _render_image():
    return _renderer().render(spp=2)


def _trace_radiance():
    o, d = _rays()
    return ttrace.trace_rays_fused(ttrace.pack_scene(_scene()), o, d, 1, 0,
                                   3)[0].numpy()


def _frames():
    s = _session()
    for _ in range(3):
        s.step("d")
    return s.flush()


@pytest.mark.parametrize("make", [_render_image, _trace_radiance, _frames],
                         ids=["render", "trace", "frames"])
def test_same_bits_with_the_profiler_on_and_off(make):
    off = make()
    on, ev = _traced(make)
    assert ev
    np.testing.assert_array_equal(on, off)
