"""The port's interactive session on the CPU: key bindings and the orbit
rig (against the JAX package's), converge-while-interactive byte-equality,
the pipelined session, quitting and the headless loop."""

import io
import math
from dataclasses import astuple

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch.ops import trace as ttrace  # noqa: E402
from raytracing_tpu_torch.runtime import interactive as tinteractive  # noqa: E402
from raytracing_tpu_torch.runtime.interactive import (  # noqa: E402
    ESC, InteractiveSession,
)

_PARAMS = dict(
    aspect_ratio=2.0, image_width=64, samples_per_pixel=2, max_depth=3,
    vertical_fov=45.0, defocus_angle=0.0, focus_distance=2.0,
    lookfrom=(0.0, 0.5, 1.5), lookat=(0.0, 0.0, -1.0),
)



@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The plain version runs many small tensor ops: one intra-op thread a
    test process keeps a parallel test run from oversubscribing the cores
    (results do not depend on the thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _scene(builder):
    b = builder()
    b.add_metallic_sphere((0.0, -100.5, -1.0), 100.0, (0.5, 0.5, 0.5), 0.0)
    b.add_lambertian_sphere((0.0, 0.0, -1.0), 0.5, (0.7, 0.3, 0.3))
    return b.build()


def _session(pipeline=0, **kw):
    return InteractiveSession(
        _scene(rtt.SceneBuilder), rtt.CameraParameters(**_PARAMS), seed=0,
        device="cpu", pipeline=pipeline, stream=io.StringIO(), **kw,
    )


def _oracle(s, spp):
    return rtt.Renderer(s.renderer.scene, s.renderer.params, seed=0,
                        device="cpu").render(spp=spp)


def test_key_bindings_and_orbit_equal_to_jax():
    import raytracing_tpu as rt
    from raytracing_tpu.runtime.interactive import (
        InteractiveSession as JaxSession,
    )

    s = _session()
    j = JaxSession(_scene(rt.SceneBuilder), rt.CameraParameters(**_PARAMS),
                   seed=0, backend="xla", stream=io.StringIO())
    assert astuple(s.orbit) == astuple(j.orbit)
    az0, el0, d0 = s.orbit.azimuth, s.orbit.elevation, s.orbit.distance
    s.handle_key("a")
    assert s.orbit.azimuth < az0
    for k in "ddw+":
        s.handle_key(k)
    assert s.orbit.azimuth > az0 and s.orbit.elevation > el0
    assert s.orbit.distance < d0
    for k in "s-=":
        s.handle_key(k)
    for k in "addw+s-=":
        j.handle_key(k)
    assert astuple(s.orbit) == astuple(j.orbit)  # bit-equal floats
    assert s.orbit.lookfrom() == j.orbit.lookfrom()
    s.handle_key("r")
    assert (s.orbit.azimuth, s.orbit.elevation, s.orbit.distance) == (
        az0, el0, d0)
    s.handle_key("?")  # unbound: ignored
    assert not s.quit
    s.handle_key(ESC)
    assert s.quit


def test_elevation_clamped():
    s = _session()
    for _ in range(100):
        s.handle_key("w")
    assert s.orbit.elevation <= math.radians(85.0) + 1e-9
    assert np.isfinite(np.asarray(s.orbit.lookfrom())).all()
    for _ in range(200):
        s.handle_key("s")
    assert s.orbit.elevation >= -math.radians(85.0) - 1e-9


def test_step_renders_and_motion_resets_accumulation():
    s = _session()
    img0 = s.step()
    s.step()
    assert s.samples_at_pose == 6  # 2 + 4 (idle growth)
    img1 = s.step("dddddddddd")  # 60 degrees of orbit
    assert img0.shape == img1.shape == (32, 64, 3)
    assert not np.array_equal(img0, img1)
    assert s.samples_at_pose == 2  # accumulation and growth restart
    s.step()
    assert s.samples_at_pose == 6 and s.frames_rendered == 4
    out = s.display.stream.getvalue()
    assert "Elapsed" in out and "keys:" in out and "converge 6/64" in out


def test_idle_frames_converge_byte_equal_to_oneshot():
    s = _session()  # 2 spp a frame; idle chunks grow 2, 4, 8 (cap 4*spp)
    for _ in range(2):
        img = s.step()
    assert s.samples_at_pose == 6
    want = _oracle(s, 6)
    np.testing.assert_array_equal(img, want)
    np.testing.assert_array_equal(s.renderer.fetch_image(s.last_frame), want)


def test_converged_idle_stops_launching(monkeypatch):
    launches = []
    launch = ttrace.render_pixels_fused

    def counted(*args, **kw):
        launches.append(kw["sample_start"])
        return launch(*args, **kw)

    monkeypatch.setattr(ttrace, "render_pixels_fused", counted)
    s = _session(converge_spp=4)
    s.step()
    img_conv = s.step()
    assert s.converged and launches == [0, 2]
    seg = s.renderer.segments_traced
    img_again = s.step()  # idle and converged: re-present, no launch
    assert launches == [0, 2] and s.renderer.segments_traced == seg
    np.testing.assert_array_equal(img_conv, img_again)
    s.step("d")  # motion un-converges
    assert s.samples_at_pose == 2 and not s.converged
    assert launches == [0, 2, 0]


def test_pipelined_session_flush_byte_equal():
    # Presentation lags the launches by up to 2 frames; flush() drains,
    # and the newest presented image is the accumulated mean, byte for
    # byte, after a pose change too.
    piped = _session(pipeline=2)
    assert piped.step() is None  # nothing presented yet
    for keys in ("d", "", ""):
        piped.step(keys)
    got = piped.flush()
    assert piped.samples_at_pose == 14  # 2 + 4 + 8 after the move
    np.testing.assert_array_equal(got, _oracle(piped, 14))
    assert piped.display.stream.getvalue().count("converge") == 4


def test_quit_key_ends_run():
    s = _session()
    s.handle_key("x")
    assert s.run(max_frames=10) == 0


def test_run_headless_fixed_frames(monkeypatch):
    monkeypatch.setattr(tinteractive.sys, "stdin", io.StringIO())
    s = _session(pipeline=2)
    assert s.run(max_frames=3) == 3
    assert s.frames_rendered == 3 and s.samples_at_pose == 14
    assert s._last_img is not None and not s._pending


def test_tools_run_the_session_and_the_orbit(tmp_path, capsys):
    from raytracing_tpu_torch.tools import interactive_converge, orbit_demo

    params, scene = interactive_converge.world(48, 1, 2)
    result, s = interactive_converge.measure(
        scene, params, spp=1, converge_spp=6, pipeline=1, orbit_frames=2,
        device="cpu")
    assert s.samples_at_pose == 6 and result["idle_frames"] == 2  # 3, 6
    assert result["s_to_8spp"] is None and result["fps_orbit"] > 0
    np.testing.assert_array_equal(
        s.flush(), _oracle(s, 6)[: s.flush().shape[0]])
    out = tmp_path / "orbit"
    assert orbit_demo.main(["--device", "cpu", "--width", "48", "--spp", "1",
                            "--depth", "2", "--frames", "3",
                            "--out-dir", str(out)]) == 0
    assert sorted(p.name for p in out.iterdir()) == [
        "frame_0000.png", "frame_0001.png", "frame_0002.png"]
    assert "3 frames 48x28 @ 1 spp" in capsys.readouterr().out


def test_shell_modules_do_not_load_jax():
    import subprocess
    import sys

    mods = ("raytracing_tpu_torch.runtime.interactive",
            "raytracing_tpu_torch.runtime.display",
            "raytracing_tpu_torch.utils.native",
            "raytracing_tpu_torch.tools.interactive_converge",
            "raytracing_tpu_torch.tools.orbit_demo")
    code = (f"import sys, importlib; [importlib.import_module(m) for m in "
            f"{mods!r}]; print(sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'raytracing_tpu.'))) or 'clean')")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"
