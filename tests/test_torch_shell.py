"""The port's application shell on the CPU: checkpoint and resume, the frame
API (against the JAX package's on the golden scene), the display, the
native helpers and the CLI's shell flags."""

import io
import os
import re

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch import cli as tcli  # noqa: E402
from raytracing_tpu_torch.runtime import display as tdisplay  # noqa: E402
from raytracing_tpu_torch.runtime import renderer as trenderer  # noqa: E402
from raytracing_tpu_torch.runtime import tiling  # noqa: E402
from raytracing_tpu_torch.utils import native as tnative  # noqa: E402
from raytracing_tpu_torch.utils import png  # noqa: E402

from torch_port_helpers import (  # noqa: E402
    golden_mesh_scene_jax, golden_params, golden_scene_jax, to_port,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "mini_pallas.png")



@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The plain version runs many small tensor ops: one intra-op thread a
    test process keeps a parallel test run from oversubscribing the cores
    (results do not depend on the thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _port_params(jparams):
    return rtt.CameraParameters(
        **{f: getattr(jparams, f) for f in jparams.__dataclass_fields__}
    )


def _golden(**kw):
    """The golden scene and camera (64x32) in the port, with defocus so
    that every path draws from the RNG."""
    jparams = golden_params(**kw)
    return to_port(golden_scene_jax()), _port_params(jparams), jparams


def _renderer(scene, params, **kw):
    return rtt.Renderer(scene, params, seed=11, device="cpu", **kw)


# ---------------------------------------------------------------------------
# checkpoint and resume
# ---------------------------------------------------------------------------


def test_resume_after_full_render_byte_equal(tmp_path):
    scene, params, _ = _golden(defocus_angle=0.5, focus_distance=2.0,
                               max_depth=3)
    full = _renderer(scene, params)
    want = full.render(spp=4)
    first = _renderer(scene, params)
    first.render(spp=1)
    ck = str(tmp_path / "ck.npz")
    first.save_checkpoint(ck)
    second = _renderer(scene, params)
    assert second.load_checkpoint(ck) == 1
    got = second.render(spp=4, resume=True)
    np.testing.assert_array_equal(got, want)
    assert second.samples_done == 4
    assert second.segments_traced == full.segments_traced
    assert second._tiles_counter == 2 * full._tiles_counter


@pytest.mark.parametrize("stop", [1, 2])
def test_resume_mid_render_from_progress_callback(tmp_path, stop):
    # Three waves of 2 spp; the checkpoint is taken from the callback after
    # wave ``stop`` and resumed in a new renderer: byte-equal at every
    # stop, with equal segments.
    scene, params, _ = _golden(defocus_angle=0.5, focus_distance=2.0,
                               max_depth=3)
    ck = str(tmp_path / "mid.npz")
    saved = []

    r = _renderer(scene, params, max_rays_per_batch=64)

    def on_progress(p):
        if len(saved) < stop:
            r.save_checkpoint(ck)
            saved.append(p.samples_done)

    want = r.render(spp=6, on_progress=on_progress)
    assert saved[-1] == 2 * stop
    resumed = _renderer(scene, params, max_rays_per_batch=64)
    assert resumed.load_checkpoint(ck) == 2 * stop
    got = resumed.render(spp=6, resume=True)
    np.testing.assert_array_equal(got, want)
    assert resumed.segments_traced == r.segments_traced
    # Without an observer the resumed plan is different; same bits.
    again = _renderer(scene, params)
    again.load_checkpoint(ck)
    np.testing.assert_array_equal(again.render(spp=6, resume=True), want)


def test_resume_toward_smaller_target_normalises_per_slot(tmp_path):
    scene, params, _ = _golden(max_depth=3)
    r = _renderer(scene, params)
    img4 = r.render(spp=4)
    ck = str(tmp_path / "ck")
    r.save_checkpoint(ck)
    assert os.path.exists(ck + ".npz")
    back = _renderer(scene, params)
    assert back.load_checkpoint(ck) == 4  # the same .npz normalisation
    np.testing.assert_array_equal(back.render(spp=2, resume=True), img4)
    # A mid-render state whose slots ran ahead of the target: each slot's
    # mean is over its own samples.
    slot_sum = back._image_sum.clone()
    back._done[: tiling.SLOTS_PER_TILE] = 3
    dev = back.render(spp=2, resume=True, as_device_array=True)
    np.testing.assert_array_equal(
        dev.numpy(), trenderer._slots_to_u8(slot_sum, back._done).numpy()
    )


def test_fingerprint_covers_seed_camera_and_every_scene_field(tmp_path):
    scene, params, _ = _golden()
    r = _renderer(scene, params)
    r.render(spp=1)
    ck = str(tmp_path / "ck.npz")
    r.save_checkpoint(ck)
    wrong_seed = rtt.Renderer(scene, params, seed=12, device="cpu")
    moved = _renderer(
        scene, rtt.CameraParameters(**{**params.__dict__,
                                       "lookfrom": (0.0, 0.4, 1.2)}),
    )
    for other in (wrong_seed, moved):
        with pytest.raises(ValueError, match="fingerprint"):
            other.load_checkpoint(ck)
    # spp is the budget being resumed: not in the fingerprint.
    more = _renderer(scene, rtt.CameraParameters(
        **{**params.__dict__, "samples_per_pixel": 9}))
    assert more.load_checkpoint(ck) == 1


def test_fingerprint_tells_meshes_with_equal_spheres_apart(tmp_path):
    # Two mesh scenes whose sphere columns are equal and whose triangles
    # differ: the JAX package's fingerprint hashes the sphere columns only.
    jscene = golden_mesh_scene_jax()
    a = to_port(jscene)
    b = rtt.Scene(**{**a.__dict__, "tri_v0": a.tri_v0 + 0.25})
    assert torch.equal(a.centers, b.centers)
    _, params, _ = _golden()
    r = _renderer(a, params)
    r.render(spp=1)
    ck = str(tmp_path / "mesh.npz")
    r.save_checkpoint(ck)
    with pytest.raises(ValueError, match="fingerprint"):
        _renderer(b, params).load_checkpoint(ck)
    assert _renderer(a, params).load_checkpoint(ck) == 1


def test_checkpoint_before_render_raises(tmp_path):
    scene, params, _ = _golden()
    with pytest.raises(ValueError, match="nothing rendered"):
        _renderer(scene, params).save_checkpoint(str(tmp_path / "x.npz"))


def test_checkpoint_row_and_done_mismatch(tmp_path):
    scene, params, _ = _golden()
    r = _renderer(scene, params)
    r.render(spp=1)
    ck = str(tmp_path / "ck.npz")
    r.save_checkpoint(ck)
    with np.load(ck) as data:
        items = {k: data[k] for k in data.files}
    assert items["layout"] == "slot" and items["done"].shape == (16, 128)
    bad = dict(items, image_sum=items["image_sum"][:1024])
    np.savez(tmp_path / "rows.npz", **bad)
    with pytest.raises(ValueError, match="rows"):
        _renderer(scene, params).load_checkpoint(str(tmp_path / "rows.npz"))
    bad = dict(items, done=items["done"][:8])
    np.savez(tmp_path / "done.npz", **bad)
    with pytest.raises(ValueError, match="done"):
        _renderer(scene, params).load_checkpoint(str(tmp_path / "done.npz"))
    bad = dict(items, layout="pixel")
    np.savez(tmp_path / "layout.npz", **bad)
    with pytest.raises(ValueError, match="layout"):
        _renderer(scene, params).load_checkpoint(str(tmp_path / "layout.npz"))


def test_reseed_drops_state_and_device_array_round_trip():
    scene, params, _ = _golden(max_depth=3)
    r = _renderer(scene, params)
    img = r.render(spp=2)
    dev = r.render(spp=2, as_device_array=True)
    assert dev.shape == (2048, 3) and dev.dtype == torch.uint8
    np.testing.assert_array_equal(r.fetch_image(dev), img)
    r.render_frame_accum(spp=1)
    r.reseed(11)
    assert r._image_sum is None and r.frame_accum_samples == 0
    assert r.segments_traced == 0 and r.samples_done == 0
    np.testing.assert_array_equal(r.render(spp=2, resume=True), img)


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------


def test_frames_byte_equal_to_jax_and_to_render():
    # The golden scene at seed 11: JAX's one-shot frame and two
    # accumulating frames (TPU-interpret mode) against the port's, and
    # against the port's render at the accumulated spp.
    import raytracing_tpu as rt

    scene, params, jparams = _golden()
    jr = rt.Renderer(golden_scene_jax(), jparams, seed=11, backend="pallas")
    want_frame = jr.fetch_image(jr.render_frame(spp=1))
    jr.frame_accum_reset()
    jr.render_frame_accum(spp=1)
    dev, total = jr.render_frame_accum(spp=1)
    want_accum = jr.fetch_image(dev)
    assert total == 2

    r = _renderer(scene, params)
    frame = r.fetch_image(r.render_frame(spp=1))
    np.testing.assert_array_equal(frame, want_frame)
    np.testing.assert_array_equal(frame, png.read_png(GOLDEN))
    r.render_frame_accum(spp=1)
    dev, total = r.render_frame_accum(spp=1)
    assert total == 2 and r.frame_accum_samples == 2
    np.testing.assert_array_equal(r.fetch_image(dev), want_accum)
    np.testing.assert_array_equal(r.fetch_image(dev),
                                  _renderer(scene, params).render(spp=2))


def test_k_accumulated_frames_byte_equal_to_one_render():
    scene, params, _ = _golden(defocus_angle=0.5, focus_distance=2.0,
                               max_depth=3)
    r = _renderer(scene, params)
    for spp in (1, 2):
        dev, prev, total = r.render_frame_accum_preview(spp=spp)
    assert total == 3 and prev.shape == (32, 64, 3)
    one = _renderer(scene, params)
    want = one.render(spp=3)
    np.testing.assert_array_equal(r.fetch_image(dev), want)
    np.testing.assert_array_equal(prev.numpy(), want)
    assert r.segments_traced == one.segments_traced
    # A reset starts a fresh pose.
    r.frame_accum_reset()
    dev, total = r.render_frame_accum(spp=1)
    assert total == 1
    np.testing.assert_array_equal(r.fetch_image(dev),
                                  _renderer(scene, params).render(spp=1))


def test_render_frames_draw_fresh_samples_and_resize_needs_reset():
    scene, params, _ = _golden(max_depth=3)
    r = _renderer(scene, params)
    a = r.fetch_image(r.render_frame(spp=1))
    b = r.fetch_image(r.render_frame(spp=1))
    assert not np.array_equal(a, b)  # sample 1, not sample 0 again
    r.render_frame_accum(spp=1)
    r.camera = rtt.derive(rtt.CameraParameters(
        **{**params.__dict__, "image_width": 96}))
    with pytest.raises(ValueError, match="frame_accum_reset"):
        r.render_frame_accum(spp=1)
    r.frame_accum_reset()
    dev, _ = r.render_frame_accum(spp=1)
    assert r.fetch_image(dev).shape == (48, 96, 3)


def test_camera_setter_moves_the_kernel_camera():
    scene, params, _ = _golden(max_depth=3)
    r = _renderer(scene, params)
    a = r.render(spp=1)
    moved = rtt.CameraParameters(**{**params.__dict__,
                                    "lookfrom": (0.4, 0.3, 1.2)})
    r.params, r.camera = moved, rtt.derive(moved)
    assert torch.equal(r._cam_host, rtt.derive(moved).as_vector())
    b = r.render(spp=1)
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(b, _renderer(scene, moved).render(spp=1))


@pytest.mark.parametrize("hw,prc", [((44, 66), (16, 32)), ((32, 64), (8, 16)),
                                    ((30, 70), (136, 240)), ((37, 41), (5, 7))])
def test_device_preview_byte_equal_to_jax(hw, prc):
    import jax.numpy as jnp

    from raytracing_tpu.runtime import renderer as jrenderer

    h, w = hw
    ids = tiling.tiled_pixel_ids(w, h)
    u8 = np.random.default_rng(h * w).integers(
        0, 256, size=(len(ids), 3), dtype=np.uint8)
    ph, pw = trenderer._preview_shape(h, w, *prc)
    want = np.asarray(jrenderer._device_preview(
        jnp.asarray(u8), jnp.asarray(ids), h, w, ph, pw))
    got = trenderer._device_preview(
        torch.from_numpy(u8), torch.from_numpy(ids), h, w, ph, pw)
    assert got.shape == want.shape == (ph, pw, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_segments_traced_ready_catches_up():
    scene, params, _ = _golden()
    r = _renderer(scene, params)
    r.render_frame(spp=1)
    r.render_frame_accum(spp=1)
    assert len(r._pending_segments) == 2
    ready = r.segments_traced_ready  # CPU counts are always ready
    assert ready > 0 and not r._pending_segments
    assert r.segments_traced == ready


def test_segment_counts_under_concurrent_drains():
    # The pipelined session drains segments_traced_ready on its worker
    # thread while the main thread queues launches' counts: no count is
    # lost or taken twice.
    import sys
    import threading

    scene, params, _ = _golden()
    r = _renderer(scene, params)
    per_thread, threads = 400, 8
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def queue():
            for _ in range(per_thread):
                r._track(torch.tensor(3, dtype=torch.int64))

        def drain():
            for _ in range(per_thread):
                r.segments_traced_ready

        workers = [threading.Thread(target=f)
                   for f in (queue, drain) * (threads // 2)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in workers)
    finally:
        sys.setswitchinterval(old)
    assert r.segments_traced == 3 * per_thread * threads // 2


# ---------------------------------------------------------------------------
# display and native helpers
# ---------------------------------------------------------------------------


def _progress(mod, img, done=3):
    return mod.RenderProgress(
        samples_done=done, samples_total=4,
        pixels_count=img.shape[0] * img.shape[1], segments_traced=1234,
        elapsed_s=0.5, _preview=lambda: img,
    )


@pytest.mark.parametrize("native", [True, False])
def test_display_bytes_equal_to_jax(monkeypatch, native):
    from raytracing_tpu.runtime import display as jdisplay
    from raytracing_tpu.runtime import renderer as jrenderer
    from raytracing_tpu.utils import native as jnative

    if native:
        assert tnative.available(), tnative.status()
        if not jnative.available():
            # The JAX side's library is a build artifact of native/Makefile
            # (not in a checkout): give its wrapper the port's build of the
            # same source.
            monkeypatch.setattr(jnative, "_load", tnative._load)
    else:
        monkeypatch.setattr(tnative, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    img = np.random.default_rng(5).integers(0, 256, (37, 50, 3), np.uint8)
    assert (tdisplay.compose_halfblock_frame(img)
            == jdisplay.compose_halfblock_frame(img))
    outs = []
    for mod, rmod in ((tdisplay, trenderer), (jdisplay, jrenderer)):
        out = io.StringIO()
        disp = mod.TerminalDisplay(stream=out, max_width=20, max_height=16)
        disp(_progress(rmod, img, 1))
        first = out.getvalue()
        disp(_progress(rmod, img, 3))
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    # The second frame rewinds over exactly the rows of the first.
    m = re.match(r"\x1b\[(\d+)F", outs[0][len(first):])
    assert m and int(m.group(1)) == first.count("\n")


def test_file_sequence_display(tmp_path):
    img = np.zeros((6, 6, 3), np.uint8)
    disp = tdisplay.FileSequenceDisplay(str(tmp_path), every=2)
    for _ in range(4):
        disp(_progress(trenderer, img))
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "preview_0001.png", "preview_0003.png"]
    assert png.read_png(tmp_path / "preview_0001.png").shape == (6, 6, 3)


def test_native_helpers(tmp_path):
    # c++ and zlib are there on the machines the tests run on.
    assert tnative.available(), tnative.status()
    assert "_build" in tnative.status() and "native/librtnative.so" \
        not in tnative.status()
    img = np.random.default_rng(3).integers(0, 256, (33, 47, 3), np.uint8)
    p = tmp_path / "n.png"
    png.write_png(p, img)  # RGB goes through the native encoder
    assert png.read_png(p).tolist() == img.tolist()
    assert open(p, "rb").read() == tnative.png_encode(img)
    frame = tnative.compose_halfblock(img[:10, :7])
    assert frame.count("▀") == 7 * 5
    small = np.full((8, 8, 3), 9, np.uint8)
    with tnative.FramePump(str(tmp_path / "f_"), queue_depth=2) as pump:
        pump.submit(small, 0)
        pump.submit(small, 1)
    np.testing.assert_array_equal(png.read_png(tmp_path / "f_0001.png"), small)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

_CLI = ["--width", "48", "--depth", "3", "--device", "cpu", "--quiet"]


def test_cli_checkpoint_resume_and_preview_dir(tmp_path):
    out, ck = str(tmp_path / "o.png"), str(tmp_path / "ck")
    prev = tmp_path / "prev"
    assert tcli.main(_CLI + ["--spp", "2", "--out", out, "--checkpoint", ck,
                             "--preview-dir", str(prev)]) == 0
    assert os.path.exists(ck + ".npz") and any(prev.iterdir())
    assert tcli.main(_CLI + ["--spp", "4", "--out", out,
                             "--checkpoint", ck]) == 0
    with np.load(ck + ".npz") as data:
        assert int(data["samples_done"]) == 4
    want = str(tmp_path / "w.png")
    assert tcli.main(_CLI + ["--spp", "4", "--out", want]) == 0
    np.testing.assert_array_equal(png.read_png(out), png.read_png(want))


def test_cli_ctrl_c_saves_checkpoint_and_exits_130(tmp_path, monkeypatch):
    # A display callback raises KeyboardInterrupt after the first wave.
    def interrupt(self, progress):
        raise KeyboardInterrupt

    monkeypatch.setattr(tdisplay.FileSequenceDisplay, "__call__", interrupt)
    out, ck = str(tmp_path / "o.png"), str(tmp_path / "ck.npz")
    rc = tcli.main(_CLI + ["--spp", "3", "--out", out, "--checkpoint", ck,
                           "--preview-dir", str(tmp_path / "p")])
    assert rc == 130 and not os.path.exists(out)
    with np.load(ck) as data:
        assert int(data["samples_done"]) == 3
    monkeypatch.undo()
    assert tcli.main(_CLI + ["--spp", "5", "--out", out,
                             "--checkpoint", ck]) == 0
    want = str(tmp_path / "w.png")
    assert tcli.main(_CLI + ["--spp", "5", "--out", want]) == 0
    np.testing.assert_array_equal(png.read_png(out), png.read_png(want))


def test_cli_interactive_headless(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr("sys.stdin", io.StringIO())
    rc = tcli.main(["--width", "48", "--spp", "1", "--depth", "2",
                    "--device", "cpu", "--interactive", "--frames", "2",
                    "--pipeline", "0"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "interactive session ended after 2 frames" in out
    assert "converge 3/64 spp" in out  # 1 + 2: the idle chunk grew


def test_cli_profile_dir(tmp_path):
    prof = tmp_path / "prof"
    assert tcli.main(_CLI + ["--spp", "1", "--out", str(tmp_path / "o.png"),
                             "--profile-dir", str(prof)]) == 0
    assert (prof / "trace.json").stat().st_size > 0


def test_cli_parser_defaults():
    args = tcli.build_arg_parser().parse_args([])
    assert args.config.endswith("world.config.json")
    assert args.device == "cuda" and args.pipeline == 2
    assert args.progress_every == 1 and not args.interactive
    assert args.checkpoint is None and args.frames is None
    assert args.converge_spp is None and args.profile_dir is None
