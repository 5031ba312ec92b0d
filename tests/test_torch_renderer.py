"""The port's batch renderer and CLI on the CPU: golden images (spheres,
textures, triangles), wave-split invariance, progress reporting, the
glTF option, and the no-JAX import contract."""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch.runtime import renderer as trenderer  # noqa: E402
from raytracing_tpu_torch.utils import png  # noqa: E402

from torch_port_helpers import (  # noqa: E402
    golden_mesh_scene_jax, golden_params, golden_scene_jax,
    golden_textured_scene_jax, to_port, write_icosphere_glb,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "mini_pallas.png")


def _golden_inputs():
    params = golden_params()
    return to_port(golden_scene_jax()), rtt.CameraParameters(
        **{f: getattr(params, f) for f in params.__dataclass_fields__}
    )


def test_golden_mini_pallas_byte_equal():
    # tests/golden/mini_pallas.png is the JAX package's regeneration-kernel
    # render (64x32 @ 1 spp, seed 11); the port reproduces it byte for byte.
    scene, params = _golden_inputs()
    r = rtt.Renderer(scene, params, seed=11, device="cpu")
    img = r.render(spp=1)
    np.testing.assert_array_equal(img, png.read_png(GOLDEN))
    assert r.samples_done == 1 and r.segments_traced > 0


@pytest.mark.parametrize("name", ["mini_textured", "mini_mesh"])
def test_golden_textured_and_mesh_byte_equal(name):
    # The JAX package's regeneration-kernel renders of the checker + image
    # texture scene and the 80-triangle mesh scene (64x32 @ 1 spp, seed 11,
    # depth 6), reproduced byte for byte by the plain version.
    jscene = (golden_textured_scene_jax if name == "mini_textured"
              else golden_mesh_scene_jax)()
    _, params = _golden_inputs()
    r = rtt.Renderer(to_port(jscene), params, seed=11, device="cpu")
    img = r.render(spp=1)
    want = png.read_png(os.path.join(ROOT, "tests", "golden", f"{name}.png"))
    np.testing.assert_array_equal(img, want)
    assert r.segments_traced > 0


def test_waves_equal_one_shot_render():
    scene, params = _golden_inputs()
    one = rtt.Renderer(scene, params, seed=11, device="cpu")
    img_one = one.render(spp=8)
    # A tiny batch bound splits the budget into 4 work-ahead waves.
    many = rtt.Renderer(scene, params, seed=11, device="cpu",
                        max_rays_per_batch=64)
    assert many._plan(8, 2048) == (2048, 2)
    events = []
    img_many = many.render(spp=8, on_progress=events.append)
    np.testing.assert_array_equal(img_many, img_one)
    assert many.segments_traced == one.segments_traced
    assert [e.samples_done for e in events] == [2, 4, 6, 8]
    assert events[-1].preview().shape == (32, 64, 3)
    np.testing.assert_array_equal(events[-1].preview(), img_one)
    assert events[1].fraction == 0.5
    # The no-observer plan never splits into more than ~4 waves.
    assert many._plan(64, 2048) == (2048, 16)


def test_multi_wave_render_matches_jax():
    # Both renderers split 8 spp into 4 waves of 2. The JAX renderer adds
    # fresh per-wave sums; the port continues each slot's running sum. On
    # the golden scene with defocus (every material, RNG on every path) the
    # two images are byte-equal, with equal segments.
    import raytracing_tpu as rt

    jparams = golden_params(defocus_angle=0.5, focus_distance=2.0)
    jr = rt.Renderer(golden_scene_jax(), jparams, seed=11, backend="pallas",
                     max_rays_per_batch=64)
    jevents = []
    want = jr.render(spp=8, on_progress=jevents.append)
    scene, _ = _golden_inputs()
    params = rtt.CameraParameters(
        **{f: getattr(jparams, f) for f in jparams.__dataclass_fields__}
    )
    r = rtt.Renderer(scene, params, seed=11, device="cpu",
                     max_rays_per_batch=64)
    events = []
    got = r.render(spp=8, on_progress=events.append)
    assert [e.samples_done for e in events] == [2, 4, 6, 8]
    assert [e.samples_done for e in jevents] == [2, 4, 6, 8]
    np.testing.assert_array_equal(got, want)
    assert r.segments_traced == jr.segments_traced


def test_renderer_metrics_and_reseed():
    scene, params = _golden_inputs()
    r = rtt.Renderer(scene, params, seed=11, device="cpu")
    assert r.pixels_count == 64 * 32 and r.fraction_done == 0.0
    a = r.render(spp=2)
    segs = r.segments_traced
    assert r.render_time() > 0 and r.mrays_per_sec() > 0
    assert r.fraction_done == 1.0 and r.pixels_raytraced == 2048
    r.reseed(12)
    assert r.samples_done == 0 and r.segments_traced == 0
    b = r.render(spp=2)
    assert not np.array_equal(a, b)
    assert abs(r.segments_traced - segs) < 0.1 * segs
    assert r.render(spp=0).sum() == 0


def test_slots_to_u8_multiplies_by_reciprocal():
    sums = torch.tensor([[0.3, 0.6, 0.9], [2.0, 0.0, 1.0]], dtype=torch.float32)
    done = torch.tensor([3, 0], dtype=torch.int32)
    got = trenderer._slots_to_u8(sums, done).numpy()
    inv = np.float32(1.0) / np.maximum(done.numpy(), 1).astype(np.float32)
    mean = sums.numpy() * inv[:, None]
    want = (np.clip(np.sqrt(np.maximum(mean, 0)), 0, 0.999) * 256).astype(np.uint8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("wh", [(64, 32), (100, 58), (33, 1), (1920, 1080)])
def test_slot_reorder_equals_reference(wh):
    from raytracing_tpu.runtime import renderer as jrenderer
    from raytracing_tpu.runtime import tiling as jtiling

    w, h = wh
    ids = jtiling.tiled_pixel_ids(w, h)
    u8 = np.random.default_rng(1).integers(0, 256, (len(ids), 3), np.uint8)
    want = jrenderer._slots_to_image(u8, ids, w * h, h, w)
    np.testing.assert_array_equal(trenderer._slots_to_image(u8, w, h), want)


def test_profile_tool_scenes_and_busy_union():
    from raytracing_tpu_torch.tools import profile_render

    params, scene = profile_render.build("cover", 192, 4, 8)
    assert (params.image_width, params.image_height) == (192, 108)
    assert scene.num_objects == 488 and params.samples_per_pixel == 4
    params, scene = profile_render.build("stress:300", 64, 2, 3)
    assert scene.num_objects == 300 and params.max_depth == 3
    params, scene = profile_render.build("textured", 64, 1, 1)
    assert scene.has_textures and params.aspect_ratio == 16.0 / 9.0
    _, scene = profile_render.build("mesh", 64, 1, 1)
    assert scene.num_triangles == 1280 and scene.has_textures
    _, scene = profile_render.build("mesh:1", 64, 1, 1)
    assert scene.num_triangles == 80
    _, scene = profile_render.build("meshes:3", 64, 1, 1)
    assert scene.num_triangles == 960 and scene.num_objects == 4
    with pytest.raises(ValueError):
        profile_render.build("nope", 64, 1, 1)
    # Device busy time is the union of overlapping intervals.
    assert profile_render._union_us([(5, 6), (0, 2), (1, 3), (3, 4)]) == 5.0


def test_profile_tool_bound_counts_only_real_rows():
    from raytracing_tpu_torch.ops import trace as ttrace
    from raytracing_tpu_torch.tools import profile_render as pr

    seg = 1000
    _, scene = pr.build("textured", 64, 1, 1)
    tables = ttrace.pack_scene(scene)
    assert (tables.n_pad, tables.n_actual) == (128, 5)
    b = pr.bound(tables, seg, 1024)
    assert b["fp32_ops"] == seg * (pr.SEGMENT_OPS + 5 * pr.SPHERE_PAIR_OPS)
    # Two-level rule, unculled tables: the real triangles, not the 2048
    # padded rows (stage 2 takes its keys from stage 1's: no window of its
    # own).
    _, scene = pr.build("mesh:3", 64, 1, 1)
    tables = ttrace.pack_scene(scene, cull=False)
    assert (tables.m_pad, tables.m_actual, tables.n_actual) == (2048, 1280, 3)
    b = pr.bound(tables, seg, 1024)
    assert b["fp32_ops"] == seg * (
        pr.SEGMENT_OPS + 3 * pr.SPHERE_PAIR_OPS
        + 1280 * pr.TRIANGLE_PAIR_OPS + pr.TRI_EXACT_OPS
    )
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(b["fp32_ops"] / pr.FP32_PEAK * 1e3)
    # With no segments only the bytes are left.
    b = pr.bound(tables, 0, 1024)
    assert b["bound_by"] == "bytes" and b["bound_ms"] > 0
    assert b["bound_ms"] == pytest.approx(b["bytes"] / pr.HBM_RATE * 1e3)


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    scene, params = _golden_inputs()
    with pytest.raises(RuntimeError):
        rtt.Renderer(scene, params, device="cuda")


def _run(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run(
        [sys.executable, *args], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300,
    )


def test_cli_cpu_render_exits_zero(tmp_path):
    out = tmp_path / "cli.png"
    config = os.path.join(ROOT, "data", "config", "world.config.json")
    proc = _run(
        ["-m", "raytracing_tpu_torch", "--device", "cpu", "--config", config,
         "--width", "64", "--spp", "1", "--out", str(out)],
        tmp_path,
    )
    assert proc.returncode == 0, proc.stderr
    img = png.read_png(out)
    assert img.shape == (37, 64, 3) and img.max() > 0


def test_cli_gltf_cpu_render_exits_zero(tmp_path):
    glb = write_icosphere_glb(tmp_path / "ico.glb", 1)
    out = tmp_path / "gltf.png"
    config = os.path.join(ROOT, "data", "config", "world.config.json")
    proc = _run(
        ["-m", "raytracing_tpu_torch", "--device", "cpu", "--config", config,
         "--gltf", f"{glb}:1.5:0,1,0", "--width", "48", "--spp", "1",
         "--depth", "3", "--out", str(out)],
        tmp_path,
    )
    assert proc.returncode == 0, proc.stderr
    img = png.read_png(out)
    assert img.shape == (28, 48, 3) and img.max() > 0


@pytest.mark.parametrize("spec", ["ico.glb:x", "ico.glb:1:0,1", ":2",
                                  "missing.glb"])
def test_cli_bad_gltf_spec_exits_2(tmp_path, spec):
    config = os.path.join(ROOT, "data", "config", "world.config.json")
    proc = _run(
        ["-m", "raytracing_tpu_torch", "--device", "cpu", "--config", config,
         "--gltf", spec, "--width", "16", "--out", str(tmp_path / "x.png")],
        tmp_path,
    )
    assert proc.returncode == 2, proc.stderr
    assert "raytracing_tpu_torch:" in proc.stderr
    assert not (tmp_path / "x.png").exists()


def test_cli_cuda_missing_exits_nonzero(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = _run(
        ["-m", "raytracing_tpu_torch", "--width", "64", "--out",
         str(tmp_path / "x.png")],
        tmp_path,
    )
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert not (tmp_path / "x.png").exists()


def test_import_does_not_load_jax(tmp_path):
    proc = _run(
        ["-c", "import sys, raytracing_tpu_torch, raytracing_tpu_torch.cli, "
         "raytracing_tpu_torch.interop, raytracing_tpu_torch.ops._build; "
         "print(sorted(m for m in sys.modules if m == 'jax' or "
         "m.startswith(('jax.', 'raytracing_tpu.'))) or 'clean')"],
        tmp_path,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"
