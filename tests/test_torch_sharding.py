"""The port's (px, spp) device mesh on the CPU: ``["cpu"] * 8`` against the
JAX package's own 8-device mesh (tests/conftest.py), at the shapes of
tests/test_sharding.py.

Both sharded functions trace the same samples as the unsharded call for
every mesh shape (the RNG is keyed by the global pixel or slot and the
absolute sample): segments equal, a px-only mesh bit-equal to the
unsharded port, an spp split within atol 2e-4 / rtol 1e-3 (the order of
the last additions differs). ``Renderer(mesh=)``: the work-ahead waves,
checkpoints and their refusals, and pixel padding past the px quantum."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402
import numpy as np  # noqa: E402

import raytracing_tpu as rt  # noqa: E402
from raytracing_tpu.core import camera as jcamera  # noqa: E402
from raytracing_tpu.parallel import mesh as jmesh  # noqa: E402
from raytracing_tpu.parallel import shard as jshard  # noqa: E402

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch.core import rng as trng  # noqa: E402
from raytracing_tpu_torch.models import integrator as tintegrator  # noqa: E402
from raytracing_tpu_torch.ops import trace as ttrace  # noqa: E402
from raytracing_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from raytracing_tpu_torch.parallel import shard as tshard  # noqa: E402
from raytracing_tpu_torch.runtime import tiling  # noqa: E402

from torch_port_helpers import ATOL, RTOL, to_port  # noqa: E402

CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Many small tensor ops: one intra-op thread keeps a parallel test run
    from oversubscribing the cores (no result depends on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scene(builder):
    b = builder()
    b.add_lambertian_sphere((0.0, -100.5, -1.0), 100.0, (0.5, 0.5, 0.5))
    b.add_metallic_sphere((0.0, 0.0, -1.0), 0.5, (0.8, 0.6, 0.2), 0.1)
    b.add_dielectric_sphere((-1.1, 0.0, -1.0), 0.5, 1.5)
    return b.build()


def _metal_scene(builder):
    """tests/test_sharding.py's all-metal fuzz-0 scene: no RNG on a path."""
    b = builder()
    b.add_metallic_sphere((0.0, -100.5, -1.0), 100.0, (0.5, 0.5, 0.5), 0.0)
    b.add_metallic_sphere((0.0, 0.0, -1.0), 0.5, (0.8, 0.6, 0.2), 0.0)
    return b.build()


def _params(module, **kw):
    d = dict(
        aspect_ratio=2.0, image_width=64, samples_per_pixel=8, max_depth=6,
        vertical_fov=60.0, defocus_angle=0.0, focus_distance=1.0,
        lookfrom=(0.0, 0.0, 0.5), lookat=(0.0, 0.0, -1.0),
    )
    d.update(kw)
    return module.CameraParameters(**d)


def _close(a, b) -> bool:
    return bool(np.isclose(np.asarray(a), np.asarray(b), atol=ATOL,
                           rtol=RTOL).all())


# -- the mesh -------------------------------------------------------------


@pytest.mark.parametrize("sample_axis", [1, 2, 4, 8])
def test_mesh_shapes(sample_axis):
    m = tmesh.make_mesh(CPU8, sample_axis=sample_axis)
    j = jmesh.make_mesh(sample_axis=sample_axis)
    assert m.shape == {"px": j.shape["px"], "spp": j.shape["spp"]}
    assert m.size == 8 and m.first == torch.device("cpu")


def test_mesh_refusals():
    with pytest.raises(ValueError,
                       match="sample_axis=3 must divide device count 8"):
        tmesh.make_mesh(CPU8, sample_axis=3)
    if not torch.cuda.is_available():
        # No CUDA: no mesh of every CUDA device, and no CPU in its place.
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_mesh()
        with pytest.raises(RuntimeError, match="cuda"):
            rtt.Renderer(_metal_scene(rtt.SceneBuilder), _params(rtt),
                         mesh=tmesh.make_mesh(["cuda:0"] * 2))


# -- render_pixels_sharded (the xla wave) ------------------------------------


def _xla_inputs():
    jscene = _scene(rt.SceneBuilder)
    jcam = jcamera.derive(_params(rt))
    ts, tcam = to_port(jscene, jcam)
    return jscene, jcam, ts, tcam


@pytest.mark.parametrize("sample_axis", [1, 2, 8])
def test_render_pixels_sharded_matches_jax_and_unsharded(sample_axis):
    # 64x32 pixels, chunk 8 of spp 8, depth 5 (tests/test_sharding.py):
    # segments equal across the port's shapes, the unsharded port and the
    # JAX package's mesh; a px-only mesh (and one sample a shard, summed in
    # shard order) bit-equal to the unsharded port.
    jscene, jcam, ts, tcam = _xla_inputs()
    ids = np.arange(2048, dtype=np.int32)
    ref, ref_seg = tintegrator.render_pixels(ts, tcam, trng.key(11),
                                             torch.from_numpy(ids).long(),
                                             0, 8, 8, 5)
    m = tmesh.make_mesh(CPU8, sample_axis=sample_axis)
    got, seg = tshard.render_pixels_sharded(ts, tcam, trng.key(11),
                                            torch.from_numpy(ids).long(), 0,
                                            8, 8, 5, m)
    jm = jmesh.make_mesh(sample_axis=sample_axis)
    want, want_seg = jshard.render_pixels_sharded(
        jscene, jcam, jr.key(11), jnp.asarray(ids), jnp.int32(0), 8, 8, 5, jm
    )
    assert int(seg) == int(ref_seg) == int(want_seg)
    assert _close(got, ref) and _close(got, want)
    if sample_axis in (1, 8):
        assert torch.equal(got, ref)


def test_render_pixels_sharded_uneven_chunk_masked_tail():
    # chunk 5 over 4 spp shards: ceil(5/4) = 2 samples each, the 3 past the
    # chunk masked.
    _, _, ts, tcam = _xla_inputs()
    ids = torch.arange(2048)
    ref, _ = tintegrator.render_pixels(ts, tcam, trng.key(3), ids, 0, 5, 16,
                                       4)
    got, seg = tshard.render_pixels_sharded(
        ts, tcam, trng.key(3), ids, 0, 5, 16, 4,
        tmesh.make_mesh(CPU8, sample_axis=4),
    )
    assert _close(got, ref)
    _, seg8 = tintegrator.render_pixels(ts, tcam, trng.key(3), ids, 0, 8, 16,
                                        4)
    assert int(seg) == int(seg8)  # the masked tail is traced all the same
    with pytest.raises(ValueError, match="px shards"):
        tshard.render_pixels_sharded(ts, tcam, trng.key(3), ids[:2044], 0, 5,
                                     16, 4, tmesh.make_mesh(CPU8))


# -- render_pixels_fused_sharded (the regeneration kernel) --------------------


def _fused_inputs(width=64, spp=2):
    jscene = _metal_scene(rt.SceneBuilder)
    jcam = jcamera.derive(_params(rt, image_width=width,
                                  samples_per_pixel=spp, max_depth=4))
    ts, tcam = to_port(jscene, jcam)
    return jscene, jcam, ts, tcam


def _padded_slots(jcam, n_px):
    q = 1024 * n_px
    slots = tiling.num_slots(jcam.image_width, jcam.image_height)
    return -(-slots // q) * q


def _unsharded(ts, tcam, slots, spp, depth=4, seed=3):
    return ttrace.render_pixels_fused(
        ts, tcam, slot_base=0, map_param=tiling.tiles_per_row(64), seed=seed,
        sample_start=0, spp=spp, max_depth=depth, t_end=spp,
        done=torch.zeros(slots, dtype=torch.int32), num_slots=slots,
    )


@pytest.mark.parametrize("sample_axis", [1, 2])
def test_fused_sharded_matches_jax_and_unsharded(sample_axis):
    jscene, jcam, ts, tcam = _fused_inputs()
    m = tmesh.make_mesh(CPU8, sample_axis=sample_axis)
    slots = _padded_slots(jcam, m.shape["px"])
    r1, s1, _ = _unsharded(ts, tcam, slots, 2)
    rn, sn = tshard.render_pixels_fused_sharded(ts, tcam, 0, 3, 0, 2, 4,
                                                slots, m)
    jm = jmesh.make_mesh(jax.devices(), sample_axis=sample_axis)
    want, want_seg = jshard.render_pixels_fused_sharded(
        jscene, jcam, jnp.int32(0), jnp.int32(3), jnp.int32(0), jnp.int32(2),
        jnp.int32(4), slots, jm, pixel_order="tiled", interpret=True,
    )
    assert int(sn) == int(s1) == int(want_seg)
    assert _close(rn, r1) and _close(rn, want)
    if sample_axis == 1:
        assert torch.equal(rn, r1)


@pytest.mark.parametrize("sample_axis", [2, 4])
def test_fused_sharded_work_ahead_waves_exact(sample_axis):
    # Waves to cumulative targets 1, 3, 4 of a 4-spp budget: every shard
    # drains its own budget share, segments equal the unsharded kernel's
    # and the self-contained sharded wave's, radiance within tolerance.
    _, jcam, ts, tcam = _fused_inputs(spp=4)
    m = tmesh.make_mesh(CPU8, sample_axis=sample_axis)
    n_sp = m.shape["spp"]
    slots = _padded_slots(jcam, m.shape["px"])
    r1, s1, _ = _unsharded(ts, tcam, slots, 4)
    rn, sn = tshard.render_pixels_fused_sharded(ts, tcam, 0, 3, 0, 4, 4,
                                                slots, m)
    done = torch.zeros((n_sp * slots // 128, 128), dtype=torch.int32)
    acc = torch.zeros((slots, 3))
    segs = 0
    for t in (1, 3, 4):
        _, seg, done = tshard.render_pixels_fused_sharded(
            ts, tcam, 0, 3, 0, 4, 4, slots, m, done=done, t_end=t,
            radiance_sum=acc,
        )
        segs += int(seg)
    d = done.reshape(n_sp, -1, 128)
    for s in range(n_sp):
        lo, hi = (4 * s) // n_sp, (4 * (s + 1)) // n_sp
        assert (d[s] == hi - lo).all()
    assert int(s1) == int(sn) == segs
    assert _close(acc, r1) and _close(acc, rn)
    with pytest.raises(ValueError, match="both done and t_end"):
        tshard.render_pixels_fused_sharded(ts, tcam, 0, 3, 0, 4, 4, slots, m,
                                           done=done)
    with pytest.raises(ValueError, match="kernel tile"):
        tshard.render_pixels_fused_sharded(ts, tcam, 0, 3, 0, 4, 4, 3072, m)


# -- Renderer(mesh=) ------------------------------------------------------------


def _renderer(scene, params, mesh=None, **kw):
    return rtt.Renderer(scene, params, device="cpu" if mesh is None else None,
                        mesh=mesh, **kw)


def test_renderer_mesh_matches_jax_and_unsharded():
    # The kernel under (px 4, spp 2) on the all-metal scene: the JAX
    # package's sharded render's image and segments, and the unsharded
    # port's image.
    params = _params(rtt, samples_per_pixel=2, max_depth=4)
    scene = _metal_scene(rtt.SceneBuilder)
    m = tmesh.make_mesh(CPU8, sample_axis=2)
    r = _renderer(scene, params, m)
    img = r.render(spp=2)
    one = _renderer(scene, params)
    np.testing.assert_array_equal(img, one.render(spp=2))
    jr_ = rt.Renderer(_metal_scene(rt.SceneBuilder), _params(
        rt, samples_per_pixel=2, max_depth=4), seed=0, backend="pallas",
        mesh=jmesh.make_mesh(jax.devices(), sample_axis=2))
    np.testing.assert_array_equal(img, jr_.render(spp=2))
    assert r.segments_traced == jr_.segments_traced


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_renderer_px_only_mesh_bit_equal(backend):
    params = _params(rtt, samples_per_pixel=4, max_depth=4, image_width=48)
    scene = _scene(rtt.SceneBuilder)
    m = tmesh.make_mesh(CPU8[:2], sample_axis=1)
    r = _renderer(scene, params, m, backend=backend, seed=5)
    one = _renderer(scene, params, backend=backend, seed=5)
    np.testing.assert_array_equal(r.render(), one.render())
    assert r.segments_traced == one.segments_traced
    np.testing.assert_array_equal(r._image_sum[:one._image_sum.shape[0]],
                                  one._image_sum)


def test_renderer_mesh_work_ahead_matches_unsharded():
    # 64x64 (4,096 slots, the px quantum: no padding slots), 8 spp in four
    # 2-spp waves under (px 4, spp 2): the same segments as the unsharded
    # render and the image within one code. The port's wave rule stops a
    # slot at its own target (the JAX kernel's tile lanes may trace past
    # it), so after each wave every slot's shards hold exactly the
    # wave's cumulative target between them.
    scene = _metal_scene(rtt.SceneBuilder)
    p = _params(rtt, aspect_ratio=1.0, image_width=64, max_depth=4)
    m = tmesh.make_mesh(CPU8, sample_axis=2)
    r = _renderer(scene, p, m, seed=5, max_rays_per_batch=128)
    targets = []

    def spy(prog):
        tot = r._per_slot_done(r._done)
        assert int(tot.min()) == int(tot.max()) == prog.samples_done
        targets.append(prog.samples_done)

    img = r.render(on_progress=spy)
    assert targets == [2, 4, 6, 8]
    one = _renderer(scene, p, seed=5, max_rays_per_batch=128)
    img1 = one.render()
    assert r.segments_traced == one.segments_traced
    assert int(np.abs(img.astype(int) - img1.astype(int)).max()) <= 1


def test_renderer_mesh_checkpoint_resume_and_refusals(tmp_path):
    # A sharded work-ahead checkpoint (per-shard done blocks + the budget
    # that split them) resumes byte-equal; a ragged state refuses another
    # budget; a checkpoint of one mesh refuses another mesh.
    scene = _metal_scene(rtt.SceneBuilder)
    p = _params(rtt, max_depth=4)
    m = tmesh.make_mesh(CPU8, sample_axis=2)
    path = str(tmp_path / "ckpt.npz")
    r = _renderer(scene, p, m, seed=9, max_rays_per_batch=128)
    saved = []

    def save_once(prog):
        if not saved and prog.samples_done < prog.samples_total:
            r.save_checkpoint(path)
            saved.append(prog.samples_done)

    full = r.render(on_progress=save_once)
    assert saved == [2]
    with np.load(path) as data:
        assert data["done"].shape == (2 * 4096 // 128, 128)
        assert int(data["done_budget"]) == 8
    r2 = _renderer(scene, p, m, seed=9, max_rays_per_batch=128)
    assert r2.load_checkpoint(path) == 2 and r2._done_budget == 8
    np.testing.assert_array_equal(r2.render(resume=True), full)
    assert r2.segments_traced == r.segments_traced
    r3 = _renderer(scene, p, m, seed=9, max_rays_per_batch=128)
    r3.load_checkpoint(path)
    assert not torch.equal(r3._done, r3._prefix_done(4096, 2, 8))
    with pytest.raises(ValueError, match="different spp"):
        r3.render(spp=16, resume=True)
    with pytest.raises(ValueError, match="different mesh px-axis"):
        _renderer(scene, p, seed=9).load_checkpoint(path)
    with pytest.raises(ValueError, match="done array"):
        _renderer(scene, p, tmesh.make_mesh(CPU8[:4], sample_axis=1),
                  seed=9).load_checkpoint(path)
    with pytest.raises(ValueError, match="single-chip"):
        r.render_frame(spp=1)
    with pytest.raises(ValueError, match="first device"):
        rtt.Renderer(scene, p, mesh=m, device="meta")


def test_renderer_mesh_resume_larger_budget_from_boundary():
    # A completed sharded render is a sample prefix in any split: resumed
    # toward 8 spp it re-splits its done blocks and traces the samples of
    # one 8-spp render (equal segments, image within one code).
    scene = _metal_scene(rtt.SceneBuilder)
    p = _params(rtt, samples_per_pixel=4, max_depth=4)
    m = tmesh.make_mesh(CPU8, sample_axis=2)
    r = _renderer(scene, p, m, seed=3)
    r.render(spp=4)
    grown = r.render(spp=8, resume=True)
    once = _renderer(scene, p, m, seed=3)
    img = once.render(spp=8)
    assert r.segments_traced == once.segments_traced
    assert int(np.abs(grown.astype(int) - img.astype(int)).max()) <= 1


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_renderer_mesh_pixel_padding(backend):
    # 49x31 = 1,519 pixels over px 4: the xla blocks and the kernel's slots
    # are padded to the px quantum; the image stays within one code of the
    # unsharded render.
    scene = _scene(rtt.SceneBuilder)
    p = _params(rtt, samples_per_pixel=2, image_width=49,
                aspect_ratio=49 / 31)
    m = tmesh.make_mesh(CPU8, sample_axis=2)
    r = _renderer(scene, p, m, seed=2, backend=backend)
    img = r.render()
    assert r._framebuffer_rows() == (1520 if backend == "xla" else 4096)
    one = _renderer(scene, p, seed=2, backend=backend)
    assert int(np.abs(img.astype(int) - one.render().astype(int)).max()) <= 1
