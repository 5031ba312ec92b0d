"""The port's wavefront backend (``backend="xla"``) against the JAX
package's, on the CPU: the threefry RNG, vector math, scattering,
intersection, the integrator, the xla ``Renderer`` (golden, resume,
checkpoint layouts), the session's xla branch and the CLI's ``--backend``.

Tolerances: RNG words, keys, ``uniform``, ``uniform3`` and
``sample_square`` bit for bit; ``normal`` (so ``unit_vector``) and
``in_unit_disk`` within the ulps measured below (``log1p``, ``sin``,
``cos``, ``rsqrt`` and XLA-CPU's fused multiply-adds round differently
from torch's); radiance within atol 2e-4 / rtol 1e-3 on the share of
pixels each test states, segments equal unless stated."""

import dataclasses
import io

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402
import numpy as np  # noqa: E402

import raytracing_tpu as rt  # noqa: E402
from raytracing_tpu.core import rng as jrng  # noqa: E402
from raytracing_tpu.core import math as jmath  # noqa: E402
from raytracing_tpu.models import integrator as jintegrator  # noqa: E402
from raytracing_tpu.ops import intersect as jintersect  # noqa: E402
from raytracing_tpu.ops import scatter as jscatter  # noqa: E402
from raytracing_tpu.utils import png as jpng  # noqa: E402

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch import cli as tcli  # noqa: E402
from raytracing_tpu_torch.core import camera as tcamera  # noqa: E402
from raytracing_tpu_torch.core import math as tmath  # noqa: E402
from raytracing_tpu_torch.core import rng as trng  # noqa: E402
from raytracing_tpu_torch.models import integrator as tintegrator  # noqa: E402
from raytracing_tpu_torch.ops import intersect as tintersect  # noqa: E402
from raytracing_tpu_torch.ops import scatter as tscatter  # noqa: E402
from raytracing_tpu_torch.ops import trace as ttrace  # noqa: E402
from raytracing_tpu_torch.runtime.interactive import InteractiveSession  # noqa: E402

from torch_port_helpers import (  # noqa: E402
    COVER, bits, close_share, golden_mesh_scene_jax, golden_params,
    golden_scene_jax, golden_textured_scene_jax, jax_arrays_without_fma,
    port_key, to_port,
)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Many small tensor ops: one intra-op thread keeps a parallel test run
    from oversubscribing the cores (no result depends on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ulps(a, b) -> np.ndarray:
    """Distance in float32 ulps (same-sign values)."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


# Ray ids past 2^24 (where float32 stops counting) and up to int32's top.
_IDS = np.array([0, 1, 2, 1000, 2**24 - 1, 2**24, 2**24 + 1, 2**27 + 5,
                 2**31 - 1], np.int32)
# The sample ids of a render resumed from 2 of 6 samples.
_RESUMED_SAMPLES = np.array([2, 3, 4, 5, 2, 3, 4, 5, 63], np.int32)


def _many_keys(n=4096):
    """(JAX keys, port keys) of n rays, two fold levels as render_pixels
    folds them, pixel ids from 2^24 - 2048 in steps of 4099."""
    ids = (np.arange(n, dtype=np.int64) * 4099 + 2**24 - 2048).astype(np.int32)
    samp = (np.arange(n) % 7 + 2).astype(np.int32)
    jk = jrng.fold(jrng.ray_keys(jr.key(11), jnp.asarray(ids)),
                   jnp.asarray(samp))
    tk = trng.fold(trng.ray_keys(trng.key(11), torch.from_numpy(ids)),
                   torch.from_numpy(samp))
    return jk, tk


# -- RNG ---------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 5, 11, 2**31 - 1, -7])
def test_key_matches_jax(seed):
    assert torch.equal(trng.key(seed), port_key(jr.key(seed)))


def test_fold_and_ray_keys_bit_equal():
    jk = jrng.ray_keys(jr.key(11), jnp.asarray(_IDS))
    tk = trng.ray_keys(trng.key(11), torch.from_numpy(_IDS))
    assert torch.equal(tk, port_key(jk))
    jk = jrng.fold(jk, jnp.asarray(_RESUMED_SAMPLES))
    tk = trng.fold(tk, torch.from_numpy(_RESUMED_SAMPLES))
    assert torch.equal(tk, port_key(jk))
    for tag in (0, 1, 2, 3, 0x10000, 0x10000 + 7):
        assert torch.equal(trng.fold(tk, tag), port_key(jrng.fold(jk, tag)))


def test_streams_bit_equal():
    jk, tk = _many_keys()
    assert torch.equal(tk, port_key(jk))
    for name in ("uniform", "uniform3", "sample_square"):
        want = np.asarray(getattr(jrng, name)(jk))
        got = getattr(trng, name)(tk)
        assert (bits(got) == bits(want)).all(), name
    for n in (1, 2, 3):
        want = np.asarray(jax.vmap(lambda k: jr.bits(k, (n,)))(jk))
        assert (trng.random_bits(tk, n).numpy() == want.astype(np.int64)).all()
    scalar = np.asarray(jax.vmap(lambda k: jr.bits(k, ()))(jk))
    assert (trng.random_bits(tk, 1)[:, 0].numpy() == scalar).all()
    # A span whose product is inexact: XLA-CPU fuses the scale and the
    # offset into one FMA, torch rounds twice (the package's ranges, [0, 1),
    # [-0.5, 0.5) and normal's, scale exactly).
    want = np.asarray(jax.vmap(lambda k: jr.uniform(k, (5,), jnp.float32,
                                                    -2.0, 3.5))(jk))
    got = trng._bits_to_uniform(trng.random_bits(tk, 5), -2.0, 3.5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-7)


def test_normal_unit_vector_and_disk_within_ulps():
    # Measured on these 4,096 keys (12,288 values): normal within 3 ulps
    # (4.7% differ), unit_vector within 4 (35%), in_unit_disk within 2
    # (4.6%). Per function on the CPU: XLA's rsqrt is an estimate, 36% of
    # values 1-2 ulps off torch's; log1p 2 ulps (8%); sin, cos 1 ulp (5%);
    # erfinv's polynomial 2 ulps (5%, 1% without XLA's fused
    # multiply-adds).
    jk, tk = _many_keys()
    normal = np.asarray(jax.vmap(lambda k: jr.normal(k, (3,), jnp.float32))(jk))
    assert _ulps(trng.normal(tk, 3), normal).max() <= 3
    assert _ulps(trng.unit_vector(tk), jrng.unit_vector(jk)).max() <= 4
    assert _ulps(trng.in_unit_disk(tk), jrng.in_unit_disk(jk)).max() <= 2


def test_erfinv_is_xlas_polynomial():
    # XLA's single-precision ErfInv (not torch.erfinv): within 2 ulps on
    # 65,536 values and the edges, +-1 exactly +-inf.
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.uniform(-1.0, 1.0, 65536).astype(np.float32),
        np.float32([0.0, 0.5, -0.5, 1e-8, 0.9999, -0.9999,
                    np.nextafter(np.float32(-1), np.float32(0)),
                    np.nextafter(np.float32(1), np.float32(0))]),
    ])
    want = np.asarray(jax.jit(jax.lax.erf_inv)(jnp.asarray(x)))
    assert _ulps(trng.erfinv(torch.from_numpy(x)), want).max() <= 2
    ends = trng.erfinv(torch.tensor([1.0, -1.0]))
    assert ends.tolist() == [float("inf"), float("-inf")]


# -- math, scatter, intersect ------------------------------------------------


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_math_matches_jax():
    rng = np.random.default_rng(1)
    v = rng.normal(size=(2048, 3)).astype(np.float32)
    n = _unit(rng.normal(size=(2048, 3))).astype(np.float32)
    eta = rng.uniform(0.5, 2.0, 2048).astype(np.float32)
    t = rng.uniform(0.0, 5.0, 2048).astype(np.float32)
    tv, tn, te, tt = (torch.from_numpy(a) for a in (v, n, eta, t))
    uv = _unit(v).astype(np.float32)
    cases = [
        (tmath.normalize(tv, eps=1e-20), jmath.normalize(v, eps=1e-20)),
        (tmath.reflect(tv, tn), jmath.reflect(v, n)),
        (tmath.refract(torch.from_numpy(uv), tn, te),
         jmath.refract(uv, n, eta)),
        (tmath.point_at_param(tv, tn, tt), jmath.point_at_param(v, n, t)),
        (tmath.lerp(tv, tn, tt[:, None]), jmath.lerp(v, n, t[:, None])),
        (tmath.dot(tv, tn), jmath.dot(v, n)),
    ]
    for got, want in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    small = np.float32([[1e-9, -1e-9, 0.0], [1e-9, 1e-7, 0.0]])
    assert tmath.near_zero(torch.from_numpy(small)).tolist() == [True, False]


def test_scatter_matches_jax():
    rng = np.random.default_rng(2)
    b = 4096
    d = rng.normal(size=(b, 3)).astype(np.float32)
    n = _unit(rng.normal(size=(b, 3))).astype(np.float32)
    n = np.where((np.sum(d * n, -1) > 0)[:, None], -n, n).astype(np.float32)
    front = rng.random(b) < 0.5
    kind = rng.integers(0, 3, b).astype(np.int32)
    albedo = rng.random((b, 3)).astype(np.float32)
    fuzz = rng.uniform(0, 0.5, b).astype(np.float32)
    ior = rng.uniform(1.1, 2.4, b).astype(np.float32)
    jk, tk = _many_keys(b)
    uvec = np.asarray(jrng.unit_vector(jk))
    ur = rng.random(b).astype(np.float32)
    args = (d, n, front, kind, albedo, fuzz, ior, uvec, ur)
    want = jscatter.scatter(*(jnp.asarray(a) for a in args))
    got = tscatter.scatter(*(torch.from_numpy(np.array(a)) for a in args))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-5)
    assert torch.equal(got[1], torch.from_numpy(albedo))
    assert (got[2].numpy() == np.asarray(want[2])).all()


def _camera_rays(jparams):
    """(origins, directions) of one sample a pixel from the JAX camera."""
    from raytracing_tpu.core import camera as jcamera

    jcam = rt.derive(jparams)
    w, h = jcam.image_width, jcam.image_height
    pix = jnp.arange(w * h)
    keys = jrng.ray_keys(jr.key(3), pix)
    o, d = jcamera.generate_rays(jcam, keys, pix % w, pix // w)
    return jcam, keys, np.asarray(o), np.asarray(d)


def test_generate_rays_matches_jax():
    jparams = golden_params(image_width=48, defocus_angle=2.0,
                            focus_distance=1.5)
    jcam, keys, o, d = _camera_rays(jparams)
    _, tcam = to_port(golden_scene_jax(), jcam)
    w = jcam.image_width
    pix = torch.arange(w * jcam.image_height)
    to, td = tcamera.generate_rays(tcam, port_key(keys), pix % w,
                                           pix // w)
    # The disk's sin/cos differ by an ulp: the origins and directions agree
    # to float32 rounding.
    np.testing.assert_allclose(to.numpy(), o, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), d, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("use_matmul", [True, False])
def test_intersect_scene_matches_jax(use_matmul):
    jparams, js = rt.load_and_build(COVER)
    jparams = dataclasses.replace(jparams, image_width=64)
    _, _, o, d = _camera_rays(jparams)
    want = jintersect.intersect_scene(jnp.asarray(o), jnp.asarray(d), js,
                                      use_matmul=use_matmul)
    got = tintersect.intersect_scene(torch.from_numpy(o), torch.from_numpy(d),
                                     to_port(js), use_matmul=use_matmul)
    t_j, i_j, h_j = (np.asarray(x) for x in want)
    assert (got[2].numpy() == h_j).all() and h_j.any()
    # The radius-1000 ground's c = |c|^2 - 2 o.c + |o|^2 - r^2 cancels ~1e6
    # in float32: its t differs by up to 1.1e-4 (measured) where the
    # products round differently; 99% of hits within 1e-5 relative.
    t_p = got[0].numpy()[h_j]
    np.testing.assert_allclose(t_p, t_j[h_j], rtol=0, atol=2e-4)
    assert np.isclose(t_p, t_j[h_j], rtol=1e-5, atol=0).mean() >= 0.99
    assert (got[1].numpy()[h_j] == i_j[h_j]).all()
    # The records of the same hits.
    p, nrm, front = tintersect.hit_records(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_j),
        torch.from_numpy(i_j).long(), to_port(js))
    jp, jn, jf = jintersect.hit_records(jnp.asarray(o), jnp.asarray(d),
                                        jnp.asarray(t_j), jnp.asarray(i_j), js)
    np.testing.assert_allclose(p.numpy()[h_j], np.asarray(jp)[h_j],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nrm.numpy()[h_j], np.asarray(jn)[h_j],
                               rtol=1e-4, atol=1e-4)
    assert (front.numpy()[h_j] == np.asarray(jf)[h_j]).all()


def test_triangles_bvh_brute_and_jax_agree():
    js = golden_mesh_scene_jax()
    _, _, o, d = _camera_rays(golden_params(image_width=64))
    ts = to_port(js)
    to_, td = torch.from_numpy(o), torch.from_numpy(d)
    bvh = tintersect.intersect_triangles_bvh(to_, td, ts)
    brute = tintersect.intersect_triangles(to_, td, ts)
    want = [np.asarray(x) for x in jintersect.intersect_triangles_bvh(
        jnp.asarray(o), jnp.asarray(d), js)]
    hit = want[2]
    assert hit.sum() > 100
    for got in (bvh, brute):
        assert (got[2].numpy() == hit).all()
        np.testing.assert_allclose(got[0].numpy()[hit], want[0][hit],
                                   rtol=1e-5)
        assert (got[1].numpy()[hit] == want[1][hit]).all()
    p, n, f = tintersect.triangle_hit_records(to_, td, bvh[0], bvh[1], ts)
    jp, jn, jf = jintersect.triangle_hit_records(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(want[0]),
        jnp.asarray(want[1]), js)
    np.testing.assert_allclose(n.numpy()[hit], np.asarray(jn)[hit],
                               rtol=1e-5, atol=1e-6)
    assert (f.numpy()[hit] == np.asarray(jf)[hit]).all()


# -- integrator ----------------------------------------------------------------

_SCENES = {
    "golden": lambda: (golden_params(), golden_scene_jax()),
    "textured": lambda: (golden_params(), golden_textured_scene_jax()),
    # 80 triangles: the BVH walk (above 2 * TRI_BVH_MIN_LEAVES).
    "mesh": lambda: (golden_params(defocus_angle=0.5, focus_distance=2.0),
                     golden_mesh_scene_jax()),
}


def _render_pixels_both(jparams, js, *, start=3, chunk=2, spp=8, depth=4,
                        seed=5):
    jcam = rt.derive(jparams)
    ts, tcam = to_port(js, jcam)
    ids = np.arange(jcam.image_width * jcam.image_height, dtype=np.int32)
    rj, sj = jintegrator.render_pixels(js, jcam, jr.key(seed),
                                       jnp.asarray(ids), jnp.int32(start),
                                       chunk, spp, depth)
    rp, sp = tintegrator.render_pixels(ts, tcam, trng.key(seed),
                                       torch.from_numpy(ids).long(), start,
                                       chunk, spp, depth)
    return (np.asarray(rj), int(sj)), (rp.numpy(), int(sp))


@pytest.mark.parametrize("name", sorted(_SCENES))
def test_render_pixels_matches_jax(name):
    # Measured: segments equal and every pixel within tolerance on all
    # three scenes (48x24, samples 3-4 of 8, depth 4).
    jparams, js = _SCENES[name]()
    jparams = dataclasses.replace(jparams, image_width=48)
    (rj, sj), (rp, sp) = _render_pixels_both(jparams, js)
    assert sp == sj
    assert close_share(rp, rj) == 1.0


def test_cover_render_pixels_matches_jax_without_fma(tmp_path):
    # With XLA-CPU's fused multiply-adds, cover's segments differ by a few
    # (measured 2 of 6,349 at 48x27, depth 4) and 99.8% of pixels are
    # within tolerance; without them the paths agree.
    code = (
        "import dataclasses, jax.numpy as jnp, jax.random as jr\n"
        "import raytracing_tpu as rt\n"
        "from raytracing_tpu.models import integrator\n"
        f"p, s = rt.load_and_build({COVER!r})\n"
        "cam = rt.derive(dataclasses.replace(p, image_width=48))\n"
        "ids = jnp.arange(cam.image_width * cam.image_height)\n"
        "r, n = integrator.render_pixels(s, cam, jr.key(5), ids, "
        "jnp.int32(3), 2, 8, 4)\n"
        "out = {'rad': np.asarray(r), 'seg': np.asarray(n)}"
    )
    data = jax_arrays_without_fma(tmp_path, code)
    jparams, js = rt.load_and_build(COVER)
    jparams = dataclasses.replace(jparams, image_width=48)
    (rj, sj), (rp, sp) = _render_pixels_both(jparams, js)
    assert abs(sp - sj) <= 8
    assert close_share(rp, rj) >= 0.99
    assert sp == int(data["seg"])
    assert close_share(rp, data["rad"]) == 1.0


def test_sample_limit_masks_the_tail_and_trace_edges():
    jparams, js = _SCENES["golden"]()
    jcam = rt.derive(dataclasses.replace(jparams, image_width=32))
    ts, tcam = to_port(js, jcam)
    ids = torch.arange(jcam.image_width * jcam.image_height)
    key = trng.key(4)
    two, seg2 = tintegrator.render_pixels(ts, tcam, key, ids, 0, 2, 4, 3)
    four, seg4 = tintegrator.render_pixels(ts, tcam, key, ids, 0, 4, 4, 3,
                                           sample_limit=2)
    assert torch.equal(two, four) and int(seg4) > int(seg2)
    # An empty world: every ray escapes at its first bounce; depth 0 is
    # black.
    empty = rtt.SceneBuilder().build()
    o = torch.zeros((5, 3))
    d = torch.randn((5, 3), generator=torch.Generator().manual_seed(0))
    k = trng.ray_keys(key, torch.arange(5))
    rad, seg = tintegrator.trace_rays(empty, o, d, k, 4)
    assert torch.equal(rad, tintegrator.sky_color(d)) and int(seg) == 5
    rad, seg = tintegrator.trace_rays(empty, o, d, k, 0)
    assert not rad.any() and int(seg) == 0


def test_render_pixels_pallas_branch_is_the_kernel_wave():
    jparams, js = _SCENES["golden"]()
    jcam = rt.derive(jparams)
    ts, tcam = to_port(js, jcam)
    ids = torch.arange(2048)
    rad, seg = tintegrator.render_pixels(
        ts, tcam, trng.key(0), ids, 0, 2, 2, 4, backend="pallas",
        pallas_seed=3, pixel_order="linear",
    )
    want, wseg, _ = ttrace.render_pixels_fused(
        ts, tcam, slot_base=0, map_param=jcam.image_width, seed=3,
        sample_start=0, spp=2, max_depth=4, t_end=2,
        done=torch.zeros(2048, dtype=torch.int32), num_slots=2048,
        pixel_order="linear",
    )
    assert torch.equal(rad, want) and int(seg) == int(wseg)
    with pytest.raises(NotImplementedError):
        tintegrator.render_pixels(ts, tcam, trng.key(0), ids, 0, 2, 2, 4,
                                  backend="pallas", sample_limit=1)


# -- the xla renderer, the session and the CLI ----------------------------------


def _port_params(jparams, **kw):
    return rtt.CameraParameters(**{**dataclasses.asdict(jparams), **kw})


def _xla(js, jparams, **kw):
    kw.setdefault("seed", 11)
    return rtt.Renderer(to_port(js), _port_params(jparams), device="cpu",
                        backend="xla", **kw)


def test_mini_xla_golden_byte_equal():
    # tests/golden/mini_xla.png (the JAX package's xla golden): byte-equal
    # through the port on the CPU, segments equal to the JAX renderer's.
    import os

    want = jpng.read_png(os.path.join(os.path.dirname(__file__), "golden",
                                      "mini_xla.png"))
    r = _xla(golden_scene_jax(), golden_params())
    np.testing.assert_array_equal(r.render(spp=1), want)
    jrend = rt.Renderer(golden_scene_jax(), golden_params(), seed=11,
                        backend="xla")
    jrend.render(spp=1)
    assert r.segments_traced == jrend.segments_traced


def test_xla_renderer_pixel_blocks_match_jax():
    # 48x24 in blocks of 512 pixels (the last padded with spill ids), one
    # sample a wave: segments equal to the JAX renderer's, image within one
    # code (the JAX package adds a per-wave sum, the port continues each
    # pixel's; measured: equal).
    jparams = golden_params(image_width=48, max_depth=4)
    js = golden_scene_jax()
    jrend = rt.Renderer(js, jparams, seed=2, backend="xla",
                        max_rays_per_batch=512)
    want = jrend.render(spp=2)
    r = _xla(js, jparams, seed=2, max_rays_per_batch=512)
    assert r._plan(2, 1152) == (512, 1)
    got = r.render(spp=2)
    assert r.segments_traced == jrend.segments_traced
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01


def test_xla_resume_byte_equal_same_and_higher_spp(tmp_path):
    jparams = golden_params(image_width=48, max_depth=4)
    js = golden_scene_jax()
    # Same spp: a checkpoint from the progress callback after the first of
    # three 2-spp waves, resumed in a new renderer.
    one = _xla(js, jparams, max_rays_per_batch=2 * 1152)
    ck = str(tmp_path / "ck.npz")
    saved = []

    def save_once(p):
        if not saved:
            one.save_checkpoint(ck)
            saved.append(p.samples_done)

    full = one.render(spp=6, on_progress=save_once)
    assert saved == [2]
    two = _xla(js, jparams, max_rays_per_batch=2 * 1152)
    assert two.load_checkpoint(ck) == 2
    np.testing.assert_array_equal(two.render(spp=6, resume=True), full)
    assert two.segments_traced == one.segments_traced
    # Higher spp: 2 spp saved, resumed to 6 in one wave of 4, against one
    # 6-spp wave.
    first = _xla(js, jparams)
    first.render(spp=2)
    first.save_checkpoint(ck)
    second = _xla(js, jparams)
    second.load_checkpoint(ck)
    resumed = second.render(spp=6, resume=True)
    once = _xla(js, jparams)
    np.testing.assert_array_equal(resumed, once.render(spp=6))
    assert second.segments_traced == once.segments_traced
    assert second.samples_done == 6
    with np.load(ck) as data:
        assert str(data["layout"]) == "pixel" and "done" not in data
        assert data["image_sum"].shape == (1153, 3)


def test_checkpoint_layouts_refused_across_backends(tmp_path):
    jparams = golden_params(image_width=32, max_depth=3)
    js = golden_scene_jax()
    kernel = rtt.Renderer(to_port(js), _port_params(jparams), seed=11,
                          device="cpu")
    kernel.render(spp=1)
    kernel.save_checkpoint(str(tmp_path / "slot.npz"))
    xla = _xla(js, jparams)
    xla.render(spp=1)
    xla.save_checkpoint(str(tmp_path / "pixel.npz"))
    with pytest.raises(ValueError, match="layout 'slot' does not match the "
                       "'xla' backend's 'pixel' layout"):
        _xla(js, jparams).load_checkpoint(str(tmp_path / "slot.npz"))
    with pytest.raises(ValueError, match="layout 'pixel' does not match the "
                       "'pallas' backend's 'slot' layout"):
        rtt.Renderer(to_port(js), _port_params(jparams), seed=11,
                     device="cpu").load_checkpoint(str(tmp_path / "pixel.npz"))


def test_backend_names_frame_api_and_cuda_refusal():
    jparams = golden_params(image_width=32)
    js = golden_scene_jax()
    assert rtt.Renderer(to_port(js), _port_params(jparams),
                        device="cpu").backend == "pallas"
    with pytest.raises(ValueError, match="unknown backend"):
        rtt.Renderer(to_port(js), _port_params(jparams), device="cpu",
                     backend="tpu")
    r = _xla(js, jparams)
    for call in (r.render_frame, r.render_frame_preview,
                 r.render_frame_accum, r.render_frame_accum_preview):
        with pytest.raises(ValueError, match="requires the pallas backend"):
            call(spp=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            rtt.Renderer(to_port(js), _port_params(jparams), backend="xla",
                         device="cuda")


def test_session_xla_branch_accumulates_byte_equal():
    # Idle frames of 2 then 4 samples through render(resume=True): the
    # one-shot 6-spp render's bytes in the port (the JAX package's session
    # allows one code off); within one code of the JAX package's render; a
    # pose change reseeds and starts again.
    params = dict(
        aspect_ratio=2.0, image_width=48, samples_per_pixel=2, max_depth=3,
        vertical_fov=45.0, defocus_angle=0.0, focus_distance=2.0,
        lookfrom=(0.0, 0.5, 1.5), lookat=(0.0, 0.0, -1.0),
    )
    b = rtt.SceneBuilder()
    b.add_metallic_sphere((0.0, -100.5, -1.0), 100.0, (0.5, 0.5, 0.5), 0.0)
    b.add_lambertian_sphere((0.0, 0.0, -1.0), 0.5, (0.7, 0.3, 0.3))
    s = InteractiveSession(b.build(), rtt.CameraParameters(**params), seed=0,
                           device="cpu", backend="xla", stream=io.StringIO())
    img = None
    for _ in range(2):
        img = s.step()
    assert s.samples_at_pose == 6 and img.shape == (24, 48, 3)
    oracle = rtt.Renderer(s.renderer.scene, s.renderer.params, seed=0,
                          device="cpu", backend="xla")
    np.testing.assert_array_equal(img, oracle.render(spp=6))
    np.testing.assert_array_equal(s.renderer.fetch_image(s.last_frame), img)
    jb = rt.SceneBuilder()
    jb.add_metallic_sphere((0.0, -100.5, -1.0), 100.0, (0.5, 0.5, 0.5), 0.0)
    jb.add_lambertian_sphere((0.0, 0.0, -1.0), 0.5, (0.7, 0.3, 0.3))
    jparams = dataclasses.replace(rt.CameraParameters(**params),
                                  lookfrom=s.renderer.params.lookfrom)
    ref = rt.Renderer(jb.build(), jparams, seed=0, backend="xla").render(spp=6)
    diff = np.abs(img.astype(int) - ref.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.005
    s.step("a")
    assert s.samples_at_pose == 2 and s.renderer.seed == 0


def test_cli_backend(tmp_path):
    assert tcli.build_arg_parser().parse_args([]).backend == "auto"
    with pytest.raises(SystemExit):
        tcli.build_arg_parser().parse_args(["--backend", "tpu"])
    base = ["--device", "cpu", "--width", "32", "--spp", "2", "--depth", "3",
            "--quiet"]
    outs = {}
    for backend in ("xla", "pallas", "auto"):
        out = str(tmp_path / f"{backend}.png")
        assert tcli.main(base + ["--backend", backend, "--out", out]) == 0
        outs[backend] = jpng.read_png(out)
    params, scene = rtt.load_and_build(COVER)
    params = dataclasses.replace(params, image_width=32,
                                 samples_per_pixel=2, max_depth=3)
    want = rtt.Renderer(scene, params, device="cpu", backend="xla").render()
    np.testing.assert_array_equal(outs["xla"], want)
    np.testing.assert_array_equal(outs["pallas"], outs["auto"])
