"""Port vs JAX package: the segment-split probe.

The port's plain version (``ops/segment_split.py``) against the JAX
package's probe kernel (``scripts/probe_segment_split.py``'s
``make_kernel``, run in TPU-interpret mode as ``run_variant`` wraps it) on
the cover scene, at 1 tile (1,024 lanes) and K = 3 steps, seed 5, under
both cameras: cover's (the probe's slots are all sky) and the hit camera
looking down on the spheres (so the fetch and a hit's shade run).

Tolerances. XLA-CPU contracts multiply-adds, and its cos, sin and rsqrt
round differently from torch's CPU kernels, so the two sides are not
bit-equal. Measured:

* in process, ``full`` has every lane within atol 2e-4 / rtol 1e-3 under
  cover's camera and 99.7% under the hit camera;
* without XLA-CPU's FMA (a fresh process), ``full`` and ``nogather`` have
  99.8-100% of lanes within tolerance (``full`` bit-equal on 99.8% / 86.1%
  of lanes), and ``nosweep`` / ``base`` 97.6% / 98.3%: their key is dy's
  low bits, so a one-ulp difference in a ray picks another synthetic
  winner and the lane's path parts from there.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from raytracing_tpu_torch.ops import segment_split as tseg  # noqa: E402
from raytracing_tpu_torch.ops import trace as ttrace  # noqa: E402

import raytracing_tpu as rt  # noqa: E402

from torch_port_helpers import (  # noqa: E402
    ATOL, COVER, RTOL, jax_arrays_without_fma, probe_camera_vector,
    segment_probe_jax, to_port,
)

STEPS, SEED = 3, 5
CAMERAS = ("cover", "hit")
JAX_VARIANTS = ("full", "nogather", "nosweep", "base")
# Least share of lanes within tolerance without XLA-CPU's FMA (measured
# above, rounded down).
MIN_CLOSE = {"full": 1.0, "nogather": 0.99, "nosweep": 0.97, "base": 0.97}


def _close(a, b) -> float:
    return float(np.isclose(a, b, atol=ATOL, rtol=RTOL).all(axis=0).mean())


@pytest.fixture(scope="module")
def tables():
    _, scene = rt.load_and_build(COVER)
    return ttrace.pack_scene(to_port(scene), cull=False)


@pytest.fixture(scope="module")
def port(tables):
    """(camera, variant) -> the plain version's (rad, hits) as numpy."""
    out = {}
    for cam in CAMERAS:
        vec = torch.from_numpy(probe_camera_vector(cam))
        for v in tseg.VARIANTS:
            rad, hits = tseg.segment_split(tables, vec, seed=SEED, steps=STEPS,
                                           slots=1024, variant=v)
            out[cam, v] = (rad.numpy(), hits.numpy())
    return out


@pytest.fixture(scope="module")
def jax_no_fma(tmp_path_factory):
    """(camera, variant) -> the JAX probe's output in a process without
    XLA-CPU's FMA."""
    code = (
        "out = {f'{c}_{v}': h.segment_probe_jax(v, c, steps=%d, seed=%d) "
        "for c in %r for v in %r}" % (STEPS, SEED, CAMERAS, JAX_VARIANTS)
    )
    arrays = jax_arrays_without_fma(tmp_path_factory.mktemp("seg"), code)
    return {tuple(k.split("_", 1)): v for k, v in arrays.items()}


@pytest.mark.parametrize("variant", JAX_VARIANTS)
@pytest.mark.parametrize("camera", CAMERAS)
def test_plain_matches_jax_probe_without_fma(port, jax_no_fma, camera,
                                             variant):
    rad_t, _ = port[camera, variant]
    rad_j = jax_no_fma[camera, variant]
    assert rad_t.shape == rad_j.shape == (3, 1024)
    assert np.isfinite(rad_t).all()
    assert _close(rad_t, rad_j) >= MIN_CLOSE[variant]


@pytest.mark.parametrize("camera", CAMERAS)
def test_full_matches_jax_probe_in_process(port, camera):
    rad_j = segment_probe_jax("full", camera, steps=STEPS, seed=SEED)
    rad_t, _ = port[camera, "full"]
    assert _close(rad_t, rad_j) >= 0.99


def test_variant_equalities(port, jax_no_fma):
    for cam in CAMERAS:
        # The radix fetch reads the same words as the indexed load.
        assert np.array_equal(port[cam, "full_radix"][0], port[cam, "full"][0])
        assert np.array_equal(port[cam, "full_radix"][1], port[cam, "full"][1])
        # nosweep and base are the same code on both sides.
        assert np.array_equal(port[cam, "nosweep"][0], port[cam, "base"][0])
        assert np.array_equal(jax_no_fma[cam, "nosweep"],
                              jax_no_fma[cam, "base"])


def test_hit_camera_exercises_fetch_and_shade(port):
    # Cover's camera sees only sky at the probe's slots; the hit camera
    # looks down on the spheres: measured 70.7% of keys hit over 3 steps.
    share = {c: port[c, "full"][1].sum() / (STEPS * 1024) for c in CAMERAS}
    assert share["cover"] == 0.0
    assert share["hit"] > 0.5


def test_tiles_repeat_the_first_tile(tables):
    vec = torch.from_numpy(probe_camera_vector("hit"))
    one, _ = tseg.segment_split(tables, vec, seed=SEED, steps=2, slots=1024,
                                variant="full")
    three, hits = tseg.segment_split(tables, vec, seed=SEED, steps=2,
                                     slots=3072, variant="full")
    assert three.shape == (3, 3072) and hits.shape == (3072,)
    for t in range(3):
        assert torch.equal(three[:, t * 1024:(t + 1) * 1024], one)


def test_wrapper_checks(tables):
    vec = torch.from_numpy(probe_camera_vector("cover"))
    kw = dict(seed=1, steps=1, slots=1024)
    with pytest.raises(ValueError, match="variant"):
        tseg.segment_split(tables, vec, variant="sweep", **kw)
    with pytest.raises(ValueError, match="multiple"):
        tseg.segment_split(tables, vec, variant="full", seed=1, steps=1,
                           slots=1000)
    with pytest.raises(ValueError, match="clocks"):
        tseg.segment_split(tables, vec, variant="full",
                           clocks=torch.zeros((32, 3), dtype=torch.int64),
                           **kw)
    _, textured = rt.make_world_textured(image_width=64)
    with pytest.raises(ValueError, match="untextured"):
        tseg.segment_split(ttrace.pack_scene(to_port(textured)), vec,
                           variant="full", **kw)
