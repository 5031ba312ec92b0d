"""Port vs JAX package: texture math (polynomial atan2/acos, sphere UV,
checker parity, nearest texel, per-hit albedo) and the triangle key's
reciprocal rule.

Bounds: the polynomials run the same f32 operations in the same order on
both sides. Measured on seeded inputs: atan2 and u bit-equal, acos and v
within 3 ulp (XLA-CPU and torch's CPU kernels round a few steps
differently); the texel and checker lookups built on them are bit-equal
except where a UV lands on a texel edge. On the card the kernel and the
plain version share one rounding (tests/test_torch_cuda.py)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import raytracing_tpu as rt  # noqa: E402
from raytracing_tpu.ops import texture as jtex  # noqa: E402

from raytracing_tpu_torch.ops import texture as ttex  # noqa: E402
from raytracing_tpu_torch.ops import trace as ttrace  # noqa: E402

from torch_port_helpers import to_port  # noqa: E402

# Largest difference allowed between the two packages' polynomial results,
# in units in the last place of f32 (measured: at most 3).
ULP_BOUND = 4


def _ulp_diff(a, b) -> np.ndarray:
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ai = np.where(ai < 0, -(ai & 0x7FFFFFFF), ai)
    bi = np.where(bi < 0, -(bi & 0x7FFFFFFF), bi)
    return np.abs(ai - bi)


def _unit_normals(n=20000, seed=4):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    # Axis-aligned and octant-boundary cases (atan2's reduction branches).
    edge = np.array(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
         [0.70710677, 0, 0.70710677], [-0.70710677, 0, -0.70710677],
         [0, 0, 0]], np.float32,
    )
    return np.concatenate([v, edge]).astype(np.float32)


def test_atan2_and_acos_within_ulp_bound():
    rng = np.random.default_rng(11)
    y = rng.normal(size=50000).astype(np.float32) * 10
    x = rng.normal(size=50000).astype(np.float32) * 10
    y[:4] = [0.0, -0.0, 1.0, -1.0]
    x[:4] = [0.0, 1.0, 0.0, -1e-30]
    want = np.asarray(jtex.atan2(jnp.asarray(y), jnp.asarray(x)))
    got = ttex.atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    assert _ulp_diff(got, want).max() <= ULP_BOUND
    # The polynomial's own error against libm (its documented 2.9e-7 rad).
    assert np.abs(got - np.arctan2(y, x)).max() < 1e-6
    c = np.linspace(-1.2, 1.2, 20001, dtype=np.float32)
    want = np.asarray(jtex.acos(jnp.asarray(c)))
    got = ttex.acos(torch.from_numpy(c)).numpy()
    assert _ulp_diff(got, want).max() <= ULP_BOUND
    assert got[0] == got[1] and np.isfinite(got).all()


def test_sphere_uv_within_ulp_bound():
    n = _unit_normals()
    ju, jv = jtex.sphere_uv(jnp.asarray(n))
    tu, tv = ttex.sphere_uv(torch.from_numpy(n))
    assert _ulp_diff(tu.numpy(), ju).max() <= ULP_BOUND
    assert _ulp_diff(tv.numpy(), jv).max() <= ULP_BOUND
    assert (tu >= 0).all() and (tu <= 1).all() and (tv >= 0).all() and (tv <= 1).all()


def test_checker_select_bit_equal():
    rng = np.random.default_rng(6)
    p = (rng.normal(size=(30000, 3)) * 40).astype(np.float32)
    inv = rng.choice(
        np.float32([1.25, 0.3125, 8.3359375, 2.0]), size=30000
    ).astype(np.float32)
    want = np.asarray(jtex.checker_select(jnp.asarray(p), jnp.asarray(inv)))
    got = ttex.checker_select(torch.from_numpy(p), torch.from_numpy(inv)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.4 < got.mean() < 0.6


def test_image_texel_bit_equal():
    rng = np.random.default_rng(9)
    tex = rng.random((3, 8, 12, 3)).astype(np.float32)
    n = 20000
    tid = rng.integers(0, 3, n).astype(np.int32)
    wh = np.array([[12, 8], [5, 7], [1, 1]], np.int32)[tid]
    u = rng.uniform(-0.2, 1.2, n).astype(np.float32)
    v = rng.uniform(-0.2, 1.2, n).astype(np.float32)
    u[:3], v[:3] = [0.0, 1.0, 0.5], [1.0, 0.0, 0.5]
    want = np.asarray(jtex.image_texel(*map(jnp.asarray, (tex, tid, wh, u, v))))
    got = ttex.image_texel(*map(torch.from_numpy, (tex, tid, wh, u, v))).numpy()
    np.testing.assert_array_equal(got, want)


def test_surface_albedo_matches():
    _, js = rt.make_world_textured(image_width=64)
    ts = to_port(js)
    rng = np.random.default_rng(1)
    n = 8000
    idx = rng.integers(0, js.num_objects, n)
    on = _unit_normals(n - 9, seed=2)
    centers = np.asarray(js.centers)[idx]
    radii = np.asarray(js.radii)[idx, None]
    p = (centers + radii * on).astype(np.float32)
    want = np.asarray(jtex.surface_albedo(
        js, jnp.asarray(idx), jnp.asarray(p), jnp.asarray(on)))
    got = ttex.surface_albedo(
        ts, torch.from_numpy(idx), torch.from_numpy(p), torch.from_numpy(on)
    ).numpy()
    # A UV a few ulp off can land on the neighbouring texel on a texel edge.
    same = (got == want).all(axis=1).mean()
    assert same >= 0.999, same


def test_triangle_key_reciprocal_is_pallas_approx_reciprocal():
    # The JAX kernel's triangle key uses pl.reciprocal(approx=True). Run in
    # TPU-interpret mode (as every JAX-side test runs) it is 1 / bf16(x) in
    # f32; the port's key reproduces that, bit for bit, on seeded values.
    rng = np.random.default_rng(12)
    x = np.concatenate([
        np.exp(rng.uniform(-30, 30, 4096)),
        rng.uniform(1e-30, 1e-12, 512), rng.uniform(0.5, 2.0, 512),
    ]).astype(np.float32).reshape(-1, 128)

    def kernel(x_ref, o_ref):
        o_ref[...] = pl.reciprocal(x_ref[...], approx=True)

    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(
            pl.pallas_call(
                kernel, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32)
            )(jnp.asarray(x))
        )
    got = ttrace.bf16_reciprocal(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # It is not the exact reciprocal: up to 0.4% off.
    rel = np.abs(got * x - 1.0)
    assert 1e-3 < rel.max() < 4e-3
