"""Port vs JAX package: the packed kernel tables are bit-equal."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import raytracing_tpu as rt  # noqa: E402
from raytracing_tpu.ops.pallas import trace as ptrace  # noqa: E402
from raytracing_tpu.scene.types import SceneBuilder  # noqa: E402

from raytracing_tpu_torch.ops import trace as ttrace  # noqa: E402

from torch_port_helpers import COVER, golden_scene_jax, to_port  # noqa: E402


def _tied_scene():
    # Several spheres quantize to the same Morton code: the sort must be
    # stable to reproduce jnp.argsort's order (and so the packed ids).
    b = SceneBuilder()
    b.add_lambertian_sphere((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5))
    for k in range(6):
        b.add_metallic_sphere((1.0 + 1e-7 * k, 0.2, 1.0), 0.2, (0.9, 0.8, 0.7), 0.1 * k)
    b.add_dielectric_sphere((3.0, 1.0, 0.0), 1.0, 1.5)
    return b.build()


_SCENES = {
    "cover": lambda: rt.load_and_build(COVER)[1],
    "stress2048": lambda: rt.make_world_stress(2048)[1],
    "golden": golden_scene_jax,
    "ties": _tied_scene,
    "empty": lambda: SceneBuilder().build(),
}


@pytest.mark.parametrize("name", sorted(_SCENES))
def test_pack_tables_bit_equal(name):
    js = _SCENES[name]()
    gh, gc, sh, n = ptrace.pack_scene(js)
    tables = ttrace.pack_scene(to_port(js))
    assert tables.n_actual == n
    for want, got, col in ((gh, tables.geom_h, "geom_h"),
                           (gc, tables.geom_c, "geom_c"),
                           (sh, tables.shade, "shade")):
        assert got.dtype == torch.float32 and got.is_contiguous()
        np.testing.assert_array_equal(
            got.view(torch.int32).numpy(), np.asarray(want).view(np.int32),
            err_msg=col,
        )


def test_morton_order_equals_reference():
    js = _tied_scene()
    want = np.asarray(ptrace._morton_order(js.centers))
    got = ttrace._morton_order(to_port(js).centers).numpy()
    np.testing.assert_array_equal(got, want)


def test_pad_rows_and_packed_words():
    _, js = rt.load_and_build(COVER)
    t = ttrace.pack_scene(to_port(js))
    n = t.n_actual
    assert (t.n_pad, n) == (512, 488)
    gc = t.geom_c.numpy()
    gh = t.geom_h.numpy()
    sh = t.shade.numpy()
    # Pad rows are never hit: cm2 = +1e30 and the last real center repeated.
    assert (gc[n:, 3] == np.float32(1.0e30)).all()
    assert (gc[:n, 3] < 1.0e29).all()
    np.testing.assert_array_equal(gh[n:, :3], np.broadcast_to(gh[n - 1, :3], (512 - n, 3)))
    assert (sh[n:, 3] == 0.0).all()
    # Packed material words survive as exact bit patterns, including the
    # gray ground's negative-subnormal w1 and the dielectric's NaN w1.
    words = t.shade.view(torch.int32).numpy()
    w1 = words[:n, 4].view(np.uint32)
    assert np.uint32(0x80008000) in w1
    assert np.uint32(0xFFFFFFFF) in w1
    albr, albg, albb, param = ttrace._mat_decode(
        torch.from_numpy(words[:, 4]), torch.from_numpy(words[:, 5])
    )
    ja = ptrace._mat_decode(jnp.asarray(words[:, 4]), jnp.asarray(words[:, 5]))
    for got, want in zip((albr, albg, albb, param), ja):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    kinds = set(np.round(param.numpy()[:n], 3).tolist())
    assert -1.0 in kinds and any(k > 5.0 for k in kinds)


def test_pack_refuses_textured_and_triangle_scenes():
    import dataclasses

    ts = to_port(golden_scene_jax())
    with pytest.raises(NotImplementedError):
        ttrace.pack_scene(dataclasses.replace(ts, has_textures=True))
    with pytest.raises(NotImplementedError):
        ttrace.pack_scene(dataclasses.replace(ts, has_triangles=True))
