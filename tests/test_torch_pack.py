"""Port vs JAX package: the packed kernel tables (spheres, the 16-column
textured shade table, texels, triangles) are bit-equal."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import raytracing_tpu as rt  # noqa: E402
from raytracing_tpu.ops.pallas import trace as ptrace  # noqa: E402
from raytracing_tpu.scene.types import SceneBuilder  # noqa: E402

from raytracing_tpu_torch.ops import trace as ttrace  # noqa: E402

from torch_port_helpers import (  # noqa: E402
    COVER, golden_mesh_scene_jax, golden_scene_jax, golden_textured_scene_jax,
    to_port, write_icosphere_glb,
)


def _tied_scene():
    # Several spheres quantize to the same Morton code: the sort must be
    # stable to reproduce jnp.argsort's order (and so the packed ids).
    b = SceneBuilder()
    b.add_lambertian_sphere((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5))
    for k in range(6):
        b.add_metallic_sphere((1.0 + 1e-7 * k, 0.2, 1.0), 0.2, (0.9, 0.8, 0.7), 0.1 * k)
    b.add_dielectric_sphere((3.0, 1.0, 0.0), 1.0, 1.5)
    return b.build()


def _big_texture_scene():
    # A 100x80 image and a 30x20 one: the stack is nearest-downsampled to
    # the 64-texel cap, and each texture's valid size scales with ceil.
    rng = np.random.default_rng(3)
    b = SceneBuilder()
    b.add_checker_sphere((0.0, -1000.0, 0.0), 1000.0, 0.5, (0.1, 0.2, 0.3),
                         (0.9, 0.8, 0.7))
    b.add_image_sphere((0.0, 1.0, 0.0), 1.0, rng.random((80, 100, 3)))
    b.add_image_sphere((2.0, 1.0, 0.0), 0.5,
                       rng.integers(0, 256, (20, 30, 3), np.uint8))
    b.add_lambertian_sphere((-2.0, 1.0, 0.0), 0.7, (0.2, 0.4, 0.6))
    return b.build()


def _mesh_only_scene():
    from raytracing_tpu.scene import mesh as jmesh

    verts, faces = jmesh.make_icosphere(2)
    b = SceneBuilder()
    b.add_mesh(verts, faces, albedo=(0.5, 0.6, 0.7))
    b.add_mesh(verts + np.float32([3.0, 0.0, 0.0]), faces,
               kind=rt.MaterialKind.DIELECTRIC, ior=1.4)
    return b.build()


_SCENES = {
    "cover": lambda: rt.load_and_build(COVER)[1],
    "stress2048": lambda: rt.make_world_stress(2048)[1],
    "golden": golden_scene_jax,
    "ties": _tied_scene,
    "empty": lambda: SceneBuilder().build(),
    "golden_textured": golden_textured_scene_jax,
    "golden_mesh": golden_mesh_scene_jax,
    "textured": lambda: rt.make_world_textured(image_width=64)[1],
    "mesh3": lambda: rt.make_world_mesh(image_width=64)[1],
    "meshes4": lambda: rt.make_world_meshes(4, image_width=64)[1],
    "mesh_only": _mesh_only_scene,
    "big_texture": _big_texture_scene,
}


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.float32 and x.is_contiguous()
        return x.view(torch.int32).numpy()
    return np.asarray(x).view(np.int32)


def _assert_tables_equal(js):
    gh, gc, sh, n = ptrace.pack_scene(js)
    tables = ttrace.pack_scene(to_port(js))
    assert tables.n_actual == n
    for want, got, col in ((gh, tables.geom_h, "geom_h"),
                           (gc, tables.geom_c, "geom_c"),
                           (sh, tables.shade, "shade")):
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=col)
    assert tables.textured == js.has_textures
    if js.has_textures:
        tex, kh, kw, kwh = ptrace.pack_textures(js)
        assert (tables.kh, tables.kw) == (kh, kw)
        np.testing.assert_array_equal(_bits(tables.tex), _bits(tex))
        _, _, _, kwh_t = ttrace.pack_textures(to_port(js))
        np.testing.assert_array_equal(kwh_t.numpy(), np.asarray(kwh))
    assert (tables.tri is not None) == js.has_triangles
    if js.has_triangles:
        tri, m = ptrace.pack_triangles(js)
        assert tables.m_actual == m
        np.testing.assert_array_equal(_bits(tables.tri), _bits(tri))
    return tables


@pytest.mark.parametrize("name", sorted(_SCENES))
def test_pack_tables_bit_equal(name):
    _assert_tables_equal(_SCENES[name]())


def test_pack_gltf_scene_bit_equal(tmp_path):
    glb = write_icosphere_glb(tmp_path / "ico.glb", 2)
    _, js = rt.make_world_mesh(image_width=64, gltf_path=glb)
    tables = _assert_tables_equal(js)
    assert (tables.m_actual, tables.m_pad, tables.tri_rule) == (320, 512, "flat")


def test_texture_downsample_and_triangle_pad_rows():
    t = _assert_tables_equal(_big_texture_scene())
    # 2 textures, stack 80x100 -> 64x64 planes; 8192 texel rows.
    assert (t.kh, t.kw, t.tex.shape[0]) == (64, 64, 8192)
    _, _, _, kwh = ttrace.pack_textures(to_port(_big_texture_scene()))
    assert kwh.tolist() == [[0, 0], [64, 64], [20, 16], [0, 0]]
    m = _assert_tables_equal(_mesh_only_scene())
    assert (m.n_actual, m.m_actual, m.m_pad, m.tri_rule) == (0, 640, 1024, "2l")
    tri = m.tri.numpy()
    assert (tri[640:, 0:3] == np.float32(1e9)).all()
    assert (tri[640:, 3:9] == 0).all() and (tri[640:, 11:] == 0).all()
    assert ttrace.kernel_variant(m) == "regen_tri_2l"


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
