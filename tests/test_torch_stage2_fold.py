"""Stage 2 of the two-level rules folded into the cooperative stage 1
(``csrc/regen.cu``: ``tri_stage1_warp``, ``sphere_chunk_warp``,
``keep_window``), held on the CPU through the plain model
``ops/trace.py::warp_stage1_reference(..., fold=True)``:

* the folded stage-2 key equals the plain version's stage 2
  (``tri_stage2_keys``, ``sphere_stage2_keys``: ``_tri_winner``'s and
  ``_sphere_winner``'s) of the stage-1 winner, ray for ray, on mesh:3, on
  tables whose last real window holds 1, 4, 127 or 128 rows, on near ties
  inside one window, on rays that hit nothing, on windows flagged outside
  ``key_rcp``'s or ``fast_root``'s range, and under every ``RT_CULL*``
  setting;
* where the model keeps row 0 of window 0 with the miss key for a ray that
  never swept window 0, the plain stage 2 reaches no output either: its
  triangle is no exact hit, or lies beyond the sphere hit that bounds the
  gate (the hint); a sphere there is no hit.

Through the plain version, the model with the fold agrees with the JAX
package's two-level closest hits in ``tests/test_torch_warp_sweep.py``
(``_with_model``). The kernel is held against the plain version on a card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import raytracing_tpu_torch as rtt  # noqa: E402
from raytracing_tpu_torch.ops import trace as ttrace  # noqa: E402
from raytracing_tpu_torch.scene import config as tconfig  # noqa: E402
from raytracing_tpu_torch.scene import mesh as tmesh  # noqa: E402
from raytracing_tpu_torch.tools import sweep_edges  # noqa: E402

WIN = ttrace.WIN
MISS2 = ttrace._BIGF_BITS & ~(WIN - 1)  # row 0 of window 0, the miss key


def _camera_rays(params, n: int, seed: int):
    """``n`` rays from the camera through seeded points of its frame."""
    cam = rtt.derive(params, torch.device("cpu"))
    rng = np.random.default_rng(seed)
    px = torch.from_numpy(rng.uniform(0, cam.image_width, n)
                          .astype(np.float32))
    py = torch.from_numpy(rng.uniform(0, cam.image_height, n)
                          .astype(np.float32))
    d = (cam.pixel00[None] + px[:, None] * cam.pixel_delta_u[None]
         + py[:, None] * cam.pixel_delta_v[None] - cam.center[None])
    o = cam.center[None].expand(n, 3)
    return tuple(t.contiguous() for t in (*o.T, *d.T)), cam.center


def _with_sky(rays, every: int = 4):
    """Every ``every``-th ray turned straight up, past everything."""
    ox, oy, oz, dx, dy, dz = (t.clone() for t in rays)
    up = torch.arange(ox.shape[0]) % every == 0
    dx[up], dy[up], dz[up] = 0.0, 1.0, 0.0
    return ox, oy, oz, dx, dy, dz


def _mesh_scene(faces_of, scale: float = 0.5):
    """A ground sphere and the icosphere's faces that ``faces_of`` picks."""
    verts, faces = tmesh.make_icosphere(3)
    b = rtt.SceneBuilder()
    b.add_lambertian_sphere((0.0, -100.5, -1.0), 100.0, (0.5, 0.5, 0.5))
    v, f = faces_of(verts * scale + np.float32([0.0, 0.0, -1.2]), faces)
    b.add_mesh(v, f, albedo=(0.8, 0.6, 0.3), kind=rtt.MaterialKind.METALLIC,
               fuzz=0.1)
    return b.build()


_NEAR = rtt.CameraParameters(
    aspect_ratio=2.0, image_width=64, samples_per_pixel=1, max_depth=4,
    vertical_fov=55.0, defocus_angle=0.0, focus_distance=1.0,
    lookfrom=(0.0, 0.3, 1.2), lookat=(0.0, 0.0, -1.2))


def _near_ties(verts, faces):
    # Each of the first 192 faces twice in a row: once as it is, once with
    # its vertices moved by about an ulp along z, so that a window holds
    # exact and near ties of the key.
    f = faces[:192]
    dup = verts.copy()
    dup[:, 2] = np.nextafter(dup[:, 2], np.float32(np.inf))
    v = np.concatenate([verts, dup]).astype(np.float32)
    pairs = np.stack([f, f + len(verts)], axis=1).reshape(-1, 3)
    return v, np.concatenate([f, pairs])


def _case(name: str, monkeypatch):
    """(kind, tables, rays, hint) of a named case."""
    if name == "mesh3":
        params, scene = tconfig.make_world_mesh(image_width=64,
                                                subdivisions=3)
        rays, center = _camera_rays(params, 1024, seed=3)
        # Half the rays bound by a sphere hit at t = 4, the rest unbound.
        hint = torch.where(torch.arange(1024) % 2 == 0, 4.0, 3.0e38)
        return "tri", ttrace.pack_scene(scene, origin=center), \
            _with_sky(rays), hint
    if name.startswith("rows"):
        monkeypatch.setenv("RT_TWO_LEVEL_MIN", "1")
        m = int(name[4:])
        scene = _mesh_scene(lambda v, f: (v, f[:m]))
        rays, center = _camera_rays(_NEAR, 512, seed=5)
        return "tri", ttrace.pack_scene(scene, origin=center), \
            _with_sky(rays), None
    if name == "near_ties":
        monkeypatch.setenv("RT_TWO_LEVEL_MIN", "1")
        scene = _mesh_scene(_near_ties)
        rays, center = _camera_rays(_NEAR, 1024, seed=6)
        return "tri", ttrace.pack_scene(scene, origin=center), rays, None
    if name == "flagged":
        # A mesh at 2^66: |det| reaches past 2^126, outside key_rcp.
        monkeypatch.setenv("RT_TWO_LEVEL_MIN", "1")
        scene = sweep_edges.scaled_mesh(rtt.SceneBuilder()).build()
        rng = np.random.default_rng(4)
        d = rng.normal(0, 1, (512, 3)).astype(np.float32)
        d[:, 2] = -np.abs(d[:, 2]) - 1.0
        rays = tuple(torch.from_numpy(np.ascontiguousarray(c)) for c in
                     (*np.zeros_like(d).T, *d.T))
        return "tri", ttrace.pack_scene(scene, origin=(0.0, 0.0, 0.0)), \
            rays, None
    if name == "stress_2l":
        monkeypatch.setenv("RT_TWO_LEVEL_MIN", "2048")
        params, scene = tconfig.make_world_stress(2048, image_width=64)
        rays, center = _camera_rays(params, 1024, seed=7)
        return "sphere", ttrace.pack_scene(scene, origin=center), \
            _with_sky(rays), None
    if name == "sphere_flagged":
        # Every hit's discriminant below 2^-101, outside fast_root.
        monkeypatch.setenv("RT_TWO_LEVEL_MIN", "2048")
        scene = sweep_edges.padded_spheres(rtt.SceneBuilder()).build()
        rays, center = _camera_rays(sweep_edges.tiny_camera(), 512, seed=2)
        return "sphere", ttrace.pack_scene(scene, origin=center), rays, None
    raise ValueError(name)


def _fold_equals_plain_stage2(kind, tables, rays, hint):
    """The model's folded key against the plain stage 2 of its stage-1
    winner; returns the model's stats."""
    stats = {}
    best, mask, key2 = ttrace.warp_stage1_reference(
        tables, rays, kind, hint, stats=stats, fold=True)
    plain_best, _ = (ttrace.tri_stage1(tables, rays, hint) if kind == "tri"
                     else ttrace.sphere_stage1(tables, rays))
    assert torch.equal(best, plain_best)
    want = (ttrace.tri_stage2_keys if kind == "tri"
            else ttrace.sphere_stage2_keys)(tables, rays, best)
    hit = best < (ttrace._BIGF_BITS & ~mask)
    assert bool(hit.any())
    # Every ray with a stage-1 hit: its window's stage 2, ray for ray.
    assert torch.equal(key2[hit], want[hit])
    # No hit: row 0 of window 0 with the miss key, or window 0's stage 2
    # where it was swept (the same bits either way when it holds no key).
    miss = ~hit
    differ = miss & (key2 != want)
    assert bool((key2[miss & (key2 != MISS2)]
                 == want[miss & (key2 != MISS2)]).all())
    if bool(differ.any()):
        # Only where window 0 went unswept: the plain stage 2 found a key
        # there, and its words reach no output.
        assert bool((key2[differ] == MISS2).all())
        sub = tuple(t[differ] for t in rays)
        row = (want[differ] & (WIN - 1)).long()
        hitk = want[differ] < MISS2
        if kind == "tri":
            words = tables.tri.view(torch.int32)[row, :11]
            exact, t = ttrace._tri_exact(words, hitk, sub)[:2]
            bound = hint[differ] if hint is not None else None
            assert bound is not None and bool(
                (~exact | (t >= bound)).all())
        else:
            assert not bool(hitk.any())
    stats["unswept_misses"] = int(differ.sum())
    stats["misses"] = int(miss.sum())
    return stats


# rowsM: the first M triangles under the two-level rule, so that the last
# real window holds 1, 4, 127 or 128 rows (129, 132, 255, 256: one
# block; 385, 388, 511, 512: past the first of several culled ones).
CASES = ["mesh3", "rows129", "rows132", "rows255", "rows256", "rows385",
         "rows388", "rows511", "rows512", "near_ties", "flagged",
         "stress_2l", "sphere_flagged"]


@pytest.mark.parametrize("name", CASES)
def test_folded_stage2_equals_plain_stage2(name, monkeypatch):
    kind, tables, rays, hint = _case(name, monkeypatch)
    if kind == "tri":
        assert tables.tri_rule == "2l"
        if name.startswith("rows"):
            real = int(name[4:])
            last = real - (real - 1) // WIN * WIN
            assert last == {129: 1, 132: 4, 255: 127, 256: 128, 385: 1,
                            388: 4, 511: 127, 512: 128}[real]
            assert (tables.tri_bounds is not None) == (real > 256)
    else:
        assert tables.sphere_rule == "2l" and tables.sph_bounds is not None
    stats = _fold_equals_plain_stage2(kind, tables, rays, hint)
    if name in ("flagged", "sphere_flagged"):
        assert stats["resweeps"] > 0
    if name in ("mesh3", "stress_2l") or name.startswith("rows"):
        assert stats["misses"] > 0  # the sky rays


def test_near_ties_share_a_window():
    # The duplicated faces land in the same window as their originals, so
    # the row id decides between equal keys there.
    scene = _mesh_scene(_near_ties)
    tables = ttrace.pack_scene(scene, origin=(0.0, 0.3, 1.2))
    keys = tables.tri[:tables.m_actual, 0:9]
    rows = torch.arange(tables.m_actual)
    same = (keys[:-1, 3:9] == keys[1:, 3:9]).all(dim=1)  # e1, e2 equal
    assert bool((same & (rows[:-1] // WIN == rows[1:] // WIN)).any())


@pytest.mark.parametrize("setting", ["off", "box", "sphere", "sub1", "sub2",
                                     "sub4", "sub8", "hint0"])
@pytest.mark.parametrize("name", ["mesh3", "rows511", "stress_2l"])
def test_folded_stage2_under_cull_settings(name, setting, monkeypatch):
    env = {"off": ("RT_CULL", "0"), "box": ("RT_CULL", "box"),
           "sphere": ("RT_CULL", "sphere"), "sub1": ("RT_CULL_SUB", "1"),
           "sub2": ("RT_CULL_SUB", "2"), "sub4": ("RT_CULL_SUB", "4"),
           "sub8": ("RT_CULL_SUB", "8"), "hint0": ("RT_CULL_HINT", "0")}
    monkeypatch.setenv(*env[setting])
    kind, tables, rays, hint = _case(name, monkeypatch)
    if setting == "off":
        bounds = tables.tri_bounds if kind == "tri" else tables.sph_bounds
        assert bounds is None
    if setting == "hint0" and kind == "tri":
        hint = None  # the plain version drops the hint under RT_CULL_HINT=0
    stats = _fold_equals_plain_stage2(kind, tables, rays, hint)
    if setting == "off":
        assert stats["unswept_misses"] == 0  # every block swept


def test_rows_past_the_real_ones_never_win(monkeypatch):
    # A last window of 1 real row (rows129): the lanes' rows past it stand
    # in as copies of row 128 with larger ids, so the folded key names the
    # window's real row wherever that window wins. Rays aimed at row 128.
    monkeypatch.setenv("RT_TWO_LEVEL_MIN", "1")
    scene = _mesh_scene(lambda v, f: (v, f[:129]))
    o = torch.tensor(_NEAR.lookfrom, dtype=torch.float32)
    tables = ttrace.pack_scene(scene, origin=tuple(_NEAR.lookfrom))
    tri = tables.tri[128]
    rng = np.random.default_rng(8)
    uv = torch.from_numpy(rng.uniform(0.05, 0.45, (64, 2))
                          .astype(np.float32))
    target = tri[0:3] + uv[:, :1] * tri[3:6] + uv[:, 1:] * tri[6:9]
    d = target - o
    rays = (*o[None].expand(64, 3).T.contiguous(), *d.T.contiguous())
    best, mask, key2 = ttrace.warp_stage1_reference(tables, rays, "tri",
                                                    fold=True)
    last = (best & mask) == 1  # the window of one real row won
    assert bool(last.any())
    assert bool(((key2[last] & (WIN - 1)) == 0).all())
    assert bool((key2[last] < MISS2).all())
    want = ttrace.tri_stage2_keys(tables, rays, best)
    assert torch.equal(key2[last], want[last])
