"""World/scene configuration: JSON schema + procedural scene builders.

Counterpart of ``raytracing_tpu/scene/config.py``. It reads the same JSON
layout (``{"material_def": "<TypeName>", ...}`` tagged materials, the
checker and image defs included) and builds the same scenes:
``build_world`` keeps the reference quirk that places every grid sphere
(22 x 22 + 4 = 488 spheres with the shipped config) and draws from
``numpy.random.default_rng`` in the same order, and the textured and mesh
scene builders make the same calls, so the port's Scene arrays equal the
JAX package's.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Sequence

import numpy as np

from ..core.camera import CameraParameters
from .types import Scene, SceneBuilder

DEFAULT_GRID_SEED = 20260816


@dataclasses.dataclass(frozen=True)
class SphereDef:
    center: tuple[float, float, float]
    radius: float


@dataclasses.dataclass(frozen=True)
class AlbedoMatDef:
    """Lambertian material def."""

    albedo: tuple[float, float, float]


@dataclasses.dataclass(frozen=True)
class DielectricMatDef:
    refindex: float


@dataclasses.dataclass(frozen=True)
class MetallicMatDef:
    """Field spelled ``fuzzines`` to stay JSON-compatible."""

    albedo: tuple[float, float, float]
    fuzzines: float


@dataclasses.dataclass(frozen=True)
class CheckerMatDef:
    """Lambertian sphere with a 3D checker texture."""

    scale: float
    even_albedo: tuple[float, float, float]
    odd_albedo: tuple[float, float, float]


@dataclasses.dataclass(frozen=True)
class ImageMatDef:
    """Image-textured lambertian sphere; ``file`` is a PNG path (resolved
    against the config file's directory at load time)."""

    file: str


MaterialDef = (
    AlbedoMatDef | DielectricMatDef | MetallicMatDef | CheckerMatDef
    | ImageMatDef
)

_MATERIAL_DEF_TAGS = {
    "AlbedoMatDef": AlbedoMatDef,
    "DielectricMatDef": DielectricMatDef,
    "MetallicMatDef": MetallicMatDef,
    "CheckerMatDef": CheckerMatDef,
    "ImageMatDef": ImageMatDef,
}


@dataclasses.dataclass(frozen=True)
class WorldDefinition:
    """Scene + camera config; the same defaults as the JAX package."""

    camera: CameraParameters = CameraParameters()
    a_min: int = -11
    a_max: int = 11
    b_min: int = -11
    b_max: int = 11
    center: tuple[float, float, float] = (0.2, 0.9, 0.2)
    center_offset: tuple[float, float, float] = (4.0, 0.2, 0.0)
    center_dist_treshold: float = 0.9
    diffuse_material_treshold: float = 0.85
    metal_material_treshold: float = 0.95
    objects: tuple[tuple[SphereDef, MaterialDef], ...] = (
        (SphereDef((0.0, -1000.0, 0.0), 1000.0), AlbedoMatDef((0.5, 0.5, 0.5))),
        (SphereDef((0.0, 1.0, 0.0), 1.0), DielectricMatDef(1.5)),
        (SphereDef((-4.0, -1.0, 0.0), 1.0), AlbedoMatDef((0.4, 0.2, 0.1))),
        (SphereDef((4.0, -1.0, 0.0), 1.0), AlbedoMatDef((0.7, 0.6, 0.5))),
    )


def _parse_material_def(
    obj: dict[str, Any], base_dir: pathlib.Path | None = None
) -> MaterialDef:
    tag = obj["material_def"]
    cls = _MATERIAL_DEF_TAGS.get(tag)
    if cls is None:
        raise ValueError(f"unknown material_def tag: {tag!r}")
    if cls is AlbedoMatDef:
        return AlbedoMatDef(tuple(float(x) for x in obj["albedo"]))
    if cls is DielectricMatDef:
        return DielectricMatDef(float(obj["refindex"]))
    if cls is CheckerMatDef:
        return CheckerMatDef(
            float(obj["scale"]),
            tuple(float(x) for x in obj["even_albedo"]),
            tuple(float(x) for x in obj["odd_albedo"]),
        )
    if cls is ImageMatDef:
        f = pathlib.Path(obj["file"])
        if base_dir is not None and not f.is_absolute():
            f = base_dir / f
        return ImageMatDef(str(f))
    return MetallicMatDef(
        tuple(float(x) for x in obj["albedo"]), float(obj["fuzzines"])
    )


def world_from_dict(
    data: dict[str, Any], base_dir: pathlib.Path | None = None
) -> WorldDefinition:
    """Parsed JSON -> WorldDefinition, defaults for absent fields;
    ``base_dir`` resolves relative ImageMatDef paths."""
    defaults = WorldDefinition()
    cam_raw = data.get("camera", {})
    cd = defaults.camera
    camera = CameraParameters(
        aspect_ratio=float(cam_raw.get("aspect_ratio", cd.aspect_ratio)),
        image_width=int(cam_raw.get("image_width", cd.image_width)),
        samples_per_pixel=int(
            cam_raw.get("samples_per_pixel", cd.samples_per_pixel)
        ),
        max_depth=int(cam_raw.get("max_depth", cd.max_depth)),
        vertical_fov=float(cam_raw.get("vertical_fov", cd.vertical_fov)),
        defocus_angle=float(cam_raw.get("defocus_angle", cd.defocus_angle)),
        focus_distance=float(cam_raw.get("focus_distance", cd.focus_distance)),
        lookfrom=tuple(float(x) for x in cam_raw.get("lookfrom", cd.lookfrom)),
        lookat=tuple(float(x) for x in cam_raw.get("lookat", cd.lookat)),
        world_up=tuple(float(x) for x in cam_raw.get("world_up", cd.world_up)),
    )

    if "objects" in data:
        objects = [
            (
                SphereDef(
                    tuple(float(x) for x in sphere_raw["center"]),
                    float(sphere_raw["radius"]),
                ),
                _parse_material_def(mat_raw, base_dir),
            )
            for sphere_raw, mat_raw in data["objects"]
        ]
    else:
        objects = list(defaults.objects)

    def _vec3(name: str, fallback):
        return tuple(float(x) for x in data.get(name, fallback))

    return WorldDefinition(
        camera=camera,
        a_min=int(data.get("a_min", defaults.a_min)),
        a_max=int(data.get("a_max", defaults.a_max)),
        b_min=int(data.get("b_min", defaults.b_min)),
        b_max=int(data.get("b_max", defaults.b_max)),
        center=_vec3("center", defaults.center),
        center_offset=_vec3("center_offset", defaults.center_offset),
        center_dist_treshold=float(
            data.get("center_dist_treshold", defaults.center_dist_treshold)
        ),
        diffuse_material_treshold=float(
            data.get("diffuse_material_treshold", defaults.diffuse_material_treshold)
        ),
        metal_material_treshold=float(
            data.get("metal_material_treshold", defaults.metal_material_treshold)
        ),
        objects=tuple(objects),
    )


def load_world(path: str | pathlib.Path) -> WorldDefinition:
    """JSON file -> WorldDefinition."""
    path = pathlib.Path(path)
    with open(path, "r", encoding="utf-8") as f:
        return world_from_dict(json.load(f), base_dir=path.parent)


def _add_explicit_objects(
    builder: SceneBuilder, objects: Sequence[tuple[SphereDef, MaterialDef]]
) -> None:
    for sphere, mat in objects:
        if isinstance(mat, AlbedoMatDef):
            builder.add_lambertian_sphere(sphere.center, sphere.radius, mat.albedo)
        elif isinstance(mat, DielectricMatDef):
            builder.add_dielectric_sphere(sphere.center, sphere.radius, mat.refindex)
        elif isinstance(mat, MetallicMatDef):
            builder.add_metallic_sphere(
                sphere.center, sphere.radius, mat.albedo, mat.fuzzines
            )
        elif isinstance(mat, CheckerMatDef):
            builder.add_checker_sphere(
                sphere.center, sphere.radius, mat.scale, mat.even_albedo,
                mat.odd_albedo,
            )
        elif isinstance(mat, ImageMatDef):
            from ..utils import png as _png

            builder.add_image_sphere(
                sphere.center, sphere.radius, _png.read_png(mat.file)
            )
        else:
            raise TypeError(f"unknown material def: {mat!r}")


def build_world(
    world: WorldDefinition,
    *,
    seed: int | None = DEFAULT_GRID_SEED,
    apply_center_filter: bool = False,
    extra=None,
) -> tuple[CameraParameters, Scene]:
    """Explicit objects plus the random grid of small spheres.

    Per cell (a, b): ``choose_mat = U``, then ``center = (a + 0.9*U, 0.2,
    b + 0.9*U)`` and radius 0.2; diffuse below ``diffuse_material_treshold``
    (albedo = U3 * U3), metal below ``metal_material_treshold`` (albedo =
    0.5 + 0.5*U3, fuzz = 0.5*U), else dielectric with ior = 1.2 + 0.4*U.
    Without ``apply_center_filter`` every grid sphere is placed (the
    reference's ``length()`` quirk). Draw order equals the JAX package's.
    ``extra``, when given, is called with the builder last, before it
    builds (the CLI adds its glTF assets so).
    """
    builder = SceneBuilder()
    _add_explicit_objects(builder, world.objects)

    rand = np.random.default_rng(seed)
    offset = np.asarray(world.center_offset, np.float32)

    for a in range(world.a_min, world.a_max):
        for b in range(world.b_min, world.b_max):
            choose_mat = rand.random()
            center = np.array(
                [a + 0.9 * rand.random(), 0.2, b + 0.9 * rand.random()], np.float32
            )
            if apply_center_filter:
                placed = float(np.linalg.norm(center - offset)) > world.center_dist_treshold
            else:
                placed = True
            if not placed:
                continue

            if choose_mat < world.diffuse_material_treshold:
                albedo = rand.random(3) * rand.random(3)
                builder.add_lambertian_sphere(center, 0.2, albedo)
            elif choose_mat < world.metal_material_treshold:
                albedo = 0.5 + 0.5 * rand.random(3)
                fuzz = 0.5 * rand.random()
                builder.add_metallic_sphere(center, 0.2, albedo, fuzz)
            else:
                ior = 1.2 + 0.4 * rand.random()
                builder.add_dielectric_sphere(center, 0.2, ior)

    if extra is not None:
        extra(builder)
    return world.camera, builder.build()


def make_world_basic() -> tuple[CameraParameters, Scene]:
    """Two-sphere test scene."""
    r = float(np.cos(np.pi * 0.25))
    builder = SceneBuilder()
    builder.add_lambertian_sphere((-r, 0.0, -1.0), r, (0.0, 0.0, 1.0))
    builder.add_lambertian_sphere((r, 0.0, -1.0), r, (1.0, 0.0, 0.0))
    camera = CameraParameters(
        aspect_ratio=16.0 / 9.0,
        image_width=800,
        samples_per_pixel=100,
        max_depth=50,
        vertical_fov=20.0,
        defocus_angle=10.0,
        focus_distance=3.4,
        lookfrom=(-2.0, 2.0, 1.0),
        lookat=(0.0, 0.0, -1.0),
        world_up=(0.0, 1.0, 0.0),
    )
    return camera, builder.build()


def make_world_stress(
    n_spheres: int = 2048,
    *,
    seed: int = 0,
    image_width: int = 1200,
) -> tuple[CameraParameters, Scene]:
    """Procedural N-sphere stress scene: a ground sphere plus
    ``n_spheres - 1`` small spheres jittered on a square grid,
    70/20/10 lambertian/metal/dielectric, camera pulled back to frame it."""
    rng = np.random.default_rng(seed)
    builder = SceneBuilder()
    builder.add_lambertian_sphere((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5))
    side = int(np.ceil(np.sqrt(max(n_spheres - 1, 1))))
    placed = 0
    for i in range(side):
        for j in range(side):
            if placed >= n_spheres - 1:
                break
            x = (i - side / 2) * 1.2 + rng.uniform(-0.4, 0.4)
            z = (j - side / 2) * 1.2 + rng.uniform(-0.4, 0.4)
            r = rng.uniform(0.15, 0.3)
            center = (x, r, z)
            m = rng.uniform()
            if m < 0.7:
                builder.add_lambertian_sphere(
                    center, r, tuple(rng.uniform(0.0, 1.0, 3))
                )
            elif m < 0.9:
                builder.add_metallic_sphere(
                    center, r, tuple(rng.uniform(0.5, 1.0, 3)),
                    rng.uniform(0.0, 0.4),
                )
            else:
                builder.add_dielectric_sphere(center, r, 1.5)
            placed += 1
    camera = CameraParameters(
        aspect_ratio=16.0 / 9.0,
        image_width=image_width,
        samples_per_pixel=8,
        max_depth=8,
        vertical_fov=20.0,
        defocus_angle=0.0,
        focus_distance=side * 1.2,
        lookfrom=(side * 0.9, side * 0.25, side * 0.9),
        lookat=(0.0, 0.0, 0.0),
        world_up=(0.0, 1.0, 0.0),
    )
    return camera, builder.build()


def make_procedural_earth(size: int = 64, seed: int = 7) -> np.ndarray:
    """A self-contained (size, size, 3) float32 planet texture:
    ocean/land from smoothed value noise (wrapping in u), polar caps."""
    rng = np.random.default_rng(seed)
    coarse = rng.random((9, 9))
    yy, xx = np.mgrid[0:size, 0:size] / (size - 1)
    gx = xx * 8
    gy = yy * 8
    x0 = np.floor(gx).astype(int)
    y0 = np.floor(gy).astype(int)
    fx = gx - x0
    fy = gy - y0
    x1 = np.minimum(x0 + 1, 8) % 8
    y1 = np.minimum(y0 + 1, 8)
    n = (
        coarse[y0, x0 % 8] * (1 - fx) * (1 - fy)
        + coarse[y0, x1] * fx * (1 - fy)
        + coarse[y1, x0 % 8] * (1 - fx) * fy
        + coarse[y1, x1] * fx * fy
    )
    land = n > 0.55
    img = np.empty((size, size, 3), np.float32)
    img[...] = (0.05, 0.15, 0.45)                      # ocean
    img[land] = (0.15, 0.45, 0.12)                     # land
    polar = (yy < 0.12) | (yy > 0.88)
    img[polar] = (0.9, 0.92, 0.95)                     # ice caps
    return img


def make_world_textured(
    *, image_width: int = 1200, earth_size: int = 64
) -> tuple[CameraParameters, Scene]:
    """Checker and image-textured spheres with a defocus camera
    (bench.py's ``textured``)."""
    builder = SceneBuilder()
    builder.add_checker_sphere(
        (0.0, -1000.0, 0.0), 1000.0, 0.8, (0.2, 0.3, 0.1), (0.9, 0.9, 0.9)
    )
    builder.add_image_sphere(
        (0.0, 1.0, 0.0), 1.0, make_procedural_earth(earth_size)
    )
    builder.add_dielectric_sphere((-2.5, 1.0, 1.0), 1.0, 1.5)
    builder.add_metallic_sphere((2.5, 1.0, -0.5), 1.0, (0.7, 0.6, 0.5), 0.05)
    builder.add_checker_sphere(
        (1.2, 0.35, 1.8), 0.35, 0.12, (0.8, 0.1, 0.1), (0.95, 0.85, 0.2)
    )
    camera = CameraParameters(
        aspect_ratio=16.0 / 9.0,
        image_width=image_width,
        samples_per_pixel=64,
        max_depth=16,
        vertical_fov=25.0,
        defocus_angle=0.8,
        focus_distance=9.0,
        lookfrom=(7.0, 2.2, 5.5),
        lookat=(0.0, 0.9, 0.0),
        world_up=(0.0, 1.0, 0.0),
    )
    return camera, builder.build()


def make_world_mesh(
    *, image_width: int = 1200, subdivisions: int = 3,
    gltf_path: str | pathlib.Path | None = None,
) -> tuple[CameraParameters, Scene]:
    """A triangle mesh on a checker ground between two spheres (bench.py's
    ``mesh:S``): ``gltf_path`` when given, else a metal icosphere of
    20 * 4^subdivisions triangles (1280 by default)."""
    from . import mesh as _mesh
    from .types import MaterialKind

    builder = SceneBuilder()
    builder.add_checker_sphere(
        (0.0, -1000.0, 0.0), 1000.0, 0.8, (0.35, 0.35, 0.35), (0.15, 0.15, 0.2)
    )
    if gltf_path is not None:
        builder.add_gltf(gltf_path, translate=(0.0, 1.0, 0.0))
    else:
        verts, faces = _mesh.make_icosphere(subdivisions)
        builder.add_mesh(
            verts + np.float32([0.0, 1.0, 0.0]), faces,
            albedo=(0.75, 0.55, 0.25), kind=MaterialKind.METALLIC, fuzz=0.08,
        )
    builder.add_dielectric_sphere((-2.4, 0.8, 1.2), 0.8, 1.5)
    builder.add_lambertian_sphere((2.4, 0.8, -0.6), 0.8, (0.2, 0.35, 0.65))
    camera = CameraParameters(
        aspect_ratio=16.0 / 9.0,
        image_width=image_width,
        samples_per_pixel=64,
        max_depth=16,
        vertical_fov=28.0,
        defocus_angle=0.0,
        focus_distance=8.0,
        lookfrom=(6.0, 2.4, 5.0),
        lookat=(0.0, 0.9, 0.0),
        world_up=(0.0, 1.0, 0.0),
    )
    return camera, builder.build()


def make_world_meshes(
    k: int = 4,
    *,
    image_width: int = 1200,
    subdivisions: int = 2,
) -> tuple[CameraParameters, Scene]:
    """``k`` separated icospheres (20 * 4^subdivisions triangles each) on a
    checker ground, every other one behind an occluding metal sphere
    (bench.py's ``meshes:K``)."""
    from . import mesh as _mesh
    from .types import MaterialKind

    builder = SceneBuilder()
    builder.add_checker_sphere(
        (0.0, -1000.0, 0.0), 1000.0, 0.8, (0.35, 0.35, 0.35), (0.15, 0.15, 0.2)
    )
    verts, faces = _mesh.make_icosphere(subdivisions)
    palette = [
        ((0.75, 0.55, 0.25), MaterialKind.METALLIC, 0.08),
        ((0.3, 0.55, 0.8), MaterialKind.LAMBERTIAN, 0.0),
        ((0.8, 0.3, 0.3), MaterialKind.METALLIC, 0.2),
        ((0.5, 0.8, 0.4), MaterialKind.LAMBERTIAN, 0.0),
    ]
    span = 2.6
    for i in range(k):
        x = (i - (k - 1) / 2.0) * span
        albedo, kind, fuzz = palette[i % len(palette)]
        builder.add_mesh(
            verts + np.float32([x, 1.0, 0.0]), faces,
            albedo=albedo, kind=kind, fuzz=fuzz,
        )
        if i % 2 == 0:
            builder.add_metallic_sphere(
                (x * 0.72, 0.85, 2.1), 0.85, (0.7, 0.65, 0.6), 0.05
            )
    builder.add_dielectric_sphere(((k / 2.0) * span - 0.4, 0.7, 3.2), 0.7, 1.5)
    camera = CameraParameters(
        aspect_ratio=16.0 / 9.0,
        image_width=image_width,
        samples_per_pixel=64,
        max_depth=16,
        vertical_fov=30.0,
        defocus_angle=0.0,
        focus_distance=9.0,
        lookfrom=(0.0, 2.6, 9.0),
        lookat=(0.0, 0.9, 0.0),
        world_up=(0.0, 1.0, 0.0),
    )
    return camera, builder.build()


def load_and_build(
    path: str | pathlib.Path,
    *,
    seed: int | None = DEFAULT_GRID_SEED,
    apply_center_filter: bool = False,
) -> tuple[CameraParameters, Scene]:
    """JSON config file -> (camera params, scene)."""
    return build_world(
        load_world(path), seed=seed, apply_center_filter=apply_center_filter
    )
