"""Scene model: structure-of-arrays sphere world held as torch tensors.

Counterpart of ``raytracing_tpu/scene/types.py``. ``Scene`` carries the same
24 fields as the JAX package's, so a scene can move between the two packages
field by field (``interop.py``). This slice renders sphere scenes only: the
texture and triangle fields exist with the shapes the JAX builder gives a
sphere-only scene (all-SOLID texture columns, a one-texel texture stack, no
triangles, a one-node empty BVH), and ``SceneBuilder`` has the sphere adders
only.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch


class MaterialKind(enum.IntEnum):
    LAMBERTIAN = 0
    METALLIC = 1
    DIELECTRIC = 2


class TextureKind(enum.IntEnum):
    SOLID = 0
    CHECKER = 1
    IMAGE = 2


@dataclasses.dataclass(frozen=True)
class Scene:
    """SoA sphere world on one device (see the JAX package's ``Scene`` for
    the meaning of every field)::

      centers float32[N, 3]   radii float32[N]   mat_kind int32[N]
      albedo  float32[N, 3]   fuzz  float32[N]   ior      float32[N]
      tex_kind int32[N]  albedo2 float32[N, 3]  tex_inv_scale float32[N]
      tex_id int32[N]    tex_wh int32[N, 2]     textures float32[T, TH, TW, 3]
      tri_* / bvh_*: triangle mesh and its BVH (empty in this slice)
    """

    centers: torch.Tensor
    radii: torch.Tensor
    mat_kind: torch.Tensor
    albedo: torch.Tensor
    fuzz: torch.Tensor
    ior: torch.Tensor
    tex_kind: torch.Tensor
    albedo2: torch.Tensor
    tex_inv_scale: torch.Tensor
    tex_id: torch.Tensor
    tex_wh: torch.Tensor
    textures: torch.Tensor
    tri_v0: torch.Tensor
    tri_e1: torch.Tensor
    tri_e2: torch.Tensor
    tri_mat_kind: torch.Tensor
    tri_albedo: torch.Tensor
    tri_fuzz: torch.Tensor
    tri_ior: torch.Tensor
    bvh_min: torch.Tensor
    bvh_max: torch.Tensor
    bvh_skip: torch.Tensor
    bvh_first: torch.Tensor
    bvh_count: torch.Tensor
    has_textures: bool = False
    has_triangles: bool = False

    @property
    def num_objects(self) -> int:
        return self.centers.shape[0]

    def to(self, device) -> "Scene":
        """The same scene with every tensor field on ``device``."""
        return dataclasses.replace(
            self,
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)
            },
        )


TENSOR_FIELDS = tuple(
    f.name for f in dataclasses.fields(Scene)
    if f.name not in ("has_textures", "has_triangles")
)


def _empty_triangle_fields() -> dict:
    z3 = torch.zeros((0, 3), dtype=torch.float32)
    z1 = torch.zeros((0,), dtype=torch.float32)
    zi = torch.zeros((0,), dtype=torch.int32)
    one_node = torch.zeros((1, 3), dtype=torch.float32)
    return dict(
        tri_v0=z3, tri_e1=z3, tri_e2=z3, tri_mat_kind=zi,
        tri_albedo=z3, tri_fuzz=z1, tri_ior=z1,
        bvh_min=one_node, bvh_max=one_node,
        bvh_skip=torch.ones((1,), dtype=torch.int32),
        bvh_first=torch.zeros((1,), dtype=torch.int32),
        bvh_count=torch.zeros((1,), dtype=torch.int32),
    )


class SceneBuilder:
    """Append-style sphere builder producing a CPU ``Scene``."""

    def __init__(self) -> None:
        self._centers: list[tuple[float, float, float]] = []
        self._radii: list[float] = []
        self._kind: list[int] = []
        self._albedo: list[tuple[float, float, float]] = []
        self._fuzz: list[float] = []
        self._ior: list[float] = []

    def _push(self, center, radius, kind, albedo, fuzz, ior) -> "SceneBuilder":
        self._centers.append(tuple(float(c) for c in center))
        self._radii.append(float(radius))
        self._kind.append(int(kind))
        self._albedo.append(tuple(float(a) for a in albedo))
        self._fuzz.append(float(fuzz))
        self._ior.append(float(ior))
        return self

    def add_lambertian_sphere(self, center, radius, albedo) -> "SceneBuilder":
        return self._push(center, radius, MaterialKind.LAMBERTIAN, albedo, 0.0, 1.0)

    def add_metallic_sphere(self, center, radius, albedo, fuzz) -> "SceneBuilder":
        return self._push(center, radius, MaterialKind.METALLIC, albedo, fuzz, 1.0)

    def add_dielectric_sphere(self, center, radius, refraction_index) -> "SceneBuilder":
        # Dielectric attenuation is identically 1.
        return self._push(
            center, radius, MaterialKind.DIELECTRIC, (1.0, 1.0, 1.0), 0.0,
            refraction_index,
        )

    def __len__(self) -> int:
        return len(self._radii)

    def build(self) -> Scene:
        n = len(self._radii)

        def f32(x, shape):
            return torch.as_tensor(np.array(x, np.float32).reshape(shape))

        def i32(x, shape):
            return torch.as_tensor(np.array(x, np.int32).reshape(shape))

        return Scene(
            centers=f32(self._centers, (n, 3)),
            radii=f32(self._radii, (n,)),
            mat_kind=i32(self._kind, (n,)),
            albedo=f32(self._albedo, (n, 3)),
            fuzz=f32(self._fuzz, (n,)),
            ior=f32(self._ior, (n,)),
            tex_kind=torch.zeros((n,), dtype=torch.int32),
            albedo2=torch.zeros((n, 3), dtype=torch.float32),
            tex_inv_scale=torch.zeros((n,), dtype=torch.float32),
            tex_id=torch.zeros((n,), dtype=torch.int32),
            tex_wh=torch.zeros((n, 2), dtype=torch.int32),
            textures=torch.ones((1, 1, 1, 3), dtype=torch.float32),
            has_textures=False,
            has_triangles=False,
            **_empty_triangle_fields(),
        )
