"""Scene model: structure-of-arrays world held as torch tensors.

Counterpart of ``raytracing_tpu/scene/types.py``. ``Scene`` carries the same
24 fields as the JAX package's, so a scene can move between the two packages
field by field (``interop.py``), and ``SceneBuilder`` builds the same arrays
from the same calls: spheres (solid, checker or image albedo), a padded
texture stack, and triangle meshes in BVH leaf order with their flattened
BVH.
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
    """SoA world on one device (see the JAX package's ``Scene`` for the
    meaning of every field)::

      centers float32[N, 3]   radii float32[N]   mat_kind int32[N]
      albedo  float32[N, 3]   fuzz  float32[N]   ior      float32[N]
      tex_kind int32[N]  albedo2 float32[N, 3]  tex_inv_scale float32[N]
      tex_id int32[N]    tex_wh int32[N, 2]     textures float32[T, TH, TW, 3]
      tri_v0/e1/e2 float32[M, 3] (BVH leaf order), tri_mat_kind int32[M],
      tri_albedo float32[M, 3], tri_fuzz/tri_ior float32[M],
      bvh_min/max float32[K, 3], bvh_skip/first/count int32[K]
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

    @property
    def num_triangles(self) -> int:
        return self.tri_v0.shape[0]

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


def _np(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


class SceneBuilder:
    """Append-style builder producing a CPU ``Scene``; the same calls give
    the same arrays as the JAX package's ``SceneBuilder``."""

    def __init__(self) -> None:
        self._centers: list[tuple[float, float, float]] = []
        self._radii: list[float] = []
        self._kind: list[int] = []
        self._albedo: list[tuple[float, float, float]] = []
        self._fuzz: list[float] = []
        self._ior: list[float] = []
        self._tex_kind: list[int] = []
        self._albedo2: list[tuple[float, float, float]] = []
        self._tex_inv_scale: list[float] = []
        self._tex_id: list[int] = []
        self._textures: list[np.ndarray] = []
        self._tri: dict[str, list[np.ndarray]] = {
            k: [] for k in ("v0", "e1", "e2", "kind", "albedo", "fuzz", "ior")
        }

    def _push(
        self, center, radius, kind, albedo, fuzz, ior,
        tex_kind=TextureKind.SOLID, albedo2=(0.0, 0.0, 0.0),
        tex_inv_scale=0.0, tex_id=0,
    ) -> "SceneBuilder":
        self._centers.append(tuple(float(c) for c in center))
        self._radii.append(float(radius))
        self._kind.append(int(kind))
        self._albedo.append(tuple(float(a) for a in albedo))
        self._fuzz.append(float(fuzz))
        self._ior.append(float(ior))
        self._tex_kind.append(int(tex_kind))
        self._albedo2.append(tuple(float(a) for a in albedo2))
        self._tex_inv_scale.append(float(tex_inv_scale))
        self._tex_id.append(int(tex_id))
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

    def add_checker_sphere(
        self, center, radius, scale, even_albedo, odd_albedo
    ) -> "SceneBuilder":
        """Lambertian sphere with a 3D checker: the parity of
        ``floor(p / scale)`` summed over xyz picks the even or odd color.
        ``1/scale`` is rounded to the nearest float16 value, so the kernel's
        table holds it exactly."""
        inv = float(np.float32(np.float16(1.0 / float(scale))))
        return self._push(
            center, radius, MaterialKind.LAMBERTIAN, even_albedo, 0.0, 1.0,
            tex_kind=TextureKind.CHECKER, albedo2=odd_albedo,
            tex_inv_scale=inv,
        )

    def add_image_sphere(self, center, radius, image) -> "SceneBuilder":
        """Lambertian sphere textured by an (H, W, 3) image: uint8 bytes are
        taken as byte/255 (no de-gamma), floats clipped to [0, 1]; sampled
        at the sphere UV of the outward normal, nearest texel."""
        img = np.asarray(image)
        if img.ndim != 3 or img.shape[2] < 3:
            raise ValueError(f"expected (H, W, 3) image, got {img.shape}")
        img = img[:, :, :3]
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        else:
            img = np.clip(img.astype(np.float32), 0.0, 1.0)
        tex_id = len(self._textures)
        self._textures.append(img)
        return self._push(
            center, radius, MaterialKind.LAMBERTIAN, (1.0, 1.0, 1.0), 0.0,
            1.0, tex_kind=TextureKind.IMAGE, tex_id=tex_id,
        )

    def add_mesh(
        self, vertices, faces, *, albedo=(1.0, 1.0, 1.0),
        kind: MaterialKind | None = None, fuzz: float = 0.0, ior: float = 1.5,
    ) -> "SceneBuilder":
        """Triangle mesh: (V,3) vertices + (F,3) integer faces with one
        material for the whole mesh (lambertian unless ``kind`` says)."""
        from . import mesh as _mesh

        kind = MaterialKind.LAMBERTIAN if kind is None else kind
        v0, e1, e2 = _mesh.faces_to_soa(vertices, faces)
        m = v0.shape[0]
        alb = (1.0, 1.0, 1.0) if kind == MaterialKind.DIELECTRIC else albedo
        t = self._tri
        t["v0"].append(v0)
        t["e1"].append(e1)
        t["e2"].append(e2)
        t["kind"].append(np.full(m, int(kind), np.int32))
        t["albedo"].append(np.tile(np.asarray(alb, np.float32), (m, 1)))
        t["fuzz"].append(np.full(m, float(fuzz), np.float32))
        t["ior"].append(np.full(m, float(ior), np.float32))
        return self

    def add_gltf(
        self, path, *, scale: float = 1.0, translate=(0.0, 0.0, 0.0)
    ) -> "SceneBuilder":
        """Every triangle primitive of a .gltf/.glb file (``scene/gltf.py``):
        metallic materials become metal with fuzz = roughness, the rest
        lambertian."""
        from . import gltf as _gltf

        t = np.asarray(translate, np.float32)
        for prim in _gltf.load_gltf(path):
            self.add_mesh(
                prim.vertices * np.float32(scale) + t,
                prim.faces,
                albedo=prim.albedo,
                kind=MaterialKind.METALLIC if prim.metallic
                else MaterialKind.LAMBERTIAN,
                fuzz=prim.fuzz,
            )
        return self

    def __len__(self) -> int:
        return len(self._radii)

    def _texture_stack(self) -> tuple[np.ndarray, np.ndarray]:
        """Textures padded to common dims (top-left anchored) and each
        sphere's valid (w, h) in the stack; one white texel when none (a
        sphere-less world included)."""
        if not self._textures:
            return (
                np.ones((1, 1, 1, 3), np.float32),
                np.zeros((len(self._radii), 2), np.int32),
            )
        th = max(t.shape[0] for t in self._textures)
        tw = max(t.shape[1] for t in self._textures)
        stack = np.zeros((len(self._textures), th, tw, 3), np.float32)
        for i, t in enumerate(self._textures):
            stack[i, : t.shape[0], : t.shape[1]] = t
        wh = np.array(
            [
                (self._textures[tid].shape[1], self._textures[tid].shape[0])
                if tk == TextureKind.IMAGE
                else (0, 0)
                for tk, tid in zip(self._tex_kind, self._tex_id)
            ],
            np.int32,
        )
        return stack, wh

    def _triangle_pack(self) -> dict:
        """Concatenate the meshes, build the BVH, permute to leaf order.
        Without meshes: empty columns and a one-node empty BVH."""
        from . import mesh as _mesh

        t = self._tri
        if not t["v0"]:
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
                has_triangles=False,
            )
        cat = {k: np.concatenate(v) for k, v in t.items()}
        bvh = _mesh.build_bvh(cat["v0"], cat["e1"], cat["e2"])
        o = bvh.order
        return dict(
            tri_v0=_np(cat["v0"][o]), tri_e1=_np(cat["e1"][o]),
            tri_e2=_np(cat["e2"][o]), tri_mat_kind=_np(cat["kind"][o]),
            tri_albedo=_np(cat["albedo"][o]), tri_fuzz=_np(cat["fuzz"][o]),
            tri_ior=_np(cat["ior"][o]),
            bvh_min=_np(bvh.node_min), bvh_max=_np(bvh.node_max),
            bvh_skip=_np(bvh.skip), bvh_first=_np(bvh.first),
            bvh_count=_np(bvh.count),
            has_triangles=True,
        )

    def build(self) -> Scene:
        tri = self._triangle_pack()
        n = len(self._radii)

        def f32(x, shape):
            return _np(np.array(x, np.float32).reshape(shape))

        def i32(x, shape):
            return _np(np.array(x, np.int32).reshape(shape))

        stack, wh = self._texture_stack()
        return Scene(
            centers=f32(self._centers, (n, 3)),
            radii=f32(self._radii, (n,)),
            mat_kind=i32(self._kind, (n,)),
            albedo=f32(self._albedo, (n, 3)),
            fuzz=f32(self._fuzz, (n,)),
            ior=f32(self._ior, (n,)),
            tex_kind=i32(self._tex_kind, (n,)),
            albedo2=f32(self._albedo2, (n, 3)),
            tex_inv_scale=f32(self._tex_inv_scale, (n,)),
            tex_id=i32(self._tex_id, (n,)),
            tex_wh=_np(wh),
            textures=_np(stack),
            has_textures=any(tk != TextureKind.SOLID for tk in self._tex_kind),
            **tri,
        )
