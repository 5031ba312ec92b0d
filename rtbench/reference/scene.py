"""The reference's own scene build: a configuration's scene description ->
per-row tables and the camera vector, in plain numpy and PyTorch.

Frozen copies (raytracing_tpu_torch at commit a1403821e8fd):

* ``Spheres``: ``scene/types.py``'s ``add_*_sphere`` field values
  (``add_checker_sphere``'s float16 ``1/scale``) and
  ``scene/config.py::_add_explicit_objects``'s materials.
* ``icosphere``, ``faces_to_soa``, ``bvh_order``: ``scene/mesh.py``
  (``make_icosphere``, ``faces_to_soa``, ``build_bvh``'s leaf order).
* ``camera_vector``: ``core/camera.py::derive`` and
  ``DerivedCamera.as_vector``.
* ``sphere_table``, ``triangle_table``: ``ops/trace.py::pack_scene``'s row
  order (Morton sort, power-of-two padding >= 128 rows, pad rows with
  ``cm2 = 1e30``; triangles in BVH leaf order, pad rows ``v0 = 1e9``,
  ``e1 = e2 = 0``) and the 16-bit material quantisation of
  ``_pack_words`` / ``_q16``.

The scene builders are files of their own, ``scenes/<name>.py`` (a
``build(config)`` -> spheres and triangles), named by the configuration's
``reference`` entry. Nothing here imports the program: the benchmark
hands the same configuration file to both sides, and this module works the
tables out again from it.
"""

from __future__ import annotations

import dataclasses
import math
import pathlib

import numpy as np
import torch

from rtbench import plugins

ROOT = pathlib.Path(__file__).resolve().parent
LAMBERTIAN, METALLIC, DIELECTRIC = 0, 1, 2
SOLID, CHECKER = 0, 1
MIN_ROWS = 128


@dataclasses.dataclass
class Spheres:
    """Spheres in insertion order (numpy, float32 / int32)."""

    centers: list = dataclasses.field(default_factory=list)
    radii: list = dataclasses.field(default_factory=list)
    kind: list = dataclasses.field(default_factory=list)
    albedo: list = dataclasses.field(default_factory=list)
    fuzz: list = dataclasses.field(default_factory=list)
    ior: list = dataclasses.field(default_factory=list)
    tex_kind: list = dataclasses.field(default_factory=list)
    albedo2: list = dataclasses.field(default_factory=list)
    tex_inv: list = dataclasses.field(default_factory=list)

    def add(self, center, radius, kind, albedo, fuzz=0.0, ior=1.0,
            tex_kind=SOLID, albedo2=(0.0, 0.0, 0.0), tex_inv=0.0) -> None:
        self.centers.append(tuple(float(c) for c in center))
        self.radii.append(float(radius))
        self.kind.append(int(kind))
        self.albedo.append(tuple(float(a) for a in albedo))
        self.fuzz.append(float(fuzz))
        self.ior.append(float(ior))
        self.tex_kind.append(int(tex_kind))
        self.albedo2.append(tuple(float(a) for a in albedo2))
        self.tex_inv.append(float(tex_inv))

    def add_def(self, center, radius, mat: dict) -> None:
        """One sphere of a world file's ``objects`` list."""
        tag = mat["material_def"]
        if tag == "AlbedoMatDef":
            self.add(center, radius, LAMBERTIAN, mat["albedo"])
        elif tag == "DielectricMatDef":
            self.add(center, radius, DIELECTRIC, (1.0, 1.0, 1.0),
                     ior=mat["refindex"])
        elif tag == "MetallicMatDef":
            self.add(center, radius, METALLIC, mat["albedo"],
                     fuzz=mat["fuzzines"])
        elif tag == "CheckerMatDef":
            self.add_checker(center, radius, mat["scale"], mat["even_albedo"],
                             mat["odd_albedo"])
        else:
            raise ValueError(f"the reference has no material {tag!r}")

    def add_checker(self, center, radius, scale, even, odd) -> None:
        inv = float(np.float32(np.float16(1.0 / float(scale))))
        self.add(center, radius, LAMBERTIAN, even, tex_kind=CHECKER,
                 albedo2=odd, tex_inv=inv)


def icosphere(subdivisions: int) -> tuple[np.ndarray, np.ndarray]:
    """Unit icosphere (20 * 4^s faces): float32 vertices, int64 faces."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [(-1, phi, 0), (1, phi, 0), (-1, -phi, 0), (1, -phi, 0),
         (0, -1, phi), (0, 1, phi), (0, -1, -phi), (0, 1, -phi),
         (phi, 0, -1), (phi, 0, 1), (-phi, 0, -1), (-phi, 0, 1)],
        np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
         (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
         (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
         (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)],
        np.int64)
    for _ in range(subdivisions):
        vlist = list(verts)
        cache: dict[tuple[int, int], int] = {}

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in cache:
                mid = vlist[a] + vlist[b]
                mid /= np.linalg.norm(mid)
                cache[key] = len(vlist)
                vlist.append(mid)
            return cache[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, np.int64)
    return verts.astype(np.float32), faces


def faces_to_soa(vertices, faces):
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces)
    v0 = vertices[faces[:, 0]]
    return v0, vertices[faces[:, 1]] - v0, vertices[faces[:, 2]] - v0


def bvh_order(v0, e1, e2, leaf_size: int = 4) -> np.ndarray:
    """Leaf order of the median-split BVH over triangle centroids."""
    va, vb, vc = v0, v0 + e1, v0 + e2
    tri_min = np.minimum(np.minimum(va, vb), vc)
    tri_max = np.maximum(np.maximum(va, vb), vc)
    centroids = (tri_min + tri_max) * 0.5
    order: list[int] = []

    def emit(ids: np.ndarray) -> None:
        if len(ids) <= leaf_size:
            order.extend(int(t) for t in ids)
            return
        c = centroids[ids]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        half = len(ids) // 2
        part = np.argpartition(c[:, axis], half)
        emit(ids[part[:half]])
        emit(ids[part[half:]])

    emit(np.arange(v0.shape[0]))
    return np.asarray(order, np.int64)


@dataclasses.dataclass
class Triangles:
    v0: np.ndarray
    e1: np.ndarray
    e2: np.ndarray
    kind: np.ndarray
    albedo: np.ndarray
    fuzz: np.ndarray
    ior: np.ndarray


def mesh_triangles(meshes: list[dict]) -> Triangles | None:
    """Icosphere meshes (``{"subdivisions", "translate", "albedo", "kind",
    "fuzz"}``) concatenated and put in BVH leaf order."""
    if not meshes:
        return None
    parts = {k: [] for k in ("v0", "e1", "e2", "kind", "albedo", "fuzz", "ior")}
    kinds = {"lambertian": LAMBERTIAN, "metal": METALLIC,
             "dielectric": DIELECTRIC}
    for m in meshes:
        verts, faces = icosphere(int(m["subdivisions"]))
        verts = verts + np.float32(m["translate"])
        v0, e1, e2 = faces_to_soa(verts, faces)
        n = v0.shape[0]
        kind = kinds[m["kind"]]
        alb = (1.0, 1.0, 1.0) if kind == DIELECTRIC else m["albedo"]
        parts["v0"].append(v0)
        parts["e1"].append(e1)
        parts["e2"].append(e2)
        parts["kind"].append(np.full(n, kind, np.int32))
        parts["albedo"].append(np.tile(np.asarray(alb, np.float32), (n, 1)))
        parts["fuzz"].append(np.full(n, float(m.get("fuzz", 0.0)), np.float32))
        parts["ior"].append(np.full(n, float(m.get("ior", 1.5)), np.float32))
    cat = {k: np.concatenate(v) for k, v in parts.items()}
    o = bvh_order(cat["v0"], cat["e1"], cat["e2"])
    return Triangles(**{k: v[o] for k, v in cat.items()})


def scene_of(config: dict) -> tuple[Spheres, Triangles | None]:
    """A configuration's scene -> spheres and triangles, by the builder
    that its ``reference`` entry names (``scenes/<scene>.py``)."""
    return plugins.load(ROOT, "scenes", config["reference"]["scene"]
                        ).build(config)


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------


def pad_rows(n: int) -> int:
    return max(MIN_ROWS, 1 << max(n - 1, 1).bit_length())


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_order(centers: torch.Tensor) -> torch.Tensor:
    lo = centers.min(dim=0).values
    hi = centers.max(dim=0).values
    scale = 1023.0 / torch.clamp(hi - lo, min=1e-6)
    q = torch.clamp((centers - lo) * scale, 0.0, 1023.0).to(torch.int64)
    code = ((_part1by2(q[:, 0]) << 2) | (_part1by2(q[:, 1]) << 1)
            | _part1by2(q[:, 2]))
    return torch.argsort(code, stable=True)


def quantized(albedo: torch.Tensor, kind: torch.Tensor, fuzz: torch.Tensor,
              ior: torch.Tensor):
    """The material as the kernel's 16-bit words decode it: albedo
    (r, g, b) and ``param`` (lambertian -1, metal fuzz, dielectric 4 +
    ior), each float32."""
    kindf = kind.to(torch.float32)
    param = torch.where(
        kindf < 0.5, torch.full_like(fuzz, -1.0),
        torch.where(kindf < 1.5, torch.clamp(fuzz, 0.0, 1.999),
                    4.0 + torch.clamp(ior, 0.0, 9.99)))
    a16 = torch.round(torch.clamp(albedo, 0.0, 1.0) * 65535.0).to(torch.int32)
    p16 = torch.round((param + 2.0) * 4096.0).to(torch.int32) & 0xFFFF
    inv16 = 1.0 / 65535.0
    alb = [a16[:, c].to(torch.float32) * inv16 for c in range(3)]
    return alb, p16.to(torch.float32) * (1.0 / 4096.0) - 2.0


@dataclasses.dataclass
class SphereTable:
    """Padded, Morton-ordered sphere rows (float32 tensors [N_pad])."""

    cx: torch.Tensor
    cy: torch.Tensor
    cz: torch.Tensor
    r: torch.Tensor
    cm2: torch.Tensor
    albedo: list
    param: torch.Tensor
    tex_kind: torch.Tensor
    albedo2: list
    tex_inv: torch.Tensor
    n_actual: int

    @property
    def n_pad(self) -> int:
        return self.cx.shape[0]


def sphere_table(s: Spheres) -> SphereTable:
    f32 = torch.float32
    n = len(s.radii)
    n_pad = pad_rows(n)
    pad = n_pad - n
    F = torch.nn.functional
    centers = torch.tensor(np.array(s.centers, np.float32).reshape(n, 3))
    order = morton_order(centers)

    def col(values, dtype=f32, width=None, value=0.0):
        shape = (n,) if width is None else (n, width)
        t = torch.tensor(np.array(values, np.float32 if dtype == f32
                                  else np.int32).reshape(shape))[order]
        return F.pad(t, (0, pad) if width is None else (0, 0, 0, pad),
                     value=value)

    c = centers[order]
    c = torch.cat([c, c[-1:].expand(pad, 3)], dim=0)
    radii = col(s.radii)
    cx, cy, cz = c[:, 0], c[:, 1], c[:, 2]
    cm2 = cx * cx + cy * cy + cz * cz - radii * radii
    cm2 = torch.where(torch.arange(n_pad) < n, cm2, torch.full_like(cm2, 1e30))
    albedo, param = quantized(col(s.albedo, width=3), col(s.kind, torch.int32),
                              col(s.fuzz), col(s.ior, value=1.0))
    tex_kind = col(s.tex_kind, torch.int32)
    albedo2, _ = quantized(col(s.albedo2, width=3), tex_kind * 0,
                           col(s.fuzz), col(s.ior, value=1.0))
    return SphereTable(cx.contiguous(), cy.contiguous(), cz.contiguous(),
                       radii, cm2, albedo, param, tex_kind, albedo2,
                       col(s.tex_inv), n)


@dataclasses.dataclass
class TriangleTable:
    """Padded triangle rows in BVH leaf order: ``cols`` the nine v0, e1,
    e2 columns (float32 [M_pad] each) and the decoded material."""

    cols: list
    albedo: list
    param: torch.Tensor
    m_actual: int

    @property
    def m_pad(self) -> int:
        return self.cols[0].shape[0]


def triangle_table(t: Triangles) -> TriangleTable:
    m = t.v0.shape[0]
    m_pad = pad_rows(m)
    pad = m_pad - m
    F = torch.nn.functional

    def tt(a, value=0.0):
        x = torch.from_numpy(np.ascontiguousarray(a))
        return F.pad(x, (0, pad) if x.dim() == 1 else (0, 0, 0, pad),
                     value=value)

    v0, e1, e2 = tt(t.v0, 1.0e9), tt(t.e1), tt(t.e2)
    cols = [v0[:, k].contiguous() for k in range(3)]
    cols += [e1[:, k].contiguous() for k in range(3)]
    cols += [e2[:, k].contiguous() for k in range(3)]
    albedo, param = quantized(tt(t.albedo), tt(t.kind), tt(t.fuzz),
                              tt(t.ior, 1.0))
    return TriangleTable(cols, albedo, param, m)


# ---------------------------------------------------------------------------
# Camera
# ---------------------------------------------------------------------------


def image_height(camera: dict) -> int:
    return int(float(camera["image_width"]) / camera["aspect_ratio"])


def camera_vector(camera: dict) -> np.ndarray:
    """The 20 floats of the ray frame: pixel00, pixel_delta_u,
    pixel_delta_v, center, defocus_disk_u, defocus_disk_v, defocus_angle,
    0 (float32, computed on the host as the upstream camera derives it)."""
    width = int(camera["image_width"])
    height = image_height(camera)
    focus = camera["focus_distance"]
    h = math.tan(math.radians(camera["vertical_fov"]) * 0.5)
    viewport_height = 2.0 * h * focus
    viewport_width = viewport_height * (float(width) / height)
    lookfrom = np.asarray(camera["lookfrom"], np.float32)
    lookat = np.asarray(camera["lookat"], np.float32)
    world_up = np.asarray(camera["world_up"], np.float32)
    w = lookfrom - lookat
    w = w / np.linalg.norm(w)
    u = np.cross(world_up, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    viewport_u = u * viewport_width
    viewport_v = -v * viewport_height
    du = viewport_u / float(width)
    dv = viewport_v / float(height)
    upper_left = lookfrom - focus * w - viewport_u * 0.5 - viewport_v * 0.5
    pixel00 = upper_left + 0.5 * (du + dv)
    radius = focus * math.tan(math.radians(camera["defocus_angle"] * 0.5))
    parts = [pixel00, du, dv, lookfrom, u * radius, v * radius,
             [camera["defocus_angle"]], [0.0]]
    return np.concatenate([np.asarray(p, np.float32).reshape(-1)
                           for p in parts]).astype(np.float32)
