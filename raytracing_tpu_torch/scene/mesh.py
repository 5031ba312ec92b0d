"""Triangle meshes on the host: BVH build, face lists to SoA, icosphere.

A numpy copy of ``raytracing_tpu/scene/mesh.py``. The BVH's leaf order is
the row order of the kernel's triangle table, so the build is the same
algorithm with the same ``np.argpartition`` median split and the same
``LEAF_SIZE``: both packages permute a mesh's triangles identically.

The flattened BVH is stackless (nodes in DFS order, each with the index to
resume at when its box is missed); leaves reference contiguous ranges of
the permuted triangle arrays. The port's kernel sweeps the triangle table
and does not walk the tree yet; the tree travels with the ``Scene``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

LEAF_SIZE = 4


@dataclasses.dataclass
class BVH:
    """Flattened skip-link BVH (numpy, host-side).

    node_min/max  f32[K, 3]  AABB per node
    skip          i32[K]     node index to resume at when the AABB is missed
    first, count  i32[K]     leaf triangle range in the permuted arrays;
                             count == 0 marks an inner node
    order         i64[M]     permutation applied to the input triangles
    """

    node_min: np.ndarray
    node_max: np.ndarray
    skip: np.ndarray
    first: np.ndarray
    count: np.ndarray
    order: np.ndarray


def build_bvh(
    v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
    leaf_size: int = LEAF_SIZE,
) -> BVH:
    """Median-split BVH over triangle centroids: split the longest axis of
    the centroid bounds at the median triangle."""
    m = v0.shape[0]
    if m == 0:
        return BVH(
            node_min=np.zeros((1, 3), np.float32),
            node_max=np.zeros((1, 3), np.float32),
            skip=np.ones((1,), np.int32),
            first=np.zeros((1,), np.int32),
            count=np.zeros((1,), np.int32),
            order=np.zeros((0,), np.int64),
        )
    va = v0
    vb = v0 + e1
    vc = v0 + e2
    tri_min = np.minimum(np.minimum(va, vb), vc)
    tri_max = np.maximum(np.maximum(va, vb), vc)
    centroids = (tri_min + tri_max) * 0.5

    nodes_min: list[np.ndarray] = []
    nodes_max: list[np.ndarray] = []
    firsts: list[int] = []
    counts: list[int] = []
    skips: list[int] = []
    order: list[int] = []

    def emit(ids: np.ndarray) -> None:
        """Append the subtree over ``ids`` in DFS order; fix skips after."""
        i = len(nodes_min)
        nodes_min.append(tri_min[ids].min(axis=0))
        nodes_max.append(tri_max[ids].max(axis=0))
        skips.append(-1)  # patched below
        if len(ids) <= leaf_size:
            firsts.append(len(order))
            counts.append(len(ids))
            order.extend(int(t) for t in ids)
        else:
            firsts.append(0)
            counts.append(0)
            c = centroids[ids]
            axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
            half = len(ids) // 2
            part = np.argpartition(c[:, axis], half)
            emit(ids[part[:half]])
            emit(ids[part[half:]])
        skips[i] = len(nodes_min)

    emit(np.arange(m))
    return BVH(
        node_min=np.asarray(nodes_min, np.float32),
        node_max=np.asarray(nodes_max, np.float32),
        skip=np.asarray(skips, np.int32),
        first=np.asarray(firsts, np.int32),
        count=np.asarray(counts, np.int32),
        order=np.asarray(order, np.int64),
    )


def faces_to_soa(
    vertices: np.ndarray, faces: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(V,3) vertices + (F,3) int faces -> (v0, e1, e2) f32 arrays."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces)
    v0 = vertices[faces[:, 0]]
    e1 = vertices[faces[:, 1]] - v0
    e2 = vertices[faces[:, 2]] - v0
    return v0, e1, e2


def make_icosphere(subdivisions: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """Unit icosphere (20 * 4^s faces), built in float64 and returned as
    float32 vertices and int64 faces."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            (-1, phi, 0), (1, phi, 0), (-1, -phi, 0), (1, -phi, 0),
            (0, -1, phi), (0, 1, phi), (0, -1, -phi), (0, 1, -phi),
            (phi, 0, -1), (phi, 0, 1), (-phi, 0, -1), (-phi, 0, 1),
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
            (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
            (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
            (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
        ],
        np.int64,
    )
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
