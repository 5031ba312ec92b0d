"""Ray-scene intersection of the wavefront backend.

Counterpart of ``raytracing_tpu/ops/intersect.py``:

* Spheres: every (ray, sphere) pair at once. The half-b quadratic (``a =
  d.d``, ``h = d.(c - o)``, ``c' = |c - o|^2 - r^2``) is expanded so that
  the (B, N) work is two products, ``d.c_j`` and ``o.c_j``; the near root
  where it lies in the open interval, else the far one; the closest over
  spheres by ``argmin`` (first index on ties). ``use_matmul=True`` takes
  both products from one ``(B, 6) @ (6, 2N)`` matmul in true float32
  (``torch.matmul``; TF32 must stay off, as the JAX package's
  ``Precision.HIGHEST``), ``use_matmul=False`` from three broadcast
  multiply-adds per product.
* Triangles: Moller-Trumbore over every (ray, triangle) pair
  (``intersect_triangles``), or the flattened skip-link BVH
  (``intersect_triangles_bvh``): a stackless walk where each ray holds a
  node cursor, advancing depth-first on a box hit and jumping the subtree
  on a miss, a leaf testing its triangles in order. The walk loops over
  the rays still inside the tree, gathered each step, until none is.
* ``hit_records`` / ``triangle_hit_records``: hit point and the unit
  normal turned against the ray, with the front-face flag.

The (B, N) tensors are materialised, as in the JAX package: at B = 2^20
rays and N = 512 spheres each is 2 GiB.
"""

from __future__ import annotations

import torch

from ..core import math as rmath
from ..scene.mesh import LEAF_SIZE
from ..scene.types import Scene

_INF = float("inf")
# Parallel-ray guard of the Moller-Trumbore determinant.
_MT_EPS = 1.0e-12


def _miss(b: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return (
        torch.full((b,), _INF, dtype=torch.float32, device=device),
        torch.zeros((b,), dtype=torch.int64, device=device),
        torch.zeros((b,), dtype=torch.bool, device=device),
    )


def _dots_matmul(o, d, centers):
    """(d.c_j, o.c_j) from ``[d | o] @ W``, ``W[:3, :N] = W[3:, N:] = C^T``."""
    n = centers.shape[0]
    x = torch.cat([d, o], dim=-1)
    w = torch.zeros((6, 2 * n), dtype=centers.dtype, device=centers.device)
    w[0:3, 0:n] = centers.T
    w[3:6, n:] = centers.T
    prod = torch.matmul(x, w)
    return prod[:, :n], prod[:, n:]


def _dots_broadcast(o, d, centers):
    """The same products as broadcast multiply-adds (no matmul)."""
    c = centers.T
    d_dot_c = d[:, 0:1] * c[0] + d[:, 1:2] * c[1] + d[:, 2:3] * c[2]
    o_dot_c = o[:, 0:1] * c[0] + o[:, 1:2] * c[1] + o[:, 2:3] * c[2]
    return d_dot_c, o_dot_c


def intersect_scene(
    origins: torch.Tensor,
    directions: torch.Tensor,
    scene: Scene,
    t_min: float = rmath.T_MIN,
    t_max: float = rmath.T_MAX,
    *,
    use_matmul: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closest sphere hit of each ray in the open interval (t_min, t_max).

    ``origins`` and ``directions`` are (B, 3) float32 (directions need not
    be unit). Returns ``(t, index, hit)``: the closest hit distance (inf on
    a miss), the hit sphere's index (0 on a miss) and the hit mask.
    """
    b = origins.shape[0]
    if scene.num_objects == 0:
        return _miss(b, origins.device)
    dots = _dots_matmul if use_matmul else _dots_broadcast
    d_dot_c, o_dot_c = dots(origins, directions, scene.centers)

    a = rmath.sum3(directions * directions)[:, None]
    d_dot_o = rmath.sum3(directions * origins)[:, None]
    o_dot_o = rmath.sum3(origins * origins)[:, None]
    c_dot_c = rmath.sum3(scene.centers * scene.centers)

    h = d_dot_c - d_dot_o
    c = c_dot_c[None, :] - 2.0 * o_dot_c + o_dot_o - (scene.radii ** 2)[None, :]
    del d_dot_c, o_dot_c
    delta = h * h - a * c
    del c
    sqrtd = torch.sqrt(torch.clamp(delta, min=0.0))
    inv_a = 1.0 / a
    root_near = (h - sqrtd) * inv_a
    root_far = (h + sqrtd) * inv_a
    del h, sqrtd
    near_ok = (root_near > t_min) & (root_near < t_max)
    far_ok = (root_far > t_min) & (root_far < t_max)
    root = torch.where(near_ok, root_near, root_far)
    del root_near, root_far
    valid = (delta >= 0.0) & (near_ok | far_ok)
    del delta, near_ok, far_ok
    t_candidates = torch.where(valid, root, _INF)
    del root, valid
    index = torch.argmin(t_candidates, dim=-1)
    t = torch.gather(t_candidates, 1, index[:, None])[:, 0]
    return t, index, t < _INF


def _mt_candidates(o, d, v0, e1, e2, t_min, t_max):
    """Moller-Trumbore over every (ray, triangle) pair: the candidate t,
    (B, M), inf where there is no hit. Two-sided."""
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    hx = dy * e2[None, :, 2] - dz * e2[None, :, 1]
    hy = dz * e2[None, :, 0] - dx * e2[None, :, 2]
    hz = dx * e2[None, :, 1] - dy * e2[None, :, 0]
    det = e1[None, :, 0] * hx + e1[None, :, 1] * hy + e1[None, :, 2] * hz
    inv = 1.0 / torch.where(torch.abs(det) > _MT_EPS, det, 1.0)
    sx = o[:, None, 0] - v0[None, :, 0]
    sy = o[:, None, 1] - v0[None, :, 1]
    sz = o[:, None, 2] - v0[None, :, 2]
    u = (sx * hx + sy * hy + sz * hz) * inv
    qx = sy * e1[None, :, 2] - sz * e1[None, :, 1]
    qy = sz * e1[None, :, 0] - sx * e1[None, :, 2]
    qz = sx * e1[None, :, 1] - sy * e1[None, :, 0]
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2[None, :, 0] * qx + e2[None, :, 1] * qy + e2[None, :, 2] * qz) * inv
    ok = (
        (torch.abs(det) > _MT_EPS)
        & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > t_min) & (t < t_max)
    )
    return torch.where(ok, t, _INF)


def intersect_triangles(
    origins: torch.Tensor,
    directions: torch.Tensor,
    scene: Scene,
    t_min: float = rmath.T_MIN,
    t_max: float = rmath.T_MAX,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closest hit over all M triangles by one masked min-reduction (the
    oracle the BVH walk is held against)."""
    b = origins.shape[0]
    if scene.num_triangles == 0:
        return _miss(b, origins.device)
    cand = _mt_candidates(origins, directions, scene.tri_v0, scene.tri_e1,
                          scene.tri_e2, t_min, t_max)
    idx = torch.argmin(cand, dim=-1)
    t = torch.gather(cand, 1, idx[:, None])[:, 0]
    return t, idx, t < _INF


def _cross(a, b):
    """``jnp.cross`` of (B, 3) rows, component by component."""
    return torch.stack([
        a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0],
    ], dim=-1)


def intersect_triangles_bvh(
    origins: torch.Tensor,
    directions: torch.Tensor,
    scene: Scene,
    t_min: float = rmath.T_MIN,
    t_max: float = rmath.T_MAX,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closest triangle hit by the stackless skip-link BVH walk.

    Each ray carries a node cursor: a box hit (slab test against the ray's
    best t so far) advances it depth-first (+1), a miss jumps the subtree
    (skip link); a leaf tests its up to ``LEAF_SIZE`` triangles in order,
    each against the best t so far. A step works on the rays whose cursor
    is still inside the tree, gathered, and the walk ends when none is;
    each ray sees the JAX package's while_loop sequence, so the result is
    the same.
    """
    b = origins.shape[0]
    dev = origins.device
    if scene.num_triangles == 0:
        return _miss(b, dev)
    k = scene.bvh_min.shape[0]
    last_tri = max(scene.num_triangles - 1, 0)
    inv_d = 1.0 / torch.where(torch.abs(directions) > 1e-30, directions,
                              1e-30)
    node = torch.zeros((b,), dtype=torch.int64, device=dev)
    best_t = torch.full((b,), _INF, dtype=torch.float32, device=dev)
    best_i = torch.zeros((b,), dtype=torch.int64, device=dev)
    bvh_count = scene.bvh_count.to(torch.int64)
    bvh_first = scene.bvh_first.to(torch.int64)
    bvh_skip = scene.bvh_skip.to(torch.int64)
    while True:
        live = torch.nonzero(node < k).squeeze(1)
        if live.numel() == 0:
            break
        n = node[live]
        o = origins[live]
        d = directions[live]
        bt = best_t[live]
        bi = best_i[live]
        t0 = (scene.bvh_min[n] - o) * inv_d[live]
        t1 = (scene.bvh_max[n] - o) * inv_d[live]
        tlo = torch.minimum(t0, t1)
        thi = torch.maximum(t0, t1)
        enter = torch.clamp(torch.amax(tlo, dim=-1), min=t_min)
        exit_ = torch.minimum(torch.amin(thi, dim=-1),
                              torch.clamp(bt, max=t_max))
        box_hit = enter <= exit_
        count = bvh_count[n]
        first = bvh_first[n]
        is_leaf = box_hit & (count > 0)
        for j in range(LEAF_SIZE):
            ti = torch.clamp(first + j, max=last_tri)
            v0 = scene.tri_v0[ti]
            e1 = scene.tri_e1[ti]
            e2 = scene.tri_e2[ti]
            hv = _cross(d, e2)
            det = rmath.sum3(e1 * hv)
            inv = 1.0 / torch.where(torch.abs(det) > _MT_EPS, det, 1.0)
            s = o - v0
            u = rmath.sum3(s * hv) * inv
            q = _cross(s, e1)
            v = rmath.sum3(d * q) * inv
            t = rmath.sum3(e2 * q) * inv
            ok = (
                is_leaf & (j < count)
                & (torch.abs(det) > _MT_EPS)
                & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                & (t > t_min) & (t < torch.clamp(bt, max=t_max))
            )
            bi = torch.where(ok, ti, bi)
            bt = torch.where(ok, t, bt)
        node[live] = torch.where(box_hit, n + 1, bvh_skip[n])
        best_t[live] = bt
        best_i[live] = bi
    return best_t, best_i, best_t < _INF


def triangle_hit_records(
    origins: torch.Tensor,
    directions: torch.Tensor,
    t: torch.Tensor,
    index: torch.Tensor,
    scene: Scene,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Hit point and the triangle's unit geometric normal turned against
    the ray (two-sided), with the front-face flag."""
    t_safe = torch.where(torch.isfinite(t), t, 0.0)
    p = rmath.point_at_param(origins, directions, t_safe)
    e1 = scene.tri_e1[index]
    e2 = scene.tri_e2[index]
    outward = rmath.normalize(_cross(e1, e2), eps=1.0e-30)
    front = rmath.dot(directions, outward) < 0.0
    normal = torch.where(front[..., None], outward, -outward)
    return p, normal, front


def hit_records(
    origins: torch.Tensor,
    directions: torch.Tensor,
    t: torch.Tensor,
    index: torch.Tensor,
    scene: Scene,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Hit point ``o + t d``, the sphere's unit normal ``(p - center) /
    radius`` turned against the ray, and the front-face flag (meaningful
    where the ray hit; ``t`` is made finite elsewhere)."""
    t_safe = torch.where(torch.isfinite(t), t, 0.0)
    p = rmath.point_at_param(origins, directions, t_safe)
    center = scene.centers[index]
    radius = scene.radii[index]
    outward = (p - center) / radius[..., None]
    front = rmath.dot(directions, outward) < 0.0
    normal = torch.where(front[..., None], outward, -outward)
    return p, normal, front
