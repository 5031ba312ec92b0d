"""Caller rays at the sphere key's edge cases, for the sweep's miss select.

The sphere key takes the root of the discriminant ``delta = h*h - a*cq``
(``csrc/regen_core.cuh``, ``sphere_key``). These rays put ``delta`` where
the root of the raw discriminant and the miss select could part, on a
scene of three spheres whose coordinates are small integers (so the
arithmetic below is exact in float32, without multiply-adds):

* ``tangent``: rays along -z that graze a sphere's silhouette: ``delta``
  exactly +0, at unit directions and at directions of length 2^-63
  (``a`` = 2^-126, the least normal, so ``T_MIN * a`` is denormal);
* ``denormal``: the grazing rays of length 2^-63 from origins a few ulps
  inside or outside the silhouette: ``delta`` a positive or negative
  denormal;
* ``tiny``: the grazing rays at directions of length 2^-50 (``a`` =
  2^-100) from origins a few ulps outside or inside the silhouette:
  ``delta`` a negative or positive normal float of magnitude below
  2^-101. The flat sweep's lean row flags a positive one for its
  ``sqrtf`` re-sweep and takes ``fast_root``'s NaN of a negative one,
  unflagged, as a miss;
* ``overflow``: origins at 1e20, where ``o.o`` overflows: ``h*h`` finite
  and ``a*cq`` infinite (``delta`` -inf), or both infinite (NaN);
* ``pad``: rays from the world origin at each sphere's centre, through
  the pad rows (``cm2`` = 1e30) that repeat the last sphere's centre;
* ``seeded``: the rest of the batch, directions from a seeded generator.

``delta`` itself can never be -0.0 here: ``h*h`` is never -0.0, and a
difference is -0.0 only as (-0.0) - (+0.0).

Usage: ``edge_rays(seed)`` returns ``(origins, directions, kinds)`` as
numpy float32 [n, 3] arrays and a list of (kind, start, stop) slices;
``add_spheres(builder)`` puts ``SPHERES`` into a ``SceneBuilder`` (the
port's or the JAX package's: they share the method names).
``sized_spheres(builder, n_pad, seed)`` fills one with a seeded scene
whose table has ``n_pad`` rows, for the staged table sizes that shared
memory sized to the table makes distinct (128, 256, 512, 1,024).

Past 1,024 rows the chunked bodies sweep the table, and their sweeps
(the flat rule, and the two-level rule's stage 1 over a chunk with its
stage 2 folded in) sweep a window again with sqrtf where a root fell
outside ``fast_root``'s range.
``padded_spheres(builder)`` puts ``SPHERES`` into a table of 2,048 rows
(``PADDED_ROWS``), the rest of the spheres behind the plane z = 3, where
no ray of ``edge_rays`` or of ``tiny_camera`` goes (each leaves z <= 0
toward -z or along x). ``tiny_camera()`` sends every hit's discriminant
outside that range: its rays leave the world origin with directions of
length about 2^-60 (``TINY_FOCUS``), so ``a`` = |d|^2 is about 2^-120 and a
hit's ``delta`` (at most ``a * r^2``, r <= 2) lies below 2^-101. The
camera sits at the origin so that the tiny pixel offsets stay exact.

The staged sweep stops at the real rows for rays inside its bound
(``csrc/regen.cu``, ``cut_ok``; ``ops/trace.py::staged_sweep_rows``).
``counted_spheres(builder, n)`` puts ``n`` seeded spheres in a table of 128
rows (1, 3, 5, 127: real rows that end inside a trip of four or at one);
``phantom_spheres(builder)`` puts a sphere past 1e15 at the Morton-last
row, so that the pad rows repeating its centre win the rays aimed at it
(``phantom_camera()`` looks at it); ``past_the_bound_rays()`` holds rays
past the bound: aimed at the phantom, from origins at 4e18, of ``a`` = 0,
and seeded.

The triangle key's reciprocal (``key_rcp``) has its own range: where
b = bf16(|det|) reaches 2^126 it is not the IEEE reciprocal, and the
triangle sweeps sweep that window again with the IEEE divide.
``scaled_mesh(builder)`` puts a mesh scaled to 2^66 (``SCALED``) in front
of ``scaled_camera()``, so that the rays that reach it carry such keys.
"""

from __future__ import annotations

import numpy as np

# (center, radius, material, parameter): lambertian albedo, metal
# (albedo, fuzz) or dielectric index.
SPHERES = (
    ((0.0, 0.0, -4.0), 1.0, "lambertian", (0.7, 0.3, 0.2)),
    ((4.0, 0.0, -8.0), 2.0, "metal", ((0.8, 0.8, 0.9), 0.0)),
    ((-4.0, 2.0, -6.0), 1.0, "dielectric", 1.5),
)
TINY = np.float32(2.0 ** -63)
TINY_NORMAL = np.float32(2.0 ** -50)
RAYS = 1024
PADDED_ROWS = 2048
TINY_FOCUS = 2.0 ** -60
SCALED = 2.0 ** 66
PHANTOM_CENTER = (2.0e15, 2.0e15, 2.0e15)


def add_spheres(builder):
    """``SPHERES`` added to ``builder``; returns it."""
    for center, radius, kind, param in SPHERES:
        if kind == "lambertian":
            builder.add_lambertian_sphere(center, radius, param)
        elif kind == "metal":
            builder.add_metallic_sphere(center, radius, *param)
        else:
            builder.add_dielectric_sphere(center, radius, param)
    return builder


def sized_spheres(builder, n_pad: int, seed: int = 0):
    """A ground sphere and small spheres of every material on it, 3/4 of
    ``n_pad`` in all (a power of two from 128), so that the packed table
    has ``n_pad`` rows; returns ``builder``."""
    rng = np.random.default_rng(seed)
    builder.add_lambertian_sphere((0.0, -1000.0, 0.0), 1000.0,
                                  (0.5, 0.5, 0.5))
    side = int(np.ceil(np.sqrt(3 * n_pad // 4)))
    for i in range(3 * n_pad // 4 - 1):
        x = (i % side - side / 2) * 0.5 + rng.uniform(-0.1, 0.1)
        z = (i // side - side / 2) * 0.5 + rng.uniform(-0.1, 0.1)
        u = rng.uniform()
        if u < 0.6:
            builder.add_lambertian_sphere((x, 0.15, z), 0.15,
                                          tuple(rng.uniform(0, 1, 3)))
        elif u < 0.9:
            builder.add_metallic_sphere((x, 0.15, z), 0.15,
                                        tuple(rng.uniform(0.5, 1, 3)),
                                        float(rng.uniform(0.0, 0.3)))
        else:
            builder.add_dielectric_sphere((x, 0.15, z), 0.15, 1.5)
    return builder


def padded_spheres(builder, spheres: int = 1200, seed: int = 0):
    """``SPHERES``, then ``spheres`` - 3 small seeded spheres on a grid
    behind the plane z = 3 (a table of ``PADDED_ROWS`` rows); returns
    ``builder``."""
    rng = np.random.default_rng(seed)
    add_spheres(builder)
    for i in range(spheres - len(SPHERES)):
        center = ((i % 20 - 9.5) * 1.2, (i // 20 % 10 - 4.5) * 1.2,
                  4.0 + i // 200 * 1.2 + rng.uniform(0.0, 0.2))
        u = rng.uniform()
        if u < 0.6:
            builder.add_lambertian_sphere(center, 0.3,
                                          tuple(rng.uniform(0, 1, 3)))
        elif u < 0.9:
            builder.add_metallic_sphere(center, 0.3,
                                        tuple(rng.uniform(0.5, 1, 3)),
                                        float(rng.uniform(0.0, 0.3)))
        else:
            builder.add_dielectric_sphere(center, 0.3, 1.5)
    return builder


def counted_spheres(builder, n: int):
    """A ground sphere and ``n`` - 1 small seeded spheres of every material
    in front of the golden camera (lookfrom (0, 0.3, 1.2)); returns
    ``builder``."""
    rng = np.random.default_rng(n)
    builder.add_lambertian_sphere((0.0, -100.5, -1.0), 100.0,
                                  (0.5, 0.5, 0.5))
    for _ in range(n - 1):
        c = (rng.uniform(-2.0, 2.0), rng.uniform(-0.4, 0.8),
             rng.uniform(-4.0, -0.5))
        u = rng.uniform()
        if u < 0.5:
            builder.add_lambertian_sphere(c, 0.15,
                                          tuple(rng.uniform(0, 1, 3)))
        elif u < 0.8:
            builder.add_metallic_sphere(c, 0.15,
                                        tuple(rng.uniform(0.5, 1, 3)), 0.1)
        else:
            builder.add_dielectric_sphere(c, 0.15, 1.5)
    return builder


def phantom_spheres(builder):
    """Three small spheres before the world origin and one of radius 1e14
    at ``PHANTOM_CENTER``, the Morton-last of four rows (a whole trip), so
    that the pad rows after it (cm2 = 1e30) meet rays as a sphere of radius
    sqrt(|c|^2 - 1e30) and win most of those aimed at it; returns
    ``builder``."""
    builder.add_lambertian_sphere((0.0, 0.0, -3.0), 1.0, (0.5, 0.5, 0.5))
    builder.add_metallic_sphere((2.0, 0.0, -4.0), 1.0, (0.8, 0.8, 0.8), 0.1)
    builder.add_dielectric_sphere((-2.0, 0.5, -4.0), 0.8, 1.5)
    builder.add_lambertian_sphere(PHANTOM_CENTER, 1.0e14, (0.2, 0.7, 0.2))
    return builder


def phantom_camera(width: int = 64, spp: int = 2, depth: int = 4):
    """The port's ``CameraParameters`` at the world origin looking at
    ``PHANTOM_CENTER``, without defocus."""
    from ..core.camera import CameraParameters

    return CameraParameters(
        aspect_ratio=16.0 / 9.0, image_width=width, samples_per_pixel=spp,
        max_depth=depth, vertical_fov=70.0, defocus_angle=0.0,
        focus_distance=1.0, lookfrom=(0.0, 0.0, 0.0), lookat=PHANTOM_CENTER)


def aimed(center, origins: np.ndarray, rng, jitter: float) -> np.ndarray:
    """Unit directions from ``origins`` at ``center`` plus normal jitter of
    ``jitter``, float32."""
    d = np.asarray(center, np.float64) - origins.astype(np.float64)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d += rng.normal(size=d.shape) * jitter
    return d.astype(np.float32)


def past_the_bound_rays(n: int = RAYS, seed: int = 9):
    """``n`` rays past the real-row cut's bound, a quarter of each kind:
    from [-1, 1]^3 aimed at ``PHANTOM_CENTER``; from origins at 4e18 aimed
    near (0, 0, -3); from the world origin with directions of about 1e-25
    (``a`` rounds to 0); from the world origin, seeded. Numpy float32
    (origins, directions) [n, 3]."""
    rng = np.random.default_rng(seed)
    q = n // 4
    o1 = rng.uniform(-1.0, 1.0, (q, 3)).astype(np.float32)
    u = rng.normal(size=(q, 3))
    o2 = (u / np.linalg.norm(u, axis=1, keepdims=True) * 4.0e18)
    o2 = o2.astype(np.float32)
    o = np.concatenate([o1, o2, np.zeros((n - 2 * q, 3), np.float32)])
    d = np.concatenate([
        aimed(PHANTOM_CENTER, o1, rng, 0.3),
        aimed((0.0, 0.0, -3.0), o2, rng, 1e-7),
        (rng.normal(size=(q, 3)) * 1.0e-25).astype(np.float32),
        rng.normal(size=(n - 3 * q, 3)).astype(np.float32)])
    return o, d


def tiny_camera(width: int = 64, spp: int = 2, depth: int = 4):
    """The port's ``CameraParameters`` at the world origin looking down -z
    at focus distance ``TINY_FOCUS``, without defocus, wide enough to see
    every sphere of ``SPHERES``."""
    from ..core.camera import CameraParameters

    return CameraParameters(
        aspect_ratio=16.0 / 9.0, image_width=width, samples_per_pixel=spp,
        max_depth=depth, vertical_fov=70.0, defocus_angle=0.0,
        focus_distance=TINY_FOCUS, lookfrom=(0.0, 0.0, 0.0),
        lookat=(0.0, 0.0, -1.0))


def scaled_mesh(builder):
    """A ground sphere, a 320-triangle icosphere scaled to ``SCALED`` and
    set 3 * ``SCALED`` down -z, and one of radius 0.5 at (0, 0, -1.2): 640
    triangle rows, the two-level triangle rule under
    ``RT_TWO_LEVEL_MIN=1`` (4 culled blocks of 256 rows). Rays from the
    world origin that reach the large mesh have |det| = |e1 . (d x e2)| at
    or past 2^126; returns ``builder``."""
    from ..scene.mesh import make_icosphere

    verts, faces = make_icosphere(2)
    scale = np.float32(SCALED)
    builder.add_lambertian_sphere((0.0, -100.5, -1.0), 100.0,
                                  (0.5, 0.5, 0.5))
    builder.add_mesh(verts * scale + np.float32([0.0, 0.0, -3.0]) * scale,
                     faces, albedo=(0.8, 0.6, 0.3))
    builder.add_mesh(verts * 0.5 + np.float32([0.0, 0.0, -1.2]), faces,
                     albedo=(0.3, 0.6, 0.8))
    return builder


def scaled_camera(width: int = 64, spp: int = 2, depth: int = 4):
    """The port's ``CameraParameters`` at the world origin looking down -z
    at both meshes of ``scaled_mesh``, without defocus."""
    from ..core.camera import CameraParameters

    return CameraParameters(
        aspect_ratio=2.0, image_width=width, samples_per_pixel=spp,
        max_depth=depth, vertical_fov=55.0, defocus_angle=0.0,
        focus_distance=1.0, lookfrom=(0.0, 0.0, 0.0),
        lookat=(0.0, 0.0, -1.0))


def _grazing(scale: float, nudge: int = 0):
    """Rays along -z from z = 0 past each sphere's four silhouette points
    (x or y offset by +-r), direction length ``scale``; the origin's offset
    coordinate moves ``nudge`` * 2^-19 away from the centre (negative:
    toward it), so that ``cq`` moves by a few of its ulps."""
    o, d = [], []
    for (cx, cy, _), r, _, _ in SPHERES:
        for axis in (0, 1):
            for sign in (1.0, -1.0):
                p = np.float32([cx, cy, 0.0])
                p[axis] = np.float32(p[axis] + sign * (r + nudge * 2.0 ** -19))
                o.append(p)
                d.append(np.float32([0.0, 0.0, -1.0]) * np.float32(scale))
    return np.array(o, np.float32), np.array(d, np.float32)


def _overflow():
    """Origins at 1e20: along -z (h*h finite, o.o infinite: delta -inf),
    and along -x through each sphere's centre line (delta NaN)."""
    o, d = [], []
    for (cx, cy, cz), _, _, _ in SPHERES:
        o.append([1.0e20, cy, 0.0])
        d.append([0.0, 0.0, -1.0])
        o.append([1.0e20, cy, cz])
        d.append([-1.0, 0.0, 0.0])
        o.append([-1.0e20, cy, cz])
        d.append([1.0, 0.0, 0.0])
    return np.array(o, np.float32), np.array(d, np.float32)


def _pad():
    """From the world origin at each sphere's centre."""
    c = np.array([s[0] for s in SPHERES], np.float32)
    return np.zeros_like(c), c


def edge_rays(seed: int = 0, n: int = RAYS):
    """The batch: every kind above, then seeded rays up to ``n``."""
    parts = [("tangent", *_grazing(1.0)), ("tangent", *_grazing(TINY))]
    for k in (1, 2, 3):
        parts += [("denormal", *_grazing(TINY, k)),
                  ("denormal", *_grazing(TINY, -k))]
    for k in (1, 2, 3):
        parts += [("tiny", *_grazing(TINY_NORMAL, k)),
                  ("tiny", *_grazing(TINY_NORMAL, -k))]
    parts += [("overflow", *_overflow()), ("pad", *_pad())]
    used = sum(len(p[1]) for p in parts)
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n - used, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2])
    parts.append(("seeded", np.zeros_like(d), d))
    kinds, start = [], 0
    for kind, o, _ in parts:
        kinds.append((kind, start, start + len(o)))
        start += len(o)
    return (np.concatenate([p[1] for p in parts]),
            np.concatenate([p[2] for p in parts]), kinds)


def deltas(origins: np.ndarray, directions: np.ndarray) -> np.ndarray:
    """``delta`` of every (ray, sphere) pair in float32, in the kernel's
    association order and without multiply-adds: [rays, spheres]."""
    f = np.float32
    out = np.empty((len(origins), len(SPHERES)), np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        for j, (c, r, _, _) in enumerate(SPHERES):
            cx, cy, cz = (f(v) for v in c)
            cm2 = cx * cx + cy * cy + cz * cz - f(r) * f(r)
            for i, (o, d) in enumerate(zip(origins, directions)):
                a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
                ddo = d[0] * o[0] + d[1] * o[1] + d[2] * o[2]
                odo = o[0] * o[0] + o[1] * o[1] + o[2] * o[2]
                h = cx * d[0] + cy * d[1] + cz * d[2] - ddo
                cq = (cm2 + f(-2.0) * cx * o[0] + f(-2.0) * cy * o[1]
                      + f(-2.0) * cz * o[2] + odo)
                out[i, j] = h * h - a * cq
    return out
