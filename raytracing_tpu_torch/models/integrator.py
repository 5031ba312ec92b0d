"""Wavefront path-tracing integrator: the portable backend (``"xla"``).

Counterpart of ``raytracing_tpu/models/integrator.py``. Every live ray
carries a throughput and adds ``throughput * sky`` to its radiance at the
bounce where it escapes; absorbed rays and rays still alive after
``max_depth`` scatters add nothing. The bounce loop stops as soon as no ray
is alive, as the JAX package's ``while_loop`` does. Each step intersects
the whole batch with every sphere (and the triangles: the BVH walk above
``2 * TRI_BVH_MIN_LEAVES`` triangles, else brute force), gathers the hit's
material, scatters, and restarts survivors ``SELF_HIT_OFFSET`` off the
surface on the side the new ray leaves by.

RNG: camera keys are two folds of the base key, ``fold(fold(base,
pixel), sample)``, so a (pixel, sample) stream is independent of the
target spp and of chunking or sharding (a render resumed to a higher spp
draws the samples an uninterrupted one does); bounce ``k`` folds
``_BOUNCE_TAG + k`` into the ray's key, then a stream tag.

This backend is plain PyTorch, as the JAX package's is plain XLA: it has
no kernel of its own. ``render_pixels(backend="pallas")`` runs the
regeneration kernel instead (``ops/trace.py::render_pixels_fused``: the
Hopper kernel on CUDA tensors, its plain version on CPU tensors).
"""

from __future__ import annotations

import torch

from ..core import camera as rcamera
from ..core import math as rmath
from ..core import rng as rrng
from ..ops import intersect as rintersect
from ..ops import scatter as rscatter
from ..ops import texture as rtexture
from ..scene.types import Scene

SKY_WHITE = (1.0, 1.0, 1.0)
SKY_BLUE = (0.5, 0.7, 1.0)

# Mixed into a ray's key with the bounce index: bounce streams stay apart
# from the camera streams.
_BOUNCE_TAG = 0x10000

# Scattered rays restart at p + eps * (normal toward the new ray's side):
# the JAX package's acne guard, at scene scale negligible.
SELF_HIT_OFFSET = 1.0e-3

# The BVH walk above this many leaves' worth of triangles (2x), brute force
# below.
TRI_BVH_MIN_LEAVES = 8


def sky_color(directions: torch.Tensor) -> torch.Tensor:
    """The vertical white-to-blue gradient of the background."""
    unit = rmath.normalize(directions, eps=1.0e-20)
    t = 0.5 * (unit[..., 1] + 1.0)
    white = torch.tensor(SKY_WHITE, dtype=torch.float32,
                         device=directions.device)
    blue = torch.tensor(SKY_BLUE, dtype=torch.float32,
                        device=directions.device)
    return rmath.lerp(white, blue, t[..., None])


def trace_rays(
    scene: Scene,
    origins: torch.Tensor,
    directions: torch.Tensor,
    keys: torch.Tensor,
    max_depth: int,
    *,
    use_matmul: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Trace a batch of rays to completion.

    ``origins``/``directions`` (B, 3) float32 and ``keys`` (B, 2) (see
    ``core/rng.py``) on the scene's device. Returns ``(radiance (B, 3),
    segments)``: the rays' linear RGB and the int64 count of segments
    traced (a ray alive at a bounce counts one; the Mrays/s numerator).
    """
    b = origins.shape[0]
    dev = origins.device
    if scene.num_objects == 0 and not scene.has_triangles:
        if max_depth <= 0:
            return (torch.zeros((b, 3), dtype=torch.float32, device=dev),
                    torch.zeros((), dtype=torch.int64, device=dev))
        return sky_color(directions), torch.tensor(b, dtype=torch.int64,
                                                   device=dev)

    o, d = origins, directions
    tp = torch.ones_like(origins)
    rad = torch.zeros_like(origins)
    alive = torch.ones((b,), dtype=torch.bool, device=dev)
    segments = torch.zeros((), dtype=torch.int64, device=dev)
    tri_fn = (
        rintersect.intersect_triangles_bvh
        if scene.num_triangles > 2 * TRI_BVH_MIN_LEAVES
        else rintersect.intersect_triangles
    )
    for bounce in range(max(int(max_depth), 0)):
        if not bool(alive.any()):
            break
        t, idx, hitm = rintersect.intersect_scene(o, d, scene,
                                                  use_matmul=use_matmul)
        if scene.has_triangles:
            # The min of the two families' closest hits is the closest hit
            # of one scan over both.
            tt, tidx, thit = tri_fn(o, d, scene)
            pick_tri = thit & (tt < t)
            hitm = hitm | thit
        hit = alive & hitm
        miss = alive & ~hitm
        rad = rad + torch.where(miss[..., None], tp * sky_color(d), 0.0)

        if scene.num_objects > 0:
            p, normal, front = rintersect.hit_records(o, d, t, idx, scene)
            kind = scene.mat_kind[idx]
            if scene.has_textures:
                outward = torch.where(front[..., None], normal, -normal)
                albedo = rtexture.surface_albedo(scene, idx, p, outward)
            else:
                albedo = scene.albedo[idx]
            fuzz = scene.fuzz[idx]
            ior = scene.ior[idx]
        else:
            # No sphere: placeholders (every hit takes the triangle's).
            p = torch.zeros_like(o)
            normal = torch.zeros_like(o)
            normal[:, 1] = 1.0
            front = torch.ones((b,), dtype=torch.bool, device=dev)
            kind = torch.zeros((b,), dtype=torch.int32, device=dev)
            albedo = torch.ones_like(o)
            fuzz = torch.zeros((b,), dtype=torch.float32, device=dev)
            ior = torch.ones((b,), dtype=torch.float32, device=dev)
        if scene.has_triangles:
            p_t, n_t, f_t = rintersect.triangle_hit_records(o, d, tt, tidx,
                                                            scene)
            pt3 = pick_tri[..., None]
            p = torch.where(pt3, p_t, p)
            normal = torch.where(pt3, n_t, normal)
            front = torch.where(pick_tri, f_t, front)
            kind = torch.where(pick_tri, scene.tri_mat_kind[tidx], kind)
            albedo = torch.where(pt3, scene.tri_albedo[tidx], albedo)
            fuzz = torch.where(pick_tri, scene.tri_fuzz[tidx], fuzz)
            ior = torch.where(pick_tri, scene.tri_ior[tidx], ior)

        bounce_keys = rrng.fold(keys, _BOUNCE_TAG + bounce)
        unit_vec = rrng.unit_vector(rrng.fold(bounce_keys,
                                              rrng.STREAM_UNIT_VEC))
        urand = rrng.uniform(rrng.fold(bounce_keys, rrng.STREAM_SCHLICK))
        new_dir, atten, scat_ok = rscatter.scatter(
            d, normal, front, kind, albedo, fuzz, ior, unit_vec, urand
        )

        survives = hit & scat_ok
        side = torch.sign(rmath.dot(new_dir, normal))[..., None]
        p_safe = p + SELF_HIT_OFFSET * side * normal
        s3 = survives[..., None]
        tp = torch.where(s3, tp * atten, tp)
        o = torch.where(s3, p_safe, o)
        d = torch.where(s3, new_dir, d)
        segments = segments + alive.sum()
        alive = survives
    return rad, segments


def _sum_samples(radiance: torch.Tensor, init: torch.Tensor | None):
    """Per-pixel sums of (P, S, 3) radiance over its samples in sample
    order, continuing ``init`` (P, 3) when given."""
    acc = radiance[:, 0] if init is None else init + radiance[:, 0]
    for s in range(1, radiance.shape[1]):
        acc = acc + radiance[:, s]
    return acc


def render_pixels(
    scene: Scene,
    cam: rcamera.DerivedCamera,
    base_key: torch.Tensor,
    pixel_ids: torch.Tensor,
    sample_start: int,
    chunk_samples: int,
    spp: int,
    max_depth: int,
    *,
    sample_limit: int | None = None,
    use_matmul: bool = True,
    backend: str = "xla",
    pallas_seed: int | None = None,
    pixel_order: str = "linear",
    slot_base: int | None = None,
    radiance_init: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Trace ``chunk_samples`` samples (absolute ids from ``sample_start``)
    for each pixel of ``pixel_ids`` (int, on the scene's device).

    ``backend="xla"``: the wavefront above. Ray ``(pixel, sample)`` is
    keyed by ``fold(fold(base_key, pixel), sample)``; samples at or past
    ``sample_limit`` add nothing (the sharded path's masked tail). The
    per-pixel sums add the samples in order, continuing ``radiance_init``
    (P, 3) when given (the port's addition: a resumed render continues
    each pixel's running sum, so any split of the samples gives the same
    bits).

    ``backend="pallas"``: one wave of the regeneration kernel, every
    pixel slot tracing its ``chunk_samples`` samples (``pixel_order``
    "linear": ``pixel_ids`` is the contiguous range from ``pixel_ids[0]``;
    "tiled": slots from ``slot_base`` of ``runtime/tiling.py``'s order;
    the kernel RNG is keyed by ``pallas_seed``, slot and sample).
    ``spp``, ``sample_limit`` and ``use_matmul`` do not apply there.

    Returns ``(radiance_sum (P, 3), segments)`` (int64 scalar tensor).
    """
    p = pixel_ids.shape[0]
    dev = pixel_ids.device
    if backend == "pallas":
        from ..ops import trace as rtrace
        from ..runtime import tiling as rtiling

        if sample_limit is not None:
            raise NotImplementedError(
                "sample_limit tail masking is an xla-backend feature (the "
                "regen kernel takes its budget as a runtime scalar instead)"
            )
        if pixel_order == "tiled":
            map_param = rtiling.tiles_per_row(cam.image_width)
            base = int(slot_base) if slot_base is not None else 0
        else:
            map_param = cam.image_width
            base = int(pixel_ids[0])
        rad, segments, _ = rtrace.render_pixels_fused(
            scene, cam, slot_base=base, map_param=map_param,
            seed=int(pallas_seed or 0), sample_start=int(sample_start),
            spp=int(chunk_samples), max_depth=int(max_depth),
            t_end=int(chunk_samples),
            done=torch.zeros((p,), dtype=torch.int32, device=dev),
            num_slots=p, pixel_order=pixel_order,
            radiance_sum=radiance_init,
        )
        return rad, segments
    if backend != "xla":
        raise ValueError(f"unknown backend {backend!r}")

    sample_ids = int(sample_start) + torch.arange(
        chunk_samples, dtype=torch.int64, device=dev)
    pix = torch.repeat_interleave(pixel_ids.to(torch.int64), chunk_samples)
    samp = sample_ids.repeat(p)
    # Two fold levels, not pixel * spp + sample: the stream does not depend
    # on the target spp.
    keys = rrng.fold(rrng.ray_keys(base_key.to(dev), pix), samp)
    px = pix % cam.image_width
    py = pix // cam.image_width
    origins, directions = rcamera.generate_rays(cam, keys, px, py)
    radiance, segments = trace_rays(scene, origins, directions, keys,
                                    max_depth, use_matmul=use_matmul)
    if sample_limit is not None:
        radiance = torch.where((samp < sample_limit)[..., None], radiance,
                               0.0)
    radiance_sum = _sum_samples(radiance.reshape(p, chunk_samples, 3),
                                radiance_init)
    return radiance_sum, segments
