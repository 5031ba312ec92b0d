"""Sharded rendering over the (px, spp) device mesh.

Counterpart of ``raytracing_tpu/parallel/shard.py``. The JAX package runs
one program per device under ``shard_map`` and combines them with
``psum``; here one process launches each shard's work on its own device
and sums the partials itself:

* pixels (or kernel slots) split contiguously over ``px``;
* the samples split over ``spp``; the ``spp`` partial sums of a pixel
  shard are added on that shard's first device, in shard order (shard 0's
  partial continues the running sums when the caller passes them);
* segments are summed as int64 over every shard.

Every draw is keyed by the global (pixel or slot, absolute sample), so
every mesh shape traces the same samples and the same segments as the
unsharded call; a px-only mesh gives its bits, an spp split differs by the
order of the final additions. Results are gathered on the mesh's first
device.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import camera as rcamera
from ..models import integrator
from ..ops import trace as rtrace
from ..runtime import tiling as rtiling
from ..scene.types import Scene
from .mesh import AXIS_PIXELS, AXIS_SAMPLES, Mesh


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _tables_on(tables: rtrace.SceneTables, device) -> rtrace.SceneTables:
    """``tables`` with every tensor on ``device`` (the same tables where
    they already are)."""
    device = torch.device(device)
    if tables.device == device:
        return tables
    return dataclasses.replace(tables, **{
        f.name: getattr(tables, f.name).to(device)
        for f in dataclasses.fields(tables)
        if isinstance(getattr(tables, f.name), torch.Tensor)
    })


def render_pixels_sharded(
    scene: Scene,
    cam: rcamera.DerivedCamera,
    base_key: torch.Tensor,
    pixel_ids: torch.Tensor,
    sample_start: int,
    chunk_samples: int,
    spp: int,
    max_depth: int,
    mesh: Mesh,
    use_matmul: bool = True,
    *,
    radiance_init: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``integrator.render_pixels`` (xla) over the mesh.

    ``pixel_ids`` (a length the ``px`` axis divides) split over ``px``;
    each ``spp`` shard traces ``ceil(chunk_samples / n_spp)`` samples from
    ``sample_start + k * ceil(...)``, and samples at or past
    ``sample_start + chunk_samples`` add nothing (masked, not skipped: the
    uneven tail is traced and its segments counted, as in the JAX
    package). ``radiance_init`` (P, 3) is continued by sample shard 0.

    Returns ``(radiance_sum (P, 3), segments)`` on the mesh's first
    device.
    """
    n_px = mesh.shape[AXIS_PIXELS]
    n_sp = mesh.shape[AXIS_SAMPLES]
    p_all = pixel_ids.shape[0]
    if p_all % n_px:
        raise ValueError(
            f"{p_all} pixel ids do not divide over {n_px} px shards"
        )
    lp = p_all // n_px
    local_chunk = _ceil_div(chunk_samples, n_sp)
    limit = int(sample_start) + int(chunk_samples)
    out, segments = [], []
    for p in range(n_px):
        ids = pixel_ids[p * lp:(p + 1) * lp]
        acc = None
        for s in range(n_sp):
            dev = mesh.devices[p][s]
            init = None
            if s == 0 and radiance_init is not None:
                init = radiance_init[p * lp:(p + 1) * lp].to(dev)
            rad, seg = integrator.render_pixels(
                scene.to(dev), cam, base_key.to(dev), ids.to(dev),
                int(sample_start) + s * local_chunk, local_chunk, spp,
                max_depth, sample_limit=limit, use_matmul=use_matmul,
                radiance_init=init,
            )
            acc = rad if acc is None else acc + rad.to(mesh.devices[p][0])
            segments.append(seg.to(mesh.first))
        out.append(acc.to(mesh.first))
    return torch.cat(out), torch.stack(segments).sum()


def render_pixels_fused_sharded(
    scene_tables,
    cam,
    slot_base: int,
    seed: int,
    sample_start: int,
    chunk_spp: int,
    max_depth: int,
    num_slots: int,
    mesh: Mesh,
    pixel_order: str = "tiled",
    done: torch.Tensor | None = None,
    t_end: int | None = None,
    *,
    map_param: int | None = None,
    radiance_sum: torch.Tensor | None = None,
    gather: str | None = None,
    counts: bool = False,
):
    """The regeneration kernel over the mesh: one launch per shard, each on
    its shard's device (``ops/trace.py::render_pixels_fused``).

    * Slots split contiguously over ``px``: pixel shard ``p`` runs
      ``num_slots / n_px`` slots from ``slot_base + p * num_slots / n_px``
      (a multiple of the 1,024-slot tile).
    * The budget ``chunk_spp`` splits over ``spp``: sample shard ``k``
      traces ``[sample_start + k * chunk // n, sample_start + (k + 1) *
      chunk // n)``.
    * Work-ahead (``done`` and ``t_end``): ``chunk_spp`` is the full
      budget; ``done`` is the JAX package's ``(n_spp * num_slots / 128,
      128)`` int32 array of local counts, sample shard ``k``'s block
      first, pixel shards within it; the global cumulative target
      ``t_end`` is apportioned to shard ``k`` as ``t_end * (k + 1) // n -
      t_end * k // n``, clamped to its share of the budget. Without them
      each shard traces its whole share (a self-contained wave).

    ``scene_tables``: a ``Scene`` (packed here, blocks ordered from the
    camera center), a ``SceneTables``, or a dict of them by device (the
    tables are copied to a device that has none). ``cam``: a
    ``DerivedCamera``, or the float32[20] camera vector with
    ``map_param`` given. ``radiance_sum`` (num_slots, 3), on the mesh's
    first device, is continued by sample shard 0 and updated in place.

    Returns ``(radiance_sum, segments)`` and, in work-ahead, the updated
    ``done``; all on the mesh's first device. ``counts``: the shards'
    int64[4] count buffers summed in place of the segments
    (``render_pixels_fused``'s).
    """
    n_px = mesh.shape[AXIS_PIXELS]
    n_sp = mesh.shape[AXIS_SAMPLES]
    tile = rtrace.TILE_SLOTS
    if num_slots % (n_px * tile) != 0:
        raise ValueError(
            f"num_slots {num_slots} must divide over {n_px} px shards in "
            f"multiples of the {tile}-slot kernel tile"
        )
    work_ahead = done is not None
    if work_ahead and t_end is None:
        raise ValueError("work-ahead needs both done and t_end")
    if map_param is None:
        if not isinstance(cam, rcamera.DerivedCamera):
            raise ValueError("a camera vector needs map_param")
        map_param = (rtiling.tiles_per_row(cam.image_width)
                     if pixel_order == "tiled" else cam.image_width)
    cam_vec = rtrace._camera_vector(cam).cpu()
    local_slots = num_slots // n_px
    rows = local_slots // 128
    first = mesh.first
    if work_ahead and tuple(done.shape) != (n_sp * num_slots // 128, 128):
        raise ValueError(
            f"done must be [{n_sp * num_slots // 128}, 128] (one block per "
            "sample shard)"
        )
    if radiance_sum is not None and tuple(radiance_sum.shape) != (
            num_slots, 3):
        raise ValueError(f"radiance_sum must be [{num_slots}, 3]")

    if isinstance(scene_tables, Scene):
        scene_tables = rtrace.pack_scene(scene_tables.to(first),
                                         origin=cam_vec[9:12])
    tables = (dict(scene_tables) if isinstance(scene_tables, dict)
              else {scene_tables.device: scene_tables})

    def tables_for(dev):
        if dev not in tables:
            tables[dev] = _tables_on(next(iter(tables.values())), dev)
        return tables[dev]

    done_out = torch.empty_like(done) if work_ahead else None
    rad_out, segments = [], []
    for p in range(n_px):
        acc = None
        for s in range(n_sp):
            dev = mesh.devices[p][s]
            lo = (chunk_spp * s) // n_sp
            local_spp = (chunk_spp * (s + 1)) // n_sp - lo
            r0 = s * (num_slots // 128) + p * rows
            if work_ahead:
                u = (t_end * (s + 1)) // n_sp - (t_end * s) // n_sp
                te = min(u, local_spp)
                done_local = done[r0:r0 + rows].reshape(-1).to(dev)
            else:
                te = local_spp
                done_local = torch.zeros((local_slots,), dtype=torch.int32,
                                         device=dev)
            rs = None
            if s == 0 and radiance_sum is not None:
                rs = radiance_sum[p * local_slots:(p + 1) * local_slots]
                rs = rs.to(dev)
            rad, seg, d_out = rtrace.render_pixels_fused(
                tables_for(dev), cam_vec,
                slot_base=int(slot_base) + p * local_slots,
                map_param=map_param, seed=seed,
                sample_start=int(sample_start) + lo, spp=local_spp,
                max_depth=max_depth, t_end=te, done=done_local,
                num_slots=local_slots, pixel_order=pixel_order,
                radiance_sum=rs, gather=gather, counts=counts,
            )
            if work_ahead:
                done_out[r0:r0 + rows] = d_out.reshape(rows, 128).to(first)
            acc = rad if acc is None else acc + rad.to(mesh.devices[p][0])
            segments.append(seg.to(first))
        rad_out.append(acc.to(first))
    if radiance_sum is not None:
        for p, acc in enumerate(rad_out):
            part = radiance_sum[p * local_slots:(p + 1) * local_slots]
            if acc.data_ptr() != part.data_ptr():
                part.copy_(acc)
        rad = radiance_sum
    else:
        rad = torch.cat(rad_out)
    seg = torch.stack(segments).sum(dim=0)
    return (rad, seg, done_out) if work_ahead else (rad, seg)
