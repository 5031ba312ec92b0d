"""Renderer: waves of the regeneration kernel over every pixel slot, the
interactive frame API, and checkpoints.

Counterpart of the regeneration-kernel path of
``raytracing_tpu/runtime/renderer.py``:

* ``_plan`` picks the wave size: one launch always covers every slot (32x32
  tiled order, padded to whole tiles) and only the sample budget is split,
  into waves of at most ``max_rays_per_batch * 64 / slots`` samples, and
  without a progress observer never into more than ~4 waves.
* Work-ahead: per-slot ``done`` counts are carried from wave to wave; each
  wave gets the full budget as its cap and the cumulative target
  ``t_end``, so a slot's samples are ``[0, spp)`` whatever the split.
* Radiance sums stay on the device in slot order, and each wave continues
  every slot's running sum (so any split gives the same bits); the image is
  ``rgb_to_u8(sums * float32(1 / done))`` (a multiply, for byte parity with
  the JAX package), reordered from slots to pixels on the host.
* The sums, the per-slot ``done`` counts and the sample count live on the
  instance, updated after every wave (before ``on_progress`` fires), so a
  render can be checkpointed at any wave (``save_checkpoint``) and resumed
  (``load_checkpoint``, ``render(resume=True)``) with the same bits.
* The frame API (``render_frame*``, ``render_frame_accum*``) is one kernel
  launch a frame plus the tonemap (and a box-downsampled preview) on the
  same stream, with no host synchronisation; an accumulating frame
  continues the pose's running sums in place, so k idle frames give the
  bits of one ``render(spp=k*spp)``.

Two backends, the JAX package's names: ``"pallas"`` is the regeneration
kernel above (``"auto"`` picks it on every device: the hand-written kernel
is what the port exists for, and its plain version runs on the CPU; the
JAX package picks ``"xla"`` off a TPU); ``"xla"`` is the portable
wavefront (``models/integrator.py``), waves of (pixel block x sample
chunk) of at most ``max_rays_per_batch`` rays in linear pixel order,
whose per-pixel sums go into a pixel-order framebuffer with one spill row
for padded ids. Each xla wave continues the running sums of its pixels
(gathered, then written back with ``index_copy_``; real pixel ids are
unique within a wave), so a resumed xla render is byte-equal to an
uninterrupted one at any split too (the JAX package adds a per-wave sum,
equal when the chunking matches). Checkpoints record the layout,
``"slot"`` (pallas) or ``"pixel"`` (xla), and refuse the other backend's.

With ``mesh=`` (``parallel/mesh.py``) a render is sharded over its (px,
spp) devices (``parallel/shard.py``): pixel blocks or slots padded to
divide over ``px``, the samples over ``spp``; under work-ahead each spp
shard carries its own ``done`` block (the JAX layout, ``(n_spp * slots /
128, 128)`` in checkpoints) laid out by the budget's split, and a resume
toward another budget re-splits a state that sits at a sample prefix and
refuses a ragged one. The frame API is single-device and raises under a
mesh, as the JAX package's does.

The JAX package's adaptive 8-spp probe wave and its wall-clock wave target
exist for a remote TPU runtime's watchdog and are not part of this port.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Callable

import numpy as np
import torch

from ..core import camera as rcamera
from ..core import color as rcolor
from ..core import rng as rrng
from ..models import integrator
from ..ops import trace as rtrace
from ..parallel import shard as rshard
from ..scene.types import Scene
from ..utils import spans
from . import tiling as rtiling

ProgressCallback = Callable[["RenderProgress"], None]


@dataclasses.dataclass
class RenderProgress:
    """Snapshot handed to progress callbacks between waves."""

    samples_done: int
    samples_total: int
    pixels_count: int
    segments_traced: int
    elapsed_s: float
    _preview: Callable[[], np.ndarray]

    @property
    def fraction(self) -> float:
        return self.samples_done / max(self.samples_total, 1)

    @property
    def pixels_raytraced(self) -> int:
        return int(self.fraction * self.pixels_count)

    def preview(self) -> np.ndarray:
        """The converged-so-far uint8 RGB image (device -> host)."""
        return self._preview()


def _slots_to_u8(slot_sum: torch.Tensor, done: torch.Tensor) -> torch.Tensor:
    """Per-slot mean through the color pipe: ``sums * float32(1/done)``."""
    inv = torch.reciprocal(torch.clamp(done, min=1).to(torch.float32))
    return rcolor.rgb_to_u8(slot_sum * inv[:, None])


def _to_u8(image_sum: torch.Tensor, samples: int, height: int,
           width: int) -> torch.Tensor:
    """The xla framebuffer (pixels + spill row) -> u8 ``[H, W, 3]``:
    ``sums * float32(1.0 / samples)``, the JAX package's ``_to_u8``."""
    inv = float(np.float32(1.0 / max(int(samples), 1)))
    return rcolor.rgb_to_u8(image_sum[:-1] * inv).reshape(height, width, 3)


def _slots_to_u8_total(slot_sum: torch.Tensor, total: int) -> torch.Tensor:
    """``_slots_to_u8`` with every slot at ``total`` samples:
    ``sums * float32(1/total)`` (the scalar is exact in float32)."""
    inv = float(np.float32(1.0) / np.float32(max(int(total), 1)))
    return rcolor.rgb_to_u8(slot_sum * inv)


def _device_preview(
    u8: torch.Tensor,
    slot_ids: torch.Tensor,
    height: int,
    width: int,
    ph: int,
    pw: int,
) -> torch.Tensor:
    """Slot->pixel reorder and (ph, pw) box downsample on ``u8``'s device
    (the JAX package's ``_device_preview``): padded slots go to a spill row,
    the frame is edge-padded to ceil box factors so the preview covers all
    of it, and each cell is ``uint8(mean + 0.5)`` of its box (the box's
    exact integer sum divided by its size in float32). The caller shrinks
    (ph, pw) to ceil(h/fy) x ceil(w/fx)."""
    num_pixels = height * width
    dev = u8.device
    ids = torch.clamp(slot_ids.to(torch.int64), max=num_pixels)
    fb = torch.zeros((num_pixels + 1, 3), dtype=torch.uint8, device=dev)
    fb.index_copy_(0, ids, u8)
    img = fb[:-1].reshape(height, width, 3)
    fy = -(-height // ph)
    fx = -(-width // pw)
    rows = torch.clamp(torch.arange(ph * fy, device=dev), max=height - 1)
    cols = torch.clamp(torch.arange(pw * fx, device=dev), max=width - 1)
    padded = img[rows][:, cols].to(torch.float32)
    box = padded.reshape(ph, fy, pw, fx, 3).sum(dim=(1, 3))
    return (box / float(fy * fx) + 0.5).to(torch.uint8)


def _preview_shape(height: int, width: int, rows: int, cols: int):
    """The preview's (ph, pw): at most (rows, cols), shrunk to the ceil box
    factors' cover of the frame."""
    fy = -(-height // min(int(rows), height))
    fx = -(-width // min(int(cols), width))
    return -(-height // fy), -(-width // fx)


def _slots_to_image(slot_u8: np.ndarray, width: int, height: int) -> np.ndarray:
    """Host-side slot->pixel reorder of the 32x32 tiled slot order (spill
    slots, and padding slots past the image's tiles, dropped). Equal to scattering by ``tiling.tiled_pixel_ids``, done
    as one tile transpose: slot ``(ty, tx, wy, wx)`` is pixel
    ``(ty*32 + wy, tx*32 + wx)``."""
    tpr = rtiling.tiles_per_row(width)
    rows = -(-height // rtiling.TILE_H)
    slot_u8 = slot_u8[:rows * tpr * rtiling.TILE_H * rtiling.TILE_W]
    tiles = slot_u8.reshape(rows, tpr, rtiling.TILE_H, rtiling.TILE_W, 3)
    img = tiles.transpose(0, 2, 1, 3, 4).reshape(
        rows * rtiling.TILE_H, tpr * rtiling.TILE_W, 3
    )
    return np.ascontiguousarray(img[:height, :width])


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without CUDA raises
    (the port never renders on the CPU in place of the card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False"
        )
    return dev


BACKENDS = ("auto", "pallas", "xla")
# Checkpoint framebuffer layout by backend.
_LAYOUT = {"pallas": "slot", "xla": "pixel"}


class Renderer:
    """Progressive renderer for one scene (spheres, textures, triangles) +
    camera on one device (``"cuda"``: the Hopper kernel; ``"cpu"``: its
    plain version), or over a ``mesh`` of devices.

    ``backend``: ``"auto"`` or ``"pallas"``, the regeneration kernel;
    ``"xla"``, the portable wavefront (``use_matmul`` picks its sphere
    products' form). ``gather`` picks the kernel's winner fetch route
    ("index", "radix" or "windows"; None: the environment's ``RT_GATHER``
    and ``RT_TWO_LEVEL_MXU``, read here once); every route gives the same
    image. ``device`` defaults to "cuda", or to the mesh's first device
    (another ``device`` with a mesh raises).

    ``camera`` may be reassigned (the interactive session moves it every
    pose): the kernel's host camera vector follows it. The packed tables
    keep the cull block order of the first pose (front to back from its
    centre), which changes no bit, only the cull's speed; assign
    ``params`` with ``camera``, as the checkpoint fingerprint reads it."""

    def __init__(
        self,
        scene: Scene,
        camera_params: rcamera.CameraParameters,
        *,
        seed: int = 0,
        device=None,
        max_rays_per_batch: int = 1 << 20,
        gather: str | None = None,
        use_matmul: bool = True,
        mesh=None,
        backend: str = "auto",
    ) -> None:
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = "pallas" if backend == "auto" else backend
        self.mesh = mesh
        if mesh is not None:
            for row in mesh.devices:
                for d in row:
                    resolve_device(d)
            if device is not None and resolve_device(device) != mesh.first:
                raise ValueError(
                    f"device {device} is not the mesh's first device "
                    f"{mesh.first}"
                )
            device = mesh.first
        self.device = resolve_device("cuda" if device is None else device)
        self.gather = rtrace.gather_route(gather)
        self.use_matmul = bool(use_matmul)
        self.scene = scene.to(self.device)
        self.params = camera_params
        # The kernel takes the camera by value: keep the host copy, so a
        # launch never waits on a device->host read.
        self._camera = rcamera.derive(camera_params, self.device)
        self._cam_host = rcamera.derive(camera_params).as_vector()
        self.seed = int(seed)
        self.base_key = rrng.key(self.seed, self.device)
        self.max_rays_per_batch = int(max_rays_per_batch)
        # Cull blocks are visited front to back from the camera center
        # (the regeneration kernel's tables; the wavefront needs none).
        self._tables = None
        if self.backend == "pallas":
            self._tables = rtrace.pack_scene(
                self.scene, origin=self._cam_host[9:12]
            )
        self._scene_hash: bytes | None = None
        self._samples_done = 0
        self._segments = 0
        # The cull's work since the render started (cull_counts).
        self._cull = [0] * len(rtrace.CULL_COUNTS)
        # (counts, event): a launch's segment scalar or count buffer
        # (copied to pinned host memory on CUDA, with the event that marks
        # the copy done). The lock guards _segments, _cull and this list:
        # the pipelined interactive session drains it from its worker
        # thread.
        self._pending_segments: list = []
        self._seg_lock = threading.Lock()
        self._start_time: float | None = None
        self._end_time: float | None = None
        self._elapsed_base = 0.0
        self._spp_target = 0
        self._tiles_counter = 0
        # Render state: running sums (slot order, or pixel order + spill
        # row for xla) and, for the kernel, the per-slot completed samples
        # (one block per spp shard, flat) with the budget whose split laid
        # them out.
        self._image_sum: torch.Tensor | None = None
        self._done: torch.Tensor | None = None
        self._done_budget: int | None = None
        # Frame API state: the absolute sample base of render_frame*, the
        # per-pose sums and count of render_frame_accum*, and the
        # per-resolution slot ids and zero done counts.
        self._frame_sample_base = 0
        self._frame_accum_sum: torch.Tensor | None = None
        self._frame_accum_count = 0
        self._frame_wh: tuple[int, int] | None = None
        self._frame_ids: torch.Tensor | None = None
        self._frame_zero_done: torch.Tensor | None = None

    @property
    def camera(self) -> rcamera.DerivedCamera:
        return self._camera

    @camera.setter
    def camera(self, cam: rcamera.DerivedCamera) -> None:
        """Point the next launch at ``cam`` (derive it on the CPU: a camera
        on the card costs one device->host read here)."""
        self._camera = cam
        self._cam_host = cam.as_vector().cpu()

    # -- metric API ------------------------------------------------------
    @property
    def pixels_count(self) -> int:
        return self.camera.image_width * self.camera.image_height

    @property
    def pixels_raytraced(self) -> int:
        return int(self.fraction_done * self.pixels_count)

    @property
    def samples_done(self) -> int:
        return self._samples_done

    @property
    def fraction_done(self) -> float:
        if not self._spp_target:
            return 0.0
        return min(self._samples_done / self._spp_target, 1.0)

    def _track(self, segments: torch.Tensor) -> None:
        """Queue a launch's segment scalar or its int64[4] count buffer
        (``render_pixels_fused``'s ``counts``); on CUDA it is copied to
        pinned host memory behind the launch, with an event to test it
        by."""
        event = None
        if segments.device.type == "cuda":
            host = torch.empty(segments.shape, dtype=torch.int64,
                               pin_memory=True)
            host.copy_(segments, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(segments.device))
            segments = host
        with self._seg_lock:
            self._pending_segments.append((segments, event))

    @property
    def segments_traced(self) -> int:
        """Total ray segments traced (int64; the Mrays/s numerator). Waits
        for every queued launch's count."""
        with self._seg_lock:
            pending, self._pending_segments = self._pending_segments, []
            for count, event in pending:
                if event is not None:
                    event.synchronize()
                self._fold(count)
            return self._segments

    def _fold(self, count: torch.Tensor) -> None:
        """Add a launch's host counts (under ``_seg_lock``)."""
        c = count.reshape(-1).tolist()
        self._segments += c[0]
        for k, v in enumerate(c[1:]):
            self._cull[k] += v

    @property
    def cull_counts(self) -> dict:
        """The cull's work in the kernel's chunked sphere sweep since the
        render started, by ``rtrace.CULL_COUNTS``: ``lane_passes`` the
        (ray, block) pairs whose gate passed, ``block_visits`` the (thread
        block, block) visits of the lock step and ``chunk_copies`` those
        whose vote copied the chunk; all zero where the table is staged.
        Taken with the segments (``segments_traced``), so it waits as
        that does."""
        self.segments_traced
        with self._seg_lock:
            return dict(zip(rtrace.CULL_COUNTS, self._cull))

    @property
    def segments_traced_ready(self) -> int:
        """``segments_traced`` without waiting: folds in, in launch order,
        only the counts whose launches have finished (``Event.query``; CPU
        counts are always ready), so the interactive display never stalls
        the frame pipeline. The count catches up as launches complete."""
        with self._seg_lock:
            pend = self._pending_segments
            while pend and (pend[0][1] is None or pend[0][1].query()):
                self._fold(pend.pop(0)[0])
            return self._segments

    def render_time(self) -> float:
        """Elapsed wall-clock seconds: running until the render completes,
        then frozen; across a checkpoint and resume, the runs' sum."""
        if self._start_time is None:
            return self._elapsed_base
        end = self._end_time if self._end_time is not None else time.perf_counter()
        return self._elapsed_base + (end - self._start_time)

    def mrays_per_sec(self) -> float:
        t = self.render_time()
        return (self.segments_traced / t) / 1.0e6 if t > 0 else 0.0

    def reseed(self, seed: int) -> None:
        """Point the next render at a fresh RNG stream: drops the counters,
        the accumulated sums (a render under one seed cannot resume another
        seed's samples) and the frame accumulation."""
        self.seed = int(seed)
        self.base_key = rrng.key(self.seed, self.device)
        self._samples_done = 0
        with self._seg_lock:
            self._segments = 0
            self._cull = [0] * len(rtrace.CULL_COUNTS)
            self._pending_segments = []
        self._elapsed_base = 0.0
        self._tiles_counter = 0
        self._image_sum = None
        self._done = None
        self._done_budget = None
        self._frame_sample_base = 0
        self._frame_accum_sum = None
        self._frame_accum_count = 0

    # -- mesh bookkeeping --------------------------------------------------
    def _mesh_axis(self, axis: str) -> int:
        return self.mesh.shape[axis] if self.mesh is not None else 1

    def _work_ahead_shards(self) -> int:
        """Stacked done blocks: one per spp mesh shard (1 unsharded)."""
        return self._mesh_axis("spp")

    def _prefix_done(self, slots: int, k: int, budget: int) -> torch.Tensor:
        """Flat done counts of a state whose completed set is the sample
        prefix ``[0, k)``, laid out under a ``budget``-sample split: shard
        ``s`` owns ``[s * budget // n, (s + 1) * budget // n)``, so a prefix
        fills each shard's own local prefix."""
        n_sp = self._work_ahead_shards()
        counts = []
        for s in range(n_sp):
            lo = (budget * s) // n_sp
            hi = (budget * (s + 1)) // n_sp
            counts.append(min(max(k - lo, 0), hi - lo))
        return torch.tensor(counts, dtype=torch.int32,
                            device=self.device).repeat_interleave(slots)

    def _per_slot_done(self, done: torch.Tensor) -> torch.Tensor:
        """Per-slot completed samples: the sum of the spp shards' local
        counts (independent of the split, so valid whatever budget laid
        the blocks out)."""
        n_sp = self._work_ahead_shards()
        if n_sp == 1:
            return done
        return done.view(n_sp, -1).sum(dim=0, dtype=torch.int32)

    def _tables_by_device(self) -> dict:
        return {self.device: self._tables}

    # -- work decomposition ------------------------------------------------
    def _plan(
        self, spp: int, total_slots: int, has_observer: bool = False
    ) -> tuple[int, int]:
        """(block, chunk_spp). Kernel: every wave covers all slots, padded
        to whole 1024-slot tiles on every px shard; the sample budget is
        split into bounded waves, and without an observer into at most
        ~4. Wavefront: whole-image blocks of ``chunk_spp`` samples under
        ``max_rays_per_batch`` rays, else blocks of that many pixels at one
        sample; blocks divide over the px shards."""
        n_px = self._mesh_axis("px")
        if self.backend == "pallas":
            quantum = rtrace.TILE_SLOTS * n_px
            block = -(-total_slots // quantum) * quantum
            chunk_spp = max(
                1, min(spp, (self.max_rays_per_batch * 64) // max(block, 1))
            )
            if not has_observer:
                chunk_spp = max(chunk_spp, -(-spp // 4))
            return block, chunk_spp
        if total_slots <= self.max_rays_per_batch:
            chunk_spp = max(1, min(spp, self.max_rays_per_batch // total_slots))
            return -(-total_slots // n_px) * n_px, chunk_spp
        block = (self.max_rays_per_batch // n_px) * n_px
        return max(block, n_px), 1

    def _waves(
        self, spp: int, max_depth: int, has_observer: bool = False,
        start: int = 0,
    ) -> tuple[list[int], dict]:
        """The kernel waves of a render from ``start`` completed samples:
        their cumulative targets ``t_end`` and the other
        ``render_pixels_fused`` arguments, which every wave shares."""
        cam = self.camera
        block, chunk_spp = self._plan(
            spp, rtiling.num_slots(cam.image_width, cam.image_height),
            has_observer=has_observer,
        )
        t_ends = list(range(start + chunk_spp, spp, chunk_spp)) + [spp]
        meta = dict(
            slot_base=0,
            map_param=rtiling.tiles_per_row(cam.image_width),
            seed=self.seed & 0x7FFFFFFF,
            sample_start=0,
            spp=spp,
            max_depth=max_depth,
            num_slots=block,
            pixel_order="tiled",
            gather=self.gather,
        )
        return t_ends, meta

    def _wave(self, image_sum, done, t_end, meta):
        """One kernel wave over every slot (sharded under a mesh); returns
        ``(image_sum, counts, done)`` (``counts``: the int64[4] buffer of
        ``render_pixels_fused``), the sums continued in place."""
        if self.mesh is None:
            return rtrace.render_pixels_fused(
                self._tables, self._cam_host, t_end=t_end, done=done,
                radiance_sum=image_sum, counts=True, **meta,
            )
        rad, segments, done2 = rshard.render_pixels_fused_sharded(
            self._tables_by_device(), self._cam_host, meta["slot_base"],
            meta["seed"], meta["sample_start"], meta["spp"],
            meta["max_depth"], meta["num_slots"], self.mesh,
            meta["pixel_order"], done.view(-1, 128), t_end,
            map_param=meta["map_param"], radiance_sum=image_sum,
            gather=meta["gather"], counts=True,
        )
        return rad, segments, done2.reshape(-1)

    def render(
        self,
        spp: int | None = None,
        max_depth: int | None = None,
        *,
        on_progress: ProgressCallback | None = None,
        progress_every_chunks: int = 1,
        resume: bool = False,
        as_device_array: bool = False,
    ):
        """Render the full image; returns ``uint8[H, W, 3]``.

        With ``resume=True`` (after a render or ``load_checkpoint``) the
        accumulated sums (and per-slot counts) are kept and only what is
        left up to ``spp`` is traced. Every wave continues each slot's or
        pixel's running sum in sample order, so a resumed render is
        byte-equal to an uninterrupted one whatever wave it was stopped
        after (stronger than the JAX package's equality when the chunking
        matches; under an spp split of the mesh, equal for the same split).
        A state that already holds ``spp`` or more samples is returned as
        it is, normalised per slot. A sharded kernel state in the middle
        of its work-ahead (not at a sample prefix) resumes only toward the
        budget that split it.

        With ``as_device_array=True`` the uint8 image stays on the device
        (slot order for the kernel, ``[H, W, 3]`` for xla), with no host
        synchronisation; ``fetch_image`` brings it to the host.
        """
        with spans.span("rt.render"):
            spp = int(
                spp if spp is not None else self.params.samples_per_pixel
            )
            max_depth = int(
                max_depth if max_depth is not None else self.params.max_depth
            )
            self._spp_target = spp
            cam = self.camera
            if spp <= 0:
                self._start_time = time.perf_counter()
                self._end_time = self._start_time
                self._samples_done = 0
                return np.zeros((cam.image_height, cam.image_width, 3),
                                np.uint8)
            resuming = (
                resume and self._image_sum is not None
                and self._samples_done > 0
            )
            if self.backend == "xla":
                return self._render_xla(spp, max_depth, on_progress,
                                        progress_every_chunks, resuming,
                                        as_device_array)
            return self._render_kernel(spp, max_depth, on_progress,
                                       progress_every_chunks, resuming,
                                       as_device_array)

    def _start(self, resuming: bool, start: int) -> None:
        if not resuming:
            with self._seg_lock:
                self._segments = 0
                self._cull = [0] * len(rtrace.CULL_COUNTS)
                self._pending_segments = []
            self._elapsed_base = 0.0
            self._tiles_counter = 0
        self._samples_done = start
        self._start_time = time.perf_counter()
        self._end_time = None

    def _finish(self, u8: torch.Tensor, as_device_array: bool):
        image = None
        if not as_device_array:
            with spans.span("rt.render.readback"):
                image = self.fetch_image(u8)
                with spans.span("rt.readback.segments"):
                    self.segments_traced  # waits for the last launch's count
        self._end_time = time.perf_counter()
        self._elapsed_base = self.render_time()
        self._start_time = None
        self._end_time = None
        return u8 if as_device_array else image

    def _progress(self, on_progress, done: int, spp: int, snap) -> None:
        on_progress(
            RenderProgress(
                samples_done=done,
                samples_total=spp,
                pixels_count=self.pixels_count,
                segments_traced=self.segments_traced,
                elapsed_s=self.render_time(),
                _preview=lambda s=snap: self.fetch_image(s),
            )
        )

    def _render_kernel(self, spp, max_depth, on_progress,
                       progress_every_chunks, resuming, as_device_array):
        start = self._samples_done if resuming else 0
        t_ends, meta = self._waves(
            spp, max_depth, has_observer=on_progress is not None, start=start
        )
        block = meta["num_slots"]
        n_sp = self._work_ahead_shards()
        if resuming:
            image_sum, done = self._image_sum, self._done
            if start >= spp:
                u8 = _slots_to_u8(image_sum, self._per_slot_done(done))
                return u8 if as_device_array else self.fetch_image(u8)
            if n_sp > 1 and self._done_budget != spp:
                # The sharded layout depends on the budget's split: a state
                # at a sample prefix (e.g. a completed render) is that
                # prefix in any split; a ragged one cannot be re-split.
                old = (None if self._done_budget is None else
                       self._prefix_done(block, start, self._done_budget))
                if old is None or not torch.equal(done, old):
                    raise ValueError(
                        "cannot resume a mid-render sharded work-ahead "
                        f"state toward a different spp (state split at "
                        f"{self._done_budget}, target {spp}); finish the "
                        "render at the original spp first"
                    )
                done = self._prefix_done(block, start, spp)
        else:
            image_sum = torch.zeros((block, 3), dtype=torch.float32,
                                    device=self.device)
            done = torch.zeros((n_sp * block,), dtype=torch.int32,
                               device=self.device)
        self._done_budget = spp
        self._start(resuming, start)
        for chunk_index, t_end in enumerate(t_ends, start=1):
            with spans.span("rt.render.wave"):
                image_sum, counts, done = self._wave(image_sum, done,
                                                     t_end, meta)
                self._track(counts)
            # The state a checkpoint saves, current before the callback.
            self._image_sum, self._done = image_sum, done
            self._samples_done = t_end
            self._tiles_counter += (block // rtrace.TILE_SLOTS) * n_sp
            if on_progress is not None and (
                chunk_index % progress_every_chunks == 0 or t_end >= spp
            ):
                snap = _slots_to_u8(image_sum, self._per_slot_done(done))
                self._progress(on_progress, t_end, spp, snap)
        u8 = _slots_to_u8(image_sum, self._per_slot_done(done))
        return self._finish(u8, as_device_array)

    def _render_xla(self, spp, max_depth, on_progress,
                    progress_every_chunks, resuming, as_device_array):
        cam = self.camera
        h, w = cam.image_height, cam.image_width
        num_pixels = self.pixels_count
        block, chunk_spp = self._plan(spp, num_pixels)
        dev = self.device
        ids = torch.arange(num_pixels, dtype=torch.int64, device=dev)
        pad = (-num_pixels) % block
        if pad:
            ids = torch.cat([ids, torch.full((pad,), num_pixels,
                                             dtype=torch.int64, device=dev)])
        blocks = list(torch.split(ids, block))
        if resuming:
            image_sum = self._image_sum
            start = self._samples_done
            if start >= spp:
                u8 = _to_u8(image_sum, start, h, w)
                return u8 if as_device_array else self.fetch_image(u8)
        else:
            image_sum = torch.zeros((num_pixels + 1, 3), dtype=torch.float32,
                                    device=dev)
            start = 0
        self._start(resuming, start)
        chunk_index = 0
        while start < spp:
            this_chunk = min(chunk_spp, spp - start)
            for pix in blocks:
                with spans.span("rt.render.wave"):
                    rows = image_sum[pix]
                    if self.mesh is None:
                        rad, segments = integrator.render_pixels(
                            self.scene, cam, self.base_key, pix, start,
                            this_chunk, spp, max_depth,
                            use_matmul=self.use_matmul, radiance_init=rows,
                        )
                    else:
                        rad, segments = rshard.render_pixels_sharded(
                            self.scene, cam, self.base_key, pix, start,
                            this_chunk, spp, max_depth, self.mesh,
                            self.use_matmul, radiance_init=rows,
                        )
                    image_sum.index_copy_(0, pix, rad)
                    self._track(segments)
                self._tiles_counter += (pix.shape[0] * this_chunk
                                        ) // rtrace.DEFAULT_TILE_RAYS
            start += this_chunk
            chunk_index += 1
            self._samples_done = start
            self._image_sum = image_sum
            if on_progress is not None and (
                chunk_index % progress_every_chunks == 0 or start >= spp
            ):
                self._progress(on_progress, start, spp,
                               _to_u8(image_sum, start, h, w))
        return self._finish(_to_u8(image_sum, spp, h, w), as_device_array)

    def fetch_image(self, u8: torch.Tensor) -> np.ndarray:
        """A device u8 image in slot order (``render(as_device_array=True)``,
        ``render_frame*``) -> host ``uint8[H, W, 3]``; a preview (already
        ``[h, w, 3]``) comes back as it is."""
        with spans.span("rt.readback.copy"):
            arr = u8.cpu().numpy()
        if arr.ndim == 2:
            with spans.span("rt.readback.untile"):
                return _slots_to_image(
                    arr, self.camera.image_width, self.camera.image_height
                )
        return arr

    # -- interactive frames ------------------------------------------------
    def _frame_setup(self, spp, max_depth, what: str):
        """The frame API's prologue: (spp, max_depth, slots), and the
        per-resolution slot ids (for the device preview) and zero done
        counts, made once per (W, H) and kept on the device. The frame API
        is the kernel's and single-device."""
        if self.backend != "pallas":
            raise ValueError(f"{what} requires the pallas backend")
        if self.mesh is not None:
            raise ValueError(
                f"{what} is single-chip (it bypasses the mesh); use "
                "render() for sharded rendering"
            )
        spp = int(spp if spp is not None else self.params.samples_per_pixel)
        max_depth = int(
            max_depth if max_depth is not None else self.params.max_depth
        )
        cam = self.camera
        wh = (cam.image_width, cam.image_height)
        slots = rtiling.num_slots(*wh)
        if self._frame_wh != wh:
            self._frame_wh = wh
            self._frame_ids = torch.from_numpy(
                rtiling.tiled_pixel_ids(*wh)
            ).to(self.device)
            self._frame_zero_done = torch.zeros(
                slots, dtype=torch.int32, device=self.device
            )
        return spp, max_depth, slots

    def _frame_launch(self, spp, max_depth, slots, sample_start,
                      radiance_sum=None) -> torch.Tensor:
        """One launch: every slot traces samples ``[sample_start,
        sample_start + spp)``, continuing ``radiance_sum`` (zeros when
        None); returns the sums."""
        cam = self.camera
        rad, segments, _ = rtrace.render_pixels_fused(
            self._tables,
            self._cam_host,
            slot_base=0,
            map_param=rtiling.tiles_per_row(cam.image_width),
            seed=self.seed & 0x7FFFFFFF,
            sample_start=sample_start,
            spp=spp,
            max_depth=max_depth,
            t_end=max(spp, 0),
            done=self._frame_zero_done,
            num_slots=slots,
            pixel_order="tiled",
            radiance_sum=radiance_sum,
            gather=self.gather,
        )
        self._tiles_counter += slots // rtrace.TILE_SLOTS
        self._track(segments)
        return rad

    def _preview(self, u8: torch.Tensor, rows: int, cols: int):
        cam = self.camera
        h, w = cam.image_height, cam.image_width
        ph, pw = _preview_shape(h, w, rows, cols)
        return _device_preview(u8, self._frame_ids, h, w, ph, pw)

    def render_frame(self, spp: int | None = None,
                     max_depth: int | None = None, *,
                     _what: str = "render_frame") -> torch.Tensor:
        """One interactive frame: one launch plus the tonemap, returning
        the device u8 image in slot order without synchronising (pair with
        ``fetch_image``). Consecutive frames draw fresh samples (the
        absolute sample base advances by ``spp``)."""
        spp, max_depth, slots = self._frame_setup(spp, max_depth, _what)
        rad = self._frame_launch(spp, max_depth, slots,
                                 self._frame_sample_base)
        self._frame_sample_base += spp
        return _slots_to_u8_total(rad, spp)

    def render_frame_preview(
        self,
        spp: int | None = None,
        max_depth: int | None = None,
        preview_cols: int = 240,
        preview_rows: int = 136,
    ):
        """``render_frame`` plus a device-side box-downsampled preview:
        ``(dev_slots, dev_preview)``. The preview covers the whole frame;
        its shape is ceil(H/fy) x ceil(W/fx) <= (preview_rows,
        preview_cols), fy and fx the ceil box factors."""
        u8 = self.render_frame(spp, max_depth, _what="render_frame_preview")
        return u8, self._preview(u8, preview_rows, preview_cols)

    @property
    def frame_accum_samples(self) -> int:
        """Samples accumulated at the current camera pose."""
        return self._frame_accum_count

    def frame_accum_reset(self) -> None:
        """Start a fresh accumulation (call when the camera moves); the next
        accumulating frame starts from zero sums."""
        self._frame_accum_count = 0

    def render_frame_accum(self, spp: int | None = None,
                           max_depth: int | None = None, *,
                           _what: str = "render_frame_accum"):
        """Accumulating frame: trace ``spp`` fresh samples (absolute ids
        ``[count, count + spp)``, the samples a one-shot ``render(spp=count
        + spp)`` with this seed draws) in one launch that continues the
        pose's running sums in place, and return ``(dev_u8, total)``: the
        accumulated mean in slot order (no synchronisation) and the pose's
        sample count after this frame. k frames give the bits of one
        ``render(spp=total)``. Call ``frame_accum_reset()`` on motion."""
        spp, max_depth, slots = self._frame_setup(spp, max_depth, _what)
        count = self._frame_accum_count
        self._frame_accum_sum = self._frame_launch(
            spp, max_depth, slots, count, self._accum_buffer(slots)
        )
        self._frame_accum_count = count + spp
        return (_slots_to_u8_total(self._frame_accum_sum, count + spp),
                count + spp)

    def render_frame_accum_preview(
        self,
        spp: int | None = None,
        max_depth: int | None = None,
        preview_cols: int = 240,
        preview_rows: int = 136,
    ):
        """``render_frame_accum`` plus the device-side preview: ``(dev_u8,
        dev_preview, total)``."""
        u8, total = self.render_frame_accum(
            spp, max_depth, _what="render_frame_accum_preview")
        return u8, self._preview(u8, preview_rows, preview_cols), total

    def _accum_buffer(self, slots: int) -> torch.Tensor | None:
        """The pose's running sums, or None (zeros) for a fresh pose; a
        resolution change without a reset raises."""
        if self._frame_accum_count == 0:
            return None
        if self._frame_accum_sum.shape[0] != slots:
            raise ValueError(
                "frame accumulation buffer does not match the current "
                "resolution; call frame_accum_reset() after resizing"
            )
        return self._frame_accum_sum

    # -- checkpoint / resume -----------------------------------------------
    def _fingerprint(self) -> str:
        """SHA-1 over every Scene field (tensor dtype, shape and bytes,
        textures and triangle tables included), the camera parameters but
        ``samples_per_pixel`` (the budget being resumed) and the seed."""
        if self._scene_hash is None:
            h = hashlib.sha1(b"raytracing_tpu_torch.Scene")
            for f in dataclasses.fields(self.scene):
                value = getattr(self.scene, f.name)
                h.update(f.name.encode() + b"\0")
                if isinstance(value, torch.Tensor):
                    t = value.detach().cpu().contiguous()
                    h.update(f"{t.dtype}{tuple(t.shape)}".encode())
                    h.update(t.numpy().tobytes())
                else:
                    h.update(repr(value).encode())
            self._scene_hash = h.digest()
        h = hashlib.sha1(self._scene_hash)
        p = dataclasses.replace(self.params, samples_per_pixel=0)
        h.update(repr(p).encode())
        h.update(str(self.seed).encode())
        return h.hexdigest()

    def _framebuffer_rows(self) -> int:
        """Rows of this backend's and mesh's accumulation buffer: slots
        padded to the px shards' tiles (kernel), or pixels + the spill row
        (xla)."""
        if self.backend == "pallas":
            cam = self.camera
            slots = rtiling.num_slots(cam.image_width, cam.image_height)
            return self._plan(1, slots)[0]
        return self.pixels_count + 1

    def save_checkpoint(self, path: str) -> None:
        """Write the accumulated sums (with the kernel's per-slot counts and
        the budget that split them) and the counters to ``path`` (``.npz``
        appended if missing), the JAX package's keys; also mid-render, from
        an ``on_progress`` callback."""
        if self._image_sum is None:
            raise ValueError("nothing rendered yet; no state to checkpoint")
        if not str(path).endswith(".npz"):
            path = f"{path}.npz"
        extra = {}
        if self._done is not None:
            extra["done"] = self._done.cpu().numpy().reshape(-1, 128)
            if self._done_budget is not None:
                extra["done_budget"] = self._done_budget
        np.savez_compressed(
            path,
            image_sum=self._image_sum.cpu().numpy(),
            samples_done=self._samples_done,
            segments=self.segments_traced,
            tiles_counter=self._tiles_counter,
            elapsed=self.render_time(),
            fingerprint=self._fingerprint(),
            layout=_LAYOUT[self.backend],
            **extra,
        )

    def load_checkpoint(self, path: str) -> int:
        """Restore a checkpoint's state; returns the samples already done.

        The checkpoint must come from a renderer with the same scene (every
        field), camera and seed: the fingerprint is checked, so one written
        by the JAX package is refused. Its layout must be this backend's
        ("slot" for the kernel, "pixel" for xla) and its rows this mesh's.
        Resume with ``render(resume=True)``: both backends key their RNG by
        (pixel or slot, absolute sample), so the resumed render is
        byte-equal to an uninterrupted one."""
        if not str(path).endswith(".npz"):
            path = f"{path}.npz"
        with np.load(path, allow_pickle=False) as data:
            if str(data["fingerprint"]) != self._fingerprint():
                raise ValueError(
                    "checkpoint fingerprint mismatch (different scene, "
                    "camera, or seed)"
                )
            layout = str(data["layout"]) if "layout" in data else "pixel"
            expected = _LAYOUT[self.backend]
            if layout != expected:
                raise ValueError(
                    f"checkpoint framebuffer layout {layout!r} does not "
                    f"match the {self.backend!r} backend's {expected!r} "
                    "layout; resume with the backend that produced the "
                    "checkpoint"
                )
            rows = int(data["image_sum"].shape[0])
            want = self._framebuffer_rows()
            if rows != want:
                raise ValueError(
                    f"checkpoint framebuffer has {rows} rows but this "
                    f"renderer expects {want} (different mesh px-axis or "
                    "image padding); resume with the mesh that produced "
                    "the checkpoint"
                )
            done = None
            if self.backend == "pallas":
                want_done = self._work_ahead_shards() * (want // 128)
                if "done" not in data or data["done"].shape != (want_done,
                                                                128):
                    got = data["done"].shape if "done" in data else None
                    raise ValueError(
                        f"checkpoint done array is {got} but this "
                        f"renderer's mesh expects [{want_done}, 128]; "
                        "resume with the mesh that produced the checkpoint"
                    )
                done = data["done"].astype(np.int32).reshape(-1)
            image_sum = data["image_sum"].astype(np.float32)
            self._image_sum = torch.from_numpy(image_sum).to(self.device)
            self._done = (None if done is None
                          else torch.from_numpy(done).to(self.device))
            self._done_budget = (int(data["done_budget"])
                                 if "done_budget" in data else None)
            self._samples_done = int(data["samples_done"])
            with self._seg_lock:
                self._segments = int(data["segments"])
                self._cull = [0] * len(rtrace.CULL_COUNTS)
                self._pending_segments = []
            self._tiles_counter = int(data["tiles_counter"])
            self._elapsed_base = float(data["elapsed"])
        self._start_time = None
        self._end_time = None
        return self._samples_done
