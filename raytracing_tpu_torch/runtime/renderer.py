"""Batch renderer: waves of the regeneration kernel over every pixel slot.

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

The JAX package's adaptive 8-spp probe wave and its wall-clock wave target
exist for a remote TPU runtime's watchdog and are not part of this port.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..core import camera as rcamera
from ..core import color as rcolor
from ..ops import trace as rtrace
from ..scene.types import Scene
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


def _slots_to_image(slot_u8: np.ndarray, width: int, height: int) -> np.ndarray:
    """Host-side slot->pixel reorder of the 32x32 tiled slot order (spill
    slots dropped). Equal to scattering by ``tiling.tiled_pixel_ids``, done
    as one tile transpose: slot ``(ty, tx, wy, wx)`` is pixel
    ``(ty*32 + wy, tx*32 + wx)``."""
    tpr = rtiling.tiles_per_row(width)
    rows = -(-height // rtiling.TILE_H)
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


class Renderer:
    """Progressive batch renderer for one scene (spheres, textures,
    triangles) + camera on one device (``"cuda"``: the Hopper kernel;
    ``"cpu"``: its plain version). ``gather`` picks the kernel's winner
    fetch route ("index", "radix" or "windows"; None: the environment's
    ``RT_GATHER`` and ``RT_TWO_LEVEL_MXU``, read here once); every route
    gives the same image."""

    def __init__(
        self,
        scene: Scene,
        camera_params: rcamera.CameraParameters,
        *,
        seed: int = 0,
        device="cuda",
        max_rays_per_batch: int = 1 << 20,
        gather: str | None = None,
    ) -> None:
        self.device = resolve_device(device)
        self.gather = rtrace.gather_route(gather)
        self.scene = scene.to(self.device)
        self.params = camera_params
        self.camera = rcamera.derive(camera_params, self.device)
        # The kernel takes the camera by value: keep the host copy, so a
        # launch never waits on a device->host read.
        self._cam_host = rcamera.derive(camera_params).as_vector()
        self.seed = int(seed)
        self.max_rays_per_batch = int(max_rays_per_batch)
        # Cull blocks are visited front to back from the camera center.
        self._tables = rtrace.pack_scene(
            self.scene, origin=self._cam_host[9:12]
        )
        self._samples_done = 0
        self._segments = 0
        self._pending_segments: list[torch.Tensor] = []
        self._start_time: float | None = None
        self._end_time: float | None = None
        self._elapsed_base = 0.0
        self._spp_target = 0

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

    @property
    def segments_traced(self) -> int:
        """Total ray segments traced (int64; the Mrays/s numerator)."""
        if self._pending_segments:
            pending, self._pending_segments = self._pending_segments, []
            self._segments += int(torch.stack(pending).sum().item())
        return self._segments

    def render_time(self) -> float:
        """Elapsed wall-clock seconds: running until the render completes,
        then frozen."""
        if self._start_time is None:
            return self._elapsed_base
        end = self._end_time if self._end_time is not None else time.perf_counter()
        return self._elapsed_base + (end - self._start_time)

    def mrays_per_sec(self) -> float:
        t = self.render_time()
        return (self.segments_traced / t) / 1.0e6 if t > 0 else 0.0

    def reseed(self, seed: int) -> None:
        """Point the next render at a fresh RNG stream (drops the counters
        of the previous render)."""
        self.seed = int(seed)
        self._samples_done = 0
        self._segments = 0
        self._pending_segments = []
        self._elapsed_base = 0.0

    # -- work decomposition ------------------------------------------------
    def _plan(
        self, spp: int, total_slots: int, has_observer: bool = False
    ) -> tuple[int, int]:
        """(slot_block, chunk_spp): every wave covers all slots, padded to
        whole 1024-slot tiles; the sample budget is split into bounded
        waves, and without an observer into at most ~4."""
        quantum = rtrace.TILE_SLOTS
        block = -(-total_slots // quantum) * quantum
        chunk_spp = max(
            1, min(spp, (self.max_rays_per_batch * 64) // max(block, 1))
        )
        if not has_observer:
            chunk_spp = max(chunk_spp, -(-spp // 4))
        return block, chunk_spp

    def _waves(
        self, spp: int, max_depth: int, has_observer: bool = False
    ) -> tuple[list[int], dict]:
        """The waves of a render: their cumulative targets ``t_end`` and the
        other ``render_pixels_fused`` arguments, which every wave shares."""
        cam = self.camera
        block, chunk_spp = self._plan(
            spp, rtiling.num_slots(cam.image_width, cam.image_height),
            has_observer=has_observer,
        )
        t_ends = list(range(chunk_spp, spp, chunk_spp)) + [spp]
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

    def render(
        self,
        spp: int | None = None,
        max_depth: int | None = None,
        *,
        on_progress: ProgressCallback | None = None,
        progress_every_chunks: int = 1,
    ) -> np.ndarray:
        """Render the full image; returns ``uint8[H, W, 3]``."""
        spp = int(spp if spp is not None else self.params.samples_per_pixel)
        max_depth = int(
            max_depth if max_depth is not None else self.params.max_depth
        )
        self._spp_target = spp
        cam = self.camera
        if spp <= 0:
            self._start_time = time.perf_counter()
            self._end_time = self._start_time
            self._samples_done = 0
            return np.zeros((cam.image_height, cam.image_width, 3), np.uint8)

        num_pixels = self.pixels_count
        t_ends, meta = self._waves(
            spp, max_depth, has_observer=on_progress is not None
        )
        block = meta["num_slots"]
        dev = self.device
        image_sum = torch.zeros((block, 3), dtype=torch.float32, device=dev)
        done = torch.zeros((block,), dtype=torch.int32, device=dev)

        def to_host_image(u8: torch.Tensor) -> np.ndarray:
            return _slots_to_image(
                u8.cpu().numpy(), cam.image_width, cam.image_height
            )

        self._segments = 0
        self._pending_segments = []
        self._elapsed_base = 0.0
        self._samples_done = 0
        self._start_time = time.perf_counter()
        self._end_time = None
        for chunk_index, t_end in enumerate(t_ends, start=1):
            image_sum, segments, done = rtrace.render_pixels_fused(
                self._tables,
                self._cam_host,
                t_end=t_end,
                done=done,
                radiance_sum=image_sum,
                **meta,
            )
            self._pending_segments.append(segments)
            self._samples_done = t_end
            if on_progress is not None and (
                chunk_index % progress_every_chunks == 0 or t_end >= spp
            ):
                snap = _slots_to_u8(image_sum, done)
                on_progress(
                    RenderProgress(
                        samples_done=t_end,
                        samples_total=spp,
                        pixels_count=num_pixels,
                        segments_traced=self.segments_traced,
                        elapsed_s=self.render_time(),
                        _preview=lambda s=snap: to_host_image(s),
                    )
                )

        image = to_host_image(_slots_to_u8(image_sum, done))
        segments_total = self.segments_traced  # synchronizes the device
        self._end_time = time.perf_counter()
        self._elapsed_base = self.render_time()
        self._start_time = None
        self._end_time = None
        self._segments = segments_total
        return image
