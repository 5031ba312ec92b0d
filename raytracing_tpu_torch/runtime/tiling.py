"""2D pixel-tile work order (copy of ``raytracing_tpu/runtime/tiling.py``).

1024 consecutive work slots map to one 32x32 pixel tile, so neighbouring
threads of the regeneration kernel trace rays into a narrow frustum. The
slot -> pixel map is computed on the host here (to reorder the slot-order
sums into an image) and inside the kernel (to generate camera rays):

  tile   = slot // (TILE_W*TILE_H)
  within = slot %  (TILE_W*TILE_H)
  wy, wx = divmod(within, TILE_W)
  ty, tx = divmod(tile, tiles_per_row)
  px, py = tx*TILE_W + wx, ty*TILE_H + wy

Slots whose (px, py) fall outside the image map to the spill id
``width*height`` and are dropped when the image is assembled.
"""

from __future__ import annotations

import numpy as np

TILE_W = 32
TILE_H = 32
SLOTS_PER_TILE = TILE_W * TILE_H


def tiles_per_row(width: int) -> int:
    return -(-width // TILE_W)


def num_slots(width: int, height: int) -> int:
    return tiles_per_row(width) * (-(-height // TILE_H)) * SLOTS_PER_TILE


def tiled_pixel_ids(width: int, height: int) -> np.ndarray:
    """Slot -> flat pixel id table (int32), spill id = width*height."""
    tpr = tiles_per_row(width)
    slots = num_slots(width, height)
    slot = np.arange(slots, dtype=np.int64)
    tile, within = np.divmod(slot, SLOTS_PER_TILE)
    wy, wx = np.divmod(within, TILE_W)
    ty, tx = np.divmod(tile, tpr)
    px = tx * TILE_W + wx
    py = ty * TILE_H + wy
    valid = (px < width) & (py < height)
    ids = np.where(valid, py * width + px, width * height)
    return ids.astype(np.int32)
