"""Carry scene and camera state across from the JAX package.

The JAX package's ``Scene`` and ``DerivedCamera`` are dataclasses of arrays.
Given their fields as numpy arrays (for example
``{f.name: np.asarray(getattr(s, f.name)) for f in dataclasses.fields(s)}``),
these functions build the port's objects, so a comparison test feeds both
packages exactly the same tables. Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.camera import DerivedCamera
from .scene.types import TENSOR_FIELDS, Scene

_CAMERA_VECTORS = (
    "pixel00", "pixel_delta_u", "pixel_delta_v", "center",
    "defocus_disk_u", "defocus_disk_v", "defocus_angle",
)


def scene_from_numpy(
    arrays: dict, *, has_textures: bool, has_triangles: bool, device="cpu"
) -> Scene:
    """Scene fields as numpy arrays -> the port's ``Scene`` on ``device``.
    Every tensor field must be present; dtypes are kept (float32/int32)."""
    missing = [n for n in TENSOR_FIELDS if n not in arrays]
    if missing:
        raise KeyError(f"scene arrays missing fields: {missing}")
    fields = {
        n: torch.from_numpy(np.array(arrays[n], copy=True)).to(device)
        for n in TENSOR_FIELDS
    }
    return Scene(
        **fields, has_textures=bool(has_textures),
        has_triangles=bool(has_triangles),
    )


def scene_to_numpy(scene: Scene) -> dict:
    """The inverse of ``scene_from_numpy`` (tensor fields only)."""
    return {n: getattr(scene, n).cpu().numpy() for n in TENSOR_FIELDS}


def camera_from_numpy(
    arrays: dict, *, image_width: int, image_height: int, device="cpu"
) -> DerivedCamera:
    """DerivedCamera vectors as numpy arrays -> the port's camera."""
    return DerivedCamera(
        **{
            n: torch.from_numpy(np.array(arrays[n], np.float32)).to(device)
            for n in _CAMERA_VECTORS
        },
        image_width=int(image_width),
        image_height=int(image_height),
    )
