"""Thin-lens camera: declarative parameters and the derived ray frame.

Counterpart of ``raytracing_tpu/core/camera.py`` (``CameraParameters``,
``DerivedCamera``, ``derive``). The frame is computed once per render on the
host in numpy float32, with the same operations in the same order as the
JAX package, so both packages hand bit-equal camera vectors to their
kernels. Batched ray generation lives inside the regeneration kernel
(``ops/trace.py``), not here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CameraParameters:
    """Declarative camera config; same fields and defaults as the JAX
    package (JSON-compatible with ``data/config/world.config.json``)."""

    aspect_ratio: float = 16.0 / 9.0
    image_width: int = 1200
    samples_per_pixel: int = 100
    max_depth: int = 50
    vertical_fov: float = 20.0
    defocus_angle: float = 10.0
    focus_distance: float = 3.4
    lookfrom: Sequence[float] = (-2.0, 2.0, 1.0)
    lookat: Sequence[float] = (0.0, 0.0, -1.0)
    world_up: Sequence[float] = (0.0, 1.0, 0.0)

    @property
    def image_height(self) -> int:
        return int(float(self.image_width) / self.aspect_ratio)


@dataclasses.dataclass(frozen=True)
class DerivedCamera:
    """Camera frame shared read-only by every ray: float32 tensors of
    shape (3,) (``defocus_angle`` is a scalar tensor) on one device."""

    pixel00: torch.Tensor
    pixel_delta_u: torch.Tensor
    pixel_delta_v: torch.Tensor
    center: torch.Tensor
    defocus_disk_u: torch.Tensor
    defocus_disk_v: torch.Tensor
    defocus_angle: torch.Tensor
    image_width: int
    image_height: int

    def as_vector(self) -> torch.Tensor:
        """The kernel's 20-float camera operand: pixel00, pixel_delta_u,
        pixel_delta_v, center, defocus_disk_u, defocus_disk_v,
        defocus_angle, pad."""
        return torch.cat(
            [
                self.pixel00, self.pixel_delta_u, self.pixel_delta_v,
                self.center, self.defocus_disk_u, self.defocus_disk_v,
                self.defocus_angle.reshape(1),
                torch.zeros(1, dtype=torch.float32, device=self.pixel00.device),
            ]
        ).to(torch.float32)


def derive(params: CameraParameters, device="cpu") -> DerivedCamera:
    """Camera params -> ray-generation frame (host-side float32 numpy)."""
    width = int(params.image_width)
    height = params.image_height

    theta = math.radians(params.vertical_fov)
    h = math.tan(theta * 0.5)
    viewport_height = 2.0 * h * params.focus_distance
    viewport_width = viewport_height * (float(width) / height)

    lookfrom = np.asarray(params.lookfrom, np.float32)
    lookat = np.asarray(params.lookat, np.float32)
    world_up = np.asarray(params.world_up, np.float32)

    w = lookfrom - lookat
    w = w / np.linalg.norm(w)
    u = np.cross(world_up, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)

    viewport_u = u * viewport_width
    viewport_v = -v * viewport_height
    pixel_delta_u = viewport_u / float(width)
    pixel_delta_v = viewport_v / float(height)

    viewport_upper_left = (
        lookfrom - params.focus_distance * w - viewport_u * 0.5 - viewport_v * 0.5
    )
    pixel00 = viewport_upper_left + 0.5 * (pixel_delta_u + pixel_delta_v)

    defocus_radius = params.focus_distance * math.tan(
        math.radians(params.defocus_angle * 0.5)
    )

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return DerivedCamera(
        pixel00=t(pixel00),
        pixel_delta_u=t(pixel_delta_u),
        pixel_delta_v=t(pixel_delta_v),
        center=t(lookfrom),
        defocus_disk_u=t(u * defocus_radius),
        defocus_disk_v=t(v * defocus_radius),
        defocus_angle=t(params.defocus_angle),
        image_width=width,
        image_height=height,
    )
