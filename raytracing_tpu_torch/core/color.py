"""Color pipeline: linear radiance -> gamma -> 8-bit channels.

Counterpart of ``raytracing_tpu/core/color.py`` on torch tensors, bit-exact:
sqrt gamma for positive values, then ``clamp(v, 0, 0.999) * 256`` truncated
to uint8 (so the largest channel value is 255).
"""

from __future__ import annotations

import torch


def linear_to_gamma(value: torch.Tensor) -> torch.Tensor:
    """sqrt gamma for positive values, 0 otherwise."""
    return torch.where(
        value > 0.0, torch.sqrt(torch.clamp(value, min=0.0)),
        torch.zeros_like(value),
    )


def quantize_channel(value: torch.Tensor) -> torch.Tensor:
    """``uint8(clamp(v, 0, 0.999) * 256)``."""
    return (torch.clamp(value, 0.0, 0.999) * 256.0).to(torch.uint8)


def rgb_to_u8(linear_rgb: torch.Tensor) -> torch.Tensor:
    """Linear RGB float tensor ``[..., 3]`` -> gamma'd ``uint8[..., 3]``."""
    return quantize_channel(linear_to_gamma(linear_rgb))
